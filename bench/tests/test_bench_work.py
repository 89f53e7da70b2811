"""The yardstick's bytes and operations against hand counts."""
from bench import work


def test_probe_bytes_by_hand():
    # 2 queries, 1 hit in each table, 8 ways each, D=2 float32:
    # reads 2*16 + 2*12*16 + 2*2*4 = 432; writes 2*2*(1+4+4+8) = 68
    assert work.probe_bytes(2, 1, 1, 8, 8, 2, 4) == 432 + 68


def test_bag_bytes_by_hand():
    # 3 bags of one id, one of them padding, D=4 float32:
    # ids 12, rows 2*16, outputs 3*16
    assert work.bag_bytes(3, 3, 2, 4, 4) == 12 + 32 + 48


def test_flash_work_by_hand():
    # 1 row, 4 positions (10 causal pairs), 2 query heads, 1 kv head, hd 8,
    # bf16: ops 4*2*8*10; bytes 4*8*2*(2*2 + 2*1)
    assert work.flash_work(1, 4, 2, 1, 8, 2) == (640, 384)
    assert work.flash_work(1, 4, 2, 1, 8, 2, causal=False)[0] == 4 * 2 * 8 * 16


def test_roofline_seconds_takes_the_larger_bound():
    peak_hbm = work.PEAKS["hbm_bytes_per_s"]
    assert work.roofline_seconds(1e12, 0.0, 1e12) == 1.0
    assert work.roofline_seconds(0.0, peak_hbm, 1e12) == 1.0


def test_sasrec_row_flops_by_hand():
    # seq 2, d 3, 1 block, ffn width 3: qkvo 2*2*3*3*4 = 144; attention
    # 2*2*3*3 = 36 (pairs 3, both products); ffn 2*2*3*3*2 = 72
    assert work.sasrec_row_flops(2, 3, 1) == 144 + 36 + 72


def test_lm_moe_row_flops_by_hand():
    # seq 2, d 4, 2 heads of 2, 1 kv head, 1 layer, 4 experts top 2, ffn 3,
    # user dim 5: a token's projections 2*4*2*(4+2) = 96, router 2*4*4 = 32,
    # experts 2*3*2*4*3 = 144; attention 2*2*3*2*2 = 48; head 2*4*5 = 40
    assert work.lm_moe_row_flops(2, 4, 2, 1, 1, 4, 2, 3, 5) == \
        2 * (96 + 32 + 144) + 48 + 40


def test_granite_row_flops_at_its_widths():
    """Granite-3.0-1B-A400M at 2,048 tokens: about 1.75 TFLOP a row."""
    f = work.lm_moe_row_flops(2048, 1024, 16, 8, 24, 32, 8, 512, 256)
    assert 1.7e12 < f < 1.8e12
