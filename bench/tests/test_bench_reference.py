"""The benchmark's plain references against repro_torch's plain path
(``backend="torch"``) on the CPU, at small sizes: the tier's hash, probe
and flush, the SASRec and Granite-MoE towers, and the precision controls."""
import numpy as np
import pytest
import torch

from bench.reference import ercache as R
from bench.reference import lm_moe as ref_lm
from bench.reference import precision
from bench.reference import sasrec as ref_sasrec
from bench.towers import lm_moe as fam_lm
from bench.towers import sasrec as fam_sasrec
from repro_torch.configs import get_config
from repro_torch.core import cache as C
from repro_torch.core.hashing import Key64, bucket_index

MM = precision.matmul_at("float32")


def test_xxh32_buckets_match_the_program():
    ids = np.concatenate([np.arange(50), np.random.default_rng(1).integers(
        0, 2 ** 62, 2000)])
    for nb in (64, 1 << 20):
        want = bucket_index(Key64.from_int(ids, device="cpu"), nb).numpy()
        assert np.array_equal(R.bucket_of(ids, nb), want)


@pytest.mark.parametrize("nb,ways,users", [(8, 4, 200), (64, 2, 300),
                                           (256, 8, 500)])
def test_flush_and_probe_match_the_program(nb, ways, users):
    """Batches of repeated keys with buckets over-full, expiries and
    re-inserts: the reference's planes and probes equal the program's
    ``insert_dual`` and ``lookup_dual`` on the plain backend."""
    rng = np.random.default_rng(nb + ways)
    pd, pf = (C.init_cache(nb, ways, 4, device="cpu") for _ in range(2))
    rd, rf = R.Tier.empty(nb, ways, "cpu"), R.Tier.empty(nb, ways, "cpu")
    ttl_d, ttl_f = 3_000, 20_000
    for step in range(30):
        now = 1_000 * step
        ids = rng.integers(0, users, 64)
        hi, lo = (torch.as_tensor(w) for w in R.key_words(ids))
        b = torch.as_tensor(R.bucket_of(ids, nb))
        live = torch.as_tensor(rng.random(64) < 0.8)
        keys = Key64.from_int(ids, device="cpu")
        got = C.lookup_dual(pd, pf, keys, now, ttl_d, ttl_f, backend="torch")
        for tier, res, ttl in zip((rd, rf), got, (ttl_d, ttl_f)):
            p = R.probe(tier, b, hi, lo, now, ttl)
            assert torch.equal(p.hit, res.hit)
            assert torch.equal(p.age, res.age_ms.long())
        ts = torch.full((64,), now, dtype=torch.int32)
        C.insert_dual(pd, pf, keys, torch.zeros(64, 4), now, ttl_d, ttl_f,
                      write_mask=live, ts_ms=ts)
        R.flush((rd, rf), (b, b), hi, lo, ts, now, (ttl_d, ttl_f),
                R.FROM_TOWER, live=live)
        for mine, theirs in ((rd, pd), (rf, pf)):
            assert torch.equal(mine.key_hi, theirs.key_hi)
            assert torch.equal(mine.key_lo, theirs.key_lo)
            assert torch.equal(mine.ts, theirs.write_ts)


def _rel(a, b):
    return float(((a.double() - b.double()).norm(dim=-1)
                  / b.double().norm(dim=-1)).max())


def test_sasrec_reference_matches_the_program_tower():
    cfg = get_config("sasrec", smoke=True)
    fam = fam_sasrec.Family(
        {"family": "sasrec", "arch_id": cfg.arch_id, "embed_dim":
         cfg.embed_dim, "n_blocks": 2, "n_heads": 2, "seq_len": cfg.seq_len,
         "vocab": cfg.vocab, "dtype": "float32"}, torch.device("cpu"), "torch")
    w = fam.make_weights(torch.Generator().manual_seed(3))
    params = fam.program_params(w)
    seq = torch.randint(0, cfg.vocab, (24, cfg.seq_len), dtype=torch.int32)
    seq[:8, :5] = -1                                   # padded histories
    got = fam.tower_fn()(params, fam.program_features(seq))
    want = ref_sasrec.user_embedding(w, seq, 2, MM)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("capacity_factor,group", [(1.25, 128), (0.5, 128),
                                                   (1.25, 32)])
def test_lm_moe_reference_matches_the_program_tower(capacity_factor, group):
    """At the SMOKE widths in float32, with and without drops past
    capacity (and dropless groups of 64 or fewer)."""
    s = get_config("granite-moe-1b-a400m", smoke=True)
    cfg = {"family": "lm_moe", "arch_id": s.arch_id, "n_layers": s.n_layers,
           "d_model": s.d_model, "n_heads": s.n_heads,
           "n_kv_heads": s.n_kv_heads, "d_ff": s.d_ff, "vocab": s.vocab,
           "n_experts": s.moe.n_experts, "top_k": s.moe.top_k,
           "capacity_factor": capacity_factor, "moe_group_size": group,
           "rope_theta": s.rope_theta, "norm_eps": s.norm_eps,
           "dtype": "float32", "user_embed_dim": s.user_embed_dim,
           "attn_impl": "flash_kernel"}
    fam = fam_lm.Family(cfg, torch.device("cpu"), "torch")
    w = fam.make_weights(torch.Generator().manual_seed(4))
    params = fam.program_params(w)
    tokens = torch.randint(0, s.vocab, (6, 128), dtype=torch.int32)
    got = fam.tower_fn()(params, tokens)
    want = ref_lm.user_embedding(w, tokens, cfg, 6, MM)
    assert _rel(got, want) < 1e-4


def test_group_and_capacity():
    assert ref_lm.group_and_capacity(48, 2048, 512, 32, 8, 1.25) == (512, 160)
    assert ref_lm.group_and_capacity(2, 32, 512, 8, 4, 1.25) == (64, 64)
    with pytest.raises(ValueError):
        ref_lm.group_and_capacity(3, 100, 512, 8, 4, 1.25)


def test_precision_controls_round_as_stated():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(5))
    t = precision.rounder("tf32")(x)
    assert float(((t - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert torch.equal(precision.rounder("tf32")(t), t)
    bits = t.view(torch.int32) & 0x1FFF
    assert int(bits.abs().sum()) == 0
    f = precision.rounder("fp8")(x)
    assert len(torch.unique(f / (x.abs().max() / 448.0))) <= 256
    with pytest.raises(ValueError):
        precision.rounder("int4")
