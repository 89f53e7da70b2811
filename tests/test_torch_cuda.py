"""The hand-written CUDA kernels of repro_torch against their plain PyTorch
versions, on the card.

Marked ``cuda``: each test asks the ``cuda`` fixture for the card and
skips where there is none (this file imports no JAX, so it runs on a
machine that has only PyTorch). Run on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cache as C  # noqa: E402
from repro_torch.core.config import NO_TTL_MS  # noqa: E402
from repro_torch.core.hashing import EMPTY_HI  # noqa: E402
from repro_torch.kernels import cache_probe as pk  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import embedding_bag as ebk  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

pytestmark = pytest.mark.cuda

MIN = 60_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def probe_population(rng, nb, ways, dim, batch, now, ttl, dtype, device):
    """Tables with fresh, expired and empty slots (some keys present twice
    in a bucket) and a query batch of hits, expired keys and misses."""
    key_hi = np.full((nb, ways), EMPTY_HI, np.int32)
    key_lo = np.zeros((nb, ways), np.int32)
    ts = np.full((nb, ways), C.TS_EMPTY, np.int32)
    live = rng.uniform(size=(nb, ways)) < 0.6
    key_hi[live] = rng.integers(0, 2 ** 31 - 1, live.sum())
    key_lo[live] = rng.integers(-2 ** 31, 2 ** 31 - 1, live.sum())
    ts[live] = now - rng.integers(0, 2 * ttl, live.sum())
    dup = rng.integers(0, nb, nb // 8)            # same key in two ways
    key_hi[dup, 1], key_lo[dup, 1] = key_hi[dup, 0], key_lo[dup, 0]
    values = rng.standard_normal((nb, ways, dim)).astype(np.float32)
    rows = rng.integers(0, nb, batch)
    cols = rng.integers(0, ways, batch)
    q_hi = key_hi[rows, cols].copy()
    q_lo = key_lo[rows, cols].copy()
    miss = rng.uniform(size=batch) < 0.3
    q_hi[miss] = rng.integers(0, 2 ** 31 - 1, miss.sum())
    t = lambda a: torch.as_tensor(a, device=device)
    tables = (t(key_hi), t(key_lo), t(ts),
              t(values).to(dtype).contiguous())
    return tables, (t(q_hi), t(q_lo), t(rows.astype(np.int32)))


def assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("batch", [1, 37, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probe_tiled_matches_plain(cuda, batch, dtype):
    rng = np.random.default_rng(batch)
    now, ttl = 10 * MIN, MIN
    tables, queries = probe_population(rng, 256, 8, 50, batch, now, ttl,
                                       dtype, cuda)
    n0 = pk.LAUNCHES["tiled"]
    got = pk.cache_probe_tiled(*tables, *queries, now, ttl)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["tiled"] == n0 + 1
    want = ref.cache_probe_ref(*tables, *queries, now, ttl)
    assert_same(got, want)
    if batch > 1:  # the population mixes hits and misses
        assert bool(want[0].any()) and not bool(want[0].all())


@pytest.mark.parametrize("wd,wf,nbd,nbf", [(8, 8, 256, 256), (8, 4, 256, 64),
                                           (2, 32, 16, 128)])
def test_probe_dual_matches_two_plain(cuda, wd, wf, nbd, nbf):
    rng = np.random.default_rng(wd * wf)
    now = 10 * MIN
    d_tab, (q_hi, q_lo, b_d) = probe_population(
        rng, nbd, wd, 50, 300, now, MIN, torch.float32, cuda)
    f_tab, _ = probe_population(rng, nbf, wf, 50, 300, now, 60 * MIN,
                                torch.float32, cuda)
    b_f = torch.as_tensor(rng.integers(0, nbf, 300).astype(np.int32),
                          device=cuda)
    n0 = pk.LAUNCHES["dual"]
    got_d, got_f = pk.cache_probe_dual(*d_tab, *f_tab, q_hi, q_lo, b_d, b_f,
                                       torch.tensor(now, dtype=torch.int32,
                                                    device=cuda),
                                       MIN, NO_TTL_MS)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["dual"] == n0 + 1
    assert_same(got_d, ref.cache_probe_ref(*d_tab, q_hi, q_lo, b_d, now,
                                           MIN))
    assert_same(got_f, ref.cache_probe_ref(*f_tab, q_hi, q_lo, b_f, now,
                                           NO_TTL_MS))


def test_probe_rejects_cpu_tables_with_cuda_queries(cuda):
    rng = np.random.default_rng(0)
    tables, queries = probe_population(rng, 16, 4, 8, 8, MIN, MIN,
                                       torch.float32, cuda)
    with pytest.raises(ValueError):
        pk.cache_probe_tiled(*(t.cpu() for t in tables), *queries, MIN, MIN)


@pytest.mark.parametrize("nnz,pad", [(1, 0.0), (4, 0.3), (7, 1.0)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_matches_plain(cuda, nnz, pad, mode, dtype):
    rng = np.random.default_rng(nnz)
    table = torch.as_tensor(rng.standard_normal((5000, 50)),
                            device=cuda).to(dtype)
    ids = rng.integers(0, 5000, (999, nnz)).astype(np.int32)
    ids[rng.uniform(size=ids.shape) < pad] = -1
    ids = torch.as_tensor(ids, device=cuda)
    n0 = ebk.LAUNCHES["embedding_bag"]
    got = ebk.embedding_bag(table, ids, mode=mode)
    torch.cuda.synchronize()
    assert ebk.LAUNCHES["embedding_bag"] == n0 + 1
    want = ref.embedding_bag_ref(table, ids, mode=mode)
    if nnz == 1:
        assert torch.equal(got, want)
    else:
        # float32 sums of nnz rows in another order: a few ulps
        tol = 1e-6 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("coalesce,budget,eviction", [(False, None, "ttl"),
                                                      (True, 3.5, "lru")])
def test_serve_many_cuda_backend_matches_torch_backend(cuda, coalesce,
                                                       budget, eviction):
    """The whole serve loop on the card: the cuda backend (probe kernel,
    bag kernel in the SMOKE SASRec tower) and the torch backend give
    bit-identical outputs, counters and cache planes; ONE dual-probe
    launch per step."""
    from repro_torch.configs import get_config
    from repro_torch.core import server as S
    from repro_torch.core.config import CacheConfig
    from repro_torch.core.hashing import Key64
    from repro_torch.kernels import ops
    from repro_torch.models import recsys as R

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_t = get_config("sasrec", smoke=True)
    rng = np.random.default_rng(5)
    ids = rng.choice(np.arange(80) * 104729, size=(10, 48))
    seq = rng.integers(0, cfg_t.vocab, (10, 48, cfg_t.seq_len))
    nows = np.arange(10, dtype=np.int32) * 20_000
    fails = rng.uniform(size=(10, 48)) < 0.1
    out = {}
    for backend in ("cuda", "torch"):
        model = R.init_params(torch.Generator(device=cuda).manual_seed(0),
                              cfg_t, cuda)
        cfg = CacheConfig(model_id=1, model_type="ctr", n_buckets=32,
                          ways=4, failover_n_buckets=16, failover_ways=2,
                          value_dim=cfg_t.embed_dim, cache_ttl_ms=MIN,
                          backend=backend, coalesce_misses=coalesce,
                          infer_budget_per_step=budget, eviction=eviction)
        srv = S.CachedEmbeddingServer(
            cfg=cfg, miss_budget=24,
            tower_fn=lambda p, f, b=backend: R.tower_step(p, f, cfg_t,
                                                          impl=b))
        state = S.init_server_state(cfg, writebuf_capacity=96, device=cuda)
        ops.reset_launch_counts()
        state, acc, ys = srv.serve_many(
            model, state, Key64.from_int(ids, device=cuda),
            {"seq": torch.as_tensor(seq, dtype=torch.int32, device=cuda)},
            torch.as_tensor(nows, device=cuda),
            torch.as_tensor(fails, device=cuda), flush_every=2)
        out[backend] = (state, S.fetch_counters(acc), ys,
                        ops.launch_counts())
    (st_c, acc_c, ys_c, n_c), (st_t, acc_t, ys_t, n_t) = out["cuda"], \
        out["torch"]
    assert n_c["cache_probe_dual"] == 10 and n_c["embedding_bag"] > 0
    assert sum(n_t.values()) == 0
    assert acc_c == acc_t
    for a, b in zip(ys_c, ys_t):
        assert torch.equal(a, b)
    for tier in ("direct", "failover"):
        for a, b in zip(getattr(st_c, tier), getattr(st_t, tier)):
            assert torch.equal(a, b)


def _multi_tier(rng, cuda, fo_ways=8, n=3000):
    """4 registry models (ids 11, 13, 15, 17: two capacities, 5- and
    1-minute TTLs, TTL and LRU eviction) as a stacked pair populated
    through the insert plan (fresh and direct-expired keys at now =
    6 min), with their policy and the stored ids."""
    from repro_torch.core.config import multi_model_tier_configs
    from repro_torch.core.hashing import Key64

    cfgs = multi_model_tier_configs(value_dim=50, n_buckets=64)[1::2]
    policy = C.policy_from_configs(cfgs, device=cuda)
    direct = C.init_multi_cache([c.n_buckets for c in cfgs], 8, 50,
                                device=cuda)
    failover = C.init_multi_cache([c.resolved_failover_n_buckets()
                                   for c in cfgs], fo_ways, 50, device=cuda)
    ids = rng.integers(0, 10 ** 6, n)
    C.insert_dual_multi(direct, failover, policy,
                        torch.as_tensor(rng.integers(0, 4, n), device=cuda),
                        Key64.from_int(ids, device=cuda),
                        torch.randn(n, 50, device=cuda), 4 * MIN,
                        ts_ms=torch.as_tensor(rng.integers(
                            0, 4 * MIN, n).astype(np.int32), device=cuda))
    return cfgs, policy, direct, failover, ids


@pytest.mark.parametrize("batch,fo_ways", [(512, 8), (37, 8), (1, 8),
                                           (300, 4)])
def test_probe_dual_multi_matches_plain(cuda, batch, fo_ways):
    """The multi-model kernel against its plain version, bit for bit, with
    the strict policy table and with a relaxed NO_TTL_MS failover
    column; one launch each."""
    from repro_torch.core.hashing import Key64

    rng = np.random.default_rng(batch)
    _, policy, direct, failover, ids = _multi_tier(rng, cuda, fo_ways)
    q = np.where(rng.uniform(size=batch) < 0.7, rng.choice(ids, batch),
                 rng.integers(10 ** 6, 2 * 10 ** 6, batch))
    k = Key64.from_int(q, device=cuda)
    slots = torch.as_tensor(rng.integers(0, 4, batch).astype(np.int32),
                            device=cuda)
    b_d, b_f = C._pooled_bucket_pair(direct, failover, policy, slots, k)
    fd, ff = direct.flat(), failover.flat()
    now = torch.tensor(6 * MIN, dtype=torch.int32, device=cuda)
    relaxed = policy.table().clone()
    relaxed[:, 1] = NO_TTL_MS
    for table in (policy.table(), relaxed):
        n0 = pk.LAUNCHES["dual_multi"]
        got = pk.cache_probe_dual_multi(*fd[:4], *ff[:4], k.hi, k.lo, slots,
                                        b_d, b_f, table, now)
        torch.cuda.synchronize()
        assert pk.LAUNCHES["dual_multi"] == n0 + 1
        want = ref.cache_probe_dual_multi_ref(*fd[:4], *ff[:4], k.hi, k.lo,
                                              slots, b_d, b_f, table, now)
        for g, w in zip(got, want):
            assert_same(g, w)


def test_lookup_dual_multi_is_one_launch(cuda):
    from repro_torch.core.hashing import Key64
    from repro_torch.kernels import ops

    rng = np.random.default_rng(3)
    _, policy, direct, failover, ids = _multi_tier(rng, cuda)
    k = Key64.from_int(rng.choice(ids, 64), device=cuda)
    slots = torch.arange(64, dtype=torch.int32, device=cuda) % 4
    ops.reset_launch_counts()
    got = C.lookup_dual_multi(direct, failover, policy, slots, k, 6 * MIN)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"cache_probe_dual": 0,
                                   "cache_probe_dual_multi": 1,
                                   "cache_probe_perquery": 0,
                                   "cache_probe_tiled": 0,
                                   "decode_attention": 0,
                                   "embedding_bag": 0,
                                   "flash_attention": 0}
    want = C.lookup_dual_multi(direct, failover, policy, slots, k, 6 * MIN,
                               backend="torch")
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)


def test_multi_serve_many_cuda_backend_matches_torch_backend(cuda):
    """The multi-model serve loop on the card (coalescing and admission on
    some models): the cuda backend and the torch backend give
    bit-identical outputs, counters (per-model vectors included) and
    stacked planes; ONE dual-multi launch per step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import server as S
    from repro_torch.core.config import multi_model_tier_configs
    from repro_torch.core.hashing import Key64
    from repro_torch.kernels import ops
    from repro_torch.models import recsys as R

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_t = get_config("sasrec", smoke=True)
    rng = np.random.default_rng(9)
    ids = rng.choice(np.arange(80) * 104729, size=(10, 48))
    slots = rng.integers(0, 8, (10, 48)).astype(np.int32)
    seq = rng.integers(0, cfg_t.vocab, (10, 48, cfg_t.seq_len))
    nows = np.arange(10, dtype=np.int32) * 40_000
    fails = rng.uniform(size=(10, 48)) < 0.1
    out = {}
    for backend in ("cuda", "torch"):
        cfgs = [dataclasses.replace(
            c, backend=backend, coalesce_misses=m % 2 == 0,
            infer_budget_per_step=2.5 if m < 3 else None)
            for m, c in enumerate(multi_model_tier_configs(
                value_dim=cfg_t.embed_dim, n_buckets=32))]
        model = R.init_params(torch.Generator(device=cuda).manual_seed(0),
                              cfg_t, cuda)
        srv = S.MultiModelServer(
            cfgs=tuple(cfgs), miss_budget=24, device=cuda,
            tower_fn=lambda p, f, b=backend: R.tower_step(p, f, cfg_t,
                                                          impl=b))
        state = S.init_multi_server_state(cfgs, writebuf_capacity=96,
                                          device=cuda)
        ops.reset_launch_counts()
        state, acc, ys = srv.serve_many(
            model, state, torch.as_tensor(slots, device=cuda),
            Key64.from_int(ids, device=cuda),
            {"seq": torch.as_tensor(seq, dtype=torch.int32, device=cuda)},
            torch.as_tensor(nows, device=cuda),
            torch.as_tensor(fails, device=cuda), flush_every=2)
        out[backend] = (state, S.fetch_counters(acc), ys,
                        ops.launch_counts())
    (st_c, acc_c, ys_c, n_c), (st_t, acc_t, ys_t, n_t) = out["cuda"], \
        out["torch"]
    assert n_c["cache_probe_dual_multi"] == 10 and n_c["embedding_bag"] > 0
    assert n_c["cache_probe_dual"] == 0 and sum(n_t.values()) == 0
    assert acc_c == acc_t
    assert sum(acc_c["per_model_requests"]) == acc_c["requests"]
    for a, b in zip(ys_c, ys_t):
        assert torch.equal(a, b)
    for tier in ("direct", "failover"):
        for a, b in zip(getattr(st_c, tier), getattr(st_t, tier)):
            assert torch.equal(a, b)


# ------------------------------------------------------ flash attention
FLASH_EDGES = [  # (B, Sq, Sk, Hq, Hkv, hd, causal, q_offset, dtype)
    (2, 256, 256, 8, 2, 64, True, 0, torch.bfloat16),
    (2, 256, 256, 8, 2, 64, True, 0, torch.float32),
    (2, 256, 256, 4, 4, 64, False, 0, torch.float32),
    (2, 128, 384, 8, 1, 64, True, 256, torch.float32),
    (2, 128, 384, 8, 8, 64, True, 256, torch.bfloat16),
    (1, 256, 256, 8, 1, 128, True, 0, torch.bfloat16),
    (1, 128, 128, 4, 1, 128, False, 0, torch.float32),
    (2, 100, 100, 4, 2, 16, True, 0, torch.float32),
    (1, 1152, 1152, 8, 2, 8, True, 0, torch.float32),
    (1, 256, 256, 4, 2, 16, True, 0, torch.float32),
]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,causal,q_offset,dtype",
                         FLASH_EDGES)
def test_flash_attention_matches_plain(cuda, b, sq, sk, hq, hkv, hd, causal,
                                       q_offset, dtype):
    """The kernel against its plain version: float32 at atol 2e-5 (the JAX
    suite's bar), bfloat16 compared in float32 at atol 2e-2 (about one
    bfloat16 ulp at |o| <= 4); one launch per call."""
    g = torch.Generator(device=cuda).manual_seed(sq + hd)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((b, sq, hq, hd), (b, sk, hkv, hd), (b, sk, hkv, hd)))
    n0 = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == n0 + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    assert got.dtype == dtype and got.shape == q.shape
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 128, 4, 64), device=cuda)
    k = torch.zeros((1, 128, 2, 64), device=cuda)
    n0 = fa.LAUNCHES["flash_attention"]
    for args in ((q.cpu(), k, k), (q, k.cpu(), k.cpu()),
                 (q.to(torch.bfloat16), k, k),
                 (q[..., :48].contiguous(), k[..., :48].contiguous(),
                  k[..., :48].contiguous()),
                 (q.transpose(1, 2), k, k),
                 (torch.zeros((1, 192, 4, 64), device=cuda), k, k)):
        with pytest.raises(ValueError):
            fa.flash_attention(*args)
    assert fa.LAUNCHES["flash_attention"] == n0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_tower_cuda_backend_matches_torch_backend(cuda, dtype):
    """The SMOKE TinyLlama tower at S=1152 (the flash path): the cuda
    backend (the kernel, one launch per layer) against the torch backend
    (its plain version); a CPU tensor with backend="cuda" raises."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                              attn_impl="flash_kernel", dtype=dtype)
    model = T.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                          cuda)
    tokens = torch.randint(0, cfg.vocab, (5, 1152), dtype=torch.int32,
                           device=cuda)
    n0 = fa.LAUNCHES["flash_attention"]
    got = T.user_tower_step(model, tokens, cfg, backend="cuda")
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == n0 + cfg.n_layers
    want = T.user_tower_step(model, tokens, cfg, backend="torch")
    assert fa.LAUNCHES["flash_attention"] == n0 + cfg.n_layers
    tol = 1e-4 if dtype == "float32" else 5e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    with pytest.raises(ValueError):
        T.user_tower_step(model, tokens.cpu(), cfg, backend="cuda")


# ------------------------------------------------------ per-query probe
@pytest.mark.parametrize("batch", [1, 37, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probe_perquery_matches_plain(cuda, batch, dtype):
    """The per-query kernel against its plain version bit for bit, with a
    -0.0 column (read back +0.0); against the tiled probe on hit and age,
    and on values up to the sign of zero."""
    rng = np.random.default_rng(batch + 1)
    now, ttl = 10 * MIN, MIN
    tables, queries = probe_population(rng, 256, 8, 50, batch, now, ttl,
                                       dtype, cuda)
    tables[3][..., 7] = -0.0
    n0 = pk.LAUNCHES["perquery"]
    got = pk.cache_probe_perquery(*tables, *queries, now, ttl)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["perquery"] == n0 + 1
    want = ref.cache_probe_perquery_ref(*tables, *queries, now, ttl)
    assert_same(got, want)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got[1].view(bits), want[1].view(bits))
    assert not bool(torch.signbit(got[1][:, 7]).any())
    hit, val, age, _ = pk.cache_probe_tiled(*tables, *queries, now, ttl)
    assert torch.equal(got[0], hit) and torch.equal(got[2], age)
    assert torch.equal(got[1], val)              # -0.0 == +0.0 as floats
    if bool(hit.any()):
        assert bool(torch.signbit(val[hit][:, 7]).all())


# ------------------------------------------------------ decode attention
DECODE_EDGES = [  # (S, Hq, Hkv, hd, dtype)
    (1024, 8, 2, 64, torch.float32),
    (1024, 8, 2, 64, torch.bfloat16),
    (1024, 4, 4, 128, torch.float32),
    (1024, 32, 4, 128, torch.bfloat16),
    (512, 8, 1, 16, torch.float32),
    (512, 8, 8, 8, torch.bfloat16),
    (200, 4, 1, 64, torch.float32),
    (48, 8, 2, 8, torch.bfloat16),
]


@pytest.mark.parametrize("s,hq,hkv,hd,dtype", DECODE_EDGES)
def test_decode_attention_matches_plain(cuda, s, hq, hkv, hd, dtype):
    """The kernel against its plain version with valid_len 0 (zeros), 1, a
    partial block and all of S: float32 within 1e-5; bfloat16 per (row,
    head) within 2**-6 of the head's largest |output| (two bfloat16 ulps of
    it; outputs shrink as sqrt(e / valid_len), so a fixed atol alone would
    pass zeros) and no more than 2e-2, and within 2**-8 in relative L2;
    one launch per call."""
    g = torch.Generator(device=cuda).manual_seed(s + hd)
    lens = [0, 1, 511, 512, 513, s, s // 2 + 3]
    B = len(lens)
    q = torch.randn((B, hq, hd), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((B, s, hkv, hd), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    valid = torch.tensor([min(n, s) for n in lens], dtype=torch.int32,
                         device=cuda)
    n0 = dk.LAUNCHES["decode_attention"]
    got = dk.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert dk.LAUNCHES["decode_attention"] == n0 + 1
    want = ref.decode_attention_ref(q, k, v, valid)
    assert got.dtype == dtype and got.shape == q.shape
    assert not bool(got[0].any())                # valid_len 0: zeros
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        err = (got.float() - want.float()).abs().amax(-1)
        scale = want.float().abs().amax(-1)
        bar = (2.0 ** -6 * scale).clamp(max=2e-2)
        assert bool((err <= bar).all()), float(
            (err / scale.clamp(min=1e-30)).max())
        rel_l2 = (got.float() - want.float()).norm() / want.float().norm()
        assert float(rel_l2) <= 2.0 ** -8
    # positions past valid_len never reach the output
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate(valid.tolist()):
        k2[b, n:], v2[b, n:] = 99.0, float("nan")
    torch.testing.assert_close(dk.decode_attention(q, k2, v2, valid), got,
                               atol=0, rtol=0)


def test_decode_attention_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((2, 8, 64), device=cuda)
    k = torch.zeros((2, 1024, 2, 64), device=cuda)
    n0 = dk.LAUNCHES["decode_attention"]
    for args, kw in (((q.cpu(), k, k), {}), ((q, k, k), {"bs": 384}),
                     ((q.to(torch.bfloat16), k, k), {}),
                     ((q[:, :5].contiguous(), k, k), {}),
                     ((q, k.transpose(1, 2), k.transpose(1, 2)), {}),
                     ((q, k, k, torch.ones(2, device=cuda)), {})):
        with pytest.raises(ValueError):
            dk.decode_attention(*args, **kw)
    assert dk.LAUNCHES["decode_attention"] == n0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_decode_cuda_backend_matches_torch_backend(cuda, dtype):
    """The SMOKE TinyLlama prefill -> 4 decode steps on the card: the cuda
    backend (the decode kernel, one launch per layer and step) against the
    torch backend from a copy of the same cache; a CPU tensor with
    backend="cuda" raises."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                              dtype=dtype)
    model = T.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                          cuda)
    tokens = torch.randint(0, cfg.vocab, (3, 40), dtype=torch.int32,
                           device=cuda)
    _, cache = T.prefill_step(model, tokens, cfg, max_seq=48)
    plain = T.KVCache(cache.k.clone(), cache.v.clone(), cache.length.clone())
    nxt = tokens[:, 0]
    tol = 1e-4 if dtype == "float32" else 5e-2
    for _ in range(4):
        n0 = dk.LAUNCHES["decode_attention"]
        got, cache = T.decode_step(model, cache, nxt, cfg, backend="cuda")
        torch.cuda.synchronize()
        assert dk.LAUNCHES["decode_attention"] == n0 + cfg.n_layers
        want, plain = T.decode_step(model, plain, nxt, cfg, backend="torch")
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(cache.k.float(), plain.k.float(),
                                   atol=tol, rtol=tol)
        nxt = want.argmax(-1).to(torch.int32)
    assert cache.length.tolist() == [44] * 3
    with pytest.raises(ValueError):
        T.decode_step(model, T.KVCache(cache.k.cpu(), cache.v.cpu(),
                                       cache.length.cpu()), nxt.cpu(), cfg,
                      backend="cuda")
