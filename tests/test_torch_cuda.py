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
    if ways > 1:
        dup = rng.integers(0, nb, nb // 8)        # same key in two ways
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


PROBE_DIMS = [1, 33, 50, 64]       # copy units of 4, 4, 8, 16 bytes (f32)
PROBE_BATCHES = [1, 37, 509, 512]


@pytest.mark.parametrize("batch", PROBE_BATCHES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", PROBE_DIMS)
def test_probe_tiled_matches_plain(cuda, batch, dtype, dim):
    rng = np.random.default_rng(batch + dim)
    now, ttl = 10 * MIN, MIN
    tables, queries = probe_population(rng, 256, 8, dim, batch, now, ttl,
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
                                           (2, 32, 16, 128),
                                           (32, 1, 64, 256)])
@pytest.mark.parametrize("batch", PROBE_BATCHES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", PROBE_DIMS)
def test_probe_dual_matches_two_plain(cuda, wd, wf, nbd, nbf, batch, dtype,
                                      dim):
    rng = np.random.default_rng(wd * wf + batch + dim)
    now = 10 * MIN
    d_tab, (q_hi, q_lo, b_d) = probe_population(
        rng, nbd, wd, dim, batch, now, MIN, dtype, cuda)
    f_tab, _ = probe_population(rng, nbf, wf, dim, batch, now, 60 * MIN,
                                dtype, cuda)
    b_f = torch.as_tensor(rng.integers(0, nbf, batch).astype(np.int32),
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


def assert_bag_close(got, want, nnz):
    """nnz = 1 bit for bit; more rows: float32 sums in another order than
    the plain version's, a few ulps."""
    if nnz == 1:
        assert torch.equal(got, want)
        return
    tol = 1e-6 if got.dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("nnz,pad", [(1, 0.0), (4, 0.3), (7, 1.0)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [1, 33, 50, 64, 128])
@pytest.mark.parametrize("batch", [1, 7, 19_200, 25_601])
def test_embedding_bag_matches_plain(cuda, nnz, pad, mode, dtype, dim,
                                     batch):
    """Every copy unit (4, 8, 16 bytes and the bfloat16 element), -1 pads,
    all-padding bags (pad 1.0), and batches below one warp's items up to
    more than one wave of them (the kernel strides)."""
    rng = np.random.default_rng(nnz + dim + batch)
    table = torch.as_tensor(rng.standard_normal((5000, dim)),
                            device=cuda).to(dtype)
    ids = rng.integers(0, 5000, (batch, nnz)).astype(np.int32)
    ids[rng.uniform(size=ids.shape) < pad] = -1
    ids = torch.as_tensor(ids, device=cuda)
    n0 = ebk.LAUNCHES["embedding_bag"]
    got = ebk.embedding_bag(table, ids, mode=mode)
    torch.cuda.synchronize()
    assert ebk.LAUNCHES["embedding_bag"] == n0 + 1
    assert_bag_close(got, ref.embedding_bag_ref(table, ids, mode=mode), nnz)


@pytest.mark.parametrize("offset", ["row", "element"])
@pytest.mark.parametrize("nnz", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [33, 50, 64, 128])
def test_embedding_bag_misaligned_table_matches_plain(cuda, offset, nnz,
                                                      dtype, dim):
    """A table view whose base is offset by one row (off a 16-byte boundary
    unless the row is a multiple of 16 bytes) or by one element (off it
    always): the kernel copies in a narrower unit, as exact as aligned."""
    rng = np.random.default_rng(dim + nnz)
    flat = torch.as_tensor(rng.standard_normal(5001 * dim),
                           device=cuda).to(dtype)
    start = dim if offset == "row" else 1
    table = flat[start:start + 5000 * dim].view(5000, dim)
    assert table.is_contiguous()
    ids = rng.integers(-1, 5000, (999, nnz)).astype(np.int32)
    ids = torch.as_tensor(ids, device=cuda)
    got = ebk.embedding_bag(table, ids)
    torch.cuda.synchronize()
    assert_bag_close(got, ref.embedding_bag_ref(table, ids), nnz)


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


@pytest.mark.parametrize("wd,wf", [(8, 4), (32, 1)])
@pytest.mark.parametrize("batch", PROBE_BATCHES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", PROBE_DIMS)
def test_probe_dual_multi_edges_match_plain(cuda, wd, wf, batch, dtype, dim):
    """The multi-model kernel at every copy unit and both way layouts, on
    pooled tables of 3 models with their own TTLs (strict, then the
    NO_TTL_MS failover column), bit for bit."""
    rng = np.random.default_rng(wd + batch + dim)
    now = 10 * MIN
    d_tab, (q_hi, q_lo, b_d) = probe_population(
        rng, 96, wd, dim, batch, now, MIN, dtype, cuda)
    f_tab, _ = probe_population(rng, 48, wf, dim, batch, now, 60 * MIN,
                                dtype, cuda)
    b_f = torch.as_tensor(rng.integers(0, 48, batch).astype(np.int32),
                          device=cuda)
    slots = torch.as_tensor(rng.integers(0, 3, batch).astype(np.int32),
                            device=cuda)
    strict = torch.tensor([[MIN, 60 * MIN], [3 * MIN, 5 * MIN],
                           [MIN // 2, 2 * MIN]], dtype=torch.int32,
                          device=cuda)
    relaxed = strict.clone()
    relaxed[:, 1] = NO_TTL_MS
    for table in (strict, relaxed):
        got = pk.cache_probe_dual_multi(*d_tab, *f_tab, q_hi, q_lo, slots,
                                        b_d, b_f, table, now)
        torch.cuda.synchronize()
        want = ref.cache_probe_dual_multi_ref(*d_tab, *f_tab, q_hi, q_lo,
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
    (2, 100, 100, 8, 2, 16, True, 0, torch.bfloat16),
    (2, 100, 100, 4, 1, 128, True, 0, torch.bfloat16),
    (1, 1152, 1152, 8, 2, 128, True, 0, torch.bfloat16),
    (2, 128, 384, 8, 2, 128, True, 256, torch.bfloat16),
    (2, 256, 256, 8, 2, 64, False, 0, torch.bfloat16),
]


def assert_attention_close(got, want, f32_atol):
    """float32 within ``f32_atol``; bfloat16 per (leading index, head) within
    2**-6 of that head's largest |output| (two bfloat16 ulps of it; outputs
    shrink as 1/sqrt(position) in late causal rows and as sqrt(e /
    valid_len) in decode, so a fixed atol alone would pass a kernel that
    drops a tile) and never more than 2e-2, and within 2**-8 in relative
    L2."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=f32_atol, rtol=0)
        return
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    bar = (2.0 ** -6 * scale).clamp(max=2e-2)
    assert bool((err <= bar).all()), float(
        (err / scale.clamp(min=1e-30)).max())
    rel_l2 = (got.float() - want.float()).norm() / want.float().norm()
    assert float(rel_l2) <= 2.0 ** -8


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,causal,q_offset,dtype",
                         FLASH_EDGES)
def test_flash_attention_matches_plain(cuda, b, sq, sk, hq, hkv, hd, causal,
                                       q_offset, dtype):
    """The kernel against its plain version: float32 at atol 2e-5 (the JAX
    suite's bar), bfloat16 by the scaled per-head rule of
    :func:`assert_attention_close` (the tensor-core body rounds p to
    bfloat16 before P.V, the reference does not); one launch per call."""
    g = torch.Generator(device=cuda).manual_seed(sq + hd)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((b, sq, hq, hd), (b, sk, hkv, hd), (b, sk, hkv, hd)))
    n0 = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == n0 + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    assert got.dtype == dtype and got.shape == q.shape
    assert_attention_close(got, want, 2e-5)


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
PERQUERY_EDGES = [  # (D, dtype, element offset of the values view): copy
    # units of 4, 8 and 16 bytes in float32, bfloat16 halves packed in
    # 4- and 16-byte units, and views off 16-byte alignment (4 and 2 bytes)
    (33, torch.float32, 0), (50, torch.float32, 0), (64, torch.float32, 0),
    (50, torch.bfloat16, 0), (64, torch.bfloat16, 0),
    (50, torch.float32, 1), (50, torch.bfloat16, 1)]


@pytest.mark.parametrize("batch", [1, 37, 4096])
@pytest.mark.parametrize("dim,dtype,offset", PERQUERY_EDGES)
def test_probe_perquery_matches_plain(cuda, batch, dim, dtype, offset):
    """The per-query kernel against its plain version bit for bit, with
    two adjacent -0.0 columns (both halves of a packed bfloat16 unit) read
    back +0.0; against the tiled probe on hit and age, and on values up to
    the sign of zero."""
    rng = np.random.default_rng(batch + dim + offset)
    now, ttl = 10 * MIN, MIN
    tables, queries = probe_population(rng, 256, 8, dim, batch, now, ttl,
                                       dtype, cuda)
    if offset:
        flat = torch.empty(tables[3].numel() + offset, dtype=dtype,
                           device=cuda)
        view = flat[offset:].view(tables[3].shape)
        view.copy_(tables[3])
        tables = tables[:3] + (view,)
    tables[3][..., 6:8] = -0.0
    n0 = pk.LAUNCHES["perquery"]
    got = pk.cache_probe_perquery(*tables, *queries, now, ttl)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["perquery"] == n0 + 1
    want = ref.cache_probe_perquery_ref(*tables, *queries, now, ttl)
    assert_same(got, want)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got[1].view(bits), want[1].view(bits))
    assert not bool(torch.signbit(got[1][:, 6:8]).any())
    hit, val, age, _ = pk.cache_probe_tiled(*tables, *queries, now, ttl)
    assert torch.equal(got[0], hit) and torch.equal(got[2], age)
    assert torch.equal(got[1], val)              # -0.0 == +0.0 as floats
    if bool(hit.any()):
        assert bool(torch.signbit(val[hit][:, 6:8]).all())


# ------------------------------------------------------ overload arm
def test_overload_cuda_backend_matches_torch_backend(cuda):
    """The overload timeline at SMOKE size on the card: the cuda backend
    (one dual probe a step, the bag in the tower) and the torch backend
    give the same report and bit-identical tiers and budget tokens."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for backend in ("cuda", "torch"):
        ops.reset_launch_counts()
        report, state = launch.overload_timeline(
            launch.plan_overload(minutes=12, users=300, batch=64,
                                 failure_rate=0.05, failure_burst_rate=0.3,
                                 backend=backend, device=cuda),
            chunk_steps=4, log=lambda *_: None)
        out[backend] = (report, state, ops.launch_counts())
    (rep_c, st_c, n_c), (rep_t, st_t, n_t) = out["cuda"], out["torch"]
    assert n_c["cache_probe_dual"] == rep_c["batches"]
    assert n_c["embedding_bag"] > 0 and sum(n_t.values()) == 0
    assert rep_c["phases"]["outage"]["deferred"] > 0
    assert rep_c["phases"] == rep_t["phases"]
    for tier in ("direct", "failover"):
        for a, b in zip(getattr(st_c, tier), getattr(st_t, tier)):
            assert torch.equal(a, b)
    assert torch.equal(st_c.budget.tokens, st_t.budget.tokens)


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
    assert_attention_close(got, want, 1e-5)
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


def _decode_cuda_vs_torch(cuda, dtype, prompt, max_seq):
    """The SMOKE TinyLlama prefill of ``prompt`` tokens into a ``max_seq``
    cache, then 4 decode steps with the cuda backend (the decode kernel,
    one launch per layer and step) against the torch backend from a copy
    of the same cache; returns the model, config, cache and next tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                              dtype=dtype)
    model = T.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                          cuda)
    tokens = torch.randint(0, cfg.vocab, (3, prompt), dtype=torch.int32,
                           device=cuda)
    _, cache = T.prefill_step(model, tokens, cfg, max_seq=max_seq)
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
    assert cache.length.tolist() == [prompt + 4] * 3
    return model, cfg, cache, nxt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_decode_cuda_backend_matches_torch_backend(cuda, dtype):
    """The SMOKE TinyLlama prefill -> 4 decode steps on the card: the cuda
    backend against the torch backend; a CPU tensor with backend="cuda"
    raises."""
    from repro_torch.models import transformer as T

    model, cfg, cache, nxt = _decode_cuda_vs_torch(cuda, dtype, 40, 48)
    with pytest.raises(ValueError):
        T.decode_step(model, T.KVCache(cache.k.cpu(), cache.v.cpu(),
                                       cache.length.cpu()), nxt.cpu(), cfg,
                      backend="cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_decode_cuda_backend_takes_any_cache_length(cuda, dtype):
    """A 600-position cache, above the kernel wrapper's default block of
    512 and not a multiple of it: ``decode_step`` passes one block of S, as
    the reference's decode path takes any S."""
    _decode_cuda_vs_torch(cuda, dtype, 590, 600)


# ------------------------------------------- compiled entry points (graphs)
def _jit_setup(cuda, kind, backend="cuda"):
    """A SMOKE SASRec server (single-model with admission, coalescing and
    LRU touches, or the multi-model tier with admission and coalescing on
    some models) and a fresh state on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import server as S
    from repro_torch.core.config import CacheConfig, multi_model_tier_configs
    from repro_torch.models import recsys as R

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_t = get_config("sasrec", smoke=True)
    model = R.init_params(torch.Generator(device=cuda).manual_seed(0), cfg_t,
                          cuda)
    tower = lambda p, f: R.tower_step(p, f, cfg_t, impl=backend)
    if kind == "multi":
        cfgs = [dataclasses.replace(
            c, backend=backend, coalesce_misses=m % 2 == 0,
            infer_budget_per_step=2.5 if m < 3 else None)
            for m, c in enumerate(multi_model_tier_configs(
                value_dim=cfg_t.embed_dim, n_buckets=32))]
        srv = S.MultiModelServer(cfgs=tuple(cfgs), miss_budget=24,
                                 device=cuda, tower_fn=tower)
        state = lambda: S.init_multi_server_state(cfgs, writebuf_capacity=96,
                                                  device=cuda)
    else:
        cfg = CacheConfig(model_id=1, model_type="ctr", n_buckets=32, ways=4,
                          failover_n_buckets=16, failover_ways=2,
                          value_dim=cfg_t.embed_dim, cache_ttl_ms=MIN,
                          backend=backend, coalesce_misses=True,
                          infer_budget_per_step=3.5, eviction="lru")
        srv = S.CachedEmbeddingServer(cfg=cfg, miss_budget=24,
                                      tower_fn=tower)
        state = lambda: S.init_server_state(cfg, writebuf_capacity=96,
                                            device=cuda)
    return srv, model, state, cfg_t


def _jit_chunks(cuda, kind, cfg_t, n_chunks, steps):
    """``n_chunks`` staged (S, B) chunks of one stream: the serve_many
    inputs after the state."""
    from repro_torch.core.hashing import Key64

    rng = np.random.default_rng(11)
    t = lambda a: torch.as_tensor(a, device=cuda)
    out = []
    for c in range(n_chunks):
        ids = rng.choice(np.arange(80) * 104729, size=(steps, 48))
        seq = rng.integers(0, cfg_t.vocab, (steps, 48, cfg_t.seq_len))
        nows = (np.arange(steps) + c * steps).astype(np.int32) * 20_000
        fails = rng.uniform(size=(steps, 48)) < 0.1
        args = (Key64.from_int(ids, device=cuda),
                {"seq": t(seq.astype(np.int32))}, t(nows), t(fails))
        if kind == "multi":
            args = (t(rng.integers(0, 8, (steps, 48)).astype(np.int32)),
                    *args)
        out.append(args)
    return out


def _state_leaves(state):
    from repro_torch.core.graph import tensors_of

    return tensors_of(state)


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_jit_serve_many_replay_equals_eager(cuda, kind):
    """Three chunks through ``jit_serve_many`` (the first runs eagerly and
    is captured, the next two replay the graph) equal three eager
    ``serve_many`` chunks bit for bit: outputs, counters (per-model
    vectors too), every cache plane, both rings and the budget tokens. A
    replay that read a stale budget or ring would differ from the second
    replay on. The counts advance by the captured launches on each
    replay."""
    from repro_torch.core import server as S
    from repro_torch.kernels import ops

    srv, model, init, cfg_t = _jit_setup(cuda, kind)
    chunks = _jit_chunks(cuda, kind, cfg_t, 3, 5)
    out = {}
    for mode in ("eager", "jit"):
        run = srv.serve_many if mode == "eager" else srv.jit_serve_many
        state = init()
        leaves0 = _state_leaves(state)
        ops.reset_launch_counts()
        got, counts = [], []
        for args in chunks:
            state, acc, ys = run(model, state, *args, flush_every=2)
            got.append((S.fetch_counters(acc), ys))
            counts.append(ops.launch_counts())
        if mode == "jit":
            assert len(srv.jit_serve_many.graphs) == 1
            assert all(a is b for a, b in zip(_state_leaves(state), leaves0))
        out[mode] = (state, got, counts)
    (st_e, got_e, n_e), (st_j, got_j, n_j) = out["eager"], out["jit"]
    probe = "cache_probe_dual_multi" if kind == "multi" else "cache_probe_dual"
    assert [n[probe] for n in n_j] == [5, 10, 15]
    assert n_j == n_e
    for (acc_e, ys_e), (acc_j, ys_j) in zip(got_e, got_j):
        assert acc_e == acc_j
        for a, b in zip(ys_e, ys_j):
            assert torch.equal(a, b)
    for a, b in zip(_state_leaves(st_e), _state_leaves(st_j)):
        assert torch.equal(a, b)


def test_jit_serve_step_and_flush_replay_equal_eager(cuda):
    """Single steps through ``jit_serve_step`` + ``jit_flush`` with the
    clock as a host int (staged outside the graph) equal eager
    ``serve_step`` + ``flush`` bit for bit, step after step; outputs are
    fresh tensors that the next replay does not overwrite."""
    from repro_torch.core import server as S
    from repro_torch.core.hashing import Key64

    srv, model, init, cfg_t = _jit_setup(cuda, "single")
    keys, feats, nows, fails = _jit_chunks(cuda, "single", cfg_t, 1, 6)[0]
    out = {}
    for mode in ("eager", "jit"):
        step = srv.serve_step if mode == "eager" else srv.jit_serve_step
        flush = srv.flush if mode == "eager" else srv.jit_flush
        state, res_all = init(), []
        for i in range(6):
            res = step(model, state, Key64(keys.hi[i], keys.lo[i]),
                       {"seq": feats["seq"][i]}, int(nows[i]), fails[i])
            state = flush(res.state, int(nows[i]))
            res_all.append((res.embeddings, res.source, res.age_ms,
                            S.fetch_counters(res.stats)))
        out[mode] = (state, res_all)
    assert len(srv.jit_serve_step.graphs) == 1
    assert len(srv.jit_flush.graphs) == 1
    (st_e, res_e), (st_j, res_j) = out["eager"], out["jit"]
    for a, b in zip(res_e, res_j):
        assert a[3] == b[3]
        for x, y in zip(a[:3], b[:3]):
            assert torch.equal(x, y)
    for a, b in zip(_state_leaves(st_e), _state_leaves(st_j)):
        assert torch.equal(a, b)


def test_jit_recaptures_for_a_new_state_only(cuda):
    """A state with other tensors captures anew; the same state and other
    inputs of the same shapes replay. Each replay adds the captured
    launches to the counts."""
    from repro_torch.kernels import ops

    srv, model, init, cfg_t = _jit_setup(cuda, "single")
    chunks = _jit_chunks(cuda, "single", cfg_t, 3, 4)
    first = init()
    srv.jit_serve_many(model, first, *chunks[0])
    graph = next(iter(srv.jit_serve_many.graphs.values()))
    assert graph.launches["cache_probe_dual"] == 4
    assert graph.launches["embedding_bag"] == 4
    before = ops.launch_counts()
    srv.jit_serve_many(model, first, *chunks[1])
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == graph.launches
    assert len(srv.jit_serve_many.graphs) == 1
    second = init()
    srv.jit_serve_many(model, second, *chunks[2])
    assert len(srv.jit_serve_many.graphs) == 2
    srv.jit_serve_many(model, first, *chunks[2], collect=False)
    assert len(srv.jit_serve_many.graphs) == 3


def test_jit_captures_while_a_dead_server_awaits_collection(cuda):
    """A server is cyclic garbage once dropped (its entry points refer
    back to it), so its graphs live until the collector runs, and a graph
    destroyed inside another capture invalidates that capture. Here the
    collector runs inside a capture (the tower calls it while the stream
    captures; automatic collection is off, so the dead server survives
    until then): the capture must still succeed, because the dead graph
    is collected before the capture begins, and replay equal to eager."""
    import dataclasses
    import gc

    from repro_torch.core import server as S

    dead, model, init, cfg_t = _jit_setup(cuda, "single")
    chunks = _jit_chunks(cuda, "single", cfg_t, 2, 4)

    def tower(p, f):
        if torch.cuda.is_current_stream_capturing():
            gc.collect()
        return dead_tower(p, f)

    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        dead.jit_serve_many(model, init(), *chunks[0])
        assert len(dead.jit_serve_many.graphs) == 1
        dead_tower = dead.tower_fn
        live = dataclasses.replace(dead, tower_fn=tower)
        del dead
        state = init()
        got = live.jit_serve_many(model, state, *chunks[1])
        for a, b in zip(_state_leaves(state), _state_leaves(init())):
            a.copy_(b)
        replay = live.jit_serve_many(model, state, *chunks[1])
        assert len(live.jit_serve_many.graphs) == 1
        want = live.serve_many(model, init(), *chunks[1])
    finally:
        if gc_was_on:
            gc.enable()
    for res in (got, replay):
        assert S.fetch_counters(res[1]) == S.fetch_counters(want[1])
        for a, b in zip(res[2], want[2]):
            assert torch.equal(a, b)


_SYNCING_TOWER = """
import sys
import torch
sys.path.insert(0, "src")
from repro_torch.core import server as S
from repro_torch.core.config import CacheConfig
from repro_torch.core.hashing import Key64

dev = torch.device("cuda")
cfg = CacheConfig(model_id=1, model_type="ctr", n_buckets=16, ways=4,
                  value_dim=8, backend="cuda")

def tower(p, f):
    scale = float(f.abs().sum().item())   # a host sync inside the step
    return f @ p / max(scale, 1.0)

srv = S.CachedEmbeddingServer(cfg=cfg, tower_fn=tower, miss_budget=8)
state = S.init_server_state(cfg, writebuf_capacity=32, device=dev)
keys = Key64.from_int(torch.arange(24).reshape(3, 8).numpy(), device=dev)
feats = torch.randn(3, 8, 8, device=dev)
nows = torch.arange(3, dtype=torch.int32, device=dev) * 1000
eager = srv.serve_many(torch.eye(8, device=dev), S.init_server_state(
    cfg, writebuf_capacity=32, device=dev), keys, feats, nows)
try:
    srv.jit_serve_many(torch.eye(8, device=dev), state, keys, feats, nows)
except RuntimeError as e:
    print("RAISED", type(e).__name__, str(e).splitlines()[0])
    sys.exit(0)
print("NOT RAISED")
sys.exit(1)
"""


def test_jit_serve_many_raises_on_a_host_sync_in_the_step(cuda):
    """A tower that calls ``.item()`` runs eagerly but cannot be
    captured: ``jit_serve_many`` raises instead of running the eager loop.
    In a subprocess, since a failed capture may leave the CUDA context
    unusable."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    done = subprocess.run([sys.executable, "-c", _SYNCING_TOWER], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr
    assert "RAISED" in done.stdout
