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


MLA_FLASH = [  # (B, Sq, Sk, Hq, Hkv, causal, q_offset) at q/k 192, v 128
    (6, 8192, 8192, 16, 16, True, 0),     # a moonlight.b8 tower call
    (2, 100, 100, 4, 4, True, 0),
    (2, 128, 384, 8, 2, True, 256),
    (1, 256, 256, 4, 4, False, 0),
]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,causal,q_offset", MLA_FLASH)
def test_flash_attention_at_mla_widths_matches_plain(cuda, b, sq, sk, hq,
                                                     hkv, causal, q_offset):
    """``fa_wgmma_kernel_qv<192, 128>`` against the plain version in
    bfloat16, by :func:`assert_attention_close`'s rule: one launch, the
    output v's 128 wide; float32 and other width pairs refused. At the
    cell's shape it prints its device time a launch (CUDA events over 5
    launches after one), the bound (operations over 989 TFLOP/s) and
    SDPA's time on the same inputs."""
    g = torch.Generator(device=cuda).manual_seed(sq + hq)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
               for s in ((b, sq, hq, 192), (b, sk, hkv, 192),
                         (b, sk, hkv, 128)))
    n0 = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == n0 + 1
    assert got.shape == (b, sq, hq, 128) and got.dtype == torch.bfloat16
    want = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    assert_attention_close(got, want, 2e-5)
    del want
    for args in ((q.float(), k.float(), v.float()),
                 (q, k, v[..., :64].contiguous())):
        with pytest.raises(ValueError):
            fa.flash_attention(*args, causal=causal, q_offset=q_offset)
    if sq != 8192:
        return

    def ms(fn, n=5):
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    kernel = ms(lambda: fa.flash_attention(q, k, v, causal=True))
    ops = 2 * b * hq * (192 + 128) * (sq * (sq + 1) // 2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=192 ** -0.5))
    print(f"[flash 192/128] B={b} S={sq} H={hq}: {kernel * 1e3:.1f} us a "
          f"launch, bound {ops / 989e12 * 1e6:.1f} us "
          f"({100 * ops / 989e12 / (kernel / 1e3):.1f}%), SDPA "
          f"{sdpa * 1e3:.1f} us; {torch.cuda.get_device_name()}")


def test_mla_layers_of_moonlight_match_the_reference(cuda, monkeypatch):
    """Moonlight's configuration (``bench/configs/moonlight-16b-a3b.json``)
    cut to its dense layer and one MoE layer, at its published widths in
    bfloat16, 6 rows of 8,192 tokens (a moonlight.b8 tower call: groups of
    512, capacity 60) through ``user_tower_step``, the (192, 128) kernel
    once a layer, against ``bench/reference/lm_mla.py`` in float32 on the
    same weights: relative L2 of each embedding within 0.03 (bf16 against
    float32 over two layers, where a few hundred tokens' expert choices
    differ; the 27-layer tower's limit and readings are in PERF.md), and
    the reference at float8, the cell's control, past it in every row."""
    import json
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from bench.reference import lm_mla as ref_mla
    from bench.reference.precision import matmul_at
    from bench.towers import lm_mla as fam_mla

    cfg = json.loads((root / "bench" / "configs"
                      / "moonlight-16b-a3b.json").read_text())
    cfg["num_hidden_layers"] = 2
    fam = fam_mla.Family(cfg, cuda, "cuda")
    w = fam.make_weights(torch.Generator(device=cuda).manual_seed(11))
    params = fam.program_params(w)
    tokens = torch.randint(0, cfg["vocab_size"], (6, 8192), device=cuda,
                           dtype=torch.int32,
                           generator=torch.Generator(device=cuda).manual_seed(12))
    n0 = fa.LAUNCHES["flash_attention"]
    got = fam.tower_fn()(params, tokens)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == n0 + 2
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    want = ref_mla.user_embedding(w, tokens, cfg, 6, matmul_at("float32"))
    rel = lambda a: ((a.double() - want.double()).norm(dim=-1)
                     / want.double().norm(dim=-1))
    ctrl = rel(ref_mla.user_embedding(w, tokens, cfg, 6, matmul_at("fp8")))
    print(f"[mla layers] relative L2 per row {rel(got).tolist()}, float8 "
          f"control {ctrl.tolist()}")
    assert float(rel(got).max()) < 0.03 < float(ctrl.min())


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


def test_indexed_moe_dispatch_is_the_dense_einsum_in_a_captured_graph(cuda):
    """Granite's MoE block at its widths in bfloat16, one 512-token group
    whose low experts overflow their capacity: the indexed dispatch buffer
    is the dense einsum's (G, E, C, D) ``xe``, laid out expert-major, bit
    for bit; ``moe_ffn`` without a mesh runs with host syncs refused and
    is captured in a CUDA graph, and its replay agrees with the dense path
    at bfloat16's tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M

    cfg = get_config("granite-moe-1b-a400m")
    moe, D, Fw, T = cfg.moe, cfg.d_model, cfg.d_ff, 512
    E, C = moe.n_experts, M.capacity_for(T, moe)
    gen = torch.Generator(device=cuda).manual_seed(5)
    params = M.init_moe_params(gen, D, Fw, moe, torch.bfloat16)
    params["router"] += torch.linspace(2.0, 0.0, E, device=cuda) / D
    x = (torch.randn(1, T, D, generator=gen, device=cuda) + 1.0
         ).to(torch.bfloat16)

    gates, idx, _ = M.top_k_gating(x.float() @ params["router"], moe.top_k)
    dest, w = M.index_routing(idx, gates, E, C)
    assert bool((dest == E * C).any())                   # drops
    disp, comb = M.dispatch_combine_tensors(idx, gates, E, C)
    xe = torch.einsum("gtec,gtd->gecd", disp.to(x.dtype), x)
    want = xe.permute(1, 0, 2, 3).reshape(E, C, D)
    got = M.indexed_dispatch(x, dest, E, C)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    y_dense = M.dense_experts(x, disp.to(x.dtype), comb.to(x.dtype),
                              params)

    n0 = M.ROUTES["indexed"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            M.moe_ffn(x, params, moe, T)                 # warm-up
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y, _ = M.moe_ffn(x, params, moe, T)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    graph.replay()
    torch.cuda.synchronize()
    assert M.ROUTES["indexed"] == n0 + 2
    torch.testing.assert_close(y.float(), y_dense.float(), atol=5e-2,
                               rtol=5e-2)


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


def test_traced_graph_times_its_phases_and_equals_untraced(cuda):
    """SASRec at its published widths behind small tiers, one step a
    ``jit_serve_many`` call (as the benchmark calls it), from fresh states
    with the span recorder off and then on: every call's outputs and
    counters and the final tiers are the same bit for bit. On, each
    replay's graph times its step phases with its own events: every
    interval is positive and all of them fit in the replay's event-timed
    wall; the entry's spans lie between the caller's clock reads around
    the call; phases after an anchor are placed after it; a state at
    another address captures the traced graph a second time (a graph more
    in ``Compiled.graphs``, an ``entry.capture`` span); each graph's
    ``load_bytes`` / ``clone_bytes`` are a call's inputs and outputs."""
    import time

    from repro_torch.configs import get_config
    from repro_torch.core import graph as graph_lib
    from repro_torch.core import server as S
    from repro_torch.core import trace
    from repro_torch.core.config import CacheConfig
    from repro_torch.core.hashing import Key64
    from repro_torch.models import recsys as R

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_t = get_config("sasrec")
    model = R.init_params(torch.Generator(device=cuda).manual_seed(0), cfg_t,
                          cuda)
    cfg = CacheConfig(model_id=1, model_type="ctr", n_buckets=1024, ways=8,
                      value_dim=cfg_t.embed_dim, cache_ttl_ms=MIN,
                      backend="cuda")
    srv = S.CachedEmbeddingServer(
        cfg=cfg, miss_budget=384,
        tower_fn=lambda p, f: R.tower_step(p, f, cfg_t, impl="cuda"))
    init = lambda: S.init_server_state(cfg, writebuf_capacity=2048,
                                       device=cuda)
    rng = np.random.default_rng(5)
    t = lambda a: torch.as_tensor(a, device=cuda)
    chunks = [(Key64.from_int(rng.choice(np.arange(2000) * 7919,
                                         size=(1, 512)), device=cuda),
               {"seq": t(rng.integers(0, cfg_t.vocab, (1, 512, 50)).astype(
                   np.int32))},
               t(np.array([i * 20_000], np.int32)),
               t(rng.uniform(size=(1, 512)) < 0.02)) for i in range(6)]
    trace.disable()
    trace.drain()
    runs = {}
    try:
        for on in (False, True):
            if on:
                trace.enable()
            state, got, walls = init(), [], []
            for i, args in enumerate(chunks):
                if on and i == len(chunks) - 1:
                    trace.anchor()
                trace.tag(i)
                w0 = torch.cuda.Event(enable_timing=True)
                w1 = torch.cuda.Event(enable_timing=True)
                t0 = time.time_ns()
                w0.record()
                state, acc, ys = srv.jit_serve_many(model, state, *args)
                w1.record()
                t1 = time.time_ns()
                got.append((S.fetch_counters(acc), ys))
                walls.append((w0.elapsed_time(w1) * 1e6, t0, t1))
            if on:
                srv.jit_serve_many(model, init(), *chunks[0])
            trace.disable()
            runs[on] = (got, _state_leaves(state), walls, trace.drain())
    finally:
        trace.disable()
        trace.drain()
    (got_a, st_a, _, off), (got_b, st_b, walls, rec) = runs[False], runs[True]
    assert off == ([], [])
    for (acc_a, ys_a), (acc_b, ys_b) in zip(got_a, got_b):
        assert acc_a == acc_b
        for a, b in zip(ys_a, ys_b):
            assert torch.equal(a, b)
    for a, b in zip(st_a, st_b):
        assert torch.equal(a, b)
    graphs = srv.jit_serve_many.graphs.values()
    assert len(graphs) == 3
    names = [s.name for s in rec.spans]
    assert names.count("entry.capture") == 2
    assert names.count("entry.replay") == len(chunks) - 1
    nbytes = lambda tree: sum(x.nbytes for x in graph_lib.tensors_of(tree))
    assert all(g.load_bytes == nbytes(chunks[0]) for g in graphs)
    assert all(g.clone_bytes == nbytes((acc, ys)) for g in graphs)
    for i, (wall_ns, t0, t1) in enumerate(walls[1:], 1):
        phases = [p for p in rec.phases if p.call_id == i]
        assert sorted(p.name for p in phases) == [
            "step.flush", "step.flush", "step.probe", "step.tail",
            "step.tail", "step.tower"]
        assert all(p.end_ns > p.start_ns for p in phases)
        assert sum(p.end_ns - p.start_ns for p in phases) <= wall_ns
        assert all(p.anchored == (i == len(chunks) - 1) for p in phases)
        if i == len(chunks) - 1:
            assert min(p.start_ns for p in phases) >= 0
        spans = {s.name: s for s in rec.spans if s.call_id == i}
        assert {"entry", "entry.key", "entry.load", "entry.replay",
                "entry.clone"} <= set(spans)
        assert all(t0 <= s.start_ns <= s.end_ns <= t1
                   for s in spans.values())


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


# ------------------------------------------- Wide&Deep, BST, MIND, combiner
# Wide&Deep against its plain version: its field bags sum nnz = 4 float32
# rows in another order than the plain ``sum`` (a few ulps of each bag),
# carried through the float32 MLP. BST and MIND gather nnz = 1 rows
# (copies), so they are held bit for bit.
WD_TOL = dict(atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("dim,dtype", [(32, torch.float32),
                                       (1, torch.float32),
                                       (32, torch.bfloat16)])
def test_field_embedding_bag_matches_plain(cuda, dim, dtype):
    """All F fields in ONE launch over the (F*V, D) view, -1 pads kept
    (a bag of pads is zeros); D = 1 is Wide&Deep's wide part."""
    from repro_torch.models import recsys as R

    gen = torch.Generator(device=cuda).manual_seed(5)
    tables = torch.randn(40, 5000, dim, generator=gen, device=cuda).to(dtype)
    ids = torch.randint(0, 5000, (384, 40, 4), generator=gen, device=cuda,
                        dtype=torch.int32)
    ids[torch.rand(ids.shape, generator=gen, device=cuda) < 0.3] = -1
    ids[3, 7] = -1
    n0 = ebk.LAUNCHES["embedding_bag"]
    got = R.field_embedding_bag(tables, ids, impl="cuda")
    assert ebk.LAUNCHES["embedding_bag"] == n0 + 1
    want = R.field_embedding_bag(tables, ids, impl="torch")
    assert got.shape == (384, 40, dim)
    assert_bag_close(got, want, 4)
    assert not got[3, 7].any()
    per_field = torch.stack([ref.embedding_bag_ref(tables[f], ids[:, f])
                             for f in range(40)], dim=1)
    assert_bag_close(got, per_field, 4)


def _tower(cuda, arch):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import recsys as R

    cfg = dataclasses.replace(get_config(arch, smoke=True), vocab=5000)
    model = R.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                          device=cuda)
    rng = np.random.default_rng(2)
    if arch == "wide-deep":
        ids = rng.integers(0, cfg.vocab, (200, cfg.n_sparse,
                                          cfg.nnz_per_field))
        ids[rng.uniform(size=ids.shape) < 0.3] = -1
        feats = {"sparse_ids": ids}
    else:
        seq = rng.integers(0, cfg.vocab, (200, cfg.seq_len))
        seq[:, :3][rng.uniform(size=(200, 3)) < 0.5] = -1
        feats = {"seq": seq, "target": rng.integers(0, cfg.vocab, 200)}
    feats = {k: torch.as_tensor(v.astype(np.int32), device=cuda)
             for k, v in feats.items()}
    return cfg, model, feats


@pytest.mark.parametrize("arch", ["wide-deep", "bst", "mind"])
def test_tower_cuda_backend_matches_torch_backend(cuda, arch):
    """One bag launch a tower call (Wide&Deep's fields included); BST and
    MIND bit-identical to the plain path, Wide&Deep within WD_TOL; the
    scores likewise (Wide&Deep's wide part one more launch)."""
    from repro_torch.models import recsys as R

    cfg, model, feats = _tower(cuda, arch)
    n0 = ebk.LAUNCHES["embedding_bag"]
    got = R.tower_step(model, feats, cfg, impl="cuda")
    assert ebk.LAUNCHES["embedding_bag"] == n0 + 1
    want = R.tower_step(model, feats, cfg, impl="torch")
    assert got.shape == (200, cfg.user_embed_dim)
    if arch == "wide-deep":
        torch.testing.assert_close(got, want, **WD_TOL)
    else:
        assert torch.equal(got, want)
    score = {"wide-deep": R.wide_deep_score, "bst": R.bst_score}.get(arch)
    if score is not None:
        n0 = ebk.LAUNCHES["embedding_bag"]
        got = score(model, feats, cfg, impl="cuda")
        assert ebk.LAUNCHES["embedding_bag"] == n0 + (
            2 if arch == "wide-deep" else 1)
        want = score(model, feats, cfg, impl="torch")
        if arch == "wide-deep":
            torch.testing.assert_close(got, want, **WD_TOL)
        else:
            assert torch.equal(got, want)
    else:
        q = R.tower_step(model, feats, cfg, impl="cuda")
        s, i = R.retrieval_step(q, model.item_emb, cfg, k_top=10)
        assert s.shape == (200, 10) and bool((s[:, :-1] >= s[:, 1:]).all())


def test_jit_serve_many_wide_deep_replay_equals_eager(cuda):
    """Wide&Deep behind the server: three chunks through
    ``jit_serve_many`` (capture, then two replays) equal eager
    ``serve_many`` bit for bit, one dual probe and one field bag a step."""
    from repro_torch.core import server as S
    from repro_torch.core.config import CacheConfig
    from repro_torch.core.graph import tensors_of
    from repro_torch.core.hashing import Key64
    from repro_torch.kernels import ops
    from repro_torch.models import recsys as R

    cfg_t, model, _ = _tower(cuda, "wide-deep")
    cfg = CacheConfig(model_id=1, model_type="ctr", n_buckets=64, ways=4,
                      value_dim=cfg_t.user_embed_dim, cache_ttl_ms=MIN,
                      backend="cuda")
    srv = S.CachedEmbeddingServer(
        cfg=cfg, miss_budget=24,
        tower_fn=lambda p, f: R.tower_step(p, f, cfg_t, impl="cuda"))
    rng = np.random.default_rng(4)
    t = lambda a: torch.as_tensor(a, device=cuda)
    chunks = []
    for c in range(3):
        ids = rng.choice(np.arange(90) * 104729, size=(5, 48))
        sparse = rng.integers(0, cfg_t.vocab, (5, 48, cfg_t.n_sparse,
                                               cfg_t.nnz_per_field))
        chunks.append((Key64.from_int(ids, device=cuda),
                       {"sparse_ids": t(sparse.astype(np.int32))},
                       t(((np.arange(5) + 5 * c) * 20_000).astype(np.int32)),
                       t(rng.uniform(size=(5, 48)) < 0.1)))
    out = {}
    for mode in ("eager", "jit"):
        run = srv.serve_many if mode == "eager" else srv.jit_serve_many
        state = S.init_server_state(cfg, writebuf_capacity=96, device=cuda)
        ops.reset_launch_counts()
        got = []
        for args in chunks:
            state, acc, ys = run(model, state, *args, flush_every=1)
            got.append((S.fetch_counters(acc), ys))
        out[mode] = (state, got, ops.launch_counts())
    (st_e, got_e, n_e), (st_j, got_j, n_j) = out["eager"], out["jit"]
    assert n_j == n_e
    assert n_j["cache_probe_dual"] == 15 and n_j["embedding_bag"] == 15
    for (acc_e, ys_e), (acc_j, ys_j) in zip(got_e, got_j):
        assert acc_e == acc_j
        for a, b in zip(ys_e, ys_j):
            assert torch.equal(a, b)
    for a, b in zip(tensors_of(st_e), tensors_of(st_j)):
        assert torch.equal(a, b)
    assert got_j[-1][0]["direct_hits"] > 0


def test_combiner_cuda_matches_torch(cuda):
    """30 members x D = 64 (1,920-float group rows): grouped writes with
    member failures, then every member's read through the tiled probe
    kernel (one launch each) equals the plain read bit for bit."""
    from repro_torch.core import combiner as G
    from repro_torch.core.hashing import Key64

    spec = G.GroupSpec(tuple(G.GroupMember(f"m{i}", 64, (i % 6 + 1) * MIN)
                             for i in range(30)))
    state = G.init_grouped(spec, 256, 8, device=cuda)
    rng = np.random.default_rng(6)
    pool = np.arange(3000) * 7919 + 1
    gen = torch.Generator(device=cuda).manual_seed(6)
    for r, now in enumerate((0, 2 * MIN, 4 * MIN)):
        keys = Key64.from_int(rng.choice(pool, 1024), device=cuda)
        values = {m.name: torch.randn(1024, 64, generator=gen, device=cuda)
                  for m in spec.members if not (r == 1 and m.name == "m7")}
        mask = {n: torch.rand(1024, generator=gen, device=cuda) < 0.9
                for n in values}
        state = G.insert_group(spec, state, keys, values, now,
                               member_mask=mask)
    q = Key64.from_int(rng.choice(np.arange(4000) * 7919 + 1, 1024),
                       device=cuda)
    n0 = pk.LAUNCHES["tiled"]
    hits = 0
    for m in spec.members:
        got = G.lookup_member(spec, state, m.name, q, 5 * MIN)
        want = G.lookup_member(spec, state, m.name, q, 5 * MIN,
                               backend="torch")
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        hits += int(got.hit.sum())
    assert pk.LAUNCHES["tiled"] == n0 + 30
    assert 0 < hits < 30 * 1024


# ------------------------------------------------ chaos engine, regions
def _chaos_schedule(cuda, kind, state, chunks):
    """A compounding schedule over the chunks' clock (a burst, model 0's
    outage, a blackout of the lower quarter of the pooled buckets, a
    flush stall starting mid-chunk, a skew) with two retries."""
    from repro_torch.ft import chaos as CH

    nows = torch.cat([c[-2] for c in chunks]).cpu().numpy()
    slots = (torch.cat([c[0] for c in chunks]).cpu().numpy()
             if kind == "multi" else None)
    n_models = 8 if kind == "multi" else 1
    pooled = state.direct.key_hi.shape[0] * (
        state.direct.key_hi.shape[1] if kind == "multi" else 1)
    t = lambda s: int(nows[s])
    faults = [CH.InferFailure(t(3), t(11), rate=0.8),
              CH.Outage(t(4), t(9), model=0),
              CH.BucketBlackout(t(2), t(12), lo=0, hi=pooled // 4),
              CH.FlushStall(t(2), t(8)),
              CH.ClockSkew(t(9), t(13), skew_ms=40 * MIN)]
    return CH.compile_schedule(
        faults, nows, chunks[0][-1].shape[1], n_models=n_models,
        n_buckets=pooled, slots=slots, retry=CH.RetryPolicy(max_retries=2),
        seed=2, device=cuda)


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_jit_chaos_replay_equals_eager(cuda, kind):
    """Three chunks under a compounding schedule through
    ``jit_serve_many`` (the first captures, the next two replay the same
    graph with other schedule rows, a stall switching on mid-chunk) equal
    eager ``serve_many`` bit for bit: outputs, every counter (the ledger's
    keys included) and every state tensor."""
    from repro_torch.core import server as S
    from repro_torch.ft import chaos as CH

    srv, model, init, cfg_t = _jit_setup(cuda, kind)
    chunks = _jit_chunks(cuda, kind, cfg_t, 3, 5)
    sched = _chaos_schedule(cuda, kind, init(), chunks)
    out = {}
    for mode in ("eager", "jit"):
        run = srv.serve_many if mode == "eager" else srv.jit_serve_many
        state, got = init(), []
        for c, args in enumerate(chunks):
            ch = CH.slice_schedule(sched, 5 * c, 5 * c + 5)
            args = (*args[:-2], args[-2] + ch.skew_ms, args[-1], ch)
            state, acc, ys = run(model, state, *args, flush_every=1)
            got.append((S.fetch_counters(acc), ys))
        out[mode] = (state, got)
    assert len(srv.jit_serve_many.graphs) == 1
    (st_e, got_e), (st_j, got_j) = out["eager"], out["jit"]
    for (acc_e, ys_e), (acc_j, ys_j) in zip(got_e, got_j):
        assert acc_e == acc_j
        for a, b in zip(ys_e, ys_j):
            assert torch.equal(a, b)
    for a, b in zip(_state_leaves(st_e), _state_leaves(st_j)):
        assert torch.equal(a, b)
    # the single-model budget (3.5 a step) leaves no token for a retry
    keys = ("blackout_write_drops", "deferred") + (
        ("retries",) if kind == "multi" else ())
    total = {k: sum(g[0][k] for g in got_j) for k in keys}
    assert all(v > 0 for v in total.values()), total


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_flush_predicated_off_on_the_card(cuda, kind):
    """With pending ring records, a flush whose ``enabled`` is a False
    device bool leaves every state tensor bit-identical; True equals the
    plain flush."""
    from repro_torch.core.hashing import Key64

    srv, model, init, cfg_t = _jit_setup(cuda, kind)
    args = _jit_chunks(cuda, kind, cfg_t, 1, 3)[0]
    state = init()
    for i in range(3):
        step = [Key64(a.hi[i], a.lo[i]) if isinstance(a, Key64) else
                {k: v[i] for k, v in a.items()} if isinstance(a, dict)
                else a[i] for a in args]
        state = srv.serve_step(model, state, *step[:-2], int(step[-2]),
                               step[-1]).state
        if i < 2:
            state = srv.flush(state, int(step[-2]))
    assert int(state.writebuf.count) > 0
    before = [x.clone() for x in _state_leaves(state)]
    off = torch.zeros((), dtype=torch.bool, device=cuda)
    srv.flush(state, 10 ** 6, off)
    for a, b in zip(_state_leaves(state), before):
        assert torch.equal(a, b)
    twin = type(state)(*[type(p)(*[x.clone() for x in p]) for p in state])
    srv.flush(state, 10 ** 6, ~off)
    srv.flush(twin, 10 ** 6)
    for a, b in zip(_state_leaves(state), _state_leaves(twin)):
        assert torch.equal(a, b)


def test_jit_regional_replay_equals_eager(cuda):
    """``RegionalServer`` (4 regions over the SMOKE SASRec tower) through
    ``jit_serve_many`` over three chunks with a drain and an undrain
    inside them equals eager ``serve_many``: outputs, counters (re-homes
    and excursions included), the home table and every state tensor; one
    dual-multi probe a step."""
    from repro_torch.configs import get_config
    from repro_torch.core import regional as RG
    from repro_torch.core import server as S
    from repro_torch.core.config import CacheConfig
    from repro_torch.core.hashing import Key64
    from repro_torch.kernels import ops
    from repro_torch.models import recsys as R

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_t = get_config("sasrec", smoke=True)
    model = R.init_params(torch.Generator(device=cuda).manual_seed(0), cfg_t,
                          cuda)
    cfgs = tuple(CacheConfig(model_id=m + 1, model_type="ctr", n_buckets=32,
                             ways=4, value_dim=cfg_t.embed_dim,
                             cache_ttl_ms=MIN, backend="cuda",
                             eviction="lru" if m else "ttl")
                 for m in range(2))
    srv = RG.RegionalServer(cfgs=cfgs, n_regions=4, n_users=80,
                            tower_fn=lambda p, f: R.tower_step(
                                p, f, cfg_t, impl="cuda"),
                            miss_budget=24, locality=0.9, seed=3,
                            device=cuda)
    rng = np.random.default_rng(12)
    steps, batch = 15, 32
    uids = rng.integers(0, 80, (steps, batch)).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=cuda)
    drained, epoch = RG.stage_drain_schedule(
        steps, 4, [(3, "drain", 3), (11, "undrain", 3)], device=cuda)
    ebase = RG.event_bases(2 ** 32 - 100, steps, batch, device=cuda)
    seq = rng.integers(0, cfg_t.vocab, (steps, batch, cfg_t.seq_len))
    args = (t(uids), t(uids % 2), Key64.from_int(uids, device=cuda),
            {"seq": t(seq.astype(np.int32))},
            t((np.arange(steps) * 20_000).astype(np.int32)),
            drained, epoch, ebase)
    out = {}
    for mode in ("eager", "jit"):
        run = srv.serve_many if mode == "eager" else srv.jit_serve_many
        state, got = srv.init_state(writebuf_capacity=128), []
        ops.reset_launch_counts()
        for lo in range(0, steps, 5):
            sl = slice(lo, lo + 5)
            chunk = [Key64(a.hi[sl], a.lo[sl]) if isinstance(a, Key64) else
                     {k: v[sl] for k, v in a.items()} if isinstance(a, dict)
                     else a[sl] for a in args]
            state, acc, ys = run(model, state, *chunk)
            got.append((S.fetch_counters(acc), ys))
        out[mode] = (state, got, ops.launch_counts())
    assert len(srv.jit_serve_many.graphs) == 1
    (st_e, got_e, n_e), (st_j, got_j, n_j) = out["eager"], out["jit"]
    assert n_j["cache_probe_dual_multi"] == n_e["cache_probe_dual_multi"] \
        == steps
    for (acc_e, ys_e), (acc_j, ys_j) in zip(got_e, got_j):
        assert acc_e == acc_j
        for a, b in zip(ys_e, ys_j):
            assert torch.equal(a, b)
    for a, b in zip(_state_leaves(st_e), _state_leaves(st_j)):
        assert torch.equal(a, b)
    assert sum(g[0]["rehomed"] for g in got_j) > 0
    assert sum(g[0]["excursions"] for g in got_j) > 0
    load = np.sum([g[0]["per_model_requests"] for g in got_j[1:2]], 0)
    assert load.reshape(4, 2)[3].sum() == 0       # steps 5..10: drained


# ------------------------------------------ snapshots and warm restarts
def _restart_server(cuda, n_buckets=1 << 12, backend="cuda"):
    """A SMOKE SASRec single-model server on 2**12 x 8 LRU tiers and a
    Zipf stream of (S, 512) staged chunks: the restart harness's shape."""
    from repro_torch.configs import get_config
    from repro_torch.core import server as S
    from repro_torch.core.config import CacheConfig
    from repro_torch.core.hashing import Key64
    from repro_torch.models import recsys as R

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_t = get_config("sasrec", smoke=True)
    model = R.init_params(torch.Generator(device=cuda).manual_seed(0), cfg_t,
                          cuda)
    cfg = CacheConfig(model_id=1, model_type="ctr", n_buckets=n_buckets,
                      ways=8, value_dim=cfg_t.embed_dim, cache_ttl_ms=5 * MIN,
                      backend=backend, eviction="lru")
    srv = S.CachedEmbeddingServer(cfg=cfg, miss_budget=512, tower_fn=(
        lambda p, f: R.tower_step(p, f, cfg_t, impl=backend)))
    rng = np.random.default_rng(21)
    t = lambda a: torch.as_tensor(a, device=cuda)

    def chunk(c, steps=10, batch=512):
        ids = rng.zipf(1.2, (steps, batch)).astype(np.int64) % 40_000
        seq = rng.integers(0, cfg_t.vocab, (steps, batch, cfg_t.seq_len))
        nows = ((np.arange(steps) + c * steps + 1) * 250).astype(np.int32)
        return (Key64.from_int(ids, device=cuda),
                {"seq": t(seq.astype(np.int32))}, t(nows))

    return srv, model, cfg, chunk


@pytest.mark.parametrize("n_buckets", [1 << 13, 1 << 11])
def test_rehash_cuda_matches_torch(cuda, n_buckets):
    """The elastic rehash of a served 2**12 x 8 table (more candidates than
    one 4096-row chunk), grown and shrunk, recency pass on the tiled probe
    kernel (one launch a chunk) vs its plain version: the candidate count
    and every plane of the new table bit for bit; the old table is only
    read."""
    from repro_torch.core import cache as C
    from repro_torch.core import server as S
    from repro_torch.ft import elastic as E
    from repro_torch.kernels import ops

    srv, model, cfg, chunk = _restart_server(cuda)
    state = S.init_server_state(cfg, writebuf_capacity=2048, device=cuda)
    for c in range(4):
        state, _, _ = srv.serve_many(model, state, *chunk(c), collect=False)
    old = [t.clone() for t in state.direct]
    out = {}
    for backend in ("cuda", "torch"):
        ops.reset_launch_counts()
        new, n = E.rehash_cache(
            state.direct, C.init_cache(n_buckets, 8, cfg.value_dim,
                                       device=cuda),
            10_000, cfg.cache_ttl_ms, evict_lru=True, backend=backend)
        out[backend] = (new, n, ops.launch_counts()["cache_probe_tiled"])
    (nc, n_c, l_c), (nt, n_t, l_t) = out["cuda"], out["torch"]
    assert n_c == n_t > 4096
    assert (l_c, l_t) == (-(-n_c // 4096), 0)
    for name, a, b in zip(nc._fields, nc, nt):
        assert torch.equal(a, b), name
    for a, b in zip(state.direct, old):
        assert torch.equal(a, b)


def test_restore_then_jit_serve_many_equals_eager(cuda, tmp_path):
    """A served state is snapshotted and restored (bit-exact, new
    tensors): ``jit_serve_many`` on the restored state captures a new
    graph (the first keys on the old state's addresses), and two chunks
    through it equal two eager ``serve_many`` chunks on a second restore
    in every output, counter and state tensor, while the old state's
    tensors stay as they were: no graph writes across the restore."""
    from repro_torch.core import server as S
    from repro_torch.core.graph import tensors_of
    from repro_torch.ft import snapshot as snap

    srv, model, cfg, chunk = _restart_server(cuda)
    chunks = [chunk(c) for c in range(3)]
    state = S.init_server_state(cfg, writebuf_capacity=2048, device=cuda)
    state, _, _ = srv.jit_serve_many(model, state, *chunks[0])
    state = snap.snapshot_server(str(tmp_path), 1, srv, state, 2500)
    before = [t.clone() for t in tensors_of(state)]
    out = {}
    for mode in ("jit", "eager"):
        r = snap.restore_server(str(tmp_path), srv, now_ms=2500,
                                writebuf_capacity=2048, device=cuda)
        assert r.mode == "bitexact"
        assert all(torch.equal(a, b) for a, b in zip(
            tensors_of(S.cache_image(r.state)),
            tensors_of(S.cache_image(state))))
        run = srv.jit_serve_many if mode == "jit" else srv.serve_many
        st, got = r.state, []
        for args in chunks[1:]:
            st, acc, ys = run(model, st, *args)
            got.append((S.fetch_counters(acc), ys))
        out[mode] = (tensors_of(st), got)
    assert len(srv.jit_serve_many.graphs) == 2
    for a, b in zip(tensors_of(state), before):
        assert torch.equal(a, b)
    (st_j, got_j), (st_e, got_e) = out["jit"], out["eager"]
    for (acc_j, ys_j), (acc_e, ys_e) in zip(got_j, got_e):
        assert acc_j == acc_e
        for a, b in zip(ys_j, ys_e):
            assert torch.equal(a, b)
    for a, b in zip(st_j, st_e):
        assert torch.equal(a, b)


def test_restart_timeline_cuda_matches_torch(cuda, tmp_path):
    """The kill/restore harness at the SMOKE tower, compiled on the
    kernels vs eager on the plain versions: the report (but the wall, the
    workdir and the backend's name) and every restored and final tensor
    of every variant bit for bit; one dual probe and one bag a step, one
    tiled probe a restore probe and a rehash chunk."""
    import re

    from repro_torch.core.graph import tensors_of
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as L

    kw = dict(pre_steps=40, recovery_steps=20, users=400, batch=64,
              checkpoint_every=10, n_buckets=256, chunk_steps=10,
              device=cuda, log=lambda s: None)
    runs = {}
    for backend, jit in (("cuda", True), ("torch", False)):
        ops.reset_launch_counts()
        rep, states = L.restart_timeline(backend=backend, jit=jit,
                                         workdir=str(tmp_path / backend),
                                         **kw)
        runs[backend] = (rep, states, ops.launch_counts())
    (rep, st, n), (rep_t, st_t, n_t) = runs["cuda"], runs["torch"]
    strip = lambda r: {k: v for k, v in r.items()
                       if k not in ("wall_s", "workdir", "backend")}
    assert strip(rep) == strip(rep_t)
    assert rep["parity"]["pass"] and rep["torn_step_skipped"]
    steps = rep["kill_step"] + 4 * rep["recovery_steps"]
    chunks = sum(-(-int(x) // 4096) for v in st.values() if v["detail"]
                 for x in re.findall(r"(\d+) (?:direct|failover)",
                                     v["detail"]))
    assert {k: v for k, v in n.items() if v} == {
        "cache_probe_dual": steps, "embedding_bag": steps,
        "cache_probe_tiled": 3 + chunks}
    assert not sum(n_t.values())
    for name in st:
        assert st[name]["detail"] == st_t[name]["detail"]
        for part in ("restored", "final"):
            a, b = st[name][part], st_t[name][part]
            for x, y in zip(tensors_of(a), tensors_of(b), strict=True):
                assert torch.equal(x, y), (name, part)


# ------------------------------------------------------------ training
# tinyllama-1.1b-smoke in float32, TF32 off: the card and the CPU sum the
# same matmuls in other orders over two layers.
TRAIN_RTOL = 1e-5


def test_train_step_on_card_matches_cpu(cuda):
    """One make_train_step (AdamW + cosine, two microbatches, remat) of
    tinyllama-1.1b-smoke on the card and on the CPU from the same
    weights: loss, ce and grad_norm, then every parameter after it."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import lm_batches, lm_train_state
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                              microbatches=2)
    opt = O.for_config(cfg, total_steps=10)
    card = lm_train_state(cfg, opt, cuda)
    cpu_params = O.tree_map(lambda t: t.detach().cpu().clone(), card.params)
    cpu = T.TrainState(cpu_params, opt.init(cpu_params),
                       torch.zeros((), dtype=torch.int32))
    batch = next(lm_batches(cfg, 8, 64, device=cuda))
    card, m_card = T.make_train_step(cfg, opt)(card, batch)
    cpu, m_cpu = T.make_train_step(cfg, opt)(
        cpu, {k: v.cpu() for k, v in batch.items()})
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(m_card[k]), float(m_cpu[k]),
                                   rtol=TRAIN_RTOL, err_msg=k)
    assert card.params["embed"].is_cuda and int(card.step) == 1
    for a, b in zip(O.tree_leaves(card.params), O.tree_leaves(cpu.params)):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().numpy(), atol=1e-5, rtol=0)


def test_sharded_lookup_and_flush_dual_cuda_match_torch(cuda):
    """The bucket-sharded tier at N=4 on one card: ``sharded_lookup_dual``
    on the dual kernel (one launch a shard) and ``sharded_flush_dual``
    equal the ``"torch"`` backend bit for bit, every output and plane."""
    from repro_torch.core import writebuf as W
    from repro_torch.core.hashing import Key64
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shard_lib
    from repro_torch.launch.mesh import make_cache_mesh

    rng = np.random.default_rng(4)
    mesh = make_cache_mesh(4, devices=[cuda] * 4)
    runs = {}
    for backend in ("cuda", "torch"):
        d = C.init_cache(256, 8, 50, device=cuda)
        f = C.init_cache(64, 4, 50, device=cuda)
        ids = rng.integers(0, 3000, 512) if backend == "cuda" else ids
        keys = Key64.from_int(ids, device=cuda)
        vals = torch.as_tensor(np.random.default_rng(1).standard_normal(
            (512, 50)), dtype=torch.float32, device=cuda)
        C.insert_dual(d, f, keys, vals, 5 * MIN, MIN, 10 * MIN)
        sd, sf = (shard_lib.split_cache(t, mesh.devices) for t in (d, f))
        n0 = pk.LAUNCHES["dual"]
        res = coll.sharded_lookup_dual(mesh, sd, sf, keys, 6 * MIN, MIN,
                                       10 * MIN, backend=backend)
        launches = pk.LAUNCHES["dual"] - n0
        buf = W.init_writebuf(1024, 50, device=cuda)
        tb = W.init_touchbuf(1024, device=cuda)
        W.append(buf, keys, vals + 1, 6 * MIN, torch.ones(
            512, dtype=torch.bool, device=cuda))
        W.touch_append(tb, res[0], res[1], 6 * MIN)
        W.flush_dual(buf, sd, sf, 7 * MIN, MIN, 10 * MIN, evict_lru=True,
                     touchbuf=tb, mesh=mesh)
        runs[backend] = (res, launches, sd.gather(), sf.gather())
    (rc, nc, dc, fc), (rt, nt, dt, ft) = runs["cuda"], runs["torch"]
    assert (nc, nt) == (4, 0)
    assert bool(rc[0].hit.any())
    for a, b in zip(rc, rt):
        assert_same([x for x in a], [x for x in b])
    assert_same(list(dc) + list(fc), list(dt) + list(ft))


# ------------------------------------------- the model-axis mesh, on the card
def _cuda_mesh(dims):
    from repro_torch.launch.mesh import ModelMesh

    return ModelMesh(dims, ("data", "model"), ("cuda",) * int(np.prod(dims)))


@pytest.mark.parametrize("n_split", [1, 3, None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,hd", [(32, 4, 64), (8, 2, 16)])
def test_decode_attention_partials_match_plain(cuda, n_split, dtype, hq,
                                               hkv, hd):
    """The partials entry on the second half of a cache (a view at
    position offset S, rows 2S apart): P = 1, 3 and the split plan's
    count, valid_len 0, S (the range all masked), S + 1, a split
    boundary, 2S and one inside; the raw partials against the plain
    version's with the same splits (an empty split m = -1e30 exactly,
    never -inf, l = acc = 0), and the two halves merged against the whole
    cache's plain decode. One launch a call, none for the refusals."""
    from repro_torch.distributed.collectives import combine_decode_partials

    S, B = 1024, 6
    g = torch.Generator(device=cuda).manual_seed(hd + S)
    P, split_len = (dk.splits_of(S, n_split) if n_split else dk.split_plan(
        B, S, hkv, torch.cuda.get_device_properties(
            cuda).multi_processor_count))
    lens = [0, S, S + 1, S + split_len, 2 * S, S + 333]
    q = torch.randn((B, hq, hd), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((B, 2 * S, hkv, hd), generator=g,
                        device=cuda).to(dtype) for _ in range(2))
    valid = torch.tensor(lens, dtype=torch.int32, device=cuda)
    n0 = dk.LAUNCHES["decode_attention_partials"]
    m, l, acc = dk.decode_attention_partials(q, k[:, S:], v[:, S:], valid, S,
                                             n_split=n_split)
    torch.cuda.synchronize()
    assert dk.LAUNCHES["decode_attention_partials"] == n0 + 1
    assert m.shape == l.shape == (P, B, hq) and acc.shape == (P, B, hq, hd)
    wm, wl, wacc = ref.decode_attention_partials_ref(
        q, k[:, S:], v[:, S:], valid, S, P, split_len)
    empty = wl == 0
    assert bool((m[empty] == -1e30).all()) and not bool(l[empty].any())
    assert bool(torch.isfinite(m).all()) and not bool(acc[empty].any())
    assert bool(empty[:, :2].all())            # valid_len 0 and S
    torch.testing.assert_close(m, wm, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l, wl, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(acc, wacc, rtol=1e-4,
                               atol=1e-4 * float(wacc.abs().max()))
    m0, l0, acc0 = dk.decode_attention_partials(q, k[:, :S], v[:, :S], valid)
    got = combine_decode_partials(torch.cat([m0, m]), torch.cat([l0, l]),
                                  torch.cat([acc0, acc]), dtype)
    want = ref.decode_attention_ref(q, k, v, valid)
    assert not bool(got[0].any())              # every range empty: zeros
    assert_attention_close(got, want, 2e-5)
    n0 = dk.LAUNCHES["decode_attention_partials"]
    for args in ((q.cpu(), k, v), (q, k[:, S:].contiguous().cpu(), v),
                 (q.to(torch.float16), k, v),
                 (q, k.transpose(1, 2), v.transpose(1, 2))):
        with pytest.raises(ValueError):
            dk.decode_attention_partials(*args, valid)
    with pytest.raises(RuntimeError):
        dk.decode_attention_partials(q.float().requires_grad_(), k.float(),
                                     v.float(), valid)
    assert dk.LAUNCHES["decode_attention_partials"] == n0


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seq_sharded_decode_cuda_matches_torch_backend(cuda, n, dtype):
    """N sequence shards of a 2048-position cache: one partials launch a
    shard; an all-masked shard and valid_len 0 (zeros on the card, the
    mean of v on the torch backend, as the reference)."""
    from repro_torch.distributed.collectives import \
        seq_sharded_decode_attention

    g = torch.Generator(device=cuda).manual_seed(n)
    B, S, hq, hkv, hd = 5, 2048, 32, 4, 64
    q = torch.randn((B, hq, hd), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((B, S, hkv, hd), generator=g,
                        device=cuda).to(dtype) for _ in range(2))
    valid = torch.tensor([0, 1, 700, 1536, 2048], dtype=torch.int32,
                         device=cuda)
    mesh = _cuda_mesh((1, n))
    n0 = dk.LAUNCHES["decode_attention_partials"]
    got = seq_sharded_decode_attention(q, k, v, mesh, kv_valid_len=valid,
                                       backend="cuda")
    assert dk.LAUNCHES["decode_attention_partials"] == n0 + n
    want = seq_sharded_decode_attention(q, k, v, mesh, kv_valid_len=valid,
                                        backend="torch")
    assert not bool(got[0].any()) and bool(want[0].any())
    assert_attention_close(got[1:], want[1:], 2e-5)
    assert_attention_close(got, ref.decode_attention_ref(q, k, v, valid),
                           2e-5)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("dim", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nnz", [1, 4])
def test_sharded_field_bag_kernel_matches_plain(cuda, n, dim, dtype, nnz):
    """The row-sharded bag: one launch a shard over the (F*V, D) view;
    bit for bit against its plain version at nnz = 1, a few ulps at 4;
    the serving scatter layout the same values."""
    from repro_torch.models import recsys as R

    gen = torch.Generator(device=cuda).manual_seed(n * dim + nnz)
    tables = torch.randn(40, 4096, dim, generator=gen, device=cuda).to(dtype)
    ids = torch.randint(0, 4096, (512, 40, nnz), generator=gen, device=cuda,
                        dtype=torch.int32)
    ids[torch.rand(ids.shape, generator=gen, device=cuda) < 0.2] = -1
    mesh = _cuda_mesh((1, n))
    n0 = ebk.LAUNCHES["embedding_bag"]
    got = R.sharded_field_embedding_bag(tables, ids, mesh, impl="cuda")
    assert ebk.LAUNCHES["embedding_bag"] == n0 + n
    want = R.sharded_field_embedding_bag(tables, ids, mesh, impl="torch")
    assert got.dtype == dtype and got.shape == (512, 40, dim)
    assert_bag_close(got, want, nnz)
    assert torch.equal(R.sharded_field_embedding_bag(
        tables, ids, mesh, scatter_batch=True, impl="cuda"), got)
    if n == 1:
        assert_bag_close(got, R.field_embedding_bag(tables, ids, impl="cuda"),
                         nnz)


def test_ercache_plan_arguments_equal_the_card_tensors(cuda):
    """The planner's ERCache cell for a (1, 1) mesh and one cache shard of
    the card, at a small batch and tier: its argument bytes equal the
    tensors the card allocates, and the planned step runs there through
    ``jit_serve_step`` with every row a miss."""
    from repro_torch.configs import get_config
    from repro_torch.core import server as S
    from repro_torch.core.config import CacheConfig, HOUR_MS, MINUTE_MS
    from repro_torch.core.graph import tensors_of
    from repro_torch.core.hashing import Key64
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import CacheMesh, ModelMesh
    from repro_torch.models import transformer as T

    B, seq, nb = 64, 64, 1 << 12
    mesh = ModelMesh((1, 1), ("data", "model"), (cuda,))
    cache_mesh = CacheMesh((cuda,))
    cfg = get_config("tinyllama-1.1b")
    plan = dryrun.run_ercache_cell(batch=B, n_buckets=nb, seq=seq,
                                   mesh=mesh, cache_mesh=cache_mesh,
                                   verbose=False)
    assert plan["ok"] and plan["n_chips"] == 1
    ccfg = CacheConfig(model_id=1, model_type="ctr",
                       cache_ttl_ms=5 * MINUTE_MS, failover_ttl_ms=HOUR_MS,
                       n_buckets=nb, ways=8, value_dim=cfg.user_embed_dim)
    params = T.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                           cuda)
    state = S.init_server_state(ccfg, writebuf_capacity=B, device=cuda,
                                mesh=cache_mesh)
    rng = np.random.default_rng(0)
    keys = Key64.from_int(rng.integers(0, 2 ** 62, B), device=cuda)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, seq)),
                           dtype=torch.int32, device=cuda)
    assert plan["argument_bytes"] == {
        "params": sum(p.nbytes for p in params.parameters()),
        "state": sum(t.nbytes for t in tensors_of(state)),
        "inputs": keys.hi.nbytes + keys.lo.nbytes + toks.nbytes}
    server = S.CachedEmbeddingServer(
        cfg=ccfg, miss_budget=B // 4, mesh=cache_mesh,
        tower_fn=lambda p, t: T.user_tower_step(p, t, cfg, backend="cuda",
                                                mesh=mesh))
    res = server.jit_serve_step(params, state, keys, toks, 0)
    assert int(res.stats["tower_inferences"]) == B // 4
    assert int(res.stats["direct_hits"]) == 0
    want = T.user_tower_step(params, toks[:B // 4], cfg, backend="torch")
    torch.testing.assert_close(res.embeddings[:B // 4], want.float(),
                               atol=0, rtol=0)


def test_table4_on_card_matches_cpu(cuda):
    """The Table 4 experiment at a small size on the card and on the CPU:
    each arm's NE within a relative 1e-5, each ne_diff within 1e-4
    points (float32 products summed in another order)."""
    from repro_torch.examples import train_ctr_tower as ex

    assert not torch.backends.cuda.matmul.allow_tf32
    card = ex.run(n_users=300, horizon_h=3.0, device=cuda)
    cpu = ex.run(n_users=300, horizon_h=3.0, device="cpu")
    for label, c in card.items():
        h = cpu[label]
        assert c["ne"] == pytest.approx(h["ne"], rel=1e-5), label
        assert c["ne_diff_pct"] == pytest.approx(h["ne_diff_pct"],
                                                 abs=1e-4), label
