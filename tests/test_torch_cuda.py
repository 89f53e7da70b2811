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
from repro_torch.kernels import embedding_bag as ebk  # noqa: E402
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
