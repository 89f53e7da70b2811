"""The plain versions beside repro_torch's CUDA kernels against the JAX
Pallas kernels (interpret mode), on the CPU.

On a CPU tensor each kernel wrapper runs its plain version and launches
nothing; these tests hold that path to the JAX kernels, bit for bit for
the probes and for nnz=1 bags, and at one float32 rounding (bfloat16:
one bfloat16 rounding) for bags that sum several rows.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_exact  # noqa: E402
from repro.kernels import cache_probe as jpk  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.embedding_bag import embedding_bag as j_bag  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro_torch.kernels import cache_probe as tpk  # noqa: E402
from repro_torch.kernels import embedding_bag as tbag  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import recsys as TR  # noqa: E402

MIN = 60_000
EMPTY_HI = -0x80000000


def tables(rng, nb, ways, dim, now, ttl):
    """Raw probe tables: live, expired and empty slots, and a key present
    in two ways of one bucket (the FIRST valid way must win)."""
    key_hi = np.full((nb, ways), EMPTY_HI, np.int32)
    key_lo = np.zeros((nb, ways), np.int32)
    ts = np.full((nb, ways), EMPTY_HI, np.int32)
    live = rng.uniform(size=(nb, ways)) < 0.6
    key_hi[live] = rng.integers(0, 50, live.sum())
    key_lo[live] = rng.integers(-2 ** 31, 2 ** 31 - 1, live.sum())
    ts[live] = now - rng.integers(0, 2 * ttl, live.sum())
    key_hi[:, 1], key_lo[:, 1] = key_hi[:, 0], key_lo[:, 0]
    values = rng.standard_normal((nb, ways, dim)).astype(np.float32)
    return key_hi, key_lo, ts, values


def queries(rng, key_hi, key_lo, batch):
    nb, ways = key_hi.shape
    rows = rng.integers(0, nb, batch)
    cols = rng.integers(0, ways, batch)
    q_hi, q_lo = key_hi[rows, cols].copy(), key_lo[rows, cols].copy()
    miss = rng.uniform(size=batch) < 0.3
    q_hi[miss] = rng.integers(0, 50, miss.sum())
    return q_hi, q_lo, rows.astype(np.int32)


def as_t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def as_j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("batch", [1, 37, 128, 300])
def test_probe_tiled_plain_matches_pallas(batch, rng):
    now, ttl = 10 * MIN, MIN
    tabs = tables(rng, 32, 8, 50, now, ttl)
    qs = queries(rng, tabs[0], tabs[1], batch)
    want = jpk.cache_probe_tiled(*as_j(*tabs), *as_j(*qs), now, ttl)
    n0 = tpk.LAUNCHES["tiled"]
    got = tpk.cache_probe_tiled(*as_t(*tabs), *as_t(*qs), now, ttl)
    assert tpk.LAUNCHES["tiled"] == n0
    for g, w in zip(got, want):
        assert_exact(g, w)


@pytest.mark.parametrize("wd,wf,nbd,nbf", [(8, 8, 32, 32), (8, 4, 32, 16),
                                           (2, 16, 8, 64)])
def test_probe_dual_plain_matches_pallas(wd, wf, nbd, nbf, rng):
    """Each half of the dual probe == the JAX dual kernel, for tables of
    other bucket counts and ways, a device-resident clock and the
    no-TTL sentinel of the relaxed failover probe."""
    now = 10 * MIN
    d = tables(rng, nbd, wd, 50, now, MIN)
    f = tables(rng, nbf, wf, 50, now, 60 * MIN)
    q_hi, q_lo, b_d = queries(rng, d[0], d[1], 77)
    b_f = rng.integers(0, nbf, 77).astype(np.int32)
    want = jpk.cache_probe_dual(*as_j(*d), *as_j(*f),
                                *as_j(q_hi, q_lo, b_d, b_f), now, MIN,
                                0x7FFFFFFF)
    got = tpk.cache_probe_dual(*as_t(*d), *as_t(*f),
                               *as_t(q_hi, q_lo, b_d, b_f),
                               torch.tensor(now, dtype=torch.int32), MIN,
                               0x7FFFFFFF)
    for g_half, w_half in zip(got, want):
        for g, w in zip(g_half, w_half):
            assert_exact(g, w)


@pytest.mark.parametrize("shape", [(4, 1, 8), (16, 5, 32), (8, 12, 50)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_f32_matches_pallas(shape, mode, rng):
    B, nnz, D = shape
    table = rng.standard_normal((64, D)).astype(np.float32)
    ids = rng.integers(-1, 64, (B, nnz)).astype(np.int32)
    want = np.asarray(j_bag(jnp.asarray(table), jnp.asarray(ids), mode=mode,
                            interpret=True))
    want_ref = np.asarray(jref.embedding_bag_ref(jnp.asarray(table),
                                                 jnp.asarray(ids), mode))
    n0 = tbag.LAUNCHES["embedding_bag"]
    got = tbag.embedding_bag(torch.as_tensor(table), torch.as_tensor(ids),
                             mode=mode).numpy()
    assert tbag.LAUNCHES["embedding_bag"] == n0
    if nnz == 1:
        assert_exact(got, want)
        assert_exact(got, want_ref)
    else:
        # float32 sums of nnz rows, order may differ: one rounding
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, want_ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nnz", [1, 6])
def test_embedding_bag_bf16_matches_pallas(nnz, rng):
    table = rng.standard_normal((64, 32)).astype(np.float32)
    ids = rng.integers(-1, 64, (20, nnz)).astype(np.int32)
    jt = jnp.asarray(table).astype(jnp.bfloat16)
    tt = torch.as_tensor(table).to(torch.bfloat16)   # same RNE rounding
    for mode in ("sum", "mean"):
        want = np.asarray(j_bag(jt, jnp.asarray(ids), mode=mode,
                                interpret=True).astype(jnp.float32))
        got = tbag.embedding_bag(tt, torch.as_tensor(ids),
                                 mode=mode).float().numpy()
        if nnz == 1:
            assert_exact(got, want)
        else:
            # float32 sums in another order may round to the next bf16
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


def test_embedding_bag_all_padding(rng):
    table = torch.as_tensor(rng.standard_normal((8, 4)).astype(np.float32))
    ids = torch.full((3, 5), -1, dtype=torch.int32)
    for mode in ("sum", "mean"):
        assert_exact(tbag.embedding_bag(table, ids, mode=mode),
                     np.zeros((3, 4), np.float32))


def test_model_embedding_bag_flattens_leading_dims(rng):
    """models.recsys.embedding_bag takes (..., nnz) ids (SASRec passes
    (B, S, 1)); it equals the JAX jnp path on the same ids."""
    table = rng.standard_normal((40, 16)).astype(np.float32)
    ids = rng.integers(-1, 40, (3, 7, 2)).astype(np.int32)
    for mode in ("sum", "mean"):
        want = np.asarray(JR.embedding_bag(jnp.asarray(table),
                                           jnp.asarray(ids), mode))
        got = TR.embedding_bag(torch.as_tensor(table), torch.as_tensor(ids),
                               mode, impl="torch").numpy()
        assert got.shape == (3, 7, 16)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    one = rng.integers(-1, 40, (3, 7, 1)).astype(np.int32)
    assert_exact(TR.embedding_bag(torch.as_tensor(table),
                                  torch.as_tensor(one), impl="torch"),
                 JR.embedding_bag(jnp.asarray(table), jnp.asarray(one)))


def test_wrap_i32_matches_int32_wraparound():
    x = torch.tensor([0, 2 ** 31 - 1, 2 ** 31, -2 ** 31 - 1, 2 ** 32 + 5,
                      -(2 ** 33)], dtype=torch.int64)
    want = x.numpy().astype(np.int32)        # numpy casts modulo 2**32
    assert_exact(tref.wrap_i32(x), want)
