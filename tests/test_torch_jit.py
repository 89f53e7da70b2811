"""repro_torch's compiled entry points (``jit_serve_step``,
``jit_serve_many``, ``jit_flush``) against the JAX package's, on the CPU.

On a CPU state each runs its plain function (the step, the S-step loop
or the flush, then the write-back of fresh state tensors); on the card
the same function is what the CUDA graph captures
(``tests/test_torch_cuda.py`` holds the replays to eager there). The same
numpy-seeded stream goes through both packages' ``jit_*``: sources, ages,
every counter (per-model vectors too), the rings, the budget tokens and
every cache plane after the flush bit for bit; embeddings and the values
cached from the tower at atol 2e-5 / rtol 1e-4; the float32 stat sums at
rtol 1e-6. The state a ``jit_*`` call returns shares every tensor with
the one passed in, the budget included: a graph replay depends on it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (SUM_RTOL, assert_exact, assert_float,  # noqa: E402
                           assert_tree)
from repro.core import server as JS  # noqa: E402
from repro.core.config import CacheConfig as JCfg  # noqa: E402
from repro.core.hashing import Key64 as JKey  # noqa: E402
from repro_torch.core import server as TS  # noqa: E402
from repro_torch.core.config import CacheConfig as TCfg  # noqa: E402
from repro_torch.core.graph import tensors_of  # noqa: E402
from repro_torch.core.hashing import Key64 as TKey  # noqa: E402
from test_torch_multi import _stream as multi_stream  # noqa: E402
from test_torch_multi import tier_kw  # noqa: E402
from test_torch_server import _linear_tower  # noqa: E402
from test_torch_server import _stream as single_stream  # noqa: E402

MIN = 60_000
DIM = 8
MISS_BUDGET = 12
N_MANY = 5                 # steps through jit_serve_many, then single steps


def _servers(kind, admission, eviction, jtower, ttower):
    """Both packages' servers and fresh states: the single-model server
    on small tiers (with admission, coalescing and LRU touches when
    asked), or the four-model tier with admission and coalescing on two
    models."""
    if kind == "multi":
        kws = tier_kw()
        for m, kw in enumerate(kws):
            kw.update(coalesce_misses=m % 2 == 0,
                      infer_budget_per_step=2.5 if m < 2 else None)
        jcfgs = [JCfg(backend="jnp", **kw) for kw in kws]
        tcfgs = [TCfg(backend="torch", **kw) for kw in kws]
        return (JS.MultiModelServer(cfgs=tuple(jcfgs), tower_fn=jtower,
                                    miss_budget=MISS_BUDGET),
                TS.MultiModelServer(cfgs=tuple(tcfgs), tower_fn=ttower,
                                    miss_budget=MISS_BUDGET, device="cpu"),
                JS.init_multi_server_state(jcfgs, writebuf_capacity=64),
                TS.init_multi_server_state(tcfgs, writebuf_capacity=64,
                                           device="cpu"))
    kw = dict(model_id=1, model_type="ctr", n_buckets=16, ways=4,
              failover_n_buckets=8, failover_ways=2, value_dim=DIM,
              cache_ttl_ms=MIN, failover_ttl_ms=3 * MIN, eviction=eviction,
              coalesce_misses=admission,
              infer_budget_per_step=3.5 if admission else None)
    jcfg, tcfg = JCfg(backend="jnp", **kw), TCfg(backend="torch", **kw)
    return (JS.CachedEmbeddingServer(cfg=jcfg, tower_fn=jtower,
                                     miss_budget=MISS_BUDGET),
            TS.CachedEmbeddingServer(cfg=tcfg, tower_fn=ttower,
                                     miss_budget=MISS_BUDGET),
            JS.init_server_state(jcfg, writebuf_capacity=64),
            TS.init_server_state(tcfg, writebuf_capacity=64, device="cpu"))


def _inputs(kind, stream, sl):
    """The (jax, torch) inputs after the state of steps ``sl``."""
    if kind == "multi":
        ids, slots, feats, nows, fails = stream
        lead = (jnp.asarray(slots[sl]),), (torch.as_tensor(slots[sl]),)
    else:
        ids, feats, nows, fails = stream
        lead = (), ()
    ids = np.asarray(ids[sl], np.int64)
    return ((*lead[0], JKey.from_int(ids),
             {k: jnp.asarray(v[sl]) for k, v in feats.items()},
             jnp.asarray(nows[sl]), jnp.asarray(fails[sl])),
            (*lead[1], TKey.from_int(ids, device="cpu"),
             {k: torch.as_tensor(v[sl]) for k, v in feats.items()},
             torch.as_tensor(nows[sl]), torch.as_tensor(fails[sl])))


def _assert_counters(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if k in TS._ACC_F32 + TS._ACC_PM_F32 or np.asarray(v).dtype == \
                np.float32:
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(v, np.float64),
                                       rtol=SUM_RTOL, err_msg=k)
        else:
            assert_exact(np.asarray(got[k]), np.asarray(v), k)


CASES = [  # (kind, admission, eviction)
    ("single", False, "ttl"),
    ("single", True, "lru"),
    ("multi", True, None),
]


@pytest.mark.parametrize("kind,admission,eviction", CASES,
                         ids=["single", "single-admission-lru", "multi"])
def test_jit_entry_points_match_jax(kind, admission, eviction):
    """``jit_serve_many`` over five steps (a flush every two), then three
    single steps of ``jit_serve_step`` + ``jit_flush``: each output equals
    the reference's ``jit_*`` on the same stream, and so does the whole
    state after the last flush."""
    rng = np.random.default_rng(CASES.index((kind, admission, eviction)))
    _, jparams, jtower, tparams, ttower, feat_of = _linear_tower(rng, DIM)
    stream = (multi_stream if kind == "multi" else single_stream)(rng,
                                                                  feat_of)
    jsrv, tsrv, jstate, tstate = _servers(kind, admission, eviction, jtower,
                                          ttower)
    jin, tin = _inputs(kind, stream, slice(0, N_MANY))
    jstate, jacc, jys = jsrv.jit_serve_many(jparams, jstate, *jin,
                                            flush_every=2)
    tstate, tacc, tys = tsrv.jit_serve_many(tparams, tstate, *tin,
                                            flush_every=2)
    assert_float(tys[0], jys[0], "embeddings")
    assert_exact(tys[1], jys[1], "source")
    assert_exact(tys[2], jys[2], "age")
    _assert_counters(TS.fetch_counters(tacc), jax.device_get(jacc))
    n_steps = stream[0].shape[0]
    for s in range(N_MANY, n_steps):
        (*jlead, jk, jf, jn, jfail), (*tlead, tk, tf, tn, tfail) = _inputs(
            kind, stream, slice(s, s + 1))
        one = lambda t: t[0]
        jres = jsrv.jit_serve_step(
            jparams, jstate, *map(one, jlead), JKey(jk.hi[0], jk.lo[0]),
            jax.tree_util.tree_map(one, jf), int(jn[0]), jfail[0])
        tres = tsrv.jit_serve_step(
            tparams, tstate, *map(one, tlead), TKey(tk.hi[0], tk.lo[0]),
            {k: v[0] for k, v in tf.items()}, int(tn[0]), tfail[0])
        assert_float(tres.embeddings, jres.embeddings, f"embeddings {s}")
        assert_exact(tres.source, jres.source, f"source {s}")
        assert_exact(tres.age_ms, jres.age_ms, f"age {s}")
        _assert_counters({k: v.numpy() for k, v in tres.stats.items()},
                         jax.device_get(jres.stats))
        jstate = jsrv.jit_flush(jres.state, int(jn[0]))
        tstate = tsrv.jit_flush(tres.state, int(tn[0]))
    for name in ("direct", "failover"):
        assert_tree(getattr(tstate, name), getattr(jstate, name),
                    float_fields=("values",), what=name)
    assert_tree(tstate.writebuf, jstate.writebuf, float_fields=("values",),
                what="writebuf")
    assert_tree(tstate.touchbuf, jstate.touchbuf, what="touchbuf")
    assert_exact(tstate.budget.tokens, jstate.budget.tokens, "tokens")
    if admission:
        assert TS.fetch_counters(tacc)["deferred"] > 0


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_jit_state_shares_storage_with_the_state_passed_in(kind):
    """Every tensor of the state that ``jit_serve_many``,
    ``jit_serve_step`` and ``jit_flush`` return is the tensor passed in,
    the admission budget included, whose tokens moved: the step's fresh
    budget was written back. Eager ``serve_many`` returns a fresh budget
    tensor with the same tokens."""
    rng = np.random.default_rng(7)
    _, jparams, jtower, tparams, ttower, feat_of = _linear_tower(rng, DIM)
    stream = (multi_stream if kind == "multi" else single_stream)(rng,
                                                                  feat_of)
    _, tsrv, _, state = _servers(kind, True, "lru", jtower, ttower)
    _, _, _, eager = _servers(kind, True, "lru", jtower, ttower)
    leaves = tensors_of(state)
    tokens0 = state.budget.tokens.clone()
    _, tin = _inputs(kind, stream, slice(0, N_MANY))
    got, _, _ = tsrv.jit_serve_many(tparams, state, *tin)
    want, _, _ = tsrv.serve_many(tparams, eager, *tin)
    assert want.budget.tokens is not eager.budget.tokens
    assert not torch.equal(got.budget.tokens, tokens0)
    assert torch.equal(got.budget.tokens, want.budget.tokens)
    assert all(a is b for a, b in zip(tensors_of(got), leaves, strict=True))
    (*lead, keys, feats, nows, fails) = _inputs(kind, stream,
                                                slice(N_MANY, N_MANY + 1))[1]
    res = tsrv.jit_serve_step(tparams, got, *(t[0] for t in lead),
                              TKey(keys.hi[0], keys.lo[0]),
                              {k: v[0] for k, v in feats.items()},
                              int(nows[0]), fails[0])
    assert all(a is b for a, b in zip(tensors_of(res.state), leaves,
                                      strict=True))
    flushed = tsrv.jit_flush(res.state, int(nows[0]))
    assert all(a is b for a, b in zip(tensors_of(flushed), leaves,
                                      strict=True))
    assert int(flushed.writebuf.count) == 0
