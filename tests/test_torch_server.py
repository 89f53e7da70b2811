"""repro_torch's serving tier against the JAX package, on the CPU: the
admission token bucket, whole ``serve_many`` runs across the option sweep,
and the launcher.

Integer outputs (sources, ages, counters, ring and cache-plane int
leaves) and the token state must match bit for bit; embeddings and the
values cached from the tower at atol 2e-5 / rtol 1e-4; the float32 stat
sums at rtol 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (SUM_RTOL, assert_exact, assert_float,  # noqa: E402
                           assert_tree, to_np)
from repro.configs import get_config as j_config  # noqa: E402
from repro.core import ratelimit as JRL  # noqa: E402
from repro.core import server as JS  # noqa: E402
from repro.core.config import CacheConfig as JCfg  # noqa: E402
from repro.core.hashing import Key64 as JKey  # noqa: E402
from repro.launch import serve as j_launch  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.core import ratelimit as TRL  # noqa: E402
from repro_torch.core import server as TS  # noqa: E402
from repro_torch.core.config import CacheConfig as TCfg  # noqa: E402
from repro_torch.core.hashing import Key64 as TKey  # noqa: E402
from repro_torch.core.metrics import ServingCounters  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402
from repro_torch.models import recsys as TR  # noqa: E402

MIN = 60_000
S, B, MISS_BUDGET = 8, 24, 12


# ------------------------------------------------------------- admission
def test_admit_step_token_state_bit_exact(rng):
    """Refill -> grant -> spend over 60 steps of random demand: grants and
    the float32 token state equal JAX's bit for bit (fractional rates,
    an unlimited model, a blocked model)."""
    rates_np = np.array([0.25, 1.5, 3.0, 0.0, 7.125], np.float32)
    limited_np = np.array([True, True, True, False, True])
    cfgs = [JCfg(model_id=i, model_type="ctr",
                 infer_budget_per_step=(float(r) if lim else None))
            for i, (r, lim) in enumerate(zip(rates_np, limited_np))]
    tcfgs = [TCfg(model_id=c.model_id, model_type="ctr",
                  infer_budget_per_step=c.infer_budget_per_step)
             for c in cfgs]
    jr, jb_, jl = JRL.budget_table(cfgs)
    tr, tb_, tl = TRL.budget_table(tcfgs, device="cpu")
    for g, w in ((tr, jr), (tb_, jb_), (tl, jl)):
        assert_exact(g, w)
    jbud, tbud = JRL.init_infer_budget(cfgs), TRL.init_infer_budget(
        tcfgs, device="cpu")
    for step in range(60):
        demand = rng.integers(0, 9, 5).astype(np.int32)
        jg, jbud = JRL.admit_step(jbud, jr, jb_, jl, jnp.asarray(demand))
        tg, tbud = TRL.admit_step(tbud, tr, tb_, tl, torch.as_tensor(demand))
        assert_exact(tg, jg, f"grant step {step}")
        assert_exact(tbud.tokens, jbud.tokens, f"tokens step {step}")
    blocked = np.array([False, True, False, True, False])
    jgrant = JRL.grant_from(jbud, jl, jnp.full(5, 4, jnp.int32),
                            blocked=jnp.asarray(blocked))
    tgrant = TRL.grant_from(tbud, tl, torch.full((5,), 4), blocked=
                            torch.as_tensor(blocked))
    assert_exact(tgrant, jgrant)


# ---------------------------------------------------------- serve sweep
def _stream(rng, feat_of):
    """An (S, B) stream over a small skewed user pool: duplicates inside
    batches, re-accesses across the TTLs, and 10% inference failures."""
    pool = np.arange(60, dtype=np.int64) * 7919 + 11
    p = 1.0 / np.arange(1, 61) ** 1.1
    ids = rng.choice(pool, size=(S, B), p=p / p.sum())
    nows = (np.arange(S) * 25_000 + 1000).astype(np.int32)
    fails = rng.uniform(size=(S, B)) < 0.1
    return ids, feat_of(ids), nows, fails


def _linear_tower(rng, dim):
    w = (rng.standard_normal((dim, dim)) / np.sqrt(dim)).astype(np.float32)

    def feats(ids):
        x = np.sin(ids[..., None] * (np.arange(dim) + 1) * 1e-3)
        return {"x": x.astype(np.float32)}

    return (dim, jnp.asarray(w), lambda p, f: f["x"] @ p,
            torch.as_tensor(w), lambda p, f: f["x"] @ p, feats)


def _sasrec_tower(rng):
    jcfg, tcfg = j_config("sasrec", smoke=True), t_config("sasrec",
                                                          smoke=True)
    params = JR.init_params(jax.random.PRNGKey(1), jcfg)
    model = TR.load_jax_params(jax.tree_util.tree_map(np.asarray, params),
                               device="cpu")

    def feats(ids):
        g = np.random.default_rng(7)
        seq = g.integers(0, jcfg.vocab, ids.shape + (jcfg.seq_len,))
        seq[..., :2] = np.where((ids % 3 == 0)[..., None], -1,
                                seq[..., :2])
        return {"seq": seq.astype(np.int32)}

    return (tcfg.user_embed_dim, params,
            lambda p, f: JR.tower_step(p, f, jcfg),
            model, lambda p, f: TR.tower_step(p, f, tcfg, impl="torch"),
            feats)


SWEEP = [  # (tower, flush_every, coalesce, admission, eviction)
    ("linear", 1, False, False, "ttl"),
    ("linear", 0, True, False, "lru"),
    ("linear", 3, False, True, "ttl"),
    ("linear", 1, True, True, "lru"),
    ("linear", 3, True, False, "ttl"),
    ("linear", 0, False, True, "lru"),
    ("sasrec", 1, False, False, "ttl"),
    ("sasrec", 3, True, True, "lru"),
]


@pytest.mark.parametrize("tower,flush_every,coalesce,admission,eviction",
                         SWEEP)
def test_serve_many_matches_jax(tower, flush_every, coalesce, admission,
                                eviction):
    rng = np.random.default_rng(SWEEP.index((tower, flush_every, coalesce,
                                             admission, eviction)))
    dim, jparams, jtower, tparams, ttower, feat_of = (
        _linear_tower(rng, 8) if tower == "linear" else _sasrec_tower(rng))
    ids, feats, nows, fails = _stream(rng, feat_of)
    kw = dict(model_id=1, model_type="ctr", n_buckets=16, ways=4,
              failover_n_buckets=8, failover_ways=2, value_dim=dim,
              cache_ttl_ms=MIN, failover_ttl_ms=3 * MIN, eviction=eviction,
              coalesce_misses=coalesce,
              infer_budget_per_step=3.5 if admission else None)
    jcfg = JCfg(backend="jnp", **kw)
    tcfg = TCfg(backend="torch", **kw)
    jsrv = JS.CachedEmbeddingServer(cfg=jcfg, tower_fn=jtower,
                                    miss_budget=MISS_BUDGET)
    tsrv = TS.CachedEmbeddingServer(cfg=tcfg, tower_fn=ttower,
                                    miss_budget=MISS_BUDGET)
    jstate = JS.init_server_state(jcfg, writebuf_capacity=64)
    tstate = TS.init_server_state(tcfg, writebuf_capacity=64, device="cpu")
    # two dispatches of one shape (one JAX compile): the second starts
    # from the first's state
    for lo, hi in ((0, S // 2), (S // 2, S)):
        jk = JKey.from_int(ids[lo:hi])
        tk = TKey.from_int(ids[lo:hi], device="cpu")
        jstate, jacc, jys = jsrv.jit_serve_many(
            jparams, jstate, jk, {k: jnp.asarray(v[lo:hi])
                                  for k, v in feats.items()},
            jnp.asarray(nows[lo:hi]), jnp.asarray(fails[lo:hi]),
            flush_every=flush_every)
        tstate, tacc, tys = tsrv.serve_many(
            tparams, tstate, tk, {k: torch.as_tensor(v[lo:hi])
                                  for k, v in feats.items()},
            torch.as_tensor(nows[lo:hi]), torch.as_tensor(fails[lo:hi]),
            flush_every=flush_every)
        assert_float(tys[0], jys[0], "embeddings")
        assert_exact(tys[1], jys[1], "source")
        assert_exact(tys[2], jys[2], "age")
        jacc = jax.device_get(jacc)
        tacc = TS.fetch_counters(tacc)
        assert set(tacc) == set(jacc)
        for k, v in jacc.items():
            if k in TS._ACC_F32:
                np.testing.assert_allclose(tacc[k], v, rtol=SUM_RTOL,
                                           err_msg=k)
            else:
                assert tacc[k] == int(v), k
    for name in ("direct", "failover"):
        assert_tree(getattr(tstate, name), getattr(jstate, name),
                    float_fields=("values",), what=name)
    assert_tree(tstate.writebuf, jstate.writebuf, float_fields=("values",),
                what="writebuf")
    assert_tree(tstate.touchbuf, jstate.touchbuf, what="touchbuf")
    assert_exact(tstate.budget.tokens, jstate.budget.tokens, "tokens")
    image = TS.cache_image(tstate)
    assert set(image) == set(JS.cache_image(jstate))
    assert image["direct"] is tstate.direct
    c = ServingCounters.from_stats(tacc)
    assert c.requests == (S - S // 2) * B
    src = to_np(tys[1])
    assert (src == TS.SRC_DIRECT).any() and (src != TS.SRC_DIRECT).any()


def test_serve_step_matches_jax_and_never_writes_tables(rng):
    """One serve step: outputs and stats equal JAX's, the cache tables are
    untouched (only the flush writes them) and the rings are appended in
    place."""
    dim, jparams, jtower, tparams, ttower, feat_of = _linear_tower(rng, 8)
    ids, feats, nows, fails = _stream(rng, feat_of)
    kw = dict(model_id=1, model_type="ctr", n_buckets=16, ways=4,
              value_dim=dim, cache_ttl_ms=MIN, eviction="lru")
    jsrv = JS.CachedEmbeddingServer(cfg=JCfg(backend="jnp", **kw),
                                    tower_fn=jtower, miss_budget=MISS_BUDGET)
    tsrv = TS.CachedEmbeddingServer(cfg=TCfg(backend="torch", **kw),
                                    tower_fn=ttower, miss_budget=MISS_BUDGET)
    jstate = JS.init_server_state(jsrv.cfg, writebuf_capacity=32)
    tstate = TS.init_server_state(tsrv.cfg, writebuf_capacity=32,
                                  device="cpu")
    for s in range(3):
        jres = jsrv.serve_step(jparams, jstate, JKey.from_int(ids[s]),
                               {"x": jnp.asarray(feats["x"][s])},
                               int(nows[s]), jnp.asarray(fails[s]))
        before = [t.clone() for t in tstate.direct]
        tres = tsrv.serve_step(tparams, tstate,
                               TKey.from_int(ids[s], device="cpu"),
                               {"x": torch.as_tensor(feats["x"][s])},
                               int(nows[s]), torch.as_tensor(fails[s]))
        for b, a in zip(before, tres.state.direct):
            assert torch.equal(b, a)
        assert tres.state.writebuf is tstate.writebuf
        assert_float(tres.embeddings, jres.embeddings)
        assert_exact(tres.source, jres.source)
        assert_exact(tres.age_ms, jres.age_ms)
        for k, v in jres.stats.items():
            if np.asarray(v).dtype == np.float32:
                np.testing.assert_allclose(to_np(tres.stats[k]), v,
                                           rtol=SUM_RTOL, err_msg=k)
            else:
                assert_exact(tres.stats[k], v, k)
        jstate = jsrv.flush(jres.state, int(nows[s]))
        tstate = tsrv.flush(tres.state, int(nows[s]))
    assert_tree(tstate.direct, jstate.direct, float_fields=("values",))


def test_no_cache_baseline_matches_jax(rng):
    dim, jparams, jtower, tparams, ttower, feat_of = _linear_tower(rng, 8)
    ids, feats, _, fails = _stream(rng, feat_of)
    je, js = JS.serve_step_no_cache(jtower, jparams, JKey.from_int(ids[0]),
                                    {"x": jnp.asarray(feats["x"][0])},
                                    jnp.asarray(fails[0]))
    te, ts = TS.serve_step_no_cache(ttower, tparams,
                                    TKey.from_int(ids[0], device="cpu"),
                                    {"x": torch.as_tensor(feats["x"][0])},
                                    torch.as_tensor(fails[0]))
    assert_float(te, je)
    assert_exact(ts, js)


@pytest.mark.parametrize("arch,opts", [
    ("sasrec", dict()), ("sasrec", dict(coalesce=True, eviction="lru")),
    ("sasrec", dict(use_cache=False)), ("wide-deep", dict()),
    ("bst", dict()), ("mind", dict())],
    ids=["basic", "coalesce-lru", "no-cache", "wide-deep", "bst", "mind"])
def test_run_serving_counters_match_jax(arch, opts):
    """The launcher end to end (each SMOKE tower, 5% failures): every
    counter equals the JAX launcher's on the same stream (the towers'
    random weights differ, and no counter depends on them)."""
    common = dict(arch=arch, minutes=6, users=300, batch=64,
                  failure_rate=0.05, chunk_steps=4, log=lambda *_: None,
                  **opts)
    want = j_launch.run_serving(backend="jnp", **common)
    got = t_launch.run_serving(backend="torch", device="cpu", **common)
    for k in dataclasses.fields(ServingCounters):
        assert got[k.name] == want[k.name], k.name
    assert got["requests"] > 0 and got["batches"] == want["batches"]


# ------------------------------------------- features as any tensor pytree
FEATURE_FORMS = {  # name -> (wrap an (..., B, dim) array, tower on it)
    "bare": (lambda x: x, lambda p, f: f @ p),
    "nested": (lambda x: {"u": (x, {"x": x})},
               lambda p, f: f["u"][1]["x"] @ p + 0 * f["u"][0]),
}


@pytest.mark.parametrize("form", list(FEATURE_FORMS))
def test_tensor_pytree_features_match_jax(form, rng):
    """The reference gathers the tower's inputs with ``tree_map`` (an LM
    tower takes a bare (B, S) token tensor): ``serve_many`` then
    ``serve_step`` + ``flush`` over one stream, with coalescing, give the
    JAX server's sources, ages and counters exactly."""
    wrap, tower = FEATURE_FORMS[form]
    dim = 8
    w = (rng.standard_normal((dim, dim)) / np.sqrt(dim)).astype(np.float32)
    ids, _, nows, fails = _stream(rng, lambda i: None)
    x = np.sin(ids[..., None] * (np.arange(dim) + 1) * 1e-3).astype(
        np.float32)
    kw = dict(model_id=1, model_type="ctr", n_buckets=16, ways=4,
              value_dim=dim, cache_ttl_ms=MIN, coalesce_misses=True)
    jsrv = JS.CachedEmbeddingServer(cfg=JCfg(backend="jnp", **kw),
                                    tower_fn=tower, miss_budget=MISS_BUDGET)
    tsrv = TS.CachedEmbeddingServer(cfg=TCfg(backend="torch", **kw),
                                    tower_fn=tower, miss_budget=MISS_BUDGET)
    jstate = JS.init_server_state(jsrv.cfg, writebuf_capacity=64)
    tstate = TS.init_server_state(tsrv.cfg, writebuf_capacity=64,
                                  device="cpu")
    jw, tw = jnp.asarray(w), torch.as_tensor(w)
    jstate, jacc, jys = jsrv.jit_serve_many(
        jw, jstate, JKey.from_int(ids[:5]), wrap(jnp.asarray(x[:5])),
        jnp.asarray(nows[:5]), jnp.asarray(fails[:5]))
    tstate, tacc, tys = tsrv.serve_many(
        tw, tstate, TKey.from_int(ids[:5], device="cpu"),
        wrap(torch.as_tensor(x[:5])), torch.as_tensor(nows[:5]),
        torch.as_tensor(fails[:5]))
    assert_exact(tys[1], jys[1], "source")
    assert_exact(tys[2], jys[2], "age")
    assert_float(tys[0], jys[0], "embeddings")
    assert TS.fetch_counters(tacc) == {
        k: (float(v) if k in TS._ACC_F32 else int(v))
        for k, v in jax.device_get(jacc).items()}
    for s in range(5, S):
        jres = jsrv.serve_step(jw, jstate, JKey.from_int(ids[s]),
                               wrap(jnp.asarray(x[s])), int(nows[s]),
                               jnp.asarray(fails[s]))
        tres = tsrv.serve_step(tw, tstate, TKey.from_int(ids[s],
                                                         device="cpu"),
                               wrap(torch.as_tensor(x[s])), int(nows[s]),
                               torch.as_tensor(fails[s]))
        assert_exact(tres.source, jres.source, f"source {s}")
        assert_exact(tres.age_ms, jres.age_ms, f"age {s}")
        for k in ("requests", "direct_hits", "tower_inferences",
                  "fallbacks", "failover_serves"):
            assert_exact(tres.stats[k], jres.stats[k], k)
        jstate = jsrv.flush(jres.state, int(nows[s]))
        tstate = tsrv.flush(tres.state, int(nows[s]))
    je, js = JS.serve_step_no_cache(tower, jw, JKey.from_int(ids[0]),
                                    wrap(jnp.asarray(x[0])),
                                    jnp.asarray(fails[0]))
    te, ts = TS.serve_step_no_cache(tower, tw,
                                    TKey.from_int(ids[0], device="cpu"),
                                    wrap(torch.as_tensor(x[0])),
                                    torch.as_tensor(fails[0]))
    assert_float(te, je)
    assert_exact(ts, js)
    with pytest.raises(TypeError):
        TS.take_rows({"x": np.zeros(3)}, 0)
