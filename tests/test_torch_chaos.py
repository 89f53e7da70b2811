"""repro_torch's chaos engine against the JAX package, on the CPU: the
compiled fault schedules, both servers under each fault family and the
``cascade`` preset, the predicated flush, the ``--chaos`` launcher's three
presets window by window, and its CLI refusals.

Schedules, sources, ages, every counter (the degradation ledger's keys and
the per-model vectors included), the rings, the budget tokens and the
integer cache planes must match bit for bit; embeddings and cached values
at atol 2e-5 / rtol 1e-4 and the float32 stat sums at rtol 1e-6
(``tests/_torch_parity.py``); a report's ``mean_failover_stale_ms``
within 0.1 ms, its rounding step.
"""
import dataclasses
import sys

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
from repro.ft import chaos as JCH  # noqa: E402
from repro.launch import serve as j_launch  # noqa: E402
from repro_torch.core import server as TS  # noqa: E402
from repro_torch.core.config import CacheConfig as TCfg  # noqa: E402
from repro_torch.core.graph import tensors_of  # noqa: E402
from repro_torch.core.hashing import Key64 as TKey  # noqa: E402
from repro_torch.ft import chaos as TCH  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402
from test_torch_server import _linear_tower  # noqa: E402

MIN = 60_000
DIM, B, S, NB = 8, 16, 8, 64
HORIZON = (S + 1) * 1000
STALE_ATOL_MS = 0.1
F32_KEYS = TS._ACC_F32 + TS._ACC_PM_F32


# ------------------------------------------------------------- schedules
def _invalid_cases(ch):
    """(faults, compile kwargs) pairs every package must refuse."""
    ok = dict(batch=8, n_models=2, n_buckets=64)
    return [
        ([ch.InferFailure(500, 500)], ok),
        ([ch.InferFailure(0, 1, rate=1.5)], ok),
        ([ch.InferFailure(0, 1, model=2)], ok),
        ([ch.Outage(0, 1, model=-1)], ok),
        ([ch.BucketBlackout(0, 1, lo=0, hi=65)], ok),
        ([ch.BucketBlackout(0, 2000, lo=0, hi=8),
          ch.BucketBlackout(1000, 3000, lo=8, hi=16)], ok),
        ([ch.ClockSkew(0, 2000, skew_ms=5),
          ch.ClockSkew(500, 900, skew_ms=9)], ok),
        ([], dict(ok, slots=np.full((4, 8), 2, np.int32))),
        ([ch.Fault(0, 1)], ok),
        ([], dict(ok, retry=ch.RetryPolicy(max_retries=-1))),
    ]


@pytest.mark.parametrize("case", range(len(_invalid_cases(TCH))))
def test_compile_refuses_what_the_reference_refuses(case):
    nows = np.arange(4) * 1000
    errs = []
    for ch in (JCH, TCH):
        faults, kw = _invalid_cases(ch)[case]
        with pytest.raises((ValueError, TypeError)) as exc:
            ch.compile_schedule(faults, nows, **kw)
        errs.append((type(exc.value), str(exc.value)))
    assert errs[0] == errs[1]


def test_unknown_preset_refused_by_both():
    for ch in (JCH, TCH):
        with pytest.raises(ValueError, match="unknown chaos scenario"):
            ch.preset_faults("nope", 1000, n_buckets=64)


def _faults(ch, family, n_models, pooled):
    """One fault family alone (or the cascade preset) over the S-step
    stream's clock (1000..8000 ms)."""
    return {
        "infer": [ch.InferFailure(2500, 6500, rate=0.7)],
        "outage": [ch.Outage(2500, 5500, model=0)],
        "blackout": [ch.BucketBlackout(2500, 6500, lo=0, hi=pooled // 2)],
        "stall": [ch.FlushStall(1500, 6500)],
        "skew": [ch.ClockSkew(3500, 6500, skew_ms=45 * MIN)],
        "cascade": ch.preset_faults("cascade", HORIZON, n_models=n_models,
                                    n_buckets=pooled),
    }[family]


def _schedules(family, n_models, pooled, nows, slots):
    kw = dict(n_models=n_models, n_buckets=pooled, slots=slots, seed=3,
              base_fail_rate=0.05)
    j = JCH.compile_schedule(
        _faults(JCH, family, n_models, pooled), nows, B,
        retry=JCH.RetryPolicy(max_retries=2, backoff_ms=500), **kw)
    t = TCH.compile_schedule(
        _faults(TCH, family, n_models, pooled), nows, B,
        retry=TCH.RetryPolicy(max_retries=2, backoff_ms=500),
        device="cpu", **kw)
    return j, t


@pytest.mark.parametrize("name", TCH.PRESETS)
def test_preset_schedules_and_windows_match_jax(name):
    """Every preset at a 3-model, 60-step scale: the same fault list, the
    same arrays from the same seed (retries included), the same skewed
    clock and the same reporting windows."""
    horizon, nows = 61_000, (np.arange(60) + 1) * 1000
    slots = (np.arange(60)[:, None] + np.arange(8)[None, :]) % 3
    jf = JCH.preset_faults(name, horizon, n_models=3, n_buckets=256)
    tf = TCH.preset_faults(name, horizon, n_models=3, n_buckets=256)
    assert [dataclasses.asdict(f) for f in tf] == [
        dataclasses.asdict(f) for f in jf]
    assert [type(f).__name__ for f in tf] == [type(f).__name__ for f in jf]
    kw = dict(n_models=3, n_buckets=256, slots=slots, seed=7)
    j = JCH.compile_schedule(jf, nows, 8, retry=JCH.RetryPolicy(), **kw)
    t = TCH.compile_schedule(tf, nows, 8, retry=TCH.RetryPolicy(),
                             device="cpu", **kw)
    assert t._fields == j._fields
    for name_, a, b in zip(t._fields, t, j):
        assert_exact(a, b, name_)
    assert (t.n_steps, t.n_retries) == (j.n_steps, j.n_retries)
    assert_exact(TCH.skewed_now(t, nows), JCH.skewed_now(j, nows))
    assert TCH.fault_windows(tf, horizon) == JCH.fault_windows(jf, horizon)
    part_t, part_j = TCH.slice_schedule(t, 7, 19), JCH.slice_schedule(j, 7, 19)
    for a, b in zip(part_t, part_j):
        assert_exact(a, b)
    for a, b in zip(TCH.benign_schedule(5, 8, n_models=3, device="cpu"),
                    JCH.benign_schedule(5, 8, n_models=3)):
        assert_exact(a, b)


# ------------------------------------------------------- the serve steps
def _servers(kind, rng):
    """Both packages' servers on small tiers with admission control (a
    budget the grants bind on), LRU touches and a 16-record ring, fresh
    states, and the linear tower's parameters."""
    dim, jparams, jtower, tparams, ttower, feats_of = _linear_tower(rng, DIM)
    kw = dict(model_type="ctr", n_buckets=NB, ways=4, value_dim=dim,
              cache_ttl_ms=30 * MIN, failover_ttl_ms=120 * MIN,
              infer_budget_per_step=12.0)
    if kind == "single":
        kw.update(model_id=1, eviction="lru")
        jcfg, tcfg = JCfg(backend="jnp", **kw), TCfg(backend="torch", **kw)
        return (JS.CachedEmbeddingServer(cfg=jcfg, tower_fn=jtower,
                                         miss_budget=B),
                TS.CachedEmbeddingServer(cfg=tcfg, tower_fn=ttower,
                                         miss_budget=B),
                lambda: JS.init_server_state(jcfg, writebuf_capacity=16),
                lambda: TS.init_server_state(tcfg, writebuf_capacity=16,
                                             device="cpu"),
                jparams, tparams, feats_of)
    kws = [dict(kw, model_id=1, eviction="lru"),
           dict(kw, model_id=2, infer_budget_per_step=6.0)]
    jcfgs = [JCfg(backend="jnp", **k) for k in kws]
    tcfgs = [TCfg(backend="torch", **k) for k in kws]
    return (JS.MultiModelServer(cfgs=tuple(jcfgs), tower_fn=jtower,
                                miss_budget=B),
            TS.MultiModelServer(cfgs=tuple(tcfgs), tower_fn=ttower,
                                miss_budget=B, device="cpu"),
            lambda: JS.init_multi_server_state(jcfgs, writebuf_capacity=16),
            lambda: TS.init_multi_server_state(tcfgs, writebuf_capacity=16,
                                               device="cpu"),
            jparams, tparams, feats_of)


def _stream(rng, feats_of, n_models):
    ids = rng.integers(0, 24, (S, B)).astype(np.int64) * 7919 + 11
    slots = rng.integers(0, n_models, (S, B)).astype(np.int32)
    nows = (np.arange(S) + 1) * 1000
    fails = rng.uniform(size=(S, B)) < 0.05
    return ids, slots, feats_of(ids), nows, fails


def _inputs(ids, slots, feats, fails, multi, lo=0, hi=S):
    """(jax, torch) serve_many inputs between the state and the clock."""
    sl = slice(lo, hi)
    j = (JKey.from_int(ids[sl]), {k: jnp.asarray(v[sl])
                                  for k, v in feats.items()})
    t = (TKey.from_int(ids[sl], device="cpu"),
         {k: torch.as_tensor(v[sl]) for k, v in feats.items()})
    if multi:
        j = (jnp.asarray(slots[sl]),) + j
        t = (torch.as_tensor(slots[sl]),) + t
    return j, t, jnp.asarray(fails[sl]), torch.as_tensor(fails[sl])


def _assert_counters(tacc, jacc):
    jacc = jax.device_get(jacc)
    tacc = TS.fetch_counters(tacc)
    assert set(tacc) == set(jacc)
    for k, v in jacc.items():
        if k in F32_KEYS:
            np.testing.assert_allclose(tacc[k], v, rtol=SUM_RTOL, err_msg=k)
        else:
            assert_exact(np.asarray(tacc[k]), np.asarray(v), k)
    return tacc


def _assert_states(tst, jst):
    for name in ("direct", "failover"):
        assert_tree(getattr(tst, name), getattr(jst, name),
                    float_fields=("values",), what=name)
    assert_tree(tst.writebuf, jst.writebuf, float_fields=("values",),
                what="writebuf")
    assert_tree(tst.touchbuf, jst.touchbuf, what="touchbuf")
    assert_exact(tst.budget.tokens, jst.budget.tokens, "tokens")


FAMILIES = ("infer", "outage", "blackout", "stall", "skew", "cascade")
# what each family must show in the port's ledger (a fault that changed
# nothing would pass the parity check vacuously)
OBSERVED = {"infer": ("retries", "retry_successes", "tower_failures"),
            "outage": ("deferred",),
            "blackout": ("blackout_write_drops",),
            "stall": ("write_ring_drops",),
            "skew": ("tower_inferences",),
            "cascade": ("retries", "deferred", "blackout_write_drops",
                        "failover_serves")}


@pytest.fixture(scope="module")
def jax_servers():
    """One JAX server of each kind for the whole module: every family's
    schedule has the same shapes, so its ``jit_serve_many`` compiles
    once."""
    return {kind: _servers(kind, np.random.default_rng(5))
            for kind in ("single", "multi")}


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("family", FAMILIES)
def test_fault_family_matches_jax(jax_servers, kind, family):
    """One ``serve_many`` over the S-step stream under one fault family
    (or ``cascade``), retries allowed, on the skewed clock: the schedule,
    sources, ages, every counter, both tiers, both rings and the budget
    tokens equal the JAX package's."""
    multi = kind == "multi"
    jsrv, tsrv, jinit, tinit, jparams, tparams, feats_of = jax_servers[kind]
    M = 2 if multi else 1
    rng = np.random.default_rng(FAMILIES.index(family))
    ids, slots, feats, nows, fails = _stream(rng, feats_of, M)
    jsched, tsched = _schedules(family, M, M * NB, nows,
                                slots if multi else None)
    for name, a, b in zip(tsched._fields, tsched, jsched):
        assert_exact(a, b, name)
    jin, tin, jf, tf = _inputs(ids, slots, feats, fails, multi)
    jst, jacc, jys = jsrv.jit_serve_many(
        jparams, jinit(), *jin, JCH.skewed_now(jsched, nows), jf, jsched)
    tst, tacc, tys = tsrv.serve_many(
        tparams, tinit(), *tin, TCH.skewed_now(tsched, nows), tf, tsched)
    assert_float(tys[0], jys[0], "embeddings")
    assert_exact(tys[1], jys[1], "source")
    assert_exact(tys[2], jys[2], "age")
    got = _assert_counters(tacc, jacc)
    _assert_states(tst, jst)
    assert all(got[k] > 0 for k in OBSERVED[family]), (
        family, {k: got[k] for k in OBSERVED[family]})
    assert got["requests"] == (got["direct_hits"] + got["computed_serves"]
                               + got["failover_serves"] + got["fallbacks"])


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_fault_rows_through_serve_step_match_jax(kind):
    """``serve_step`` with one schedule row at a time (the cascade's
    fault step), then the flush: outputs and stats equal JAX's."""
    multi = kind == "multi"
    rng = np.random.default_rng(21)
    jsrv, tsrv, jinit, tinit, jparams, tparams, feats_of = _servers(kind,
                                                                   rng)
    M = 2 if multi else 1
    ids, slots, feats, nows, fails = _stream(rng, feats_of, M)
    jsched, tsched = _schedules("cascade", M, M * NB, nows,
                                slots if multi else None)
    jst, tst = jinit(), tinit()
    for i in range(4):
        jin, tin, jf, tf = _inputs(ids, slots, feats, fails, multi, i, i + 1)
        jin = jax.tree_util.tree_map(lambda x: x[0], jin)
        tin = [TKey(x.hi[0], x.lo[0]) if isinstance(x, TKey) else
               {k: v[0] for k, v in x.items()} if isinstance(x, dict)
               else x[0] for x in tin]
        now = int(TCH.skewed_now(tsched, nows)[i])
        jres = jsrv.serve_step(jparams, jst, *jin, now, jf[0],
                               jax.tree_util.tree_map(lambda x: x[i],
                                                      jsched))
        tres = tsrv.serve_step(tparams, tst, *tin, now, tf[0],
                               TS._row(tsched, i))
        assert_float(tres.embeddings, jres.embeddings)
        assert_exact(tres.source, jres.source)
        assert_exact(tres.age_ms, jres.age_ms)
        assert set(tres.stats) == set(jres.stats)
        for k, v in jres.stats.items():
            if jnp.issubdtype(v.dtype, jnp.floating):
                assert_float(tres.stats[k], v, k, rtol=SUM_RTOL)
            else:
                assert_exact(tres.stats[k], v, k)
        jst = jsrv.flush(jres.state, now)
        tst = tsrv.flush(tres.state, now)
    _assert_states(tst, jst)


def test_chaos_requires_admission_control():
    for pkg, cfg_cls, srv_mod, ch, kw in (
            ("jax", JCfg, JS, JCH, {}), ("torch", TCfg, TS, TCH,
                                         {"device": "cpu"})):
        cfg = cfg_cls(model_id=1, model_type="ctr", n_buckets=NB, ways=4,
                      value_dim=DIM, backend="jnp" if pkg == "jax"
                      else "torch")
        srv = srv_mod.CachedEmbeddingServer(cfg=cfg,
                                            tower_fn=lambda p, f: f,
                                            miss_budget=4)
        state = srv_mod.init_server_state(cfg, writebuf_capacity=16, **kw)
        key = (JKey if pkg == "jax" else TKey).from_int(
            np.arange(4), **kw)
        feats = np.zeros((4, DIM), np.float32)
        feats = jnp.asarray(feats) if pkg == "jax" else torch.as_tensor(feats)
        row = ch.benign_schedule(1, 4, **kw)
        row = type(row)(*(x[0] for x in row))
        with pytest.raises(ValueError, match="admission"):
            srv.serve_step(None, state, key, feats, 1000, None, row)


# ------------------------------------------- port-only chaos contracts
def _port_run(kind, sched_fn, chunks=((0, S),), flush_every=1):
    """The port's server over the S-step stream, in ``chunks``."""
    rng = np.random.default_rng(9)
    _, srv, _, init, _, params, feats_of = _servers(kind, rng)
    multi = kind == "multi"
    ids, slots, feats, nows, fails = _stream(rng, feats_of, 2 if multi
                                             else 1)
    sched = sched_fn(nows, slots if multi else None)
    state, accs, ys = init(), [], []
    for lo, hi in chunks:
        _, tin, _, tf = _inputs(ids, slots, feats, fails, multi, lo, hi)
        ch = None if sched is None else TCH.slice_schedule(sched, lo, hi)
        now = torch.as_tensor(nows[lo:hi].astype(np.int32))
        if ch is not None:
            now = now + ch.skew_ms
        state, acc, y = srv.serve_many(params, state, *tin, now, tf, ch,
                                       flush_every=flush_every)
        accs.append(TS.fetch_counters(acc))
        ys.append(y)
    return state, accs, ys


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_benign_schedule_is_bit_exact_with_chaos_off(kind):
    M = 2 if kind == "multi" else 1
    base = _port_run(kind, lambda nows, slots: None)
    benign = _port_run(kind, lambda nows, slots: TCH.benign_schedule(
        S, B, n_models=M, device="cpu"))
    for a, b in zip(base[2][0], benign[2][0]):
        assert torch.equal(a, b)
    acc = benign[1][0]
    for k, v in base[1][0].items():
        assert acc[k] == v, k
    assert all(acc[k] == 0 for k in TS._ACC_CHAOS_STEP[1:]
               + TS._ACC_CHAOS_SCAN)
    for a, b in zip(tensors_of(base[0]), tensors_of(benign[0])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_chunked_dispatch_equals_one_dispatch(kind):
    """Slicing the schedule across three calls (the cascade without its
    flush stall, whose tail flush lands at each call's end by contract:
    an outage, a blackout and a skew crossing the cuts) accumulates the
    same ledger and leaves the same state as one call over the whole
    schedule."""
    M = 2 if kind == "multi" else 1
    faults = [f for f in _faults(TCH, "cascade", M, M * NB)
              if not isinstance(f, TCH.FlushStall)]

    def sched(nows, slots):
        return TCH.compile_schedule(
            faults, nows, B, n_models=M,
            n_buckets=M * NB, slots=slots, seed=4, device="cpu",
            retry=TCH.RetryPolicy(max_retries=1))

    one = _port_run(kind, sched)
    parts = _port_run(kind, sched, chunks=((0, 3), (3, 4), (4, S)))
    total = {k: (np.sum([np.asarray(a[k]) for a in parts[1]], axis=0)
                 if k not in F32_KEYS else None) for k in one[1][0]}
    for k, v in one[1][0].items():
        if k not in F32_KEYS:
            assert_exact(total[k], np.asarray(v), k)
    assert one[1][0]["blackout_write_drops"] > 0
    for a, b in zip(tensors_of(one[0]), tensors_of(parts[0])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_flush_predicated_off_leaves_state_bit_identical(kind):
    """A flush with ``enabled`` False leaves every plane and both rings
    (records and counts) as they were; with True it equals the plain
    flush."""
    rng = np.random.default_rng(13)
    _, srv, _, init, _, params, feats_of = _servers(kind, rng)
    multi = kind == "multi"
    ids, slots, feats, nows, fails = _stream(rng, feats_of, 2)
    state = init()
    for i in range(3):       # fill the tables, then leave records pending
        _, tin, _, tf = _inputs(ids, slots, feats, fails, multi, i, i + 1)
        tin = [TKey(x.hi[0], x.lo[0]) if isinstance(x, TKey) else
               {k: v[0] for k, v in x.items()} if isinstance(x, dict)
               else x[0] for x in tin]
        state = srv.serve_step(params, state, *tin, int(nows[i]),
                               tf[0]).state
        if i < 2:
            state = srv.flush(state, int(nows[i]))
    assert int(state.writebuf.count) > 0 and int(state.touchbuf.count) > 0
    before = [x.clone() for x in tensors_of(state)]
    srv.flush(state, int(nows[2]), torch.tensor(False))
    for a, b in zip(tensors_of(state), before):
        assert torch.equal(a, b)
    twin = type(state)(*[type(part)(*[x.clone() for x in part])
                         for part in state])
    srv.flush(state, int(nows[2]), torch.tensor(True))
    srv.flush(twin, int(nows[2]))
    for a, b in zip(tensors_of(state), tensors_of(twin)):
        assert torch.equal(a, b)
    assert int(state.writebuf.count) == 0


# -------------------------------------------------------------- launcher
@pytest.mark.parametrize("scenario", TCH.PRESETS)
def test_run_serving_chaos_matches_jax(scenario):
    """Each preset end to end at a small size (SMOKE SASRec, 20 steps of
    32 over 4 models): every window row and total of the report equals
    the JAX launcher's; staleness within its 0.1 ms rounding."""
    common = dict(arch="sasrec", scenario=scenario, steps=20, users=200,
                  batch=32, n_buckets=64, recovery_win=4,
                  log=lambda *_: None)
    want = j_launch.run_serving_chaos(backend="jnp", **common)
    got = t_launch.run_serving_chaos(backend="torch", device="cpu",
                                     **common)
    skip = {"wall_s", "backend", "device", "host_ms_per_step", "windows"}
    assert set(want) - skip <= set(got)
    for k in set(want) - skip:
        assert got[k] == want[k], k
    assert len(got["windows"]) == len(want["windows"])
    for g, w in zip(got["windows"], want["windows"]):
        assert set(g) == set(w)
        for k in w:
            if k == "mean_failover_stale_ms":
                assert abs(g[k] - w[k]) <= STALE_ATOL_MS, (w["label"], k)
            else:
                assert g[k] == w[k], (w["label"], k)
    assert got["conservation_ok"] and got["requests"] == 20 * 32
    if scenario == "cascade":
        assert got["blackout_write_drops"] > 0 and got["retries"] > 0


CHAOS_REFUSED = [["--overload"], ["--multi"], ["--regions", "2"],
                 ["--no-cache"], ["--coalesce"], ["--eviction", "lru"]]


@pytest.mark.parametrize("flags", CHAOS_REFUSED,
                         ids=[" ".join(f) for f in CHAOS_REFUSED])
def test_chaos_cli_refuses_what_the_reference_refuses(flags, capsys,
                                                      monkeypatch):
    args = ["--chaos", "cascade", *flags]
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    with pytest.raises(SystemExit) as ref_exit:
        j_launch.main()
    with pytest.raises(SystemExit) as exc:
        t_launch.main(args)
    assert exc.value.code == ref_exit.value.code == 2
    err = capsys.readouterr().err
    assert err.count("--chaos") >= 2


@pytest.mark.parametrize("entry", ["compile_schedule", "benign_schedule",
                                   "plan_chaos", "run_serving_chaos"])
def test_chaos_entry_points_default_to_the_card(entry):
    """Without a card the chaos entry points' default device raises;
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA card is present")
    calls = {
        "compile_schedule": lambda: TCH.compile_schedule(
            [], np.arange(3), 4, n_buckets=8),
        "benign_schedule": lambda: TCH.benign_schedule(3, 4),
        "plan_chaos": lambda: t_launch.plan_chaos(steps=4, batch=8),
        "run_serving_chaos": lambda: t_launch.run_serving_chaos(
            steps=4, batch=8, log=lambda *_: None),
    }
    with pytest.raises((RuntimeError, AssertionError)):
        calls[entry]()
