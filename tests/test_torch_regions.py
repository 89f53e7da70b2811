"""repro_torch's regional serving against the JAX package, on the CPU:
the host router and rate limiter copies, on-device routing
(``route_batch``, duplicates and the 2**32 event-index wrap),
the drain schedule's staging, ``RegionalServer`` against the reference's
and against a sequential oracle at R in {2, 4, 13}, the
``--regions --drain`` launcher and its CLI refusals.

Routing, counters, the home table and every integer cache plane must
match bit for bit; cached values at atol 2e-5 / rtol 1e-4
(``tests/_torch_parity.py``).
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_exact, assert_tree  # noqa: E402
from repro.core import ratelimit as j_rl  # noqa: E402
from repro.core import regional as JRG  # noqa: E402
from repro.core import regions as j_regions  # noqa: E402
from repro.core import server as JS  # noqa: E402
from repro.core.config import CacheConfig as JCfg  # noqa: E402
from repro.core.hashing import Key64 as JKey  # noqa: E402
from repro.launch import serve as j_launch  # noqa: E402
from repro_torch.core import ratelimit as t_rl  # noqa: E402
from repro_torch.core import regional as TRG  # noqa: E402
from repro_torch.core import regions as t_regions  # noqa: E402
from repro_torch.core import server as TS  # noqa: E402
from repro_torch.core.config import CacheConfig as TCfg  # noqa: E402
from repro_torch.core.graph import tensors_of  # noqa: E402
from repro_torch.core.hashing import Key64 as TKey  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402

MIN = 60_000
DIM = 8
LOCALITY = 0.9
SEED = 5


# ------------------------------------------------- host copies (numpy)
@pytest.mark.parametrize("sampler", ["hash", "rng"])
def test_region_router_copy_matches_original(sampler):
    """Both routers over one stream with drains and undrains: the same
    regions, homes and epochs; the hash and threshold helpers agree."""
    rng = np.random.default_rng(2)
    routers = [m.RegionRouter(n_regions=5, locality=0.8, seed=3,
                              sampler=sampler)
               for m in (j_regions, t_regions)]
    for step in range(300):
        if step in (60, 200):
            for r in routers:
                r.drain(4 if step == 60 else 1)
        if step == 150:
            for r in routers:
                r.undrain(4)
        uid = int(rng.integers(0, 80))
        assert routers[1].route(uid) == routers[0].route(uid), step
    assert routers[1]._home == routers[0]._home
    for lo, hi, seed in ((0, 0, 0), (123, 7, 99), (2**32 - 1, 2**31, 5)):
        assert (t_regions.hash_u32_host(lo, hi, seed)
                == j_regions.hash_u32_host(lo, hi, seed))
    for loc in (0.0, 0.5, 0.98, 1.0):
        assert (t_regions.excursion_threshold(loc)
                == j_regions.excursion_threshold(loc))
    for r in routers:
        for reg in range(5):
            r.drain(reg) if reg not in r.drained else None
    for mod, r in zip((j_regions, t_regions), routers):
        with pytest.raises(mod.AllRegionsDrainedError):
            r.route(1)


def test_rate_limiters_copy_matches_original():
    rng = np.random.default_rng(4)
    lims = [m.RegionalRateLimiter.uniform(range(3), rate_per_s=40.0,
                                          burst_s=0.5)
            for m in (j_rl, t_rl)]
    t = 0
    for _ in range(400):
        t += int(rng.integers(0, 30))
        reg, n = int(rng.integers(0, 3)), int(rng.integers(1, 9))
        assert lims[1].admit(reg, t, n) == lims[0].admit(reg, t, n)
    assert lims[1].stats() == lims[0].stats()
    b = [m.TokenBucket(rate_per_s=5.0, burst=2.0) for m in (j_rl, t_rl)]
    assert [x.admit(1000, 3) for x in b] == [2, 2]
    assert b[1].tokens == b[0].tokens


def test_drain_test_harness_copy_matches_original():
    """The host drain harness (one single-model server a region, the
    hash router, a rate limiter) on both packages: the same hit-rate
    timeline and per-region load."""
    cfg_kw = dict(model_id=1, model_type="ctr", n_buckets=32, ways=4,
                  value_dim=DIM, cache_ttl_ms=5 * MIN,
                  failover_ttl_ms=20 * MIN)
    rng = np.random.default_rng(6)
    events = rng.integers(0, 40, 300)
    times = np.cumsum(rng.integers(0, 400, 300)).astype(np.int64)
    out = []
    for regions_mod, rl, cfg_cls, srv_mod, key_cls, asarr, kw in (
            (j_regions, j_rl, JCfg, JS, JKey, jnp.asarray, {}),
            (t_regions, t_rl, TCfg, TS, TKey, torch.as_tensor,
             {"device": "cpu"})):
        cfg = cfg_cls(backend="jnp" if kw == {} else "torch", **cfg_kw)
        servers = [srv_mod.CachedEmbeddingServer(
            cfg=cfg, tower_fn=lambda p, f: f, miss_budget=8)
            for _ in range(3)]
        harness = regions_mod.DrainTestHarness(
            servers=servers,
            states=[srv_mod.init_server_state(cfg, writebuf_capacity=64,
                                              **kw) for _ in range(3)],
            params=None,
            router=regions_mod.RegionRouter(n_regions=3, locality=0.9,
                                            seed=1, sampler="hash"),
            limiter=rl.RegionalRateLimiter.uniform(range(3), 50.0),
            feature_fn=lambda ids, now: asarr(
                (np.asarray(ids)[:, None] % 7
                 * np.ones(DIM)).astype(np.float32)),
            key_fn=lambda ids: key_cls.from_int(ids, **kw), batch=8,
            flush_every_ms=500)
        out.append(harness.run(events, times, drain_region=2,
                               drain_window_ms=(20_000, 40_000),
                               bucket_ms=10_000))
    assert out[1] == out[0]


# ------------------------------------------------ on-device routing
ROUTE_CASES = [  # (R, drained, locality, epoch, event base)
    (1, [], 0.9, 0, 0),
    (2, [1], 0.9, 3, 100),
    (4, [], 0.9, 1, 2**32 - 37),
    (4, [0, 2], 0.5, 7, 2**32 - 5),
    (13, [3, 4, 12], 0.98, 2, 2**31 - 11),
    (13, [], 1.0, 0, 5),
]


@pytest.mark.parametrize("R,drained,locality,epoch,base", ROUTE_CASES)
def test_route_batch_matches_jax(R, drained, locality, epoch, base):
    """Several steps of routing from a half-assigned home table with
    duplicate uids in every batch (one step crossing the event index's
    2**32 wrap where the base lies near it): regions, the home table,
    re-homes and excursions equal JAX's, duplicates agree on their home."""
    rng = np.random.default_rng(R * 31 + epoch)
    U, Bq = 50, 24
    home0 = np.where(rng.uniform(size=U) < 0.5,
                     rng.integers(0, R, U), -1).astype(np.int32)
    mask = np.zeros(R, bool)
    mask[drained] = True
    jhome, thome = jnp.asarray(home0), torch.as_tensor(home0.copy())
    bases = TRG.event_bases(base, 3, Bq, device="cpu")
    assert_exact(bases, JRG.event_bases(base, 3, Bq))
    for step in range(3):
        uids = rng.integers(0, U, Bq).astype(np.int32)
        uids[-4:] = uids[:4]                       # duplicates
        jr, jhome, jre, jex = JRG.route_batch(
            jhome, jnp.asarray(uids), jnp.asarray(mask),
            jnp.int32(epoch + step), JRG.event_bases(base, 3, Bq)[step],
            locality=locality, seed=SEED)
        tr, thome, tre, tex = TRG.route_batch(
            thome, torch.as_tensor(uids), torch.as_tensor(mask),
            torch.tensor(epoch + step, dtype=torch.int32), bases[step],
            locality=locality, seed=SEED)
        assert_exact(tr, jr, f"regions step {step}")
        assert_exact(thome, jhome, f"home step {step}")
        assert int(tre) == int(jre) and int(tex) == int(jex)
        homes = thome.numpy()[uids]
        assert (homes[-4:] == homes[:4]).all()
        assert not mask[tr.numpy()].any()


def test_stage_drain_schedule_matches_jax():
    events = [(2, "drain", 1), (5, "drain", 0), (7, "undrain", 1)]
    j = JRG.stage_drain_schedule(10, 3, events)
    t = TRG.stage_drain_schedule(10, 3, events, device="cpu")
    for a, b in zip(t, j):
        assert_exact(a, b)
    with pytest.raises(t_regions.AllRegionsDrainedError):
        TRG.stage_drain_schedule(4, 2, [(1, "drain", 0), (2, "drain", 1)],
                                 device="cpu")
    for bad in ([(4, "drain", 0)], [(0, "drain", 2)], [(0, "flip", 0)]):
        msgs = []
        for stage, kw in ((JRG.stage_drain_schedule, {}),
                          (TRG.stage_drain_schedule, {"device": "cpu"})):
            with pytest.raises(ValueError) as exc:
                stage(4, 2, bad, **kw)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]
    for start in (0, 2**32 - 1000, 2**40 + 3):
        assert_exact(TRG.event_bases(start, 9, 256, device="cpu"),
                     JRG.event_bases(start, 9, 256))


# ---------------------------------------------------- RegionalServer
def model_cfgs(cfg_cls, backend):
    """Two models with different capacity, TTLs and eviction under the
    region axis (tests/test_region_parity.py's registry)."""
    return (
        cfg_cls(model_id=1, model_type="ctr", n_buckets=32, ways=4,
                value_dim=DIM, cache_ttl_ms=5 * MIN,
                failover_ttl_ms=20 * MIN, backend=backend),
        cfg_cls(model_id=2, model_type="cvr", n_buckets=16, ways=4,
                value_dim=DIM, cache_ttl_ms=3 * MIN,
                failover_ttl_ms=10 * MIN, eviction="lru", backend=backend),
    )


def stage_stream(n_steps, batch, n_users, n_models, seed=3):
    rng = np.random.default_rng(seed)
    uids = rng.integers(0, n_users, size=(n_steps, batch)).astype(np.int32)
    mslots = (uids % n_models).astype(np.int32)
    nows = (np.arange(n_steps) * 10_000).astype(np.int32)
    feats = (uids[..., None] * np.ones(DIM)).astype(np.float32)
    return uids, mslots, nows, feats


def _torch_server(n_regions, n_users, batch):
    return TRG.RegionalServer(cfgs=model_cfgs(TCfg, "torch"),
                              n_regions=n_regions, n_users=n_users,
                              tower_fn=lambda p, f: f @ p,
                              miss_budget=batch, locality=LOCALITY,
                              seed=SEED, device="cpu")


def test_regional_server_matches_jax():
    """``serve_many`` in two calls (the drain and the undrain inside them)
    against the reference's ``jit_serve_many``: counters (per-region
    vectors, ``rehomed``, ``excursions``), sources, ages, the home table,
    both tiers, both rings and the tokens."""
    n_regions, n_steps, batch, n_users = 4, 10, 12, 60
    uids, mslots, nows, feats = stage_stream(n_steps, batch, n_users, 2)
    events = [(3, "drain", 3), (7, "undrain", 3)]
    jsrv = JRG.RegionalServer(cfgs=model_cfgs(JCfg, "jnp"),
                              n_regions=n_regions, n_users=n_users,
                              tower_fn=lambda p, f: f @ p,
                              miss_budget=batch, locality=LOCALITY,
                              seed=SEED)
    tsrv = _torch_server(n_regions, n_users, batch)
    jst = jsrv.init_state(writebuf_capacity=256)
    tst = tsrv.init_state(writebuf_capacity=256)
    jdr, jep = JRG.stage_drain_schedule(n_steps, n_regions, events)
    tdr, tep = TRG.stage_drain_schedule(n_steps, n_regions, events,
                                        device="cpu")
    jeb = JRG.event_bases(2**32 - 50, n_steps, batch)
    teb = TRG.event_bases(2**32 - 50, n_steps, batch, device="cpu")
    for lo, hi in ((0, 5), (5, n_steps)):
        sl = slice(lo, hi)
        jst, jacc, jys = jsrv.jit_serve_many(
            jnp.eye(DIM), jst, uids[sl], mslots[sl], JKey.from_int(uids[sl]),
            jnp.asarray(feats[sl]), nows[sl], jdr[sl], jep[sl], jeb[sl])
        tst, tacc, tys = tsrv.jit_serve_many(
            torch.eye(DIM), tst, torch.as_tensor(uids[sl]),
            torch.as_tensor(mslots[sl]),
            TKey.from_int(uids[sl], device="cpu"), torch.as_tensor(feats[sl]),
            torch.as_tensor(nows[sl]), tdr[sl], tep[sl], teb[sl])
        jacc = jax.device_get(jacc)
        tacc = TS.fetch_counters(tacc)
        assert set(tacc) == set(jacc)
        for k, v in jacc.items():
            if np.asarray(v).dtype.kind == "f":
                np.testing.assert_allclose(tacc[k], v, rtol=1e-6, err_msg=k)
            else:
                assert_exact(np.asarray(tacc[k]), np.asarray(v), k)
        for a, b in zip(tys, jys):
            assert_exact(a, b)
    assert tacc["rehomed"] + tacc["excursions"] > 0
    assert_exact(tst.home, jst.home, "home")
    for name in ("direct", "failover"):
        assert_tree(getattr(tst.inner, name), getattr(jst.inner, name),
                    what=name)
    assert_tree(tst.inner.writebuf, jst.inner.writebuf, what="writebuf")
    assert_tree(tst.inner.touchbuf, jst.inner.touchbuf, what="touchbuf")
    img_t, img_j = TRG.cache_image(tst), JRG.cache_image(jst)
    assert set(img_t) == set(img_j)
    cold = TRG.with_cache_image(tsrv.init_state(writebuf_capacity=256),
                                img_t)
    assert cold.home is tst.home and cold.inner.direct is tst.inner.direct


def oracle_replay(n_regions, uids, mslots, nows, events):
    """Sequential ground truth: the numpy ``RegionRouter`` (hash sampler)
    routes one event at a time and R independent port
    ``MultiModelServer`` states serve each region's sub-batch."""
    cfgs = model_cfgs(TCfg, "torch")
    router = t_regions.RegionRouter(n_regions=n_regions, locality=LOCALITY,
                                    seed=SEED, sampler="hash")
    by_step = {}
    for step, op, reg in events:
        by_step.setdefault(step, []).append((op, reg))
    srv = TS.MultiModelServer(cfgs=cfgs, tower_fn=lambda p, f: f @ p,
                              miss_budget=uids.shape[1], device="cpu")
    states = [TS.init_multi_server_state(cfgs, writebuf_capacity=256,
                                         device="cpu")
              for _ in range(n_regions)]
    M = len(cfgs)
    counters = np.zeros((n_regions, M, 2), np.int64)   # requests, hits
    for s in range(uids.shape[0]):
        for op, reg in by_step.get(s, ()):
            getattr(router, op)(reg)
        regions = np.array([router.route(int(u)) for u in uids[s]])
        for r in range(n_regions):
            idx = np.flatnonzero(regions == r)
            if idx.size == 0:
                continue
            res = srv.serve_step(
                torch.eye(DIM), states[r], torch.as_tensor(mslots[s][idx]),
                TKey.from_int(uids[s][idx], device="cpu"),
                torch.as_tensor((uids[s][idx][:, None] * np.ones(DIM))
                                .astype(np.float32)), int(nows[s]))
            states[r] = srv.flush(res.state, int(nows[s]))
            counters[r, :, 0] += res.stats["per_model_requests"].numpy()
            counters[r, :, 1] += res.stats["per_model_direct_hits"].numpy()
    return router, states, counters


@pytest.mark.parametrize("n_regions", [2, 4, 13])
def test_regional_replay_bit_exact_vs_oracle(n_regions):
    """One ``serve_many`` with a mid-stream drain and undrain equals the
    sequential oracle: per-region per-model counters, every leaf of every
    region's slabs in both tiers, and the home table."""
    n_steps, batch, n_users = 10, 12, 60
    uids, mslots, nows, feats = stage_stream(n_steps, batch, n_users, 2)
    drain_reg = n_regions - 1
    events = [(3, "drain", drain_reg), (7, "undrain", drain_reg)]
    srv = _torch_server(n_regions, n_users, batch)
    drained, epoch = TRG.stage_drain_schedule(n_steps, n_regions, events,
                                              device="cpu")
    ebase = TRG.event_bases(0, n_steps, batch, device="cpu")
    final, acc, _ = srv.serve_many(
        torch.eye(DIM), srv.init_state(writebuf_capacity=256),
        torch.as_tensor(uids), torch.as_tensor(mslots),
        TKey.from_int(uids, device="cpu"), torch.as_tensor(feats),
        torch.as_tensor(nows), drained, epoch, ebase)
    acc = TS.fetch_counters(acc)
    router, states, oc = oracle_replay(n_regions, uids, mslots, nows, events)
    M = 2
    np.testing.assert_array_equal(
        np.reshape(acc["per_model_requests"], (n_regions, M)), oc[:, :, 0])
    np.testing.assert_array_equal(
        np.reshape(acc["per_model_direct_hits"], (n_regions, M)),
        oc[:, :, 1])
    for r in range(n_regions):
        for m, cfg in enumerate(model_cfgs(TCfg, "torch")):
            for tier, nb in (("direct", cfg.n_buckets),
                             ("failover", cfg.resolved_failover_n_buckets())):
                got = getattr(final.inner, tier).model_view(r * M + m, nb)
                want = getattr(states[r], tier).model_view(m, nb)
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (r, m, tier)
    home = np.full((n_users,), -1, np.int32)
    for uid, h in router._home.items():
        home[uid] = h
    np.testing.assert_array_equal(final.home.numpy(), home)


def test_regional_step_path_matches_many_path():
    """``jit_serve_step`` + ``jit_flush`` step by step equal one
    ``serve_many`` call in every state tensor."""
    n_regions, n_steps, batch, n_users = 4, 8, 10, 40
    uids, mslots, nows, feats = stage_stream(n_steps, batch, n_users, 2,
                                             seed=9)
    drained, epoch = TRG.stage_drain_schedule(
        n_steps, n_regions, [(2, "drain", 0), (6, "undrain", 0)],
        device="cpu")
    ebase = TRG.event_bases(0, n_steps, batch, device="cpu")
    srv = _torch_server(n_regions, n_users, batch)
    t = torch.as_tensor
    keys = TKey.from_int(uids, device="cpu")
    many, acc, _ = srv.serve_many(
        torch.eye(DIM), srv.init_state(writebuf_capacity=256), t(uids),
        t(mslots), keys, t(feats), t(nows), drained, epoch, ebase)
    step = srv.init_state(writebuf_capacity=256)
    req = 0
    for s in range(n_steps):
        res = srv.jit_serve_step(
            torch.eye(DIM), step, t(uids[s]), t(mslots[s]),
            TKey(keys.hi[s], keys.lo[s]), t(feats[s]), int(nows[s]),
            drained[s], epoch[s], ebase[s])
        step = srv.jit_flush(res.state, int(nows[s]))
        req += int(res.stats["requests"])
    assert req == TS.fetch_counters(acc)["requests"]
    for a, b in zip(tensors_of(many), tensors_of(step)):
        assert torch.equal(a, b)


# ------------------------------------------------------------- launcher
def test_run_serving_regional_matches_jax():
    """``--regions 4 --drain`` end to end at a small size (SMOKE SASRec):
    every counter, the hit-rate curve, per-region load, re-homes,
    excursions and the drain window equal the JAX launcher's; the drained
    region serves nothing in its window."""
    common = dict(arch="sasrec", n_regions=4, minutes=20, users=300,
                  batch=32, chunk_steps=4, drain=True, n_buckets=64,
                  log=lambda *_: None)
    want = j_launch.run_serving_regional(backend="jnp", **common)
    got = t_launch.run_serving_regional(backend="torch", device="cpu",
                                        **common)
    skip = {"wall_s", "req_per_s", "step_ms", "device"}
    assert set(want) - skip <= set(got)
    for k in set(want) - skip:
        assert got[k] == want[k], k
    assert got["drained_load_during_drain"] == 0
    assert got["rehomed"] > 0 and got["excursions"] > 0
    assert got["hit_rate_drain"] is not None


REGION_REFUSED = [["--regions", "2", "--overload"],
                  ["--regions", "2", "--multi"],
                  ["--regions", "2", "--no-cache"],
                  ["--regions", "2", "--coalesce"],
                  ["--regions", "0"], ["--drain"]]


@pytest.mark.parametrize("args", REGION_REFUSED,
                         ids=[" ".join(a) for a in REGION_REFUSED])
def test_regions_cli_refuses_what_the_reference_refuses(args, capsys,
                                                        monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    with pytest.raises(SystemExit) as ref_exit:
        j_launch.main()
    ref_err = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as exc:
        t_launch.main(args)
    err = capsys.readouterr().err.splitlines()[-1]
    assert exc.value.code == ref_exit.value.code == 2
    flag = "--drain" if args == ["--drain"] else "--regions"
    assert flag in err and flag in ref_err


@pytest.mark.parametrize("entry", ["stage_drain_schedule", "event_bases",
                                   "regional_server", "run_serving_regional"])
def test_regional_entry_points_default_to_the_card(entry):
    """Without a card the regional entry points' default device raises;
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA card is present")
    calls = {
        "stage_drain_schedule": lambda: TRG.stage_drain_schedule(4, 2),
        "event_bases": lambda: TRG.event_bases(0, 4, 8),
        "regional_server": lambda: TRG.RegionalServer(
            cfgs=model_cfgs(TCfg, "torch"), n_regions=2, n_users=8,
            tower_fn=lambda p, f: f, miss_budget=4),
        "run_serving_regional": lambda: t_launch.run_serving_regional(
            minutes=1, users=10, log=lambda *_: None),
    }
    with pytest.raises((RuntimeError, AssertionError)):
        calls[entry]()
