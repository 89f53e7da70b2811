"""repro_torch's multi-model tier against the JAX package, on the CPU: the
registry configs, the policy table, the stacked tiers' probe, insert plan
and flush, ``MultiModelServer.serve_many`` across an option sweep, and the
``--multi`` launcher.

The same numpy-seeded inputs go through both packages; the JAX multi-model
probe kernel runs in Pallas interpret mode (as the JAX tests run it here).
Integer outputs (hit, way, age, bucket, sources, counters including every
per-model vector) and every cache-plane leaf must match bit for bit;
embeddings and the values cached from the tower at atol 2e-5 / rtol 1e-4;
the float32 stat sums at rtol 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (SUM_RTOL, assert_exact, assert_float,  # noqa: E402
                           assert_tree, to_torch)
from repro.core import cache as JC  # noqa: E402
from repro.core import config as JCF  # noqa: E402
from repro.core import server as JS  # noqa: E402
from repro.core import writebuf as JW  # noqa: E402
from repro.core.hashing import Key64 as JKey  # noqa: E402
from repro.launch import serve as j_launch  # noqa: E402
from repro_torch.core import cache as TC  # noqa: E402
from repro_torch.core import config as TCF  # noqa: E402
from repro_torch.core import server as TS  # noqa: E402
from repro_torch.core import writebuf as TW  # noqa: E402
from repro_torch.core.hashing import Key64 as TKey  # noqa: E402
from repro_torch.core.metrics import ServingCounters  # noqa: E402
from repro_torch.kernels import cache_probe as tpk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402
from test_torch_server import _linear_tower, _sasrec_tower  # noqa: E402

MIN = 60_000
DIM = 8
S, B, MISS_BUDGET = 8, 24, 12


def jkeys(ids):
    return JKey.from_int(np.asarray(ids, np.int64))


def tkeys(ids):
    return TKey.from_int(np.asarray(ids, np.int64), device="cpu")


def tier_kw(fo_nb=None, fo_ways=None):
    """The four models of tests/test_multi_model.py: different capacity,
    TTLs and eviction policies (optionally one failover size for all)."""
    rows = [(10, "ctr", 32, 1, 10, "ttl"), (11, "cvr", 64, 5, 20, "lru"),
            (12, "ctr", 16, 2, 10, "ttl"), (13, "cvr", 32, 3, 15, "lru")]
    return [dict(model_id=mid, model_type=mt, n_buckets=nb, ways=4,
                 value_dim=DIM, cache_ttl_ms=ttl * MIN,
                 failover_ttl_ms=fo * MIN, eviction=ev,
                 failover_n_buckets=fo_nb, failover_ways=fo_ways)
            for mid, mt, nb, ttl, fo, ev in rows]


def both_cfgs(kws):
    return ([JCF.CacheConfig(backend="jnp", **kw) for kw in kws],
            [TCF.CacheConfig(backend="torch", **kw) for kw in kws])


def both_tiers(jcfgs):
    """Empty JAX stacks and their torch twins on the CPU."""
    jd = JC.init_multi_cache([c.n_buckets for c in jcfgs],
                             max(c.ways for c in jcfgs), DIM)
    jf = JC.init_multi_cache([c.resolved_failover_n_buckets()
                              for c in jcfgs],
                             max(c.resolved_failover_ways() for c in jcfgs),
                             DIM)
    return jd, jf, TC.MultiCacheState(*to_torch(jd)), \
        TC.MultiCacheState(*to_torch(jf))


# ------------------------------------------------------------- configs
def test_registry_configs_match_jax():
    """paper_production_configs and multi_model_tier_configs field for
    field (the backend default is each package's own), and the registry's
    id / type / enable lookup."""
    skip = {"backend"}
    fields = [f.name for f in dataclasses.fields(JCF.CacheConfig)
              if f.name not in skip]
    jp, tp = JCF.paper_production_configs(), TCF.paper_production_configs()
    assert list(tp) == list(jp)
    for name in jp:
        assert tp[name].stage == jp[name].stage
        for f in fields:
            assert getattr(tp[name].cache, f) == getattr(jp[name].cache, f)
    for kw in (dict(), dict(value_dim=50, n_buckets=1 << 18),
               dict(value_dim=16, n_buckets=64, ways=4,
                    failover_n_buckets=32)):
        jt, tt = (JCF.multi_model_tier_configs(**kw),
                  TCF.multi_model_tier_configs(**kw))
        assert len(tt) == len(jt) == 8
        for a, b in zip(tt, jt):
            for f in fields:
                assert getattr(a, f) == getattr(b, f), f
    reg = TCF.CacheConfigRegistry()
    cfgs = TCF.multi_model_tier_configs()
    reg.register(cfgs[0])
    reg.register_type(dataclasses.replace(cfgs[1], model_id=99))
    reg.register(dataclasses.replace(cfgs[2], enable_flag=False))
    assert reg.get(10) is cfgs[0]
    assert reg.get(55, cfgs[1].model_type).model_id == 99
    assert reg.get(55) is None and reg.get(12) is None


@pytest.mark.parametrize("fo_nb", [None, 16])
def test_policy_from_configs_matches_jax(fo_nb):
    """Every field of the policy table equals JAX's, and the mask
    aliasing marker (one tensor for both masks) is kept exactly when
    JAX keeps it, also through the admission probe policy's _replace."""
    kws = tier_kw(fo_nb=fo_nb)
    kws[1].update(infer_budget_per_step=2.5, failover_ttl_relax=40 * MIN)
    kws[2].update(infer_budget_per_step=0.75, coalesce_misses=True)
    kws[3].update(touch=False)
    jcfgs, tcfgs = both_cfgs(kws)
    jp = JC.policy_from_configs(jcfgs)
    tp = TC.policy_from_configs(tcfgs, device="cpu")
    assert tp._fields == jp._fields
    assert_tree(tp, jp, what="policy")
    assert_exact(tp.table(), jp.table(), "table")
    aliased = jp.bucket_mask_f is jp.bucket_mask_d
    assert aliased == (fo_nb is None)
    assert (tp.bucket_mask_f is tp.bucket_mask_d) == aliased
    srv = TS.MultiModelServer(cfgs=tuple(tcfgs), tower_fn=None,
                              miss_budget=4, device="cpu")
    pp = srv._probe_policy
    assert (pp.bucket_mask_f is pp.bucket_mask_d) == aliased
    assert_exact(pp.failover_ttl_ms, jp.failover_relax_ttl_ms)
    assert srv.backend == "torch" and srv.n_models == 4


# --------------------------------------------------------------- probes
def _populate(rng, jcfgs, jd, jf, n=60):
    policy = JC.policy_from_configs(jcfgs)
    ids = rng.integers(0, 40, n)
    slots = jnp.asarray(rng.integers(0, len(jcfgs), n), jnp.int32)
    vals = jnp.asarray(rng.standard_normal((n, DIM)), jnp.float32)
    ts = jnp.asarray(rng.integers(0, MIN, n), jnp.int32)
    jd, jf = JC.insert_dual_multi(jd, jf, policy, slots, jkeys(ids), vals,
                                  MIN, ts_ms=ts)
    return policy, jd, jf, ids


@pytest.mark.parametrize("fo_nb,now", [(None, 90_000), (16, 150_000),
                                       (128, 200_000)])
def test_lookup_dual_multi_matches_jax_kernel_and_jnp(fo_nb, now, rng):
    """Port lookup_dual_multi (torch backend) == JAX jnp == JAX Pallas
    dual-multi kernel (interpret): hit, value, age, way and the pooled
    bucket bit for bit, across models whose TTLs differ; the kernel
    wrapper on CPU tensors runs the same plain version and launches
    nothing."""
    jcfgs, tcfgs = both_cfgs(tier_kw(fo_nb=fo_nb))
    jd, jf, _, _ = both_tiers(jcfgs)
    jpol, jd, jf, ids = _populate(rng, jcfgs, jd, jf)
    td, tf = TC.MultiCacheState(*to_torch(jd)), \
        TC.MultiCacheState(*to_torch(jf))
    tpol = TC.policy_from_configs(tcfgs, device="cpu")
    q = rng.choice(np.concatenate([ids, np.arange(85) + 10 ** 6]), 85)
    slots = rng.integers(0, 4, 85).astype(np.int32)
    want_j = JC.lookup_dual_multi(jd, jf, jpol, jnp.asarray(slots),
                                  jkeys(q), now, backend="jnp")
    want_k = JC.lookup_dual_multi(jd, jf, jpol, jnp.asarray(slots),
                                  jkeys(q), now, backend="pallas")
    n0 = dict(tpk.LAUNCHES)
    got = TC.lookup_dual_multi(td, tf, tpol, torch.as_tensor(slots),
                               tkeys(q), now, backend="torch")
    for g, wj, wk, name in zip(got, want_j, want_k, ("direct", "failover")):
        assert_tree(g, wj, what=f"{name} vs jnp")
        assert_tree(g, wk, what=f"{name} vs pallas")
    fd, ff = td.flat(), tf.flat()
    plain = tpk.cache_probe_dual_multi(
        *fd[:4], *ff[:4], tkeys(q).hi, tkeys(q).lo, torch.as_tensor(slots),
        got[0].bucket, got[1].bucket, tpol.table(), now)
    assert tpk.LAUNCHES == n0
    for g_half, w in zip(plain, want_k):
        for g, wv in zip(g_half, (w.hit, w.values, w.age_ms, w.way)):
            assert_exact(g, wv)
    # the per-model TTLs differentiate, and every case is present
    assert bool(got[0].hit.any()) and not bool(got[0].hit.all())
    assert bool((~got[0].hit & got[1].hit).any())


def test_dual_multi_ref_is_per_query_probe(rng):
    """The plain version of the new kernel equals cache_probe_ref with
    the per-query TTL columns gathered by hand, for a strict table and a
    relaxed failover column holding NO_TTL_MS (at a clock where every
    strict failover TTL has run out)."""
    jcfgs, tcfgs = both_cfgs(tier_kw())
    jd, jf, _, _ = both_tiers(jcfgs)
    _, jd, jf, ids = _populate(rng, jcfgs, jd, jf, n=80)
    td, tf = TC.MultiCacheState(*to_torch(jd)), \
        TC.MultiCacheState(*to_torch(jf))
    pol = TC.policy_from_configs(tcfgs, device="cpu")
    relaxed = pol.table().clone()
    relaxed[:, 1] = TCF.NO_TTL_MS
    k = tkeys(rng.choice(ids, 50))
    slots = torch.as_tensor(rng.integers(0, 4, 50).astype(np.int32))
    bd, bf = TC._pooled_bucket_pair(td, tf, pol, slots, k)
    now = 30 * MIN
    fo_hits = []
    for table in (pol.table(), relaxed):
        got = ref.cache_probe_dual_multi_ref(
            *td.flat()[:4], *tf.flat()[:4], k.hi, k.lo, slots, bd, bf,
            table, now)
        fo_hits.append(int(got[1][0].sum()))
        for col, (g_half, st, b) in enumerate(zip(
                got, (td.flat(), tf.flat()), (bd, bf))):
            ttl = [int(table[int(s), col]) for s in slots]
            for i in range(50):
                one = ref.cache_probe_ref(*st[:4], k.hi[i:i + 1],
                                          k.lo[i:i + 1], b[i:i + 1],
                                          now, ttl[i])
                for g, w in zip(g_half, one):
                    assert torch.equal(g[i:i + 1], w)
    assert fo_hits[0] == 0 < fo_hits[1]     # NO_TTL_MS serves stale rows


# --------------------------------------------------------------- inserts
@pytest.mark.parametrize("fo_nb,fo_ways", [(None, None), (16, 2),
                                           (64, None)])
def test_insert_dual_multi_sequences_match_jax(fo_nb, fo_ways, rng):
    """Random mixed-model insert rounds (duplicates within and across
    models, masks, per-entry timestamps, LRU models beside TTL models,
    touches between rounds) leave all five planes of both stacks equal to
    JAX's; the tables are updated in place through the pooled views.
    ``fo_nb=64`` gives both stacks one pooled size under different masks,
    where reusing the direct ranks would be wrong."""
    jcfgs, tcfgs = both_cfgs(tier_kw(fo_nb=fo_nb, fo_ways=fo_ways))
    jd, jf, td, tf = both_tiers(jcfgs)
    jpol = JC.policy_from_configs(jcfgs)
    tpol = TC.policy_from_configs(tcfgs, device="cpu")
    ptrs = [t.data_ptr() for t in td]
    j_ins = jax.jit(JC.insert_dual_multi)
    n = 32
    for step in range(10):
        ids = rng.integers(0, 50, n)
        ids[:4] = 7                               # one user, four models
        slots = rng.integers(0, 4, n).astype(np.int32)
        slots[:4] = np.arange(4)
        vals = rng.standard_normal((n, DIM)).astype(np.float32)
        mask = rng.uniform(size=n) < 0.9
        now = step * MIN // 2
        ts = (now - rng.integers(0, MIN, n)).astype(np.int32)
        jd, jf = j_ins(jd, jf, jpol, jnp.asarray(slots), jkeys(ids),
                       jnp.asarray(vals), now, write_mask=jnp.asarray(mask),
                       ts_ms=jnp.asarray(ts))
        out = TC.insert_dual_multi(td, tf, tpol, torch.as_tensor(slots),
                                   tkeys(ids), torch.as_tensor(vals), now,
                                   write_mask=torch.as_tensor(mask),
                                   ts_ms=torch.as_tensor(ts))
        assert out[0] is td and out[1] is tf
        if step % 3 == 2:                         # touch the LRU planes
            q = rng.integers(0, 50, 20)
            qs = jnp.asarray(rng.integers(0, 4, 20), jnp.int32)
            wd, wf = JC.lookup_dual_multi(jd, jf, jpol, qs, jkeys(q), now)
            gd, gf = TC.lookup_dual_multi(td, tf, tpol,
                                          torch.as_tensor(np.asarray(qs)),
                                          tkeys(q), now, backend="torch")
            assert_tree(gd, wd, what=f"step {step} probe")
            fd, ff = jd.flat(), jf.flat()
            jd = jd.with_flat(JC.touch(fd, wd.bucket, wd.way, now + 3))
            jf = jf.with_flat(JC.touch(ff, wf.bucket, wf.way, now + 5))
            TC.touch(td.flat(), gd.bucket, gd.way, now + 3)
            TC.touch(tf.flat(), gf.bucket, gf.way, now + 5)
        assert_tree(td, jd, what=f"step {step} direct")
        assert_tree(tf, jf, what=f"step {step} failover")
    assert [t.data_ptr() for t in td] == ptrs
    # the same user was written into every model's slab
    seven = (td.key_lo == 7) & (td.key_hi == 0)
    assert bool(seven.flatten(1).any(dim=1).all())


def test_insert_dual_rank_reuse_follows_object_identity(rng):
    """insert_dual reuses the direct ranks only for ONE buckets tensor
    passed twice (the aliased-mask path); equal VALUES in two tensors
    re-rank, with the same result, and differing pooled masks give two
    tensors."""
    jcfgs, tcfgs = both_cfgs(tier_kw())
    pol = TC.policy_from_configs(tcfgs, device="cpu")
    _, _, td, tf = both_tiers(jcfgs)
    k = tkeys(rng.integers(0, 99, 30))
    slots = torch.as_tensor(rng.integers(0, 4, 30).astype(np.int32))
    bd, bf = TC._pooled_bucket_pair(td, tf, pol, slots, k)
    assert bd is bf
    _, _, td2, tf2 = both_tiers(both_cfgs(tier_kw(fo_nb=16))[0])
    pol2 = TC.policy_from_configs(both_cfgs(tier_kw(fo_nb=16))[1],
                                  device="cpu")
    bd2, bf2 = TC._pooled_bucket_pair(td2, tf2, pol2, slots, k)
    assert bd2 is not bf2
    vals = torch.as_tensor(rng.standard_normal((30, DIM)), dtype=torch.float32)
    a = [TC.MultiCacheState(*(t.clone() for t in x)) for x in (td, tf)]
    b = [TC.MultiCacheState(*(t.clone() for t in x)) for x in (td, tf)]
    s = slots.long()
    for (d, f), (b_d, b_f) in ((a, (bd, bd)), (b, (bd, bd.clone()))):
        TC.insert_dual(d.flat(), f.flat(), k, vals, MIN, pol.ttl_ms[s],
                       pol.failover_ttl_ms[s], evict_lru=pol.evict_lru[s],
                       buckets_d=b_d, buckets_f=b_f, dedupe_salt=slots)
    for x, y in zip(a, b):
        for p, q in zip(x, y):
            assert torch.equal(p, q)


# ----------------------------------------------------------------- rings
def test_flush_dual_multi_with_touches_matches_jax(rng):
    """Model-tagged ring appends (compacted like the keys) and
    flush_dual_multi with a touch ring of POOLED coordinates equal JAX's
    on every leaf of both stacks and both rings; the flush is in place."""
    jcfgs, tcfgs = both_cfgs(tier_kw(fo_nb=16, fo_ways=2))
    jd, jf, _, _ = both_tiers(jcfgs)
    jpol, jd, jf, ids = _populate(rng, jcfgs, jd, jf, n=80)
    tpol = TC.policy_from_configs(tcfgs, device="cpu")
    jb, tb = JW.init_writebuf(32, DIM), TW.init_writebuf(32, DIM,
                                                          device="cpu")
    jt, tt = JW.init_touchbuf(32), TW.init_touchbuf(32, device="cpu")
    for r in range(3):
        n = 14
        k = rng.integers(0, 60, n)
        slots = rng.integers(0, 4, n).astype(np.int32)
        vals = rng.standard_normal((n, DIM)).astype(np.float32)
        mask = rng.uniform(size=n) < 0.8
        jb = JW.append(jb, jkeys(k), jnp.asarray(vals), MIN + r,
                       mask=jnp.asarray(mask), model_ids=jnp.asarray(slots))
        TW.append(tb, tkeys(k), torch.as_tensor(vals), MIN + r,
                  mask=torch.as_tensor(mask),
                  model_ids=torch.as_tensor(slots))
        assert_tree(tb, jb, what=f"writebuf round {r}")
        # reads of other records than the ring's (a ring write resets
        # its slot's recency)
        q = rng.choice(ids, n)
        qs = jnp.asarray(rng.integers(0, 4, n), jnp.int32)
        wd, wf = JC.lookup_dual_multi(jd, jf, jpol, qs, jkeys(q), 2 * MIN)
        jt = JW.touch_append(jt, wd, wf, 2 * MIN + r, mask=jpol.touch[qs])
    td, tf = TC.MultiCacheState(*to_torch(jd)), \
        TC.MultiCacheState(*to_torch(jf))
    tt = TW.TouchBuffer(*to_torch(jt))
    ptrs = [t.data_ptr() for t in td]
    want = JW.flush_dual_multi(jb, jd, jf, jpol, 3 * MIN, touchbuf=jt)
    got = TW.flush_dual_multi(tb, td, tf, tpol, 3 * MIN, touchbuf=tt)
    for g, w, name in zip(got, want, ("direct", "failover", "writebuf",
                                      "touchbuf")):
        assert_tree(g, w, what=name)
    assert got[0] is td and [t.data_ptr() for t in td] == ptrs
    assert int(got[2].count) == 0 and int(got[3].count) == 0
    assert bool((td.last_access_ts > 2 * MIN).any())


# ------------------------------------------------------------ serve sweep
def _stream(rng, feat_of):
    """An (S, B) mixed-model stream over a small skewed user pool: the same
    user for several models, re-accesses across the TTLs, 10% inference
    failures."""
    pool = np.arange(40, dtype=np.int64) * 7919 + 11
    p = 1.0 / np.arange(1, 41) ** 1.1
    ids = rng.choice(pool, size=(S, B), p=p / p.sum())
    slots = rng.integers(0, 4, (S, B)).astype(np.int32)
    nows = (np.arange(S) * 25_000 + 1000).astype(np.int32)
    fails = rng.uniform(size=(S, B)) < 0.1
    return ids, slots, feat_of(ids), nows, fails


SWEEP = [  # (tower, flush_every, coalesce, admission, fo_nb)
    ("linear", 1, False, False, None),
    ("linear", 0, True, False, 16),
    ("linear", 3, False, True, None),
    ("linear", 1, True, True, 16),
    ("linear", 3, True, False, None),
    ("sasrec", 1, True, True, None),
]


@pytest.mark.parametrize("tower,flush_every,coalesce,admission,fo_nb",
                         SWEEP)
def test_multi_serve_many_matches_jax(tower, flush_every, coalesce,
                                      admission, fo_nb):
    """Two serve_many calls (the second continuing the first's state) of
    both packages' MultiModelServer: sources, ages and every counter
    (per-model vectors included) exact, float sums at SUM_RTOL,
    embeddings and cached values at the tower tolerance, final planes,
    rings and tokens equal."""
    case = SWEEP.index((tower, flush_every, coalesce, admission, fo_nb))
    rng = np.random.default_rng(100 + case)
    dim, jparams, jtower, tparams, ttower, feat_of = (
        _linear_tower(rng, DIM) if tower == "linear" else _sasrec_tower(rng))
    kws = tier_kw(fo_nb=fo_nb)
    for m, kw in enumerate(kws):
        kw["value_dim"] = dim
        if coalesce and m != 2:
            kw["coalesce_misses"] = True
        if admission and m in (0, 1):
            kw["infer_budget_per_step"] = 2.5 if m == 0 else 1.25
            kw["failover_ttl_relax"] = None if m == 0 else 30 * MIN
    jcfgs, tcfgs = both_cfgs(kws)
    jsrv = JS.MultiModelServer(cfgs=tuple(jcfgs), tower_fn=jtower,
                               miss_budget=MISS_BUDGET)
    tsrv = TS.MultiModelServer(cfgs=tuple(tcfgs), tower_fn=ttower,
                               miss_budget=MISS_BUDGET, device="cpu")
    jstate = JS.init_multi_server_state(jcfgs, writebuf_capacity=64)
    tstate = TS.init_multi_server_state(tcfgs, writebuf_capacity=64,
                                        device="cpu")
    ids, slots, feats, nows, fails = _stream(rng, feat_of)
    for lo, hi in ((0, 5), (5, S)):
        jstate, jacc, jys = jsrv.jit_serve_many(
            jparams, jstate, jnp.asarray(slots[lo:hi]), jkeys(ids[lo:hi]),
            {k: jnp.asarray(v[lo:hi]) for k, v in feats.items()},
            jnp.asarray(nows[lo:hi]), jnp.asarray(fails[lo:hi]),
            flush_every=flush_every)
        tstate, tacc, tys = tsrv.serve_many(
            tparams, tstate, torch.as_tensor(slots[lo:hi]),
            tkeys(ids[lo:hi]),
            {k: torch.as_tensor(v[lo:hi]) for k, v in feats.items()},
            torch.as_tensor(nows[lo:hi]), torch.as_tensor(fails[lo:hi]),
            flush_every=flush_every)
        assert_float(tys[0], jys[0], "embeddings")
        assert_exact(tys[1], jys[1], "source")
        assert_exact(tys[2], jys[2], "age")
        jacc = jax.device_get(jacc)
        tacc = TS.fetch_counters(tacc)
        assert set(tacc) == set(jacc)
        for k, v in jacc.items():
            if k in TS._ACC_F32 + TS._ACC_PM_F32:
                np.testing.assert_allclose(tacc[k], v, rtol=SUM_RTOL,
                                           err_msg=k)
            else:
                assert_exact(np.asarray(tacc[k]), np.asarray(v), k)
        assert sum(tacc["per_model_requests"]) == tacc["requests"]
    for name in ("direct", "failover"):
        assert_tree(getattr(tstate, name), getattr(jstate, name),
                    float_fields=("values",), what=name)
    assert_tree(tstate.writebuf, jstate.writebuf, float_fields=("values",),
                what="writebuf")
    assert_tree(tstate.touchbuf, jstate.touchbuf, what="touchbuf")
    assert_exact(tstate.budget.tokens, jstate.budget.tokens, "tokens")
    src = tys[1].numpy()
    assert (src == TS.SRC_DIRECT).any() and (src != TS.SRC_DIRECT).any()
    if admission:
        assert tacc["deferred"] > 0


def test_multi_serve_step_matches_jax_and_never_writes_tables(rng):
    """One mixed-model step at a time: outputs and every stat (the
    per-model means too) equal JAX's, the step leaves the tables
    untouched and appends to the rings in place."""
    dim, jparams, jtower, tparams, ttower, feat_of = _linear_tower(rng, DIM)
    jcfgs, tcfgs = both_cfgs(tier_kw())
    jsrv = JS.MultiModelServer(cfgs=tuple(jcfgs), tower_fn=jtower,
                               miss_budget=MISS_BUDGET)
    tsrv = TS.MultiModelServer(cfgs=tuple(tcfgs), tower_fn=ttower,
                               miss_budget=MISS_BUDGET, device="cpu")
    jstate = JS.init_multi_server_state(jcfgs, writebuf_capacity=32)
    tstate = TS.init_multi_server_state(tcfgs, writebuf_capacity=32,
                                        device="cpu")
    ids, slots, feats, nows, fails = _stream(rng, feat_of)
    for s in range(3):
        jres = jsrv.serve_step(jparams, jstate, jnp.asarray(slots[s]),
                               jkeys(ids[s]), {"x": jnp.asarray(
                                   feats["x"][s])}, int(nows[s]),
                               jnp.asarray(fails[s]))
        before = [t.clone() for t in tstate.direct]
        tres = tsrv.serve_step(tparams, tstate, torch.as_tensor(slots[s]),
                               tkeys(ids[s]),
                               {"x": torch.as_tensor(feats["x"][s])},
                               int(nows[s]), torch.as_tensor(fails[s]))
        for b, a in zip(before, tres.state.direct):
            assert torch.equal(b, a)
        assert tres.state.writebuf is tstate.writebuf
        assert_float(tres.embeddings, jres.embeddings)
        assert_exact(tres.source, jres.source)
        assert_exact(tres.age_ms, jres.age_ms)
        assert set(tres.stats) == set(jres.stats)
        for k, v in jres.stats.items():
            if np.asarray(v).dtype == np.float32:
                np.testing.assert_allclose(tres.stats[k].numpy(), v,
                                           rtol=SUM_RTOL, err_msg=k)
            else:
                assert_exact(tres.stats[k], v, k)
        jstate = jsrv.flush(jres.state, int(nows[s]))
        tstate = tsrv.flush(tres.state, int(nows[s]))
    assert_tree(tstate.direct, jstate.direct, float_fields=("values",))


def test_run_serving_multi_counters_match_jax():
    """The --multi launcher end to end (SMOKE SASRec, 5% failures, one
    chunk boundary mid-stream): every counter and the per-model report
    equal the JAX launcher's on the same stream (the towers' random
    weights differ, and no counter depends on them)."""
    common = dict(arch="sasrec", minutes=10, users=200, batch=64,
                  failure_rate=0.05, chunk_steps=6, n_buckets=64,
                  log=lambda *_: None)
    want = j_launch.run_serving_multi(backend="jnp", **common)
    got = t_launch.run_serving_multi(backend="torch", device="cpu",
                                     **common)
    for k in dataclasses.fields(ServingCounters):
        assert got[k.name] == want[k.name], k.name
    assert got["per_model"] == want["per_model"]
    assert got["batches"] == want["batches"] and got["n_models"] == 8
    assert got["requests"] > 0 and got["direct_hits"] > 0


@pytest.mark.parametrize("flags", [["--no-cache"], ["--ttl-min", "5"],
                                   ["--eviction", "lru"]],
                         ids=["no-cache", "ttl-min", "eviction"])
def test_multi_cli_refuses_flags_the_registry_owns(flags, capsys):
    """--multi refuses what the per-model registry decides (TTLs,
    eviction) and the cache-off baseline it has none of, before it
    touches a device."""
    with pytest.raises(SystemExit) as exc:
        t_launch.main(["--multi", *flags])
    assert exc.value.code == 2
    assert "--multi" in capsys.readouterr().err


def test_multi_model_bare_tensor_features_match_jax(rng):
    """A tower that takes a bare (B, dim) tensor behind the multi-model
    tier: sources, ages and every counter equal the JAX tier's (the
    reference gathers features with ``tree_map``)."""
    w = (rng.standard_normal((DIM, DIM)) / np.sqrt(DIM)).astype(np.float32)
    jcfgs, tcfgs = both_cfgs(tier_kw())
    tower = lambda p, x: x @ p
    jsrv = JS.MultiModelServer(cfgs=tuple(jcfgs), tower_fn=tower,
                               miss_budget=MISS_BUDGET)
    tsrv = TS.MultiModelServer(cfgs=tuple(tcfgs), tower_fn=tower,
                               miss_budget=MISS_BUDGET, device="cpu")
    jstate = JS.init_multi_server_state(jcfgs, writebuf_capacity=64)
    tstate = TS.init_multi_server_state(tcfgs, writebuf_capacity=64,
                                        device="cpu")
    ids, slots, _, nows, fails = _stream(rng, lambda i: None)
    x = np.cos(ids[..., None] * (np.arange(DIM) + 1) * 1e-3).astype(
        np.float32)
    jstate, jacc, jys = jsrv.jit_serve_many(
        jnp.asarray(w), jstate, jnp.asarray(slots), jkeys(ids),
        jnp.asarray(x), jnp.asarray(nows), jnp.asarray(fails))
    tstate, tacc, tys = tsrv.serve_many(
        torch.as_tensor(w), tstate, torch.as_tensor(slots), tkeys(ids),
        torch.as_tensor(x), torch.as_tensor(nows), torch.as_tensor(fails))
    assert_exact(tys[1], jys[1], "source")
    assert_exact(tys[2], jys[2], "age")
    assert_float(tys[0], jys[0], "embeddings")
    jacc = jax.device_get(jacc)
    tacc = TS.fetch_counters(tacc)
    for k, v in jacc.items():
        if k in TS._ACC_F32 + TS._ACC_PM_F32:
            np.testing.assert_allclose(tacc[k], v, rtol=SUM_RTOL, err_msg=k)
        else:
            assert_exact(np.asarray(tacc[k]), np.asarray(v), k)
