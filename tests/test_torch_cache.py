"""repro_torch's hashing, cache tables and write/touch rings against the
JAX package, on the CPU.

The same numpy-seeded inputs go through both packages; the JAX probe
kernels run in Pallas interpret mode (as the JAX tests run them here).
Every integer output, every probe value and every cache-plane leaf must
match bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_exact, assert_tree, to_torch  # noqa: E402
from repro.core import cache as JC  # noqa: E402
from repro.core import hashing as JH  # noqa: E402
from repro.core import writebuf as JW  # noqa: E402
from repro_torch.core import cache as TC  # noqa: E402
from repro_torch.core import hashing as TH  # noqa: E402
from repro_torch.core import writebuf as TW  # noqa: E402
from repro_torch.kernels import cache_probe as tpk  # noqa: E402

MIN = 60_000
DIM = 8


def jkeys(ids):
    return JH.Key64.from_int(np.asarray(ids, np.int64))


def tkeys(ids):
    return TH.Key64.from_int(np.asarray(ids, np.int64), device="cpu")


def tstate(jstate):
    return TC.CacheState(*to_torch(jstate))


def mixed_state(rng, n_buckets=64, ways=4, n_fresh=40, n_stale=20):
    """The population of tests/test_probe_parity.py: fresh entries,
    expired entries and never-written slots (probe at 2*MIN, ttl MIN)."""
    state = JC.init_cache(n_buckets, ways, DIM)
    fresh_ids = np.arange(n_fresh, dtype=np.int64) * 7
    stale_ids = (np.arange(n_stale, dtype=np.int64) + 1) * 13 + 10_000
    state = JC.insert(state, jkeys(stale_ids),
                      jnp.asarray(rng.standard_normal((n_stale, DIM)),
                                  jnp.float32), now_ms=0, ttl_ms=MIN)
    state = JC.insert(state, jkeys(fresh_ids),
                      jnp.asarray(rng.standard_normal((n_fresh, DIM)),
                                  jnp.float32), now_ms=3 * MIN // 2,
                      ttl_ms=MIN)
    return state, fresh_ids, stale_ids


def query_mix(rng, fresh_ids, stale_ids, batch):
    pool = np.concatenate([fresh_ids, stale_ids,
                           np.arange(batch, dtype=np.int64) + 10 ** 6])
    return rng.choice(pool, size=batch, replace=True)


def assert_lookup(got, want, what=""):
    assert_tree(got, want, what=what)


# ------------------------------------------------------------------ hashing
def test_hash_and_bucket_match_jax(rng):
    ids = rng.integers(-2 ** 63, 2 ** 63 - 1, size=4096, dtype=np.int64)
    ids[:4] = [0, -2 ** 63, 2 ** 63 - 1, -1]   # incl. negative lo words
    kj, kt = jkeys(ids), tkeys(ids)
    assert_exact(kt.hi, kj.hi)
    assert_exact(kt.lo, kj.lo)
    for seed in (0, 17, 2 ** 32 - 1):
        assert_exact(TH.hash_u32(kt, seed),
                     np.asarray(JH.hash_u32(kj, seed)).astype(np.int64))
    for nb in (1, 64, 1 << 20):
        assert_exact(TH.bucket_index(kt, nb), JH.bucket_index(kj, nb))


def test_empty_sentinel_matches_jax():
    kj = JH.Key64(hi=jnp.full((3,), JH.EMPTY_HI), lo=jnp.full((3,),
                                                              JH.EMPTY_LO))
    kt = TH.Key64(hi=torch.full((3,), TH.EMPTY_HI, dtype=torch.int32),
                  lo=torch.full((3,), TH.EMPTY_LO, dtype=torch.int32))
    assert bool(kt.is_empty().all()) and bool(kj.is_empty().all())
    assert_exact(TH.bucket_index(kt, 1 << 14), JH.bucket_index(kj, 1 << 14))


# ------------------------------------------------------------------- probes
@pytest.mark.parametrize("batch", [1, 37, 130])
def test_lookup_matches_jax_tiled_kernel_and_jnp(batch, rng):
    """Port lookup (torch backend) == JAX jnp lookup == JAX tiled Pallas
    kernel, and the kernel wrapper on CPU tensors runs the same plain
    version."""
    jstate, fresh, stale = mixed_state(rng)
    ids = query_mix(rng, fresh, stale, batch)
    want = JC.lookup(jstate, jkeys(ids), now_ms=2 * MIN, ttl_ms=MIN)
    want_k = JC.lookup(jstate, jkeys(ids), now_ms=2 * MIN, ttl_ms=MIN,
                       backend="pallas")
    st = tstate(jstate)
    got = TC.lookup(st, tkeys(ids), 2 * MIN, MIN, backend="torch")
    assert_lookup(got, want, "lookup")
    assert_lookup(got, want_k, "lookup vs pallas")
    b = TH.bucket_index(tkeys(ids), st.n_buckets)
    n0 = dict(tpk.LAUNCHES)
    plain = tpk.cache_probe_tiled(st.key_hi, st.key_lo, st.write_ts,
                                  st.values, tkeys(ids).hi, tkeys(ids).lo,
                                  b, 2 * MIN, MIN)
    assert tpk.LAUNCHES == n0          # a CPU tensor launches nothing
    for g, w in zip(plain, (want.hit, want.values, want.age_ms, want.way)):
        assert_exact(g, w)
    if batch >= 37:
        assert bool(got.hit.any()) and not bool(got.hit.all())


@pytest.mark.parametrize("fo_buckets,fo_ways", [(64, 4), (128, 8), (32, 2)])
def test_lookup_dual_matches_jax_dual_kernel(fo_buckets, fo_ways, rng):
    """lookup_dual == JAX cache_probe_dual (Pallas) == two jnp lookups,
    for failover tables of other bucket counts and ways."""
    direct, fresh, stale = mixed_state(rng)
    failover = JC.init_cache(fo_buckets, fo_ways, DIM)
    failover = JC.insert(failover, jkeys(stale),
                         jnp.asarray(rng.standard_normal((len(stale), DIM)),
                                     jnp.float32), now_ms=0, ttl_ms=10 * MIN)
    ids = query_mix(rng, fresh, stale, 75)
    want = JC.lookup_dual(direct, failover, jkeys(ids), 2 * MIN, MIN,
                          10 * MIN, backend="pallas")
    want_j = JC.lookup_dual(direct, failover, jkeys(ids), 2 * MIN, MIN,
                            10 * MIN, backend="jnp")
    got = TC.lookup_dual(tstate(direct), tstate(failover), tkeys(ids),
                         2 * MIN, MIN, 10 * MIN, backend="torch")
    for g, w, wj, name in zip(got, want, want_j, ("direct", "failover")):
        assert_lookup(g, w, name)
        assert_lookup(g, wj, name)
    assert bool((~got[0].hit & got[1].hit).any())


def test_probe_empty_table_and_no_ttl(rng):
    st = TC.init_cache(16, 4, DIM, device="cpu")
    res = TC.lookup(st, tkeys(np.arange(9)), 0, 0x7FFFFFFF, backend="torch")
    assert not bool(res.hit.any())
    assert_exact(res.values, np.zeros((9, DIM), np.float32))
    assert_exact(res.age_ms, np.full(9, -1, np.int32))
    assert_exact(res.way, np.full(9, -1, np.int32))


# ----------------------------------------------------- inserts and touches
def test_random_insert_touch_sequences_match_jax(rng):
    """Random insert / insert_dual / touch rounds (duplicates, masks,
    per-entry timestamps, TTL and LRU victim orders) leave all five planes
    of both tables equal to JAX's, and lookups along the way agree."""
    jd, jf = JC.init_cache(16, 4, DIM), JC.init_cache(8, 2, DIM)
    td, tf = TC.CacheState(*to_torch(jd)), TC.CacheState(*to_torch(jf))
    j_insert = jax.jit(JC.insert, static_argnames=("evict_lru",))
    j_insert_dual = jax.jit(JC.insert_dual, static_argnames=("evict_lru",))
    j_lookup_dual = jax.jit(JC.lookup_dual)
    j_touch = jax.jit(JC.touch)
    n = 32          # one shape: the JAX side compiles each op once
    for step in range(24):
        ids = rng.integers(0, 120, size=n)
        vals = rng.standard_normal((n, DIM)).astype(np.float32)
        mask = rng.uniform(size=n) < 0.85
        now = step * MIN // 3
        ts = (now - rng.integers(0, MIN, n)).astype(np.int32)
        lru = bool(step % 3 == 0)
        op = step % 4
        if op == 0:
            jd = j_insert(jd, jkeys(ids), jnp.asarray(vals), now, MIN,
                          write_mask=jnp.asarray(mask), evict_lru=lru)
            TC.insert(td, tkeys(ids), torch.as_tensor(vals), now, MIN,
                      write_mask=torch.as_tensor(mask), evict_lru=lru)
        elif op in (1, 2):
            jd, jf = j_insert_dual(jd, jf, jkeys(ids), jnp.asarray(vals),
                                   now, MIN, 10 * MIN,
                                   write_mask=jnp.asarray(mask),
                                   ts_ms=jnp.asarray(ts), evict_lru=lru)
            TC.insert_dual(td, tf, tkeys(ids), torch.as_tensor(vals), now,
                           MIN, 10 * MIN, write_mask=torch.as_tensor(mask),
                           ts_ms=torch.as_tensor(ts), evict_lru=lru)
        else:
            probe = rng.integers(0, 150, size=29)
            wd, wf = j_lookup_dual(jd, jf, jkeys(probe), now, MIN,
                                   10 * MIN)
            gd, gf = TC.lookup_dual(td, tf, tkeys(probe), now, MIN,
                                    10 * MIN, backend="torch")
            assert_lookup(gd, wd, f"step {step} direct")
            assert_lookup(gf, wf, f"step {step} failover")
            live = rng.uniform(size=29) < 0.7
            jd = j_touch(jd, wd.bucket, wd.way, now + 5,
                         live=jnp.asarray(live))
            TC.touch(td, gd.bucket, gd.way, now + 5,
                     live=torch.as_tensor(live))
            jf = j_touch(jf, wf.bucket, wf.way, now + 7)
            TC.touch(tf, gf.bucket, gf.way, now + 7)
        assert_tree(td, jd, what=f"step {step} direct")
        assert_tree(tf, jf, what=f"step {step} failover")
    assert bool((td.write_ts != TC.TS_EMPTY).any())


def test_dedupe_first_groups_matches_jax(rng):
    for _ in range(5):
        ids = rng.integers(0, 12, size=40)
        live = rng.uniform(size=40) < 0.7
        want = JC.dedupe_first_groups(jkeys(ids), jnp.asarray(live))
        got = TC.dedupe_first_groups(tkeys(ids), torch.as_tensor(live))
        assert_exact(got[0], want[0])
        assert_exact(got[1], want[1])


def test_plan_insert_matches_jax(rng):
    jd, _, _ = mixed_state(rng, n_buckets=8, ways=4)
    ids = rng.integers(0, 300, size=50)
    for lru in (False, True):
        want = JC.plan_insert(jd, jkeys(ids), 2 * MIN, MIN, evict_lru=lru)
        got = TC.plan_insert(tstate(jd), tkeys(ids), 2 * MIN, MIN,
                             evict_lru=lru)
        for g, w in zip(got, want):
            assert_exact(g, w)


# -------------------------------------------------------------------- rings
def _append_rounds(rng, cap=16, rounds=4, batch=12):
    jb = JW.init_writebuf(cap, DIM)
    tb = TW.init_writebuf(cap, DIM, device="cpu")
    for t in range(rounds):
        ids = rng.integers(0, 30, size=batch)
        vals = rng.standard_normal((batch, DIM)).astype(np.float32)
        mask = rng.uniform(size=batch) < 0.8
        jb = JW.append(jb, jkeys(ids), jnp.asarray(vals), t * 1000,
                       mask=jnp.asarray(mask))
        TW.append(tb, tkeys(ids), torch.as_tensor(vals), t * 1000,
                  mask=torch.as_tensor(mask))
        assert_tree(tb, jb, what=f"round {t}")
    return jb, tb


def test_write_ring_matches_jax_incl_overflow(rng):
    """Ring appends (wrapping, and one batch larger than the ring: the
    last `capacity` live records win) and the ring unroll."""
    jb, tb = _append_rounds(rng)
    ids = rng.integers(0, 30, size=40)
    vals = rng.standard_normal((40, DIM)).astype(np.float32)
    jb = JW.append(jb, jkeys(ids), jnp.asarray(vals), 9000,
                   mask=jnp.ones(40, bool))
    TW.append(tb, tkeys(ids), torch.as_tensor(vals), 9000,
              mask=torch.ones(40, dtype=torch.bool))
    assert_tree(tb, jb, what="overflow")
    for g, w in zip(TW._ring_order(tb), JW._ring_order(jb)):
        if isinstance(w, JH.Key64):
            assert_exact(g.hi, w.hi)
            assert_exact(g.lo, w.lo)
        else:
            assert_exact(g, w)


def test_touch_ring_matches_jax(rng):
    jd, fresh, stale = mixed_state(rng)
    jt = JW.init_touchbuf(24)
    tt = TW.init_touchbuf(24, device="cpu")
    td = tstate(jd)
    for t in range(4):
        ids = query_mix(rng, fresh, stale, 20)
        wd, wf = JC.lookup_dual(jd, jd, jkeys(ids), 2 * MIN, MIN, 10 * MIN)
        gd, gf = TC.lookup_dual(td, td, tkeys(ids), 2 * MIN, MIN, 10 * MIN,
                                backend="torch")
        mask = rng.uniform(size=20) < 0.8
        jt = JW.touch_append(jt, wd, wf, 2 * MIN + t, mask=jnp.asarray(mask))
        TW.touch_append(tt, gd, gf, 2 * MIN + t, mask=torch.as_tensor(mask))
        assert_tree(tt, jt, what=f"touch round {t}")


@pytest.mark.parametrize("fo_buckets,fo_ways,lru", [(64, 2, False),
                                                    (32, 4, True)])
def test_flush_dual_equals_two_flushes_and_jax(fo_buckets, fo_ways, lru,
                                               rng):
    """flush_dual == flush(direct) + flush(failover) in the port, and ==
    JAX's flush_dual, touches included, on every leaf."""
    jb, _ = _append_rounds(rng)
    jd, fresh, stale = mixed_state(rng, n_buckets=32)
    jf = JC.init_cache(fo_buckets, fo_ways, DIM)
    jt = JW.init_touchbuf(32)
    ids = query_mix(rng, fresh, stale, 20)
    wd, wf = JC.lookup_dual(jd, jf, jkeys(ids), 2 * MIN, MIN, 10 * MIN)
    jt = JW.touch_append(jt, wd, wf, 2 * MIN)
    buf = lambda: TW.WriteBuffer(*to_torch(jb))
    tch = lambda: TW.TouchBuffer(*to_torch(jt))
    want_d, want_f, want_b, want_t = JW.flush_dual(
        jb, jd, jf, 3 * MIN, MIN, 10 * MIN, evict_lru=lru, touchbuf=jt)
    got_d, got_f, got_b, got_t = TW.flush_dual(
        buf(), tstate(jd), tstate(jf), 3 * MIN, MIN, 10 * MIN,
        evict_lru=lru, touchbuf=tch())
    for g, w, name in ((got_d, want_d, "direct"), (got_f, want_f, "failover"),
                       (got_b, want_b, "writebuf"), (got_t, want_t, "touch")):
        assert_tree(g, w, what=name)
    # two independent single-table flushes give the same tables
    one_d, _, _ = TW.flush(buf(), tstate(jd), 3 * MIN, MIN, evict_lru=lru,
                           touchbuf=tch())
    t2 = tch()
    t2 = TW.TouchBuffer(t2.bucket_f, t2.way_f, t2.bucket_d, t2.way_d,
                        t2.ts_ms, t2.count)   # failover coords first
    one_f, _, _ = TW.flush(buf(), tstate(jf), 3 * MIN, 10 * MIN,
                           evict_lru=lru, touchbuf=t2)
    assert_tree(one_d, got_d, what="flush direct")
    assert_tree(one_f, got_f, what="flush failover")
    assert int(got_b.count) == 0 and int(got_t.count) == 0


def test_flush_is_in_place(rng):
    jb, _ = _append_rounds(rng)
    st = TC.init_cache(32, 4, DIM, device="cpu")
    planes = [t.data_ptr() for t in st]
    buf = TW.WriteBuffer(*to_torch(jb))
    new, buf2, _ = TW.flush(buf, st, 5000, MIN)
    assert new is st and buf2 is buf
    assert [t.data_ptr() for t in new] == planes
    assert bool((st.write_ts != TC.TS_EMPTY).any())


def test_flat_entries_and_occupancy_match_jax(rng):
    jd, _, _ = mixed_state(rng, n_buckets=16, ways=4)
    td = tstate(jd)
    want, got = JC.flat_entries(jd), TC.flat_entries(td)
    assert_exact(got[0].hi, want[0].hi)
    assert_exact(got[0].lo, want[0].lo)
    for g, w in zip(got[1:], want[1:]):
        assert_exact(g, w)
    assert float(td.occupancy()) == float(jd.occupancy())
    assert td.capacity == jd.capacity and td.dim == jd.dim


def test_touch_skips_negative_buckets(rng):
    """A bucket of -1 marks "no hit" and is never bumped. (The reference's
    ``touch`` wraps a -1 bucket with a live way to the last bucket, JAX's
    negative-index rule; its serve path masks such rows before the call.)"""
    st = TC.init_cache(4, 2, 2, device="cpu")
    TC.touch(st, torch.tensor([-1, 2], dtype=torch.int32),
             torch.tensor([1, 0], dtype=torch.int32), 500)
    want = np.full((4, 2), TC.TS_EMPTY, np.int32)
    want[2, 0] = 500
    assert_exact(st.last_access_ts, want)
