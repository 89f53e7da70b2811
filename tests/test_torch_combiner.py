"""repro_torch's update combiner (paper §3.4, Fig. 5) against the JAX
package, on the CPU: ``tests/test_combiner.py``'s six cases on both
packages, a random grouped stream, and the 32-member group both refuse.

Every plane of the grouped state (the base cache's key, ts, value and
last-access planes, and the ``present`` bitmap) and each member lookup's
hit, values and age must match bit for bit: the group row is a copy of
the members' values and the bitmap is integer arithmetic.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_exact  # noqa: E402
from repro.core import combiner as JG  # noqa: E402
from repro.core.hashing import Key64 as JKey  # noqa: E402
from repro_torch.core import combiner as TG  # noqa: E402
from repro_torch.core.hashing import Key64 as TKey  # noqa: E402

MIN = 60_000
MEMBERS = (("ctr_first", 4, 5 * MIN), ("cvr_first", 8, 1 * MIN),
           ("ctr_second", 4, 10 * MIN))


class Pair:
    """One grouped cache in each package, written and read in step."""

    def __init__(self, members=MEMBERS, n_buckets=64, ways=4):
        self.j = JG.GroupSpec(tuple(JG.GroupMember(*m) for m in members))
        self.t = TG.GroupSpec(tuple(TG.GroupMember(*m) for m in members))
        self.js = JG.init_grouped(self.j, n_buckets=n_buckets, ways=ways)
        self.ts = TG.init_grouped(self.t, n_buckets=n_buckets, ways=ways,
                                  device="cpu")

    def insert(self, ids, values, now, member_mask=None, write_mask=None,
               ts_ms=None):
        ids = np.asarray(ids, np.int64)
        jopt = lambda a: None if a is None else jnp.asarray(a)
        topt = lambda a: None if a is None else torch.as_tensor(a)
        self.js = JG.insert_group(
            self.j, self.js, JKey.from_int(ids),
            {k: jnp.asarray(v) for k, v in values.items()}, now,
            member_mask=None if member_mask is None else {
                k: jnp.asarray(v) for k, v in member_mask.items()},
            write_mask=jopt(write_mask), ts_ms=jopt(ts_ms))
        got = TG.insert_group(
            self.t, self.ts, TKey.from_int(ids, device="cpu"),
            {k: torch.as_tensor(v) for k, v in values.items()}, now,
            member_mask=None if member_mask is None else {
                k: torch.as_tensor(v) for k, v in member_mask.items()},
            write_mask=topt(write_mask), ts_ms=topt(ts_ms))
        assert got is self.ts                 # written in place
        for name in self.js.base._fields:
            assert_exact(getattr(self.ts.base, name),
                         getattr(self.js.base, name), name)
        assert_exact(self.ts.present, self.js.present, "present")

    def lookup(self, name, ids, now):
        ids = np.asarray(ids, np.int64)
        want = JG.lookup_member(self.j, self.js, name, JKey.from_int(ids),
                                now)
        got = TG.lookup_member(self.t, self.ts, name,
                               TKey.from_int(ids, device="cpu"), now,
                               backend="torch")
        for field in ("hit", "values", "age_ms"):
            assert_exact(getattr(got, field), getattr(want, field),
                         f"{name}.{field}")
        return got


def vals(b, d, fill):
    return np.full((b, d), float(fill), np.float32)


ALL = {"ctr_first": (4, 1.0), "cvr_first": (8, 2.0), "ctr_second": (4, 3.0)}


def all_members(b):
    return {n: vals(b, d, f) for n, (d, f) in ALL.items()}


# --------------------------------------------- tests/test_combiner.py's six
def case_one_write_many_reads():
    g = Pair()
    g.insert([1, 2], all_members(2), 0)
    for name, (d, fill) in ALL.items():
        res = g.lookup(name, [1, 2], 1000)
        assert bool(res.hit.all()), name
        assert bool((res.values == fill).all())


def case_per_member_ttl():
    g = Pair()
    g.insert([7], all_members(1), 0)
    t = 2 * MIN      # cvr_first (1 min TTL) stale; others fresh
    assert bool(g.lookup("ctr_first", [7], t).hit[0])
    assert not bool(g.lookup("cvr_first", [7], t).hit[0])
    assert bool(g.lookup("ctr_second", [7], t).hit[0])


def case_partial_failure_bitmap():
    g = Pair()
    g.insert([3], all_members(1), 0,
             member_mask={"cvr_first": np.asarray([False])})
    assert bool(g.lookup("ctr_first", [3], 0).hit[0])
    assert not bool(g.lookup("cvr_first", [3], 0).hit[0])
    assert bool(g.lookup("ctr_second", [3], 0).hit[0])


def case_missing_member_value_not_valid():
    g = Pair()
    g.insert([4], {"ctr_first": vals(1, 4, 1.0)}, 0)
    assert bool(g.lookup("ctr_first", [4], 0).hit[0])
    assert not bool(g.lookup("cvr_first", [4], 0).hit[0])


def case_write_amplification_30x():
    for n_models, n_stages in ((30, 1), (10, 3), (7, 2)):
        assert (TG.write_amplification(n_models, n_stages)
                == JG.write_amplification(n_models, n_stages))
    assert TG.write_amplification(n_models=30, n_stages=1) >= 30.0


def case_group_update_refreshes_all_members():
    g = Pair()
    g.insert([5], all_members(1), 0)
    g.insert([5], {"ctr_first": vals(1, 4, 9.0), "cvr_first": vals(1, 8, 8.0),
                   "ctr_second": vals(1, 4, 7.0)}, MIN)
    res = g.lookup("ctr_first", [5], MIN + 1000)
    assert bool((res.values == 9.0).all())
    assert int(res.age_ms[0]) == 1000


CASES = {f.__name__[5:]: f for f in (
    case_one_write_many_reads, case_per_member_ttl,
    case_partial_failure_bitmap, case_missing_member_value_not_valid,
    case_write_amplification_30x, case_group_update_refreshes_all_members)}


@pytest.mark.parametrize("case", list(CASES))
def test_combiner_case_matches_jax(case):
    CASES[case]()


# ------------------------------------------------------------ a stream
def test_grouped_stream_matches_jax(rng):
    """Rounds of grouped writes into a small table (bucket collisions,
    evictions, duplicate users in a batch, per-member failures, a missing
    member, dropped writes, per-entry compute timestamps), each followed
    by every member's lookup at a later clock."""
    members = tuple((f"m{i}", d, ttl) for i, (d, ttl) in enumerate(
        [(3, MIN), (5, 4 * MIN), (2, 9 * MIN), (4, 2 * MIN), (1, 30 * MIN)]))
    g = Pair(members, n_buckets=8, ways=2)
    pool = np.arange(40, dtype=np.int64) * 7919 + 3
    for r in range(6):
        b = 24
        ids = rng.choice(pool, b)
        now = r * 90_000
        values = {n: rng.standard_normal((b, d)).astype(np.float32)
                  for n, d, _ in members if not (r == 2 and n == "m3")}
        mask = {n: rng.uniform(size=b) < 0.8 for n in values}
        write_mask = rng.uniform(size=b) < 0.9
        ts = (now - rng.integers(0, 30_000, b)).astype(np.int32)
        g.insert(ids, values, now, member_mask=mask, write_mask=write_mask,
                 ts_ms=ts if r % 2 else None)
        q = np.concatenate([rng.choice(pool, 30), [10 ** 9 + r]])
        for n, _, _ in members:
            g.lookup(n, q, now + 40_000)
    hits = g.lookup("m4", pool, 6 * 90_000).hit
    assert bool(hits.any()) and not bool(hits.all())


def test_thirty_two_member_group_refused_by_both():
    """GroupSpec admits 32 members, but member 31's bit does not fit the
    int32 bitmap: the reference's insert raises OverflowError on it
    (``jnp.int32(1 << 31)``), and the port refuses it the same way instead
    of wrapping bit 31 into the sign. 31 members write and read."""
    spec31 = tuple((f"m{i}", 2, MIN) for i in range(31))
    g = Pair(spec31, n_buckets=16, ways=2)
    g.insert([1, 2], {n: vals(2, d, i) for i, (n, d, _) in
                      enumerate(spec31)}, 0)
    res = g.lookup("m30", [1, 2], 10)
    assert bool(res.hit.all()) and bool((res.values == 30.0).all())
    assert int(g.ts.present[g.ts.present != 0].min()) == 2 ** 31 - 1
    spec32 = spec31 + (("m31", 2, MIN),)
    g = Pair(spec32, n_buckets=16, ways=2)
    values = {n: vals(1, d, 1.0) for n, d, _ in spec32}
    with pytest.raises(OverflowError):
        JG.insert_group(g.j, g.js, JKey.from_int(np.asarray([1])),
                        {k: jnp.asarray(v) for k, v in values.items()}, 0)
    with pytest.raises(OverflowError):
        TG.insert_group(g.t, g.ts, TKey.from_int(np.asarray([1]),
                                                 device="cpu"),
                        {k: torch.as_tensor(v) for k, v in values.items()},
                        0)
    assert not bool(g.ts.present.any())
    # without member 31's values both packages write the other 31
    del values["m31"]
    g.insert([1], values, 0)
    with pytest.raises(AssertionError):
        TG.GroupSpec(tuple(TG.GroupMember(f"m{i}", 1, MIN)
                           for i in range(33)))


def test_lookup_member_miss_beside_a_set_last_way():
    """A miss reports way -1; the present bit is read at a clamped way
    and masked by the probe's hit, so a miss whose bucket's LAST way holds
    a set bit stays a miss."""
    g = Pair(n_buckets=1, ways=2)
    g.insert([11, 12], all_members(2), 0)
    assert int(g.ts.present[0, -1]) == 0b111
    res = g.lookup("ctr_first", [13], 10)
    assert not bool(res.hit[0]) and int(res.age_ms[0]) == -1
