"""A plain ERCache tier, written from the semantics alone: XXH32 bucket
hashing, the TTL probe, one serve batch's sources, ages and counters, and
the flush's batched insert. It keeps keys, write times and where each
entry came from, not values: a served value is judged against the value
its (user, write time) must have.

Semantics (paper Fig. 3, sections 3.2-3.5, as the JAX package states them):

* a key hashes to one bucket of ``ways`` slots; a probe hits where the key
  matches and ``now - write_ts`` (int32 arithmetic) is at most the TTL,
  and reads the first such way;
* a batch serves direct hits; its misses, in batch order, run the tower up
  to ``miss_budget`` of them, and those that do not fail are computed (age
  0); every other miss takes the failover tier's hit, or the default
  embedding (source fallback, age -1);
* a flush writes the computed records into both tiers at one plan each:
  the last record of a key wins; a key present in the bucket keeps its
  way; the other winners of a bucket take, in record order, the ways in
  eviction order (empty, then expired, then live; older first; lower way
  first), the last of them sharing the last such way; where two winners
  aim at one slot the later record takes it.

No read refreshes an entry, so every hit leaves the tables as they were.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

EMPTY_HI = -0x80000000
EMPTY_LO = 0
TS_EMPTY = -0x80000000
SRC_DIRECT, SRC_COMPUTED, SRC_FAILOVER, SRC_FALLBACK = 0, 1, 2, 3
# where an entry came from: never written, the set-up image, a tower run
FROM_NONE, FROM_IMAGE, FROM_TOWER = 0, 1, 2

_P2, _P3, _P4, _P5 = 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1
_M32 = 0xFFFFFFFF


def xxh32_of_ids(ids: np.ndarray) -> np.ndarray:
    """XXH32, seed 0, of each non-negative 64-bit id as 8 little-endian
    bytes (its low word, then its high word). Returns uint32 as int64."""
    u = np.asarray(ids, np.int64).astype(np.uint64)
    m = np.uint64(_M32)
    h = np.full(u.shape, (_P5 + 8) & _M32, np.uint64)
    for lane in (u & m, u >> np.uint64(32)):
        h = (h + lane * np.uint64(_P3)) & m
        h = (((h << np.uint64(17)) | (h >> np.uint64(15))) & m)
        h = (h * np.uint64(_P4)) & m
    h ^= h >> np.uint64(15)
    h = (h * np.uint64(_P2)) & m
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(_P3)) & m
    h ^= h >> np.uint64(16)
    return h.astype(np.int64)


def bucket_of(ids: np.ndarray, *n_buckets: int):
    """Each id's bucket in a table of each of ``n_buckets`` (powers of 2;
    the hash is taken once): one array, or a tuple for several tables."""
    for n in n_buckets:
        if n & (n - 1):
            raise ValueError(f"n_buckets must be a power of 2, got {n}")
    h = xxh32_of_ids(ids)
    out = tuple((h & (n - 1)).astype(np.int64) for n in n_buckets)
    return out[0] if len(out) == 1 else out


def key_words(ids) -> tuple:
    """A 64-bit id as its (high, low) int32 words."""
    ids = np.asarray(ids, np.int64)
    return ((ids >> 32).astype(np.int32),
            (ids & _M32).astype(np.uint32).view(np.int32))


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value two's-complement arithmetic gives."""
    return ((x + 0x80000000) & _M32) - 0x80000000


class Tier(NamedTuple):
    """One table: (n_buckets + 1, ways, 4) int32 slots holding key hi, key
    lo, write time and origin (``FROM_*``); one gather reads a whole
    bucket. The last bucket is no key's: a flush's rows that write nothing
    are aimed at it, so a flush has one shape whatever it writes."""

    slots: torch.Tensor

    @property
    def ways(self) -> int:
        return self.slots.shape[1]

    @property
    def n_buckets(self) -> int:
        return self.slots.shape[0] - 1

    key_hi = property(lambda self: self.slots[:-1, :, 0])
    key_lo = property(lambda self: self.slots[:-1, :, 1])
    ts = property(lambda self: self.slots[:-1, :, 2])
    origin = property(lambda self: self.slots[:-1, :, 3])

    @staticmethod
    def empty(n_buckets: int, ways: int, device) -> "Tier":
        slots = torch.empty((n_buckets + 1, ways, 4), dtype=torch.int32,
                            device=device)
        slots[..., 0] = EMPTY_HI
        slots[..., 1] = EMPTY_LO
        slots[..., 2] = TS_EMPTY
        slots[..., 3] = FROM_NONE
        return Tier(slots)

    def clone(self) -> "Tier":
        return Tier(self.slots.clone())


class Probe(NamedTuple):
    hit: torch.Tensor      # (B,) bool
    age: torch.Tensor      # (B,) int64, -1 on a miss
    origin: torch.Tensor   # (B,) int32, FROM_NONE on a miss


def probe(tier: Tier, bucket, hi, lo, now: int, ttl: int) -> Probe:
    g = tier.slots[bucket]                                   # (B, W, 4)
    age = wrap32(now - g[..., 2].long())
    valid = (g[..., 0] == hi[:, None]) & (g[..., 1] == lo[:, None]) & (
        age <= ttl)
    hit = valid.any(dim=1)
    way = valid.to(torch.int8).argmax(dim=1, keepdim=True)  # first valid
    return Probe(hit, torch.where(hit, age.gather(1, way)[:, 0], -1),
                 torch.where(hit, g[..., 3].gather(1, way)[:, 0], FROM_NONE))


class Served(NamedTuple):
    source: torch.Tensor      # (B,) int32
    age: torch.Tensor         # (B,) int32
    computed: torch.Tensor    # (B,) bool: rows whose record the flush writes
    selected: torch.Tensor    # (B,) bool: rows the tower ran on
    direct: Probe
    failover: Probe
    counters: dict            # 0-d tensors


def serve(direct: Tier, failover: Tier, bucket_d, bucket_f, hi, lo,
          now: int, failed, miss_budget: int, ttl_d: int,
          ttl_f: int) -> Served:
    """One serve batch against the tables as they stand (reads only)."""
    pd = probe(direct, bucket_d, hi, lo, now, ttl_d)
    pf = probe(failover, bucket_f, hi, lo, now, ttl_f)
    miss = ~pd.hit
    # the tower's rows: the misses in batch order, then the other rows in
    # batch order, cut to the budget
    order = torch.sort(pd.hit.to(torch.int8), stable=True).indices
    selected = torch.zeros_like(miss).index_fill_(0, order[:miss_budget],
                                                  True)
    ran = selected & miss
    computed = ran & ~failed
    unresolved = miss & ~computed
    from_fo = unresolved & pf.hit
    fallback = unresolved & ~pf.hit
    source = torch.where(pd.hit, SRC_DIRECT, torch.where(
        computed, SRC_COMPUTED, torch.where(from_fo, SRC_FAILOVER,
                                            SRC_FALLBACK))).to(torch.int32)
    age = torch.where(pd.hit, pd.age, torch.where(
        computed, 0, torch.where(from_fo, pf.age, -1))).to(torch.int32)
    counters = torch.stack([pd.hit, ran, ran & failed, miss & ~ran, from_fo,
                            fallback]).sum(dim=1)
    return Served(source, age, computed, selected, pd, pf, counters)


# the counters of ``serve``, in the order of its counter vector
COUNTER_KEYS = ("direct_hits", "tower_inferences", "tower_failures",
                "overflow", "failover_hits", "fallbacks")


def _runs(sorted_vals: torch.Tensor):
    """(first of its run, last of its run) masks of a sorted vector."""
    change = sorted_vals[1:] != sorted_vals[:-1]
    t = torch.ones(1, dtype=torch.bool, device=sorted_vals.device)
    return torch.cat([t, change]), torch.cat([change, t])


def _rank_in_run(vals: torch.Tensor) -> torch.Tensor:
    """Each element's position among the equal elements before it."""
    n = vals.shape[0]
    pos = torch.arange(n, device=vals.device)
    sv, order = torch.sort(vals, stable=True)
    first, _ = _runs(sv)
    start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = torch.empty_like(order)
    rank[order] = pos - start
    return rank


def _last_of_run(vals: torch.Tensor) -> torch.Tensor:
    """True at the last of the equal elements (in order)."""
    sv, order = torch.sort(vals, stable=True)
    last = torch.empty_like(sv, dtype=torch.bool)
    last[order] = _runs(sv)[1]
    return last


def flush(tiers, buckets, hi, lo, ts_rec, now, ttls, origin: int,
          live=None) -> None:
    """Write the records (in record order) into each tier IN PLACE, as one
    flush does (module docstring): ``buckets[k]`` and ``ttls[k]`` are the
    records' buckets in and the TTL of ``tiers[k]``; ``ts_rec`` each
    record's write time; ``now`` the flush's clock, which decides what has
    expired; ``live`` (None: all) which rows are records at all."""
    n = hi.shape[0]
    if n == 0:
        return
    dev = hi.device
    idx = torch.arange(n, device=dev)
    if live is None:
        live = torch.ones(n, dtype=torch.bool, device=dev)
    # real keys are non-negative; a dead row gets a key of its own
    key = torch.where(live, (hi.long() << 32) | (lo.long() & _M32), -1 - idx)
    winner = live & _last_of_run(key)
    for tier, bucket, ttl in zip(tiers, buckets, ttls):
        W, nb = tier.ways, tier.n_buckets
        # a winner's rank among its bucket's winners, in record order
        rank = _rank_in_run(torch.where(winner, bucket, nb + idx))
        # the bucket as it stood before this flush
        g = tier.slots[bucket]
        kh, kl, ts = g[..., 0], g[..., 1], g[..., 2].long()
        match = (kh == hi[:, None]) & (kl == lo[:, None])
        empty = (kh == EMPTY_HI) & (kl == EMPTY_LO)
        expired = ~empty & (wrap32(now - ts) > ttl)
        prio = (~empty).long() + (~empty & ~expired).long()
        ways = torch.arange(W, device=dev)
        evict_order = torch.argsort((prio << 40) | ((ts + 0x80000000) << 3)
                                    | ways, dim=1)
        pick = evict_order.gather(1, rank.clamp(max=W - 1)[:, None])[:, 0]
        way = torch.where(match.any(dim=1),
                          match.to(torch.int8).argmax(dim=1), pick)
        # two winners on one slot: the later record takes it
        slot = torch.where(winner, bucket * W + way, (nb + 1) * W + idx)
        keep = winner & _last_of_run(slot)
        new = torch.stack([hi, lo, ts_rec.to(torch.int32).expand(n),
                           torch.full_like(hi, origin)], dim=1)
        tier.slots[torch.where(keep, bucket, nb), torch.where(keep, way, 0)] \
            = torch.where(keep[:, None], new, tier.slots[nb, 0])
