"""Update combination (paper §3.4, Fig. 5).

Twin of ``repro/core/combiner.py``. Production ERCache consolidates the
embeddings a user produced across *all* ranking models x ranking stages
into ONE cache-write request, cutting write QPS by >= 30x for 30 models.
All member models share one grouped cache entry per user: a single bucket
slot whose value row is the concatenation of every member's embedding,
plus a per-slot ``present`` bitmap (bit i: member i valid) so per-model
validity survives partial failures.

One grouped insert == one insert plan and one scatter per plane == "one
write request"; per-member lookups probe the group row (on the card one
``cache_probe_tiled`` launch), slice it and apply the member's own TTL
against the shared write timestamp.

Like the port's ``cache.insert``, :func:`insert_group` writes IN PLACE
and returns the same state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import cache as cache_lib
from repro_torch.core.cache import CacheState, LookupResult
from repro_torch.core.hashing import Key64

# the present bitmap is one int32: bit i is member i's
_INT32_BITS = 32


@dataclasses.dataclass(frozen=True)
class GroupMember:
    name: str           # e.g. "ctr_first"
    dim: int
    ttl_ms: int


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    members: Tuple[GroupMember, ...]

    def __post_init__(self):
        assert len(self.members) <= _INT32_BITS, \
            "present bitmap is one int32"

    @property
    def total_dim(self) -> int:
        return sum(m.dim for m in self.members)

    def offset(self, name: str) -> Tuple[int, int, int]:
        """(member index, start, end) of a member's slice in the group row."""
        off = 0
        for i, m in enumerate(self.members):
            if m.name == name:
                return i, off, off + m.dim
            off += m.dim
        raise KeyError(name)


class GroupedCacheState(NamedTuple):
    base: CacheState
    # (n_buckets, ways) int32 bitmap — bit i: member i valid
    present: torch.Tensor


def init_grouped(spec: GroupSpec, n_buckets: int, ways: int,
                 dtype=torch.float32, device="cuda") -> GroupedCacheState:
    base = cache_lib.init_cache(n_buckets, ways, spec.total_dim, dtype,
                                device=device)
    return GroupedCacheState(
        base=base, present=torch.zeros((n_buckets, ways), dtype=torch.int32,
                                       device=base.key_hi.device))


def _member_bit(i: int) -> int:
    """Member i's bit as an int32 value. Bit 31 is refused as the
    reference refuses it (``jnp.int32(1 << 31)`` raises OverflowError), not
    wrapped into the sign."""
    if not 0 <= i < _INT32_BITS - 1:
        raise OverflowError(f"member {i}'s bit 1 << {i} is out of bounds "
                            "for the int32 present bitmap")
    return 1 << i


def insert_group(spec: GroupSpec, state: GroupedCacheState, keys: Key64,
                 member_values: Dict[str, torch.Tensor], now_ms,
                 member_mask: Optional[Dict[str, torch.Tensor]] = None,
                 write_mask: Optional[torch.Tensor] = None,
                 ts_ms: Optional[torch.Tensor] = None) -> GroupedCacheState:
    """ONE combined write for all members (the Fig. 5 consolidation), IN
    PLACE.

    ``member_values[name]`` is (B, dim_name); ``member_mask[name]`` (B,) marks
    which users actually produced that member this round (failed inferences
    contribute nothing: their bit stays 0).
    """
    B = keys.hi.shape[0]
    dev, dt = keys.hi.device, state.base.values.dtype
    rows = []
    bits = torch.zeros(B, dtype=torch.int32, device=dev)
    for i, m in enumerate(spec.members):
        v = member_values.get(m.name)
        if v is None:
            rows.append(torch.zeros((B, m.dim), dtype=dt, device=dev))
            continue
        ok = (member_mask or {}).get(m.name)
        if ok is None:
            ok = torch.ones(B, dtype=torch.bool, device=dev)
        rows.append(torch.where(ok[:, None], v, 0).to(dt))
        bits = bits | torch.where(ok, _member_bit(i), 0).to(torch.int32)
    group_row = torch.cat(rows, dim=-1)

    # ONE plan on the pre-insert state; the base planes and the bitmap are
    # written on its (bucket, way, owner) with the same masked write
    eviction_ttl = max(m.ttl_ms for m in spec.members)
    _, bucket, way, owner = cache_lib._plan(
        state.base, keys, now_ms, eviction_ttl, write_mask, False, None,
        None)
    cache_lib._scatter_insert(state.base, keys, group_row,
                              cache_lib._ts_vector(group_row, now_ms, ts_ms),
                              owner, bucket, way)
    cache_lib.put_owned(state.present, bits, owner, bucket, way)
    return state


def lookup_member(spec: GroupSpec, state: GroupedCacheState, name: str,
                  keys: Key64, now_ms, backend: str = "cuda"
                  ) -> LookupResult:
    """Per-model read: slice the group row, member's own TTL + present bit.
    ``backend="cuda"`` probes with the one-table kernel
    (``cache_probe_tiled``), whose (bucket, way) locate the present bit."""
    idx, lo, hi = spec.offset(name)
    member = spec.members[idx]
    res = cache_lib.lookup(state.base, keys, now_ms, member.ttl_ms,
                           backend=backend)
    # a miss reports way -1, which would index the last way: it is masked
    # by ``res.hit`` below, and clamped so it reads a real slot
    way = res.way.clamp(min=0).long()
    bit = (state.present[res.bucket.long(), way] >> idx) & 1
    hit = res.hit & (bit == 1)
    vals = torch.where(hit[:, None], res.values[:, lo:hi],
                       torch.zeros((), dtype=res.values.dtype,
                                   device=res.values.device))
    return LookupResult(hit=hit, values=vals,
                        age_ms=torch.where(hit, res.age_ms, -1).to(
                            torch.int32))


def write_amplification(n_models: int, n_stages: int) -> float:
    """Writes-per-user without combining / with combining (paper: >= 30x)."""
    return float(n_models * n_stages) / 1.0
