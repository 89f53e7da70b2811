"""Asynchronous write + touch rings (paper §3.5), as PyTorch tensors.

Twin of ``repro/core/writebuf.py``, with the model-tagged records and the
multi-model flush. The serve step
appends (key, value, ts) records of computed embeddings to a fixed-size
ring (an O(B) scatter, no cache-table traffic) and the hit coordinates of
its probes to a touch ring; ``flush`` later scatter-maxes the touches into
the recency plane and applies the inserts.

Unlike the reference, which returns new buffers, :func:`append`,
:func:`touch_append` and the flushes update the rings (and the flushes the
cache tables) IN PLACE and return the same objects. Coordinates in the
touch ring stay valid until the flush because only the flush writes the
tables. Each flush takes the reference's ``mesh``: a bucket-sharded tier
(``distributed/collectives.py``) is flushed shard by shard, with the same
results.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import cache as cache_lib
from repro_torch.core.hashing import Key64


class WriteBuffer(NamedTuple):
    key_hi: torch.Tensor    # (cap,) int32
    key_lo: torch.Tensor    # (cap,) int32
    ts_ms: torch.Tensor     # (cap,) int32
    values: torch.Tensor    # (cap, dim)
    count: torch.Tensor     # () int32 — appended since the last flush (may
                            # exceed cap; the ring overwrites the oldest)
    model_id: torch.Tensor  # (cap,) int32 — model slot per record (all
                            # zero for single-model servers)

    @property
    def capacity(self) -> int:
        return self.key_hi.shape[0]


def init_writebuf(capacity: int, dim: int, dtype=torch.float32,
                  device="cuda") -> WriteBuffer:
    device = cache_lib.resolve_device(device)
    z = lambda: torch.zeros((capacity,), dtype=torch.int32, device=device)
    return WriteBuffer(
        key_hi=z(), key_lo=z(), ts_ms=z(),
        values=torch.zeros((capacity, dim), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        model_id=z())


def _ring_slots(count: torch.Tensor, mask: torch.Tensor, capacity: int):
    """Shared ring discipline of both appends: live rows first in batch
    order (stable), at slots ``(count + pos) % capacity``. When a batch
    holds more live rows than the ring, only the LAST ``capacity`` are
    kept (two live rows a capacity apart would otherwise race for one
    slot).

    Every position writes its slot, so no host sync picks the kept rows
    out: a dropped position writes what its slot ends with, the record of
    the kept position that shares the slot or the slot's own contents, and
    each slot receives one value whatever the order of the writes. Returns
    (target slots (B,), source rows (B,), -1 where the slot keeps its
    contents, number of live rows)."""
    B = mask.shape[0]
    order = torch.sort((~mask).to(torch.int32), stable=True).indices
    n_live = mask.sum(dtype=torch.int32)
    pos = torch.arange(B, dtype=torch.int32, device=mask.device)
    slot = ((count + pos) % capacity).long()
    # the kept positions form the window [lo, n_live), at most `capacity`
    # long: the one congruent to pos (mod capacity) owns pos's slot
    lo = torch.clamp(n_live - capacity, min=0)
    owner = lo + (pos - lo) % capacity
    src = torch.where(owner < n_live,
                      order[owner.clamp(max=max(B - 1, 0)).long()], -1)
    return slot, src, n_live


def _ring_write(plane: torch.Tensor, slot: torch.Tensor, src: torch.Tensor,
                rows: torch.Tensor) -> None:
    """``plane[slot] = rows[src]`` where ``src >= 0``, else the slot's own
    contents (the :func:`_ring_slots` contract), IN PLACE."""
    new = rows[src.clamp(min=0)].to(plane.dtype)
    keep = (src >= 0).view(-1, *([1] * (new.dim() - 1)))
    plane[slot] = torch.where(keep, new, plane[slot])


def append(buf: WriteBuffer, keys: Key64, values: torch.Tensor, ts_ms,
           mask: torch.Tensor,
           model_ids: Optional[torch.Tensor] = None) -> WriteBuffer:
    """Append the masked records at the ring head, IN PLACE. O(B).
    ``model_ids`` (B,) tags each record with its model slot (the
    multi-model flush gathers each record's policy from it); None tags
    slot 0 (the single-model server)."""
    B = values.shape[0]
    ts_vec = torch.as_tensor(ts_ms, dtype=torch.int32,
                             device=values.device).expand(B)
    slot, src, n_live = _ring_slots(buf.count, mask, buf.capacity)
    _ring_write(buf.key_hi, slot, src, keys.hi)
    _ring_write(buf.key_lo, slot, src, keys.lo)
    _ring_write(buf.ts_ms, slot, src, ts_vec)
    _ring_write(buf.values, slot, src, values)
    _ring_write(buf.model_id, slot, src,
                torch.zeros_like(keys.hi) if model_ids is None
                else model_ids)
    buf.count.add_(n_live)
    return buf


def _ring_order(buf: WriteBuffer):
    """Unroll the ring into append order. Returns (keys, values, ts, live,
    model slots)."""
    cap = buf.capacity
    idx = torch.arange(cap, dtype=torch.int32, device=buf.count.device)
    n_live = torch.clamp(buf.count, max=cap)
    # the oldest surviving record sits at count % cap once the ring wrapped
    start = torch.where(buf.count > cap, buf.count % cap, 0)
    ring = ((start + idx) % cap).long()
    keys = Key64(hi=buf.key_hi[ring], lo=buf.key_lo[ring])
    return (keys, buf.values[ring], buf.ts_ms[ring], idx < n_live,
            buf.model_id[ring])


# ============================================================= touch buffer
class TouchBuffer(NamedTuple):
    """Ring of hit coordinates awaiting deferred last-access bumps: the
    (bucket, way) each request hit in the direct AND failover caches
    (bucket -1 = no hit there) and the access timestamp."""

    bucket_d: torch.Tensor  # (cap,) int32 — direct-cache bucket, -1 = none
    way_d: torch.Tensor     # (cap,) int32
    bucket_f: torch.Tensor  # (cap,) int32 — failover bucket, -1 = none
    way_f: torch.Tensor     # (cap,) int32
    ts_ms: torch.Tensor     # (cap,) int32 — access timestamp
    count: torch.Tensor     # () int32 — appended since the last flush

    @property
    def capacity(self) -> int:
        return self.bucket_d.shape[0]


def init_touchbuf(capacity: int, device="cuda") -> TouchBuffer:
    device = cache_lib.resolve_device(device)
    full = lambda v: torch.full((capacity,), v, dtype=torch.int32,
                                device=device)
    return TouchBuffer(bucket_d=full(-1), way_d=full(0), bucket_f=full(-1),
                       way_f=full(0), ts_ms=full(0),
                       count=torch.zeros((), dtype=torch.int32,
                                         device=device))


def touch_append(buf: TouchBuffer, direct: cache_lib.LookupResult,
                 failover: cache_lib.LookupResult, ts_ms,
                 mask: Optional[torch.Tensor] = None) -> TouchBuffer:
    """Append one batch's hit coordinates at the ring head, IN PLACE.
    Rows that hit neither cache are compacted away; same ring discipline
    as :func:`append`."""
    B = direct.hit.shape[0]
    ts_vec = torch.as_tensor(ts_ms, dtype=torch.int32,
                             device=direct.hit.device).expand(B)
    live = direct.hit | failover.hit
    if mask is not None:
        live = live & mask
    bkt_d = torch.where(direct.hit & live, direct.bucket, -1)
    bkt_f = torch.where(failover.hit & live, failover.bucket, -1)
    slot, src, n_live = _ring_slots(buf.count, live, buf.capacity)
    _ring_write(buf.bucket_d, slot, src, bkt_d)
    _ring_write(buf.way_d, slot, src, direct.way)
    _ring_write(buf.bucket_f, slot, src, bkt_f)
    _ring_write(buf.way_f, slot, src, failover.way)
    _ring_write(buf.ts_ms, slot, src, ts_vec)
    buf.count.add_(n_live)
    return buf


def _touch_live(buf: TouchBuffer) -> torch.Tensor:
    """(cap,) bool — physical slots holding un-flushed records (scatter-max
    is order-independent, so no ring unroll is needed)."""
    idx = torch.arange(buf.capacity, dtype=torch.int32,
                       device=buf.count.device)
    return idx < torch.clamp(buf.count, max=buf.capacity)


# A flush may be predicated on a 0-d device bool ``enabled`` (the chaos
# engine's FlushStall), so a captured graph can skip it without a host
# sync: ``enabled`` is ANDed into every write mask and each ring's count
# is kept where it is False. A False predicate writes every slot with its
# own contents, which leaves every plane and both rings bit-identical.
def _gate(mask: torch.Tensor, enabled: Optional[torch.Tensor]):
    return mask if enabled is None else mask & enabled


def _reset(count: torch.Tensor, enabled: Optional[torch.Tensor]) -> None:
    if enabled is None:
        count.zero_()
    else:
        count.copy_(torch.where(enabled, 0, count))


def _apply_touches(buf: TouchBuffer, state: cache_lib.CacheState,
                   bucket: torch.Tensor, way: torch.Tensor,
                   enabled: Optional[torch.Tensor] = None
                   ) -> cache_lib.CacheState:
    """Scatter-max one cache's buffered bumps (records with bucket -1
    never hit that cache and are skipped)."""
    return cache_lib.touch(state, bucket, way, buf.ts_ms,
                           live=_gate(_touch_live(buf) & (bucket >= 0),
                                      enabled))


def _apply_touches_dual(buf: Optional[TouchBuffer],
                        direct: cache_lib.CacheState,
                        failover: cache_lib.CacheState,
                        enabled: Optional[torch.Tensor] = None):
    """Scatter-max the buffered bumps into both recency planes and reset
    the ring (no-op without a touch buffer)."""
    if buf is None:
        return direct, failover, None
    _apply_touches(buf, direct, buf.bucket_d, buf.way_d, enabled)
    _apply_touches(buf, failover, buf.bucket_f, buf.way_f, enabled)
    _reset(buf.count, enabled)
    return direct, failover, buf


def flush(buf: WriteBuffer, state: cache_lib.CacheState, now_ms, ttl_ms,
          evict_lru: bool = False, touchbuf: Optional[TouchBuffer] = None,
          enabled: Optional[torch.Tensor] = None, mesh=None
          ) -> Tuple[cache_lib.CacheState, WriteBuffer,
                     Optional[TouchBuffer]]:
    """Apply all buffered records to one cache, IN PLACE, in append order
    (so last-writer-wins follows the true write stream), after
    scatter-maxing ``touchbuf``'s DIRECT-cache bumps; reset the ring(s).
    ``evict_lru`` selects the victim order (paper §3.3); ``enabled`` (0-d
    bool, None: True) predicates the whole flush; ``mesh`` routes it to a
    bucket-sharded table, bit for bit."""
    if mesh is not None:
        from repro_torch.distributed import collectives as coll

        return coll.sharded_flush(mesh, buf, state, now_ms, ttl_ms,
                                  evict_lru=evict_lru, touchbuf=touchbuf,
                                  enabled=enabled)
    if touchbuf is not None:
        _apply_touches(touchbuf, state, touchbuf.bucket_d, touchbuf.way_d,
                       enabled)
        _reset(touchbuf.count, enabled)
    keys, values, ts, live, _ = _ring_order(buf)
    cache_lib.insert(state, keys, values, now_ms, ttl_ms,
                     write_mask=_gate(live, enabled), ts_ms=ts,
                     evict_lru=evict_lru)
    _reset(buf.count, enabled)
    return state, buf, touchbuf


def flush_dual(buf: WriteBuffer, direct: cache_lib.CacheState,
               failover: cache_lib.CacheState, now_ms,
               direct_ttl_ms, failover_ttl_ms, evict_lru: bool = False,
               touchbuf: Optional[TouchBuffer] = None,
               enabled: Optional[torch.Tensor] = None, mesh=None
               ) -> Tuple[cache_lib.CacheState, cache_lib.CacheState,
                          WriteBuffer, Optional[TouchBuffer]]:
    """Flush the ring into BOTH caches, IN PLACE, with ONE shared insert
    plan (``cache.insert_dual``): per cache the same as two :func:`flush`
    calls with the respective TTLs. The touch ring's bumps land in both
    recency planes first. ``enabled`` and ``mesh`` as in :func:`flush`
    (the sharded flush runs the two inserts apart: a record's two rows
    may live on different shards)."""
    if mesh is not None:
        from repro_torch.distributed import collectives as coll

        return coll.sharded_flush_dual(mesh, buf, direct, failover, now_ms,
                                       direct_ttl_ms, failover_ttl_ms,
                                       evict_lru=evict_lru,
                                       touchbuf=touchbuf, enabled=enabled)
    direct, failover, touchbuf = _apply_touches_dual(touchbuf, direct,
                                                     failover, enabled)
    keys, values, ts, live, _ = _ring_order(buf)
    cache_lib.insert_dual(direct, failover, keys, values, now_ms,
                          direct_ttl_ms, failover_ttl_ms,
                          write_mask=_gate(live, enabled), ts_ms=ts,
                          evict_lru=evict_lru)
    _reset(buf.count, enabled)
    return direct, failover, buf, touchbuf


def flush_dual_multi(buf: WriteBuffer, direct: cache_lib.MultiCacheState,
                     failover: cache_lib.MultiCacheState,
                     policy: cache_lib.ModelPolicy, now_ms,
                     touchbuf: Optional[TouchBuffer] = None,
                     enabled: Optional[torch.Tensor] = None, mesh=None
                     ) -> Tuple[cache_lib.MultiCacheState,
                                cache_lib.MultiCacheState, WriteBuffer,
                                Optional[TouchBuffer]]:
    """Flush a mixed-model ring into BOTH stacked tiers, IN PLACE, with ONE
    shared insert plan (``cache.insert_dual_multi``): each record under
    its model's TTLs and eviction policy, the dedupe salted by model slot.
    The touch ring holds POOLED (M*Nb) coordinates, so its bumps land on
    the flat views of the stacked recency planes first. ``enabled`` and
    ``mesh`` as in :func:`flush`."""
    if mesh is not None:
        from repro_torch.distributed import collectives as coll

        return coll.sharded_flush_dual_multi(mesh, buf, direct, failover,
                                             policy, now_ms,
                                             touchbuf=touchbuf,
                                             enabled=enabled)
    if touchbuf is not None:
        _apply_touches_dual(touchbuf, direct.flat(), failover.flat(),
                            enabled)
    keys, values, ts, live, slots = _ring_order(buf)
    cache_lib.insert_dual_multi(direct, failover, policy, slots, keys,
                                values, now_ms,
                                write_mask=_gate(live, enabled), ts_ms=ts)
    _reset(buf.count, enabled)
    return direct, failover, buf, touchbuf
