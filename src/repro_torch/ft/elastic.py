"""Elastic re-sharding: keep serving when the device count or the table
geometry changes.

Twin of ``repro/ft/elastic.py``. :func:`plan_mesh` and
:func:`elastic_transition` are pure-Python copies: a deterministic plan
from (n_devices, constraints) to a mesh shape and the re-partitioning of
the standing state.

The cache side (paper §3.6–3.7: a deploy must not cold-start the table):
a snapshot taken under one geometry restores into a differently shaped
table (:func:`rehash_cache` / :func:`rehash_multi_cache`). Live, unexpired
entries are re-bucketed through the normal insert plan with their ORIGINAL
write timestamps (age is preserved), oldest first, so that when a shrunk
table's bucket overflows the newest entries win the contested ways. A
second pass re-applies ``last_access_ts`` through the touch scatter-max so
the LRU recency plane survives too.

The tables stay on their device: the candidates are picked and ordered
there (one host sync sizes the set), the inserts and touches write the new
table IN PLACE (``core.cache``), and the recency pass's lookup runs
``backend``'s probe (``"cuda"``: the one-table kernel). The old table is
only read.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import cache as C
from repro_torch.core.hashing import EMPTY_HI, EMPTY_LO, Key64


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    per_device_batch: int
    notes: str = ""

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def _factor_pairs(n: int) -> List[Tuple[int, int]]:
    out = []
    d = 1
    while d * d <= n:
        if n % d == 0:
            out.append((d, n // d))
            out.append((n // d, d))
        d += 1
    return sorted(set(out))


def plan_mesh(n_devices: int, global_batch: int,
              model_parallel_min: int = 1,
              prefer_model: int = 16) -> MeshPlan:
    """Choose (data, model) maximizing data-parallel width subject to:
    model >= model_parallel_min (HBM fit) and data | global_batch.

    Among feasible factorizations prefer model size closest to
    ``prefer_model`` (the TP width the kernels are blocked for), breaking
    ties toward larger data.
    """
    candidates = []
    for data, model in _factor_pairs(n_devices):
        if model < model_parallel_min:
            continue
        if global_batch % data != 0:
            continue
        candidates.append((abs(model - prefer_model), -data, data, model))
    if not candidates:
        # degenerate: all devices on model axis
        return MeshPlan(shape=(1, n_devices), axes=("data", "model"),
                        per_device_batch=global_batch,
                        notes="no data-parallel factorization fits")
    _, _, data, model = sorted(candidates)[0]
    return MeshPlan(shape=(data, model), axes=("data", "model"),
                    per_device_batch=global_batch // data)


def elastic_transition(old: MeshPlan, n_devices_now: int,
                       global_batch: int,
                       model_parallel_min: int = 1) -> Dict[str, object]:
    """The coordinator's failover recipe when the device count changes.

    Returns the new plan plus the re-partition summary: which state is
    re-split (optimizer/cache shards move between devices; checkpointed
    global arrays simply re-load under the new sharding).
    """
    new = plan_mesh(n_devices_now, global_batch,
                    model_parallel_min=model_parallel_min,
                    prefer_model=old.shape[-1])
    old_data, old_model = old.shape[-2], old.shape[-1]
    new_data, new_model = new.shape[-2], new.shape[-1]
    return {
        "new_plan": new,
        "batch_resplit": old_data != new_data,
        "weight_reshard": old_model != new_model,
        "cache_resplit": old_data != new_data,   # cache slots follow data
        "restart_from_checkpoint": True,
        "per_device_batch": new.per_device_batch,
    }


# ======================================================= cache elastic rehash
def _padded(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    """``x`` padded along its first axis to ``n`` rows of ``fill``."""
    pad = x.new_full((n - x.shape[0],) + tuple(x.shape[1:]), fill)
    return torch.cat([x, pad])


def rehash_cache(old: C.CacheState, new: C.CacheState, now_ms: int,
                 ttl_ms: int, evict_lru: Optional[bool] = None,
                 chunk: int = 4096, backend: str = "cuda"
                 ) -> Tuple[C.CacheState, int]:
    """Re-bucket ``old``'s live, unexpired entries into ``new``'s geometry,
    writing ``new`` IN PLACE (``old`` is only read).

    ``new`` is a (typically empty) table with a different ``n_buckets`` /
    ``ways``; entries flow through the normal insert plan in padded chunks
    of ``chunk``, so every batching and eviction invariant holds:

    * **Age preservation**: inserts carry ``ts_ms = original write_ts``;
      entries already expired at ``now_ms`` are dropped up front.
    * **Newest wins on shrink**: candidates are inserted oldest first
      (a stable sort on ``write_ts``: ties keep table order).
    * **Recency survives**: a second pass looks every candidate up
      (``backend``'s probe) and re-applies its ``last_access_ts`` through
      the touch scatter-max; entries evicted by a later chunk miss the
      lookup and are skipped.

    Returns ``(new, n_candidates)``: the count of live unexpired entries
    that were replayed (survivors of a shrink may be fewer).
    """
    C._check_backend(backend, new.key_hi)
    keys, vals, wts, lats, live = C.flat_entries(old)
    dev = new.key_hi.device
    # int64 age math: empty slots hold TS_EMPTY = int32 min, and
    # now - int32min overflows int32
    age = now_ms - wts.long()
    idx = torch.nonzero(live & (age <= int(ttl_ms))).reshape(-1)
    idx = idx[torch.sort(wts[idx], stable=True).indices]
    n = int(idx.numel())
    lru = bool(evict_lru)

    def gather(base):
        sel = idx[base:base + chunk]
        b = int(sel.numel())
        k = Key64(hi=_padded(keys.hi[sel], chunk, EMPTY_HI).to(dev),
                  lo=_padded(keys.lo[sel], chunk, EMPTY_LO).to(dev))
        mask = torch.arange(chunk, device=dev) < b
        return sel, k, mask

    for base in range(0, n, chunk):
        sel, k, mask = gather(base)
        C.insert(new, k, _padded(vals[sel], chunk, 0).to(dev), now_ms,
                 ttl_ms, write_mask=mask,
                 ts_ms=_padded(wts[sel], chunk, 0).to(dev), evict_lru=lru)
    for base in range(0, n, chunk):
        sel, k, mask = gather(base)
        res = C.lookup(new, k, now_ms, ttl_ms, backend=backend)
        C.touch(new, res.bucket, res.way,
                _padded(lats[sel], chunk, 0).to(dev), live=mask)
    return new, n


def rehash_multi_cache(old: C.MultiCacheState,
                       old_n_buckets: Sequence[int],
                       new: C.MultiCacheState,
                       new_n_buckets: Sequence[int],
                       now_ms: int, ttl_ms: Sequence[int],
                       evict_lru: Optional[Sequence[bool]] = None,
                       chunk: int = 4096, backend: str = "cuda"
                       ) -> Tuple[C.MultiCacheState, List[int]]:
    """Per-model elastic rehash of a stacked tier, IN PLACE in ``new``.

    Each model's slab is a standalone set-associative table over its own
    first ``n_buckets[m]`` rows, and ``bucket_index`` over a power-of-2
    ``nb`` equals the pooled local mapping, so the rehash is M single-table
    rehashes, each straight into its slot's view of the new stack
    (``model_view``). Returns ``(new, per-model candidate counts)``.
    """
    assert old.n_models == new.n_models, (old.n_models, new.n_models)
    counts: List[int] = []
    for m in range(new.n_models):
        _, cnt = rehash_cache(
            old.model_view(m, int(old_n_buckets[m])),
            new.model_view(m, int(new_n_buckets[m])), now_ms,
            int(ttl_ms[m]),
            evict_lru=None if evict_lru is None else bool(evict_lru[m]),
            chunk=chunk, backend=backend)
        counts.append(cnt)
    return new, counts
