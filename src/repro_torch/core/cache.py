"""ERCache core: a set-associative, TTL-validated embedding cache in device
memory, as PyTorch functions on tensors.

Twin of ``repro/core/cache.py`` (its single-table part; the stacked
multi-model tier and the bucket-sharded tier join with their slices).
Layout and semantics are the reference's:

  * ``n_buckets`` buckets x ``ways`` slots; a lookup is one bucket row
    gather, which the ``cache_probe`` kernels exploit;
  * a hit needs the key to match AND ``now - write_ts <= ttl``; inserts
    pick, within the bucket: key-match > empty > expired > oldest (or the
    least recently used, with ``evict_lru``);
  * no read-refresh: entries are written only by inserts; reads feed the
    ``last_access_ts`` recency plane through :func:`touch`.

Unlike the reference, whose functions return new arrays, :func:`insert`,
:func:`insert_dual` and :func:`touch` update the tables IN PLACE and
return the same :class:`CacheState` (a multi-GB table is never copied).
Lookups never write.

Timestamps are int32 milliseconds; keys are (hi, lo) int32 pairs
(``hashing.Key64``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.hashing import EMPTY_HI, EMPTY_LO, Key64, bucket_index
from repro_torch.kernels import ref

INT32_MIN = -0x80000000
# Timestamp value for never-written slots (also the minimum, so "oldest
# wins" eviction prefers empty slots automatically on the ts tie-break).
TS_EMPTY = INT32_MIN

BACKENDS = ("torch", "cuda")


class CacheState(NamedTuple):
    """All tensors of one cache namespace."""

    key_hi: torch.Tensor          # (n_buckets, ways) int32
    key_lo: torch.Tensor          # (n_buckets, ways) int32
    write_ts: torch.Tensor        # (n_buckets, ways) int32, ms
    values: torch.Tensor          # (n_buckets, ways, dim)
    # max(read timestamps) per slot, bumped through the touch buffer;
    # writes reset it to the write ts. Only LRU eviction ranks on it.
    last_access_ts: torch.Tensor  # (n_buckets, ways) int32, ms

    @property
    def n_buckets(self) -> int:
        return self.key_hi.shape[0]

    @property
    def ways(self) -> int:
        return self.key_hi.shape[1]

    @property
    def dim(self) -> int:
        return self.values.shape[-1]

    @property
    def capacity(self) -> int:
        return self.n_buckets * self.ways

    def occupancy(self) -> torch.Tensor:
        """Fraction of slots holding an entry (any age)."""
        occupied = ~((self.key_hi == EMPTY_HI) & (self.key_lo == EMPTY_LO))
        return occupied.float().mean()


class LookupResult(NamedTuple):
    hit: torch.Tensor     # (B,) bool — key present AND within TTL
    values: torch.Tensor  # (B, dim) — cached value where hit, zeros otherwise
    age_ms: torch.Tensor  # (B,) int32 — now - write_ts where hit, -1 otherwise
    bucket: Optional[torch.Tensor] = None  # (B,) int32 — probed bucket
    way: Optional[torch.Tensor] = None     # (B,) int32 — hit way, -1 on miss


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA card is available; pass "
            "device='cpu' (with backend='torch') to run on the CPU")
    return device


def init_cache(n_buckets: int, ways: int, dim: int, dtype=torch.float32,
               device="cuda") -> CacheState:
    """Create an empty cache. ``n_buckets`` must be a power of two."""
    if n_buckets <= 0 or n_buckets & (n_buckets - 1):
        raise ValueError(f"n_buckets must be a power of 2, got {n_buckets}")
    device = resolve_device(device)
    shape = (n_buckets, ways)
    full = lambda v: torch.full(shape, v, dtype=torch.int32, device=device)
    return CacheState(
        key_hi=full(EMPTY_HI), key_lo=full(EMPTY_LO), write_ts=full(TS_EMPTY),
        values=torch.zeros(shape + (dim,), dtype=dtype, device=device),
        last_access_ts=full(TS_EMPTY))


def flat_entries(state: CacheState):
    """Every slot as flat per-entry vectors (bucket-major, way-minor) plus
    the occupancy mask: ``(keys, values, write_ts, last_access_ts, live)``
    with shapes ``(Nb*W,)`` / ``(Nb*W, dim)``. Views, not copies."""
    n = state.n_buckets * state.ways
    keys = Key64(hi=state.key_hi.reshape(n), lo=state.key_lo.reshape(n))
    live = ~((keys.hi == EMPTY_HI) & (keys.lo == EMPTY_LO))
    return (keys, state.values.reshape(n, state.dim),
            state.write_ts.reshape(n), state.last_access_ts.reshape(n), live)


def _check_backend(backend: str, *tensors) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown cache backend: {backend!r}")
    if backend == "cuda" and not all(t.is_cuda for t in tensors):
        raise ValueError("backend='cuda' runs the CUDA kernels and needs "
                         "CUDA tensors; use backend='torch' on the CPU")


def _now(now_ms, device) -> torch.Tensor:
    """The clock as an int64 0-d tensor (a device-resident clock stays on
    the device)."""
    return torch.as_tensor(now_ms, device=device).long()


def _probe(state: CacheState, keys: Key64):
    """Bucket index + per-way match/empty/ts gathers.
    Returns (bucket (B,) int32, match (B,W), empty (B,W), ts (B,W))."""
    bucket = bucket_index(keys, state.n_buckets)
    b = bucket.long()
    k_hi = state.key_hi[b]
    k_lo = state.key_lo[b]
    match = (k_hi == keys.hi[:, None]) & (k_lo == keys.lo[:, None])
    empty = (k_hi == EMPTY_HI) & (k_lo == EMPTY_LO)
    return bucket, match, empty, state.write_ts[b]


def lookup(state: CacheState, keys: Key64, now_ms, ttl_ms,
           backend: str = "cuda") -> LookupResult:
    """Batched TTL-validated lookup of one table.

    ``backend="cuda"`` launches the one-table probe kernel
    (``kernels.cache_probe.cache_probe_tiled``); ``"torch"`` runs its
    plain version. The two agree bit for bit.
    """
    _check_backend(backend, state.key_hi, keys.hi)
    buckets = bucket_index(keys, state.n_buckets)
    if backend == "cuda":
        from repro_torch.kernels import cache_probe as probe_kernels

        probe = probe_kernels.cache_probe_tiled
    else:
        probe = ref.cache_probe_ref
    hit, vals, age, way = probe(state.key_hi, state.key_lo, state.write_ts,
                                state.values, keys.hi, keys.lo, buckets,
                                now_ms, ttl_ms)
    return LookupResult(hit=hit, values=vals, age_ms=age, bucket=buckets,
                        way=way)


def lookup_dual(direct: CacheState, failover: CacheState, keys: Key64,
                now_ms, direct_ttl_ms, failover_ttl_ms,
                backend: str = "cuda"):
    """Probe the direct AND failover caches for the same keys.

    Returns (LookupResult_direct, LookupResult_failover). On the cuda
    backend this is ONE kernel launch (``cache_probe_dual``); on torch it
    is two plain lookups, with the same results.
    """
    if backend != "cuda":
        return (lookup(direct, keys, now_ms, direct_ttl_ms, backend=backend),
                lookup(failover, keys, now_ms, failover_ttl_ms,
                       backend=backend))
    from repro_torch.kernels import cache_probe as probe_kernels

    _check_backend(backend, direct.key_hi, failover.key_hi, keys.hi)
    b_d = bucket_index(keys, direct.n_buckets)
    b_f = bucket_index(keys, failover.n_buckets)
    (hd, vd, ad, wd), (hf, vf, af, wf) = probe_kernels.cache_probe_dual(
        direct.key_hi, direct.key_lo, direct.write_ts, direct.values,
        failover.key_hi, failover.key_lo, failover.write_ts, failover.values,
        keys.hi, keys.lo, b_d, b_f, now_ms, direct_ttl_ms, failover_ttl_ms)
    return (LookupResult(hit=hd, values=vd, age_ms=ad, bucket=b_d, way=wd),
            LookupResult(hit=hf, values=vf, age_ms=af, bucket=b_f, way=wf))


def _lexsort(cols) -> torch.Tensor:
    """``jnp.lexsort``: the LAST column is the primary key. Chained stable
    sorts, least significant column first."""
    order = torch.sort(cols[0], stable=True).indices
    for col in cols[1:]:
        order = order[torch.sort(col[order], stable=True).indices]
    return order


def _next(a: torch.Tensor, fill: int) -> torch.Tensor:
    return torch.cat([a[1:], torch.full((1,), fill, dtype=a.dtype,
                                        device=a.device)])


def _sorted_runs(keys: Key64, dead: torch.Tensor, idx_col: torch.Tensor):
    """The one lexsort of the batch dedupes: order by (dead, hi, lo,
    idx_col). Returns (order, same_as_next, sorted dead)."""
    order = _lexsort([idx_col, keys.lo, keys.hi, dead])
    s_d = dead[order]
    s_hi = keys.hi[order]
    s_lo = keys.lo[order]
    same_as_next = ((s_d == _next(s_d, -1)) & (s_hi == _next(s_hi, 0))
                    & (s_lo == _next(s_lo, 0)))
    return order, same_as_next, s_d


def _dedupe(keys: Key64, live: torch.Tensor) -> torch.Tensor:
    """Last-writer-wins batch dedupe: winner (B,) bool marks the LAST live
    occurrence of each distinct key."""
    B = keys.hi.shape[0]
    idx = torch.arange(B, dtype=torch.int32, device=live.device)
    order, same_as_next, s_d = _sorted_runs(keys, (~live).to(torch.int32),
                                            idx)
    winner = torch.zeros(B, dtype=torch.bool, device=live.device)
    winner[order] = ~same_as_next & (s_d == 0)
    return winner


def dedupe_first_groups(keys: Key64, live: torch.Tensor):
    """First-occurrence dedupe of the ``live`` rows (the serve path's
    in-batch coalescing) plus the broadcast map.

    Returns ``(rep, src_row)``: ``rep`` (B,) bool marks each distinct
    key's FIRST live row; ``src_row`` (B,) int32 gives every live row the
    batch index of its representative, -1 on dead rows.
    """
    B = keys.hi.shape[0]
    dev = live.device
    idx = torch.arange(B, dtype=torch.int32, device=dev)
    # reversed index column: the sort's within-group "last" is then the
    # smallest original index, the first occurrence
    order, same_as_next, s_d = _sorted_runs(keys, (~live).to(torch.int32),
                                            B - 1 - idx)
    rep_sorted = ~same_as_next & (s_d == 0)
    rep = torch.zeros(B, dtype=torch.bool, device=dev)
    rep[order] = rep_sorted
    # groups are contiguous in sorted order: scatter each group's
    # representative index by dense group id, gather back
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          ~same_as_next[:-1]])
    gid = torch.cumsum(is_start.long(), 0) - 1
    s_idx = idx[order]
    rep_of_g = torch.full((B,), -1, dtype=torch.int32, device=dev)
    rep_of_g.scatter_reduce_(0, gid, torch.where(rep_sorted, s_idx, -1),
                             "amax", include_self=True)
    src_row = torch.zeros(B, dtype=torch.int32, device=dev)
    src_row[order] = rep_of_g[gid]
    return rep, torch.where(live, src_row, -1)


def _bucket_rank(bucket: torch.Tensor, winner: torch.Tensor,
                 n_buckets: int) -> torch.Tensor:
    """Per-bucket rank of the winners (batch order within each bucket),
    via ONE stable single-key sort."""
    B = bucket.shape[0]
    bkt_w = torch.where(winner, bucket, n_buckets)
    order = torch.sort(bkt_w, stable=True).indices
    s_b = bkt_w[order]
    win_i = winner[order].long()
    cum = torch.cumsum(win_i, 0)
    prev_b = torch.cat([torch.full((1,), -1, dtype=s_b.dtype,
                                   device=s_b.device), s_b[:-1]])
    seg_base = torch.cummax(torch.where(s_b != prev_b, cum - win_i, -1),
                            0).values
    rank = torch.zeros(B, dtype=torch.int32, device=bucket.device)
    rank[order] = (cum - 1 - seg_base).to(torch.int32)
    return rank


def _choose_way(match, empty, expired, ts, rank, lru: bool = False,
                recency=None) -> torch.Tensor:
    """(B, W) probe results + (B,) rank -> (B,) way, without sorting.

    Eviction order is lexicographic (priority, ts, way): TTL-priority
    ranks empty(0) > expired(1) > live(2) on the write timestamp;
    LRU-timestamp (``lru``) ranks empty(0) > everything else(2) on
    ``recency`` = max(write_ts, last_access_ts). A key already in the
    bucket keeps its way.
    """
    W = ts.shape[-1]
    if lru:
        priority = torch.where(empty, 0, 2)
        if recency is not None:
            ts = recency
    else:
        priority = torch.where(empty, 0, torch.where(expired, 1, 2))
    w_idx = torch.arange(W, device=ts.device)
    # rank_ts[b, w] = #{w' : (ts[b, w'], w') < (ts[b, w], w)}
    ts_w = ts[:, :, None]
    ts_wp = ts[:, None, :]
    lt = (ts_wp < ts_w) | ((ts_wp == ts_w)
                           & (w_idx[None, None, :] < w_idx[None, :, None]))
    rank_ts = lt.sum(dim=2)
    composite = priority * W + rank_ts
    pos = (composite[:, None, :] < composite[:, :, None]).sum(dim=2)
    r = rank.clamp(0, W - 1).long()
    way_evict = (w_idx[None, :] * (pos == r[:, None])).sum(dim=1)
    has_match = match.any(dim=-1)
    way_match = match.to(torch.int32).argmax(dim=-1)
    return torch.where(has_match, way_match, way_evict).to(torch.int32)


def _resolve_collisions(winner, bucket, way, n_buckets: int,
                        ways: int) -> torch.Tensor:
    """Last-writer-wins on residual slot collisions: scatter-max each
    winner's batch index into its target slot, keep the index that won."""
    B = bucket.shape[0]
    idx = torch.arange(B, dtype=torch.int32, device=bucket.device)
    slot = bucket.long() * ways + way.long()
    best = torch.full((n_buckets * ways,), -1, dtype=torch.int32,
                      device=bucket.device)
    best.scatter_reduce_(0, slot[winner], idx[winner], "amax",
                         include_self=True)
    return winner & (best[slot] == idx)


def _expired(empty, ts, now, ttl_ms) -> torch.Tensor:
    # TS_EMPTY lanes wrap; ~empty masks them
    return ~empty & (ref.wrap_i32(now - ts.long()) > ttl_ms)


def plan_insert(state: CacheState, keys: Key64, now_ms, ttl_ms,
                write_mask: Optional[torch.Tensor] = None,
                evict_lru: bool = False):
    """Slot assignment for a batched insert, emulating sequential writes:
    the LAST occurrence of a key wins, a present key keeps its way,
    distinct new keys of one bucket get distinct ways in eviction order,
    and more than W new keys of one bucket collide on the last way.
    Returns (winner (B,) bool, bucket (B,) int32, way (B,) int32) with
    distinct target slots for the winners."""
    B = keys.hi.shape[0]
    now = _now(now_ms, keys.hi.device)
    bucket, match, empty, ts = _probe(state, keys)
    live = (write_mask if write_mask is not None
            else torch.ones(B, dtype=torch.bool, device=keys.hi.device))
    winner = _dedupe(keys, live)
    rank = _bucket_rank(bucket, winner, state.n_buckets)
    recency = torch.maximum(ts, state.last_access_ts[bucket.long()])
    way = _choose_way(match, empty, _expired(empty, ts, now, ttl_ms), ts,
                      rank, lru=evict_lru, recency=recency)
    winner = _resolve_collisions(winner, bucket, way, state.n_buckets,
                                 state.ways)
    return winner, bucket, way


def _scatter_insert(state: CacheState, keys: Key64, values, ts_vec,
                    winner, bucket, way) -> CacheState:
    """Apply a resolved insert plan in place: only the winners' rows are
    written (the reference drops the losers with ``mode="drop"``). A write
    resets the slot's last_access_ts to the write timestamp."""
    b = bucket.long()[winner]
    w = way.long()[winner]
    state.key_hi[b, w] = keys.hi[winner]
    state.key_lo[b, w] = keys.lo[winner]
    state.write_ts[b, w] = ts_vec[winner]
    state.values[b, w] = values[winner].to(state.values.dtype)
    state.last_access_ts[b, w] = ts_vec[winner]
    return state


def _ts_vector(values, now_ms, ts_ms) -> torch.Tensor:
    if ts_ms is None:
        return torch.as_tensor(now_ms, dtype=torch.int32,
                               device=values.device).expand(values.shape[0])
    return torch.as_tensor(ts_ms, dtype=torch.int32, device=values.device)


def insert(state: CacheState, keys: Key64, values: torch.Tensor, now_ms,
           ttl_ms, write_mask: Optional[torch.Tensor] = None,
           ts_ms: Optional[torch.Tensor] = None,
           evict_lru: bool = False) -> CacheState:
    """Batched insert/overwrite with sequential-write emulation (see
    :func:`plan_insert`), IN PLACE. ``write_mask`` disables individual
    writes; ``ts_ms`` carries per-entry compute timestamps (an embedding
    computed at t ages from t however late it is flushed)."""
    winner, bucket, way = plan_insert(state, keys, now_ms, ttl_ms,
                                      write_mask, evict_lru=evict_lru)
    return _scatter_insert(state, keys, values,
                           _ts_vector(values, now_ms, ts_ms),
                           winner, bucket, way)


def touch(state: CacheState, bucket, way, ts_ms,
          live: Optional[torch.Tensor] = None) -> CacheState:
    """Bump ``last_access_ts`` at hit coordinates, IN PLACE, with ONE
    scatter-max (so the order of the bumps is irrelevant). Rows with
    ``way`` < 0, ``live`` False or a bucket outside the table are
    skipped."""
    B = bucket.shape[0]
    ts_vec = torch.as_tensor(ts_ms, dtype=torch.int32,
                             device=bucket.device).expand(B)
    ok = (way >= 0) & (bucket >= 0) & (bucket < state.n_buckets)
    if live is not None:
        ok = ok & live
    slot = bucket.long() * state.ways + way.long()
    state.last_access_ts.view(-1).scatter_reduce_(0, slot[ok], ts_vec[ok],
                                                  "amax", include_self=True)
    return state


def insert_dual(direct: CacheState, failover: CacheState, keys: Key64,
                values: torch.Tensor, now_ms, direct_ttl_ms, failover_ttl_ms,
                write_mask: Optional[torch.Tensor] = None,
                ts_ms: Optional[torch.Tensor] = None,
                evict_lru: bool = False):
    """Insert the same records into BOTH caches, IN PLACE, with ONE shared
    plan: the batch dedupe runs once, the per-bucket ranks are reused when
    both tables map keys alike (same ``n_buckets``), and way choice and
    collision resolution run per cache on its own contents. Results equal
    two independent :func:`insert` calls. Returns (direct, failover)."""
    B = keys.hi.shape[0]
    dev = keys.hi.device
    now = _now(now_ms, dev)
    live = (write_mask if write_mask is not None
            else torch.ones(B, dtype=torch.bool, device=dev))
    ts_vec = _ts_vector(values, now_ms, ts_ms)
    winner = _dedupe(keys, live)
    # Both plans read their table's pre-insert contents before either
    # table is written.
    b_d, match_d, empty_d, ts_d = _probe(direct, keys)
    b_f, match_f, empty_f, ts_f = _probe(failover, keys)
    rank_d = _bucket_rank(b_d, winner, direct.n_buckets)
    rank_f = (rank_d if failover.n_buckets == direct.n_buckets
              else _bucket_rank(b_f, winner, failover.n_buckets))
    plans = []
    for state, b, match, empty, ts, rank, ttl in (
            (direct, b_d, match_d, empty_d, ts_d, rank_d, direct_ttl_ms),
            (failover, b_f, match_f, empty_f, ts_f, rank_f,
             failover_ttl_ms)):
        recency = torch.maximum(ts, state.last_access_ts[b.long()])
        way = _choose_way(match, empty, _expired(empty, ts, now, ttl), ts,
                          rank, lru=evict_lru, recency=recency)
        win = _resolve_collisions(winner, b, way, state.n_buckets,
                                  state.ways)
        plans.append((state, win, b, way))
    for state, win, b, way in plans:
        _scatter_insert(state, keys, values, ts_vec, win, b, way)
    return direct, failover
