"""ERCache core: a set-associative, TTL-validated embedding cache in device
memory, as PyTorch functions on tensors.

Twin of ``repro/core/cache.py``: the single-table functions and the
stacked multi-model tier (the bucket-sharded tier joins with its slice).
Layout and semantics are the reference's:

  * ``n_buckets`` buckets x ``ways`` slots; a lookup is one bucket row
    gather, which the ``cache_probe`` kernels exploit;
  * a hit needs the key to match AND ``now - write_ts <= ttl``; inserts
    pick, within the bucket: key-match > empty > expired > oldest (or the
    least recently used, with ``evict_lru``);
  * no read-refresh: entries are written only by inserts; reads feed the
    ``last_access_ts`` recency plane through :func:`touch`.

Unlike the reference, whose functions return new arrays, :func:`insert`,
:func:`insert_dual`, :func:`insert_dual_multi` and :func:`touch` update
the tables IN PLACE and return the same states (a multi-GB table is never
copied). Lookups never write.

Timestamps are int32 milliseconds; keys are (hi, lo) int32 pairs
(``hashing.Key64``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core.hashing import (EMPTY_HI, EMPTY_LO, Key64,
                                      bucket_index, hash_u32)
from repro_torch.core.ratelimit import budget_table
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


def _ttl_cols(ttl_ms):
    """Scalar TTL or per-query (B,) TTLs, broadcastable against (B, W).
    Per-query TTLs are how the multi-model tier threads each model's
    policy through one shared probe and insert plan."""
    if isinstance(ttl_ms, torch.Tensor) and ttl_ms.dim() == 1:
        return ttl_ms[:, None]
    return ttl_ms


def _probe(state: CacheState, keys: Key64, bucket=None):
    """Bucket index + per-way match/empty/ts gathers. ``bucket`` overrides
    the hash-derived index (the multi-model tier passes pooled buckets).
    Returns (bucket (B,) int32, match (B,W), empty (B,W), ts (B,W))."""
    if bucket is None:
        bucket = bucket_index(keys, state.n_buckets)
    b = bucket.long()
    k_hi = state.key_hi[b]
    k_lo = state.key_lo[b]
    match = (k_hi == keys.hi[:, None]) & (k_lo == keys.lo[:, None])
    empty = (k_hi == EMPTY_HI) & (k_lo == EMPTY_LO)
    return bucket, match, empty, state.write_ts[b]


def lookup(state: CacheState, keys: Key64, now_ms, ttl_ms,
           backend: str = "cuda", buckets=None) -> LookupResult:
    """Batched TTL-validated lookup of one table.

    ``backend="cuda"`` launches the one-table probe kernel
    (``kernels.cache_probe.cache_probe_tiled``); ``"torch"`` runs its
    plain version. The two agree bit for bit. ``ttl_ms`` may be a
    per-query (B,) tensor on the torch backend (the multi-model tier's
    kernel is :func:`lookup_dual_multi`); ``buckets`` overrides the
    hash-derived index.
    """
    _check_backend(backend, state.key_hi, keys.hi)
    if buckets is None:
        buckets = bucket_index(keys, state.n_buckets)
    if backend == "cuda":
        from repro_torch.kernels import cache_probe as probe_kernels

        if isinstance(ttl_ms, torch.Tensor) and ttl_ms.dim():
            raise ValueError("per-query ttl_ms needs the multi-model "
                             "kernel: use lookup_dual_multi")
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


def _sorted_runs(keys: Key64, dead: torch.Tensor, idx_col: torch.Tensor,
                 salt=None):
    """The one lexsort of the batch dedupes: order by (dead, salt, hi, lo,
    idx_col). ``salt`` (optional (B,) int32, the multi-model tier's model
    slots) widens key identity to (salt, key). Returns (order,
    same_as_next, sorted dead)."""
    cols = [idx_col, keys.lo, keys.hi]
    if salt is not None:
        salt = salt.to(torch.int32)
        cols.append(salt)
    order = _lexsort(cols + [dead])
    s_d = dead[order]
    s_hi = keys.hi[order]
    s_lo = keys.lo[order]
    same_as_next = ((s_d == _next(s_d, -1)) & (s_hi == _next(s_hi, 0))
                    & (s_lo == _next(s_lo, 0)))
    if salt is not None:
        s_s = salt[order]
        same_as_next = same_as_next & (s_s == _next(s_s, -1))
    return order, same_as_next, s_d


def _dedupe(keys: Key64, live: torch.Tensor, salt=None) -> torch.Tensor:
    """Last-writer-wins batch dedupe: winner (B,) bool marks the LAST live
    occurrence of each distinct (salt, key). The salt keeps the same user
    buffered for two models two records: they target different slabs."""
    B = keys.hi.shape[0]
    idx = torch.arange(B, dtype=torch.int32, device=live.device)
    order, same_as_next, s_d = _sorted_runs(keys, (~live).to(torch.int32),
                                            idx, salt)
    winner = torch.zeros(B, dtype=torch.bool, device=live.device)
    winner[order] = ~same_as_next & (s_d == 0)
    return winner


def dedupe_first_groups(keys: Key64, live: torch.Tensor, salt=None):
    """First-occurrence dedupe of the ``live`` rows (the serve path's
    in-batch coalescing) plus the broadcast map. ``salt`` widens key
    identity as in :func:`_dedupe` (the same user queried for two models
    is two inferences).

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
                                            B - 1 - idx, salt)
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


def _choose_way(match, empty, expired, ts, rank, lru=False,
                recency=None) -> torch.Tensor:
    """(B, W) probe results + (B,) rank -> (B,) way, without sorting.

    Eviction order is lexicographic (priority, ts, way): TTL-priority
    ranks empty(0) > expired(1) > live(2) on the write timestamp;
    LRU-timestamp (``lru``) ranks empty(0) > everything else(2) on
    ``recency`` = max(write_ts, last_access_ts). ``lru`` is a bool or a
    per-query (B,) bool tensor (mixed-model batches: each row ranks on
    its own policy). A key already in the bucket keeps its way.
    """
    W = ts.shape[-1]
    prio_ttl = torch.where(empty, 0, torch.where(expired, 1, 2))
    if isinstance(lru, torch.Tensor):
        lru_b = lru[:, None] if lru.dim() == 1 else lru
        priority = torch.where(lru_b, torch.where(empty, 0, 2), prio_ttl)
        if recency is not None:
            ts = torch.where(lru_b, recency, ts)
    elif lru:
        priority = torch.where(empty, 0, 2)
        if recency is not None:
            ts = recency
    else:
        priority = prio_ttl
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
                        ways: int):
    """Last-writer-wins on residual slot collisions: scatter-max each
    winner's batch index into its target slot, keep the index that won.
    Returns (winner (B,) bool, owner (B,) int32: the winner whose record
    each row's target slot receives, -1 where no winner writes it)."""
    B = bucket.shape[0]
    idx = torch.arange(B, dtype=torch.int32, device=bucket.device)
    slot = bucket.long() * ways + way.long()
    best = torch.full((n_buckets * ways,), -1, dtype=torch.int32,
                      device=bucket.device)
    # losers scatter -1, which never beats the fill: no host sync picks
    # the winners out
    best.scatter_reduce_(0, slot, torch.where(winner, idx, -1), "amax",
                         include_self=True)
    owner = best[slot]
    return winner & (owner == idx), owner


def _expired(empty, ts, now, ttl_ms) -> torch.Tensor:
    # TS_EMPTY lanes wrap; ~empty masks them
    return ~empty & (ref.wrap_i32(now - ts.long()) > _ttl_cols(ttl_ms))


def _plan(state: CacheState, keys: Key64, now_ms, ttl_ms, write_mask,
          evict_lru, buckets, dedupe_salt):
    """:func:`plan_insert` plus each row's slot owner (the
    :func:`_resolve_collisions` contract)."""
    B = keys.hi.shape[0]
    now = _now(now_ms, keys.hi.device)
    bucket, match, empty, ts = _probe(state, keys, buckets)
    live = (write_mask if write_mask is not None
            else torch.ones(B, dtype=torch.bool, device=keys.hi.device))
    winner = _dedupe(keys, live, dedupe_salt)
    rank = _bucket_rank(bucket, winner, state.n_buckets)
    recency = torch.maximum(ts, state.last_access_ts[bucket.long()])
    way = _choose_way(match, empty, _expired(empty, ts, now, ttl_ms), ts,
                      rank, lru=evict_lru, recency=recency)
    winner, owner = _resolve_collisions(winner, bucket, way,
                                        state.n_buckets, state.ways)
    return winner, bucket, way, owner


def plan_insert(state: CacheState, keys: Key64, now_ms, ttl_ms,
                write_mask: Optional[torch.Tensor] = None,
                evict_lru=False, buckets=None, dedupe_salt=None):
    """Slot assignment for a batched insert, emulating sequential writes:
    the LAST occurrence of a key wins, a present key keeps its way,
    distinct new keys of one bucket get distinct ways in eviction order,
    and more than W new keys of one bucket collide on the last way.
    Multi-model knobs: ``ttl_ms`` and ``evict_lru`` may be per-query,
    ``buckets`` injects pooled indices and ``dedupe_salt`` widens key
    identity (:func:`_dedupe`).
    Returns (winner (B,) bool, bucket (B,) int32, way (B,) int32) with
    distinct target slots for the winners."""
    return _plan(state, keys, now_ms, ttl_ms, write_mask, evict_lru,
                 buckets, dedupe_salt)[:3]


def _scatter_insert(state: CacheState, keys: Key64, values, ts_vec,
                    owner, bucket, way) -> CacheState:
    """Apply a resolved insert plan in place: only the winners' records
    land (the reference drops the losers with ``mode="drop"``). A write
    resets the slot's last_access_ts to the write timestamp.

    Every row writes its target slot, so no host sync picks the winners
    out: a row writes the record of the slot's ``owner`` (-1: the slot's
    own contents), and each slot receives one value whatever the order of
    the writes."""
    b, w = bucket.long(), way.long()
    src = owner.clamp(min=0).long()
    won = owner >= 0

    def put(plane, rows):
        new = rows[src].to(plane.dtype)
        keep = won.view(-1, *([1] * (new.dim() - 1)))
        plane[b, w] = torch.where(keep, new, plane[b, w])

    put(state.key_hi, keys.hi)
    put(state.key_lo, keys.lo)
    put(state.write_ts, ts_vec)
    put(state.values, values)
    put(state.last_access_ts, ts_vec)
    return state


def _ts_vector(values, now_ms, ts_ms) -> torch.Tensor:
    if ts_ms is None:
        return torch.as_tensor(now_ms, dtype=torch.int32,
                               device=values.device).expand(values.shape[0])
    return torch.as_tensor(ts_ms, dtype=torch.int32, device=values.device)


def insert(state: CacheState, keys: Key64, values: torch.Tensor, now_ms,
           ttl_ms, write_mask: Optional[torch.Tensor] = None,
           ts_ms: Optional[torch.Tensor] = None,
           evict_lru=False, buckets=None, dedupe_salt=None) -> CacheState:
    """Batched insert/overwrite with sequential-write emulation (see
    :func:`plan_insert`), IN PLACE. ``write_mask`` disables individual
    writes; ``ts_ms`` carries per-entry compute timestamps (an embedding
    computed at t ages from t however late it is flushed)."""
    _, bucket, way, owner = _plan(state, keys, now_ms, ttl_ms, write_mask,
                                  evict_lru, buckets, dedupe_salt)
    return _scatter_insert(state, keys, values,
                           _ts_vector(values, now_ms, ts_ms),
                           owner, bucket, way)


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
    # skipped rows scatter TS_EMPTY (the int32 minimum, which never beats
    # a slot's value) into slot 0: no host sync picks the rows out
    slot = torch.where(ok, bucket.long() * state.ways + way.long(), 0)
    state.last_access_ts.view(-1).scatter_reduce_(
        0, slot, torch.where(ok, ts_vec, TS_EMPTY), "amax",
        include_self=True)
    return state


def insert_dual(direct: CacheState, failover: CacheState, keys: Key64,
                values: torch.Tensor, now_ms, direct_ttl_ms, failover_ttl_ms,
                write_mask: Optional[torch.Tensor] = None,
                ts_ms: Optional[torch.Tensor] = None,
                evict_lru=False, buckets_d=None, buckets_f=None,
                dedupe_salt=None):
    """Insert the same records into BOTH caches, IN PLACE, with ONE shared
    plan: the batch dedupe runs once, the per-bucket ranks are reused when
    both tables map keys alike (the hash-derived path with equal
    ``n_buckets``, or ONE explicit ``buckets`` tensor passed as both
    ``buckets_d`` and ``buckets_f``: object identity, as in the
    reference), and way choice and collision resolution run per cache on
    its own contents. TTLs and ``evict_lru`` may be per-query (the
    multi-model flush). Results equal two independent :func:`insert`
    calls. Returns (direct, failover)."""
    B = keys.hi.shape[0]
    dev = keys.hi.device
    now = _now(now_ms, dev)
    live = (write_mask if write_mask is not None
            else torch.ones(B, dtype=torch.bool, device=dev))
    ts_vec = _ts_vector(values, now_ms, ts_ms)
    winner = _dedupe(keys, live, dedupe_salt)
    # Both plans read their table's pre-insert contents before either
    # table is written.
    b_d, match_d, empty_d, ts_d = _probe(direct, keys, buckets_d)
    b_f, match_f, empty_f, ts_f = _probe(failover, keys, buckets_f)
    rank_d = _bucket_rank(b_d, winner, direct.n_buckets)
    same_mapping = ((buckets_d is None and buckets_f is None
                     and failover.n_buckets == direct.n_buckets)
                    or (buckets_d is not None and buckets_d is buckets_f))
    rank_f = (rank_d if same_mapping
              else _bucket_rank(b_f, winner, failover.n_buckets))
    plans = []
    for state, b, match, empty, ts, rank, ttl in (
            (direct, b_d, match_d, empty_d, ts_d, rank_d, direct_ttl_ms),
            (failover, b_f, match_f, empty_f, ts_f, rank_f,
             failover_ttl_ms)):
        recency = torch.maximum(ts, state.last_access_ts[b.long()])
        way = _choose_way(match, empty, _expired(empty, ts, now, ttl), ts,
                          rank, lru=evict_lru, recency=recency)
        _, owner = _resolve_collisions(winner, b, way, state.n_buckets,
                                       state.ways)
        plans.append((state, owner, b, way))
    for state, owner, b, way in plans:
        _scatter_insert(state, keys, values, ts_vec, owner, b, way)
    return direct, failover


# =========================================================== multi-model tier
# One serving tier fronting the whole model registry: per-model direct and
# failover tables stacked along a leading model axis; a mixed-model batch
# of (model slot, user key) pairs is served by ONE dual-probe launch, each
# query validated at its own model's TTLs from a small policy table.


class ModelPolicy(NamedTuple):
    """Per-model policy table of the multi-model tier: device tensors
    indexed by model SLOT (the model's position in the tier, not its
    ``model_id``). The bucket masks give each model its own capacity
    inside the stacked table: local bucket = hash & mask[slot]."""

    ttl_ms: torch.Tensor            # (M,) int32 — direct-cache TTL
    failover_ttl_ms: torch.Tensor   # (M,) int32
    evict_lru: torch.Tensor         # (M,) bool — LRU-timestamp eviction
    bucket_mask_d: torch.Tensor     # (M,) int32 — direct n_buckets[m] - 1
    bucket_mask_f: torch.Tensor     # (M,) int32 — failover n_buckets[m] - 1
    touch: torch.Tensor             # (M,) bool — record last-access bumps
    infer_budget: torch.Tensor      # (M,) float32 — tokens per serve step
    budget_limited: torch.Tensor    # (M,) bool — admission control on
    failover_relax_ttl_ms: torch.Tensor  # (M,) int32 — degradation-path TTL
    coalesce: torch.Tensor          # (M,) bool — in-batch coalescing

    @property
    def n_models(self) -> int:
        return self.ttl_ms.shape[0]

    def table(self) -> torch.Tensor:
        """(M, 2) int32 [direct_ttl, failover_ttl], the table the
        ``cache_probe_dual_multi`` kernel reads per query."""
        return torch.stack([self.ttl_ms, self.failover_ttl_ms], dim=1)


def policy_from_configs(cfgs, device="cuda") -> ModelPolicy:
    """The policy table of an ordered CacheConfig list (slot i <->
    cfgs[i]), built once on ``device``.

    When every model's failover capacity equals its direct capacity the
    two mask fields are ONE tensor: object identity is the marker
    :func:`_pooled_bucket_pair` tests to share the insert plan's rank sort
    across both tiers."""
    device = resolve_device(device)
    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32, device=device)
    flag = lambda xs: torch.tensor(xs, dtype=torch.bool, device=device)
    rates, _, limited = budget_table(cfgs, device)
    masks_d = [c.n_buckets - 1 for c in cfgs]
    masks_f = [c.resolved_failover_n_buckets() - 1 for c in cfgs]
    mask_d = i32(masks_d)
    return ModelPolicy(
        ttl_ms=i32([c.cache_ttl_ms for c in cfgs]),
        failover_ttl_ms=i32([c.failover_ttl_ms for c in cfgs]),
        evict_lru=flag([c.eviction == "lru" for c in cfgs]),
        bucket_mask_d=mask_d,
        bucket_mask_f=mask_d if masks_f == masks_d else i32(masks_f),
        touch=flag([c.resolved_touch() for c in cfgs]),
        infer_budget=rates,
        budget_limited=limited,
        failover_relax_ttl_ms=i32([c.resolved_failover_relax_ttl_ms()
                                   for c in cfgs]),
        coalesce=flag([c.coalesce_misses for c in cfgs]))


class MultiCacheState(NamedTuple):
    """Per-model cache tables stacked along a leading model axis.

    The stack allocates ``max(n_buckets)`` buckets per model; a model with
    a smaller capacity only addresses the first ``n_buckets[m]`` rows of
    its slab. Ways and dim are uniform across the tier.

    :meth:`flat` and :meth:`with_flat` are ``reshape`` VIEWS of the
    contiguous stacked tensors, never copies: the flush updates the
    stacked tier IN PLACE through the pooled (M*Nb, W) view, so a
    multi-GB tier is never copied.
    """

    key_hi: torch.Tensor          # (M, n_buckets, ways) int32
    key_lo: torch.Tensor          # (M, n_buckets, ways) int32
    write_ts: torch.Tensor        # (M, n_buckets, ways) int32, ms
    values: torch.Tensor          # (M, n_buckets, ways, dim)
    last_access_ts: torch.Tensor  # (M, n_buckets, ways) int32, ms

    @property
    def n_models(self) -> int:
        return self.key_hi.shape[0]

    @property
    def n_buckets(self) -> int:
        """Stacked (maximum) buckets per model slab."""
        return self.key_hi.shape[1]

    @property
    def ways(self) -> int:
        return self.key_hi.shape[2]

    @property
    def dim(self) -> int:
        return self.values.shape[-1]

    def flat(self) -> CacheState:
        """The pooled (M*Nb, W) view the shared probe/insert math runs
        on (a view: writes through it land in the stack)."""
        M, Nb, W = self.key_hi.shape
        return CacheState(*(t.view(M * Nb, *t.shape[2:]) for t in self))

    def with_flat(self, flat: CacheState) -> "MultiCacheState":
        """Re-stack a pooled view produced by :meth:`flat` (a view)."""
        M, Nb, W = self.key_hi.shape
        return MultiCacheState(*(t.view(M, Nb, *t.shape[1:]) for t in flat))

    def model_view(self, slot: int, n_buckets: Optional[int] = None
                   ) -> CacheState:
        """Model ``slot``'s slab as a standalone CacheState, trimmed to
        ``n_buckets`` so ``bucket_index`` reproduces the pooled mapping
        (the per-model oracle's operand in the tests)."""
        nb = self.n_buckets if n_buckets is None else n_buckets
        return CacheState(*(t[slot, :nb] for t in self))


def init_multi_cache(n_buckets: Sequence[int], ways: int, dim: int,
                     dtype=torch.float32, device="cuda") -> MultiCacheState:
    """An empty stacked tier: one slab per model, each a power-of-2 bucket
    count; the stack is sized by the largest."""
    for nb in n_buckets:
        if nb <= 0 or nb & (nb - 1):
            raise ValueError(f"per-model n_buckets must be powers of 2, "
                             f"got {nb}")
    device = resolve_device(device)
    shape = (len(n_buckets), max(n_buckets), ways)
    full = lambda v: torch.full(shape, v, dtype=torch.int32, device=device)
    return MultiCacheState(
        key_hi=full(EMPTY_HI), key_lo=full(EMPTY_LO), write_ts=full(TS_EMPTY),
        values=torch.zeros(shape + (dim,), dtype=dtype, device=device),
        last_access_ts=full(TS_EMPTY))


def pooled_buckets(slots: torch.Tensor, keys: Key64,
                   bucket_mask: torch.Tensor, nb_stack: int) -> torch.Tensor:
    """Flat bucket index into a stacked tier's pooled (M*Nb, W) view:
    ``slot * Nb + (hash & mask[slot])``. Slots must lie in [0, M)."""
    local = (hash_u32(keys) & bucket_mask[slots.long()].long()).to(
        torch.int32)
    return slots.to(torch.int32) * nb_stack + local


def _pooled_bucket_pair(direct: MultiCacheState, failover: MultiCacheState,
                        policy: ModelPolicy, slots, keys: Key64):
    """(direct, failover) pooled buckets of one mixed-model batch, the
    mapping lookup and insert agree on. An identical stack size and
    aliased masks give ONE tensor for both, which :func:`insert_dual`'s
    ``buckets_d is buckets_f`` test uses to reuse the per-bucket ranks."""
    b_d = pooled_buckets(slots, keys, policy.bucket_mask_d,
                         direct.n_buckets)
    if (failover.n_buckets == direct.n_buckets
            and policy.bucket_mask_f is policy.bucket_mask_d):
        return b_d, b_d
    return b_d, pooled_buckets(slots, keys, policy.bucket_mask_f,
                               failover.n_buckets)


def lookup_dual_multi(direct: MultiCacheState, failover: MultiCacheState,
                      policy: ModelPolicy, slots, keys: Key64, now_ms,
                      backend: str = "cuda"):
    """Probe BOTH stacked tiers for a mixed-model batch: ``slots`` (B,)
    int32 assigns each query its model (in [0, M)), whose direct/failover
    TTLs validate it. On the cuda backend this is ONE kernel launch
    (``cache_probe_dual_multi``, the TTLs read per query from the policy
    table in device memory); on torch it is two per-query-TTL plain
    lookups on the pooled views, with the same results.

    Returns (LookupResult_direct, LookupResult_failover), buckets pooled.
    """
    _check_backend(backend, direct.key_hi, failover.key_hi, keys.hi)
    slots = torch.as_tensor(slots, dtype=torch.int32, device=keys.hi.device)
    b_d, b_f = _pooled_bucket_pair(direct, failover, policy, slots, keys)
    fd, ff = direct.flat(), failover.flat()
    if backend == "cuda":
        from repro_torch.kernels import cache_probe as probe_kernels

        ((hd, vd, ad, wd),
         (hf, vf, af, wf)) = probe_kernels.cache_probe_dual_multi(
            *fd[:4], *ff[:4], keys.hi, keys.lo, slots, b_d, b_f,
            policy.table(), now_ms)
        return (LookupResult(hit=hd, values=vd, age_ms=ad, bucket=b_d,
                             way=wd),
                LookupResult(hit=hf, values=vf, age_ms=af, bucket=b_f,
                             way=wf))
    s = slots.long()
    return (lookup(fd, keys, now_ms, policy.ttl_ms[s], backend=backend,
                   buckets=b_d),
            lookup(ff, keys, now_ms, policy.failover_ttl_ms[s],
                   backend=backend, buckets=b_f))


def insert_dual_multi(direct: MultiCacheState, failover: MultiCacheState,
                      policy: ModelPolicy, slots, keys: Key64,
                      values: torch.Tensor, now_ms,
                      write_mask: Optional[torch.Tensor] = None,
                      ts_ms: Optional[torch.Tensor] = None):
    """Insert a mixed-model record batch into BOTH stacked tiers, IN
    PLACE, with ONE shared plan: per-record TTLs and eviction policies
    come from the policy table, and the dedupe is salted with the model
    slot so the same user appearing for two models stays two records.
    Equal to looping :func:`insert` over each model's slab with that
    model's settings. Returns (direct, failover)."""
    slots = torch.as_tensor(slots, dtype=torch.int32, device=keys.hi.device)
    s = slots.long()
    b_d, b_f = _pooled_bucket_pair(direct, failover, policy, slots, keys)
    insert_dual(direct.flat(), failover.flat(), keys, values, now_ms,
                policy.ttl_ms[s], policy.failover_ttl_ms[s],
                write_mask=write_mask, ts_ms=ts_ms,
                evict_lru=policy.evict_lru[s], buckets_d=b_d, buckets_f=b_f,
                dedupe_salt=slots)
    return direct, failover
