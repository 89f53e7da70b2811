"""CachedEmbeddingServer: the paper's Fig. 3 serve sequence on PyTorch.

Twin of the single-model part of ``repro/core/server.py``. Per serve
batch:

  1. **Direct + failover cache check**: ONE probe launch for both tables
     (``cache.lookup_dual``, the ``cache_probe_dual`` kernel on the cuda
     backend).
  2. **Compaction**: the rows that run the tower go first (stable sort)
     and the user tower runs on the first ``miss_budget`` of them.
  3. **Failover assistance**: failed, deferred and overflowed misses
     consult the failover probe, then fall back to the default embedding.
  4. **Cache update**: computed embeddings go to the write ring, hit
     coordinates to the touch ring; ``flush`` applies both later.

Optional stages as in the reference: in-batch coalescing
(``coalesce_misses``), SLA admission (``infer_budget_per_step``) and
access-recency touches (``eviction="lru"``).

Ports of JAX machinery: ``jit`` and donation have no counterpart (PyTorch
runs eagerly); the caches are never copied because ``serve_step`` does not
write them and ``flush`` updates them IN PLACE. ``serve_step`` appends to
the rings in place too, so the state passed in and the one returned share
their tensors: callers follow the move pattern ``state = res.state``.
``serve_many``'s ``lax.scan`` becomes a Python loop over a stream staged
on the device; its counters accumulate on the device and the caller
fetches them once per call (:func:`fetch_counters`). The chaos hooks,
the multi-model tier and the sharded tier join with their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import cache as cache_lib
from repro_torch.core import ratelimit as rl_lib
from repro_torch.core import writebuf as wb_lib
from repro_torch.core.cache import CacheState
from repro_torch.core.config import CacheConfig
from repro_torch.core.hashing import Key64
from repro_torch.core.writebuf import TouchBuffer, WriteBuffer

# Provenance codes (per request)
SRC_DIRECT = 0
SRC_COMPUTED = 1
SRC_FAILOVER = 2
SRC_FALLBACK = 3


class ServerState(NamedTuple):
    direct: CacheState
    failover: CacheState
    writebuf: WriteBuffer
    touchbuf: TouchBuffer
    # (1,) inference token bucket; allocated whether or not admission
    # control is configured, untouched when it is off.
    budget: rl_lib.InferBudget


class ServeResult(NamedTuple):
    embeddings: torch.Tensor  # (B, D)
    source: torch.Tensor      # (B,) int32 — SRC_* provenance
    age_ms: torch.Tensor      # (B,) int32 — staleness of the served embedding
    state: ServerState        # rings appended (in place)
    stats: dict               # 0-d counter tensors


def init_server_state(cfg: CacheConfig, dtype=torch.float32,
                      writebuf_capacity: int = 4096,
                      touchbuf_capacity: Optional[int] = None,
                      device="cuda") -> ServerState:
    """Allocate both caches (the failover sized by its own knobs) and the
    write and touch rings on ``device``."""
    if touchbuf_capacity is None:
        touchbuf_capacity = writebuf_capacity
    return ServerState(
        direct=cache_lib.init_cache(cfg.n_buckets, cfg.ways, cfg.value_dim,
                                    dtype, device),
        failover=cache_lib.init_cache(cfg.resolved_failover_n_buckets(),
                                      cfg.resolved_failover_ways(),
                                      cfg.value_dim, dtype, device),
        writebuf=wb_lib.init_writebuf(writebuf_capacity, cfg.value_dim,
                                      dtype, device),
        touchbuf=wb_lib.init_touchbuf(touchbuf_capacity, device),
        budget=rl_lib.init_infer_budget([cfg], device))


# ------------------------------------------------- serve_many accumulators
# The additive subset of serve_step's stats: what serve_many carries on the
# device across steps. Means are not additive, so the *_sum_ms / *_count
# keys ride instead and the host derives means after the one fetch.
_ACC_I32 = ("requests", "direct_hits", "tower_inferences", "tower_failures",
            "overflow", "admitted", "deferred", "failover_hits",
            "failover_serves", "fallbacks", "served_age_count")
_ACC_F32 = ("failover_stale_sum_ms", "served_age_sum_ms")


def _zero_acc(device) -> dict:
    """Zeroed device counters; ``steps`` counts serve steps (one grouped
    async write each, the combined_writes analogue)."""
    acc = {k: torch.zeros((), dtype=torch.int32, device=device)
           for k in _ACC_I32 + ("steps",)}
    acc.update({k: torch.zeros((), dtype=torch.float32, device=device)
                for k in _ACC_F32})
    return acc


def _acc_add(acc: dict, stats: dict) -> dict:
    """One step's counter contribution: device adds, no host sync."""
    out = {k: acc[k] + stats[k] for k in acc if k != "steps"}
    out["steps"] = acc["steps"] + 1
    return out


def fetch_counters(acc: dict) -> dict:
    """The accumulator as host numbers with ONE device-to-host transfer
    (float64 holds every int32 and float32 value exactly)."""
    keys = list(acc)
    flat = torch.stack([acc[k].to(torch.float64) for k in keys]).cpu()
    return {k: (float(v) if acc[k].is_floating_point() else int(v))
            for k, v in zip(keys, flat.tolist())}


def _serve_many_loop(step_fn, flush_fn, state, keys: Key64, features,
                     now_ms, failure_mask, *, flush_every: int,
                     collect: bool):
    """Run ``step_fn`` over the staged (S, B) stream, accumulating the
    counters on the device and flushing every ``flush_every`` steps
    (0 = only at the end); a tail flush always runs."""
    S = now_ms.shape[0]
    acc = _zero_acc(now_ms.device)
    outs = []
    for i in range(S):
        res = step_fn(state, Key64(keys.hi[i], keys.lo[i]),
                      {k: v[i] for k, v in features.items()}, now_ms[i],
                      failure_mask[i])
        acc = _acc_add(acc, res.stats)
        state = res.state
        if flush_every >= 1 and (i + 1) % flush_every == 0:
            state = flush_fn(state, now_ms[i])
        if collect:
            outs.append((res.embeddings, res.source, res.age_ms))
    state = flush_fn(state, now_ms[-1])
    ys = (tuple(torch.stack(x) for x in zip(*outs)) if collect else None)
    return state, acc, ys


def _serve_tail(tower_fn: Callable, miss_budget: int, fallback_value: float,
                params, features, keys: Key64, now_ms, failure_mask,
                direct, fo, writebuf: WriteBuffer,
                admit: Optional[torch.Tensor] = None,
                fo_strict_hit: Optional[torch.Tensor] = None,
                infer: Optional[torch.Tensor] = None,
                src_row: Optional[torch.Tensor] = None):
    """Steps (2)-(4): miss-budget compaction + tower, failover assistance /
    model fallback, provenance + counters, write-ring append.

    ``admit`` marks the misses admitted to inference (None: every miss);
    ``fo_strict_hit`` the strict-TTL subset of the (relaxed) failover
    probe; ``infer`` the rows that RUN the tower (coalescing
    representatives; None: ``admit``) and ``src_row`` the row whose tower
    output serves each admitted row (None: the identity).
    Returns (embeddings, source, age, writebuf, stats).
    """
    B = keys.hi.shape[0]
    dev = keys.hi.device
    miss = ~direct.hit
    if admit is None:
        admit = miss
    if infer is None:
        infer = admit
    if fo_strict_hit is None:
        fo_strict_hit = fo.hit

    # (2) compaction: rows that RUN the tower first, stable
    order = torch.sort((~infer).to(torch.int32), stable=True).indices
    sel = order[:miss_budget]
    sel_is_inf = infer[sel]
    towered = tower_fn(params, {k: v[sel] for k, v in features.items()})
    towered = towered.to(direct.values.dtype)
    sel_failed = failure_mask[sel]
    sel_ok = sel_is_inf & ~sel_failed

    # (3) computed rows back in place (broadcast to duplicates when
    # coalescing); deferred, overflowed and failed misses go down the
    # degradation chain: failover probe, then the default embedding.
    if src_row is None:
        computed = torch.zeros(B, dtype=torch.bool, device=dev)
        computed[sel] = sel_ok
        emb = direct.values.clone()
        emb[sel] = torch.where(sel_ok[:, None], towered, emb[sel])
    else:
        src = src_row.clamp(min=0).long()
        ok_row = torch.zeros(B, dtype=torch.bool, device=dev)
        ok_row[sel] = sel_ok
        computed = admit & ok_row[src]
        tower_rows = torch.zeros_like(direct.values)
        tower_rows[sel] = torch.where(sel_is_inf[:, None], towered,
                                      torch.zeros_like(towered))
        emb = torch.where(computed[:, None], tower_rows[src], direct.values)
    unresolved = miss & ~computed
    use_fo = unresolved & fo.hit
    emb = torch.where(use_fo[:, None], fo.values.to(emb.dtype), emb)
    fallback = unresolved & ~fo.hit
    emb = torch.where(fallback[:, None],
                      torch.full_like(emb, fallback_value), emb)

    source = torch.where(
        direct.hit, SRC_DIRECT,
        torch.where(computed, SRC_COMPUTED,
                    torch.where(use_fo, SRC_FAILOVER, SRC_FALLBACK))
    ).to(torch.int32)
    age = torch.where(direct.hit, direct.age_ms,
                      torch.where(computed, 0,
                                  torch.where(use_fo, fo.age_ms, -1))
                      ).to(torch.int32)

    # (4) async cache update: computed rows into the write ring
    sel_keys = Key64(hi=keys.hi[sel], lo=keys.lo[sel])
    new_wb = wb_lib.append(writebuf, sel_keys, towered, now_ms, mask=sel_ok)

    def count(flag):
        return flag.sum(dtype=torch.int32)

    # float32 staleness sums (int32 would wrap on hour-scale ages)
    fo_age_sum = torch.where(use_fo, fo.age_ms, 0).to(torch.float32).sum()
    # age >= 0: a same-millisecond hit is a legitimate age-0 serve
    age_sum = torch.where(age >= 0, age, 0).to(torch.float32).sum()
    age_served = count(age >= 0)
    n_fo = count(use_fo)
    stats = {
        "requests": torch.full((), B, dtype=torch.int32, device=dev),
        "direct_hits": count(direct.hit),
        "tower_inferences": count(sel_is_inf),
        "tower_failures": count(sel_is_inf & sel_failed),
        "overflow": count(infer) - count(sel_is_inf),
        "admitted": count(admit),
        "deferred": count(miss) - count(admit),
        "failover_hits": count(use_fo & fo_strict_hit),
        "failover_serves": n_fo,
        "fallbacks": count(fallback),
        "failover_stale_ms": fo_age_sum / n_fo.clamp(min=1).float(),
        "mean_age_ms": age_sum / age_served.clamp(min=1).float(),
        "failover_stale_sum_ms": fo_age_sum,
        "served_age_sum_ms": age_sum,
        "served_age_count": age_served,
        "computed_serves": count(computed),
    }
    return emb, source, age, new_wb, stats


@dataclasses.dataclass(frozen=True)
class CachedEmbeddingServer:
    """Binds a user-tower fn to ERCache semantics.

    ``tower_fn(params, features) -> (rows, D)`` takes a dict of feature
    tensors with ``miss_budget`` rows (fewer when the batch is smaller).
    """

    cfg: CacheConfig
    tower_fn: Callable
    miss_budget: int
    fallback_value: float = 0.0   # default embedding on total fallback

    @property
    def _admission(self) -> bool:
        return self.cfg.infer_budget_per_step is not None

    # ----------------------------------------------------------------- serve
    def serve_step(self, params, state: ServerState, keys: Key64,
                   features, now_ms,
                   failure_mask: Optional[torch.Tensor] = None
                   ) -> ServeResult:
        """One serve batch. Reads the cache tables as they were before the
        step (it never writes them); appends to the write and touch rings
        IN PLACE. ``now_ms`` may be an int or a 0-d device tensor."""
        B = keys.hi.shape[0]
        cfg = self.cfg
        dev = keys.hi.device
        now = torch.as_tensor(now_ms, dtype=torch.int32, device=dev)
        if failure_mask is None:
            failure_mask = torch.zeros(B, dtype=torch.bool, device=dev)

        # (1) direct + failover probe: ONE launch. With admission control
        # the failover validates at the RELAXED TTL and the strict hit set
        # is recovered from the probe's age below.
        direct, fo = cache_lib.lookup_dual(
            state.direct, state.failover, keys, now, cfg.cache_ttl_ms,
            cfg.resolved_failover_relax_ttl_ms(), backend=cfg.backend)

        # (1b) hit coordinates for the deferred last-access bump
        new_tb = state.touchbuf
        if cfg.resolved_touch():
            new_tb = wb_lib.touch_append(new_tb, direct, fo, now)

        # (1c) in-batch coalescing: first occurrence of each missed key
        # is its group's representative; duplicates reuse its embedding
        miss = ~direct.hit
        infer = src_row = None
        if cfg.coalesce_misses:
            rep, src_row = cache_lib.dedupe_first_groups(keys, miss)
            unit = rep
        else:
            unit = miss

        # (1d) admission: refill, grant this step's inferences (clipped to
        # the miss-budget window), charge only what runs
        admit = fo_strict = None
        new_budget = state.budget
        if self._admission:
            rates, bursts, limited = rl_lib.budget_table([cfg], dev)
            fo_strict = fo.hit & (fo.age_ms <= cfg.failover_ttl_ms)
            demand = unit.sum(dtype=torch.int32)[None]
            refilled = rl_lib.refill(state.budget, rates, bursts)
            grant = rl_lib.grant_from(refilled, limited, demand)
            u_i = unit.to(torch.int32)
            rank = torch.cumsum(u_i, 0) - u_i                 # exclusive
            infer = unit & (rank < torch.clamp(grant[0],
                                               max=self.miss_budget))
            new_budget = rl_lib.spend(refilled, limited,
                                      infer.sum(dtype=torch.int32)[None])
            if cfg.coalesce_misses:
                admit = miss & infer[src_row.clamp(min=0).long()]
            else:
                admit = infer
        elif cfg.coalesce_misses:
            infer = rep          # window clipping happens in the tail

        # (2)-(4): shared serve tail
        emb, source, age, new_wb, stats = _serve_tail(
            self.tower_fn, self.miss_budget, self.fallback_value, params,
            features, keys, now, failure_mask, direct, fo, state.writebuf,
            admit=admit, fo_strict_hit=fo_strict, infer=infer,
            src_row=src_row)
        return ServeResult(
            embeddings=emb, source=source, age_ms=age,
            state=ServerState(direct=state.direct, failover=state.failover,
                              writebuf=new_wb, touchbuf=new_tb,
                              budget=new_budget),
            stats=stats)

    # ------------------------------------------------------------ serve_many
    def serve_many(self, params, state: ServerState, keys: Key64, features,
                   now_ms, failure_mask: Optional[torch.Tensor] = None, *,
                   flush_every: int = 1, collect: bool = True):
        """Run S serve steps over a stream staged on the device.

        ``keys`` is an (S, B) Key64, ``features`` a dict of (S, B, ...)
        tensors, ``now_ms`` (S,) int32, ``failure_mask`` (S, B) bool (None:
        no failures). The flush runs every ``flush_every`` steps (0: only
        at the end); a tail flush always runs, so the returned rings are
        empty. Counters accumulate on the device: fetch them with ONE
        :func:`fetch_counters` per call.

        Returns ``(state, counters, outputs)``, ``outputs`` being
        ``(embeddings (S, B, D), source, age_ms)`` or None with
        ``collect=False``.
        """
        dev = keys.hi.device
        now_ms = torch.as_tensor(now_ms, dtype=torch.int32, device=dev)
        if failure_mask is None:
            failure_mask = torch.zeros(keys.hi.shape, dtype=torch.bool,
                                       device=dev)

        def step(st, k, f, now, fail):
            return self.serve_step(params, st, k, f, now, fail)

        return _serve_many_loop(step, self.flush, state, keys, features,
                                now_ms, failure_mask,
                                flush_every=int(flush_every),
                                collect=collect)

    # ----------------------------------------------------------------- flush
    def flush(self, state: ServerState, now_ms) -> ServerState:
        """Apply the write ring to the cache tier(s), IN PLACE, bumping the
        recency planes from the touch ring first. ``failover_write="dual"``
        flushes both caches with one shared plan; ``"off"`` only the
        direct cache."""
        tb = state.touchbuf if self.cfg.resolved_touch() else None
        lru = self.cfg.eviction == "lru"
        if self.cfg.failover_write == "off":
            wb_lib.flush(state.writebuf, state.direct, now_ms,
                         self.cfg.cache_ttl_ms, evict_lru=lru, touchbuf=tb)
        else:
            wb_lib.flush_dual(state.writebuf, state.direct, state.failover,
                              now_ms, self.cfg.cache_ttl_ms,
                              self.cfg.failover_ttl_ms, evict_lru=lru,
                              touchbuf=tb)
        return state


def cache_image(state: ServerState) -> dict:
    """The durable subset of a server state (what a warm-restart snapshot
    stores): both cache tables plus the admission token bucket."""
    return {"direct": state.direct, "failover": state.failover,
            "budget": state.budget}


def serve_step_no_cache(tower_fn: Callable, params, keys: Key64, features,
                        failure_mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache-disabled baseline (the paper's "w/o cache" arm): every
    request pays a tower inference; failures go straight to fallback."""
    emb = tower_fn(params, features)
    B = emb.shape[0]
    if failure_mask is None:
        failure_mask = torch.zeros(B, dtype=torch.bool, device=emb.device)
    emb = torch.where(failure_mask[:, None], torch.zeros_like(emb), emb)
    source = torch.where(failure_mask, SRC_FALLBACK, SRC_COMPUTED)
    return emb, source.to(torch.int32)
