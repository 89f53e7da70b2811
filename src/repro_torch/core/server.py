"""CachedEmbeddingServer and MultiModelServer: the paper's Fig. 3 serve
sequence on PyTorch.

Twin of ``repro/core/server.py`` (its single-model server and its
multi-model tier). Per serve batch:

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

Ports of JAX machinery: the caches are never copied because
``serve_step`` does not write them and ``flush`` updates them IN PLACE.
``serve_step`` appends to the rings in place too, so the state passed in
and the one returned share their tensors: callers follow the move pattern
``state = res.state``. ``serve_many``'s ``lax.scan`` becomes a Python loop
over a stream staged on the device; its counters accumulate on the device
and the caller fetches them once per call (:func:`fetch_counters`).

``jax.jit`` with the state donated becomes ``jit_serve_step``,
``jit_serve_many`` and ``jit_flush`` (``core/graph.py``): on a CUDA state
each call of a static key is captured once into a ``torch.cuda.CUDAGraph``
(``jit_serve_many`` the whole S-step chunk, flushes included, as one
graph) and replayed; on a CPU state the plain function runs. Their state
shares every tensor with the one passed in: the admission budget, which
``ratelimit`` returns fresh, is written back into the state's own tensor.
The step's body makes no host sync and no host-to-device copy, so it can
be captured.

:class:`MultiModelServer` fronts the whole model registry with one
stacked tier: a mixed-model batch is ONE ``cache_probe_dual_multi``
launch, each query at its own model's TTLs, and the flush applies each
model's TTL and eviction policy through one shared insert plan. Per-model
(M,) counters ride beside the global ones. The reference's ``chaos=`` and
``mesh=`` arguments join with the chaos and sharding slices.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import cache as cache_lib
from repro_torch.core import graph as graph_lib
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
_ACC_PM_I32 = ("per_model_requests", "per_model_direct_hits",
               "per_model_failover_hits", "per_model_fallbacks",
               "per_model_admitted", "per_model_deferred",
               "per_model_failover_serves")
_ACC_PM_F32 = ("per_model_failover_stale_sum_ms",)


def _zero_acc(device, n_models: Optional[int] = None) -> dict:
    """Zeroed device counters; ``steps`` counts serve steps (one grouped
    async write each, the combined_writes analogue). ``n_models`` adds
    the multi-model tier's (M,) per-model counters."""
    acc = {k: torch.zeros((), dtype=torch.int32, device=device)
           for k in _ACC_I32 + ("steps",)}
    acc.update({k: torch.zeros((), dtype=torch.float32, device=device)
                for k in _ACC_F32})
    if n_models is not None:
        acc.update({k: torch.zeros((n_models,), dtype=torch.int32,
                                   device=device) for k in _ACC_PM_I32})
        acc.update({k: torch.zeros((n_models,), dtype=torch.float32,
                                   device=device) for k in _ACC_PM_F32})
    return acc


def _acc_add(acc: dict, stats: dict) -> dict:
    """One step's counter contribution: device adds, no host sync. Keys
    the step's stats do not carry pass through untouched."""
    out = {k: (acc[k] + stats[k] if k in stats else acc[k])
           for k in acc if k != "steps"}
    out["steps"] = acc["steps"] + 1
    return out


def fetch_counters(acc: dict) -> dict:
    """The accumulator as host numbers with ONE device-to-host transfer
    (float64 holds every int32 and float32 value exactly). 0-d counters
    come back as ints/floats, the per-model (M,) ones as lists."""
    keys = list(acc)
    flat = torch.cat([acc[k].reshape(-1).to(torch.float64)
                      for k in keys]).cpu().tolist()
    out, pos = {}, 0
    for k in keys:
        cast = float if acc[k].is_floating_point() else int
        n = acc[k].numel()
        vals = [cast(v) for v in flat[pos:pos + n]]
        out[k] = vals[0] if acc[k].dim() == 0 else vals
        pos += n
    return out


def _serve_many_loop(step_fn, flush_fn, state, n_steps: int, acc: dict, *,
                     flush_every: int, collect: bool):
    """Run ``step_fn(state, i)`` over the S staged steps, accumulating the
    counters on the device and flushing every ``flush_every`` steps
    (0 = only at the end) with ``flush_fn(state, i)``; a tail flush
    always runs."""
    outs = []
    for i in range(n_steps):
        res = step_fn(state, i)
        acc = _acc_add(acc, res.stats)
        state = res.state
        if flush_every >= 1 and (i + 1) % flush_every == 0:
            state = flush_fn(state, i)
        if collect:
            outs.append((res.embeddings, res.source, res.age_ms))
    state = flush_fn(state, n_steps - 1)
    ys = (tuple(torch.stack(x) for x in zip(*outs)) if collect else None)
    return state, acc, ys


def take_rows(features, idx):
    """Index every tensor of a feature pytree along its first axis: a bare
    tensor, or a (nested) dict, tuple or list of tensors. The reference
    does this with ``tree_map(lambda x: x[sel], features)``, so a tower
    may take any of these forms."""
    if isinstance(features, torch.Tensor):
        return features[idx]
    if isinstance(features, dict):
        return {k: take_rows(v, idx) for k, v in features.items()}
    if isinstance(features, (tuple, list)):
        return type(features)(take_rows(v, idx) for v in features)
    raise TypeError(f"features must be a tensor or a dict/tuple/list of "
                    f"tensors, got {type(features).__name__}")


class _CompiledEntryPoints:
    """``jit_serve_step``, ``jit_serve_many`` and ``jit_flush`` of both
    servers: the reference's names, arguments and move pattern
    (``state = res.state``, ``state = srv.jit_flush(state, now)``). Each
    wraps one plain function of tensors: the step, the S-step loop or the
    flush, which then writes every fresh state tensor back into the
    state passed in (:func:`graph.write_back`)."""

    def _step_out(self, params, state, *args, **kwargs):
        res = self.serve_step(params, state, *args, **kwargs)
        graph_lib.write_back(state, res.state)
        return res.embeddings, res.source, res.age_ms, res.stats

    def _many_out(self, params, state, *args, **kwargs):
        new_state, acc, ys = self.serve_many(params, state, *args, **kwargs)
        graph_lib.write_back(state, new_state)
        return acc, ys

    def _flush_out(self, state, now_ms):
        graph_lib.write_back(state, self.flush(state, now_ms))

    @functools.cached_property
    def jit_serve_step(self) -> graph_lib.Compiled:
        return graph_lib.Compiled(
            self._step_out, inplace=2,
            assemble=lambda bound, out: ServeResult(
                embeddings=out[0], source=out[1], age_ms=out[2],
                state=bound[1], stats=out[3]))

    @functools.cached_property
    def jit_serve_many(self) -> graph_lib.Compiled:
        return graph_lib.Compiled(
            self._many_out, inplace=2,
            assemble=lambda bound, out: (bound[1], *out),
            static_argnames=("flush_every", "collect"))

    @functools.cached_property
    def jit_flush(self) -> graph_lib.Compiled:
        return graph_lib.Compiled(self._flush_out, inplace=1,
                                  assemble=lambda bound, out: bound[0])


def _one_hot(slots: torch.Tensor, n_models: int) -> torch.Tensor:
    """(B, M) bool: row b is True at column slots[b]."""
    return slots[:, None] == torch.arange(n_models, device=slots.device)


def _per_model_count(one_hot: torch.Tensor, flag: torch.Tensor
                     ) -> torch.Tensor:
    """(M,) int32 count of the ``flag`` rows of each model."""
    return (one_hot & flag[:, None]).sum(dim=0, dtype=torch.int32)


def _per_model_miss_rank(slots, miss, n_models: int) -> torch.Tensor:
    """(B,) batch-order rank of each miss among ITS model's misses (the
    per-model admission cutoff index; the insert plan's segmented rank).
    Garbage where ``miss`` is False; callers gate on it."""
    return cache_lib._bucket_rank(slots, miss, n_models)


def _serve_tail(tower_fn: Callable, miss_budget: int, fallback_value: float,
                params, features, keys: Key64, now_ms, failure_mask,
                direct, fo, writebuf: WriteBuffer,
                model_slots: Optional[torch.Tensor] = None,
                n_models: Optional[int] = None,
                admit: Optional[torch.Tensor] = None,
                fo_strict_hit: Optional[torch.Tensor] = None,
                infer: Optional[torch.Tensor] = None,
                src_row: Optional[torch.Tensor] = None):
    """Steps (2)-(4): miss-budget compaction + tower, failover assistance /
    model fallback, provenance + counters, write-ring append.

    ``model_slots``/``n_models`` (multi-model tier) tag the buffered
    records and add per-model (M,) stat breakdowns. ``admit`` marks the
    misses admitted to inference (None: every miss);
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
    towered = tower_fn(params, take_rows(features, sel))
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
    new_wb = wb_lib.append(
        writebuf, sel_keys, towered, now_ms, mask=sel_ok,
        model_ids=None if model_slots is None else model_slots[sel])

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
    if model_slots is not None:
        # Per-model sums as one-hot reductions, not scatter-adds: CUDA
        # scatter-adds of floats use atomics in a run-dependent order, and
        # hour-scale staleness sums pass 2**24, where float32 rounding
        # depends on that order.
        oh = _one_hot(model_slots, n_models)
        pm = lambda flag: _per_model_count(oh, flag)
        pm_fo = pm(use_fo)
        pm_stale_sum = (oh * torch.where(use_fo, fo.age_ms, 0).to(
            torch.float32)[:, None]).sum(dim=0)
        stats.update({
            "per_model_requests": pm(torch.ones_like(miss)),
            "per_model_direct_hits": pm(direct.hit),
            "per_model_failover_hits": pm(use_fo & fo_strict_hit),
            "per_model_fallbacks": pm(fallback),
            "per_model_admitted": pm(admit),
            "per_model_deferred": pm(miss) - pm(admit),
            "per_model_failover_serves": pm_fo,
            "per_model_failover_stale_ms":
                pm_stale_sum / pm_fo.clamp(min=1).float(),
            "per_model_failover_stale_sum_ms": pm_stale_sum,
        })
    return emb, source, age, new_wb, stats


@dataclasses.dataclass(frozen=True)
class CachedEmbeddingServer(_CompiledEntryPoints):
    """Binds a user-tower fn to ERCache semantics.

    ``tower_fn(params, features) -> (rows, D)`` takes the batch's features
    (a tensor, or a dict/tuple/list of tensors, :func:`take_rows`) cut to
    ``miss_budget`` rows (fewer when the batch is smaller).
    """

    cfg: CacheConfig
    tower_fn: Callable
    miss_budget: int
    fallback_value: float = 0.0   # default embedding on total fallback

    @property
    def _admission(self) -> bool:
        return self.cfg.infer_budget_per_step is not None

    @functools.cached_property
    def _budget_tables(self) -> dict:
        return {}

    def _budget_table(self, device):
        """``cfg``'s (rates, bursts, limited) on ``device``, built once
        per server and device by the first step (which runs eagerly, also
        under ``jit_*``), so no step copies it to the device again."""
        table = self._budget_tables.get(device)
        if table is None:
            table = rl_lib.budget_table([self.cfg], device)
            self._budget_tables[device] = table
        return table

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
            rates, bursts, limited = self._budget_table(dev)
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

        ``keys`` is an (S, B) Key64, ``features`` a pytree of (S, B, ...)
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

        def step(st, i):
            return self.serve_step(params, st, Key64(keys.hi[i], keys.lo[i]),
                                   take_rows(features, i),
                                   now_ms[i], failure_mask[i])

        return _serve_many_loop(step, lambda st, i: self.flush(st, now_ms[i]),
                                state, now_ms.shape[0], _zero_acc(dev),
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


# ========================================================== multi-model tier
class MultiServerState(NamedTuple):
    direct: cache_lib.MultiCacheState     # stacked per-model direct tables
    failover: cache_lib.MultiCacheState   # stacked per-model failover tables
    writebuf: WriteBuffer                 # shared ring, records model-tagged
    touchbuf: TouchBuffer                 # shared ring of POOLED hit coords
    budget: rl_lib.InferBudget            # (M,) per-model inference tokens


def init_multi_server_state(cfgs: Sequence[CacheConfig], dtype=torch.float32,
                            writebuf_capacity: int = 4096,
                            touchbuf_capacity: Optional[int] = None,
                            device="cuda") -> MultiServerState:
    """Allocate the stacked tier of an ordered model registry on
    ``device``. Every model keeps its own direct/failover capacity (bucket
    masks); value_dim must agree across the tier, and heterogeneous
    ``ways`` are normalized up to the tier maximum."""
    dims = {c.value_dim for c in cfgs}
    if len(dims) != 1:
        raise ValueError(f"tier needs one value_dim, got {sorted(dims)}")
    dim = dims.pop()
    if touchbuf_capacity is None:
        touchbuf_capacity = writebuf_capacity
    return MultiServerState(
        direct=cache_lib.init_multi_cache(
            [c.n_buckets for c in cfgs], max(c.ways for c in cfgs), dim,
            dtype, device),
        failover=cache_lib.init_multi_cache(
            [c.resolved_failover_n_buckets() for c in cfgs],
            max(c.resolved_failover_ways() for c in cfgs), dim, dtype,
            device),
        writebuf=wb_lib.init_writebuf(writebuf_capacity, dim, dtype, device),
        touchbuf=wb_lib.init_touchbuf(touchbuf_capacity, device),
        budget=rl_lib.init_infer_budget(cfgs, device))


@dataclasses.dataclass(frozen=True)
class MultiModelServer(_CompiledEntryPoints):
    """One serving tier fronting the WHOLE model registry (paper §3.3,
    Table 1): a serve batch is a mixed stream of (model slot, user key)
    pairs, the direct+failover probe of every model is ONE launch
    (``lookup_dual_multi``), and the flush applies per-model TTL and
    eviction policy through one shared insert plan.

    ``tower_fn(params, features) -> (rows, D)`` stands in for the
    per-model user towers (one shared tower, as in the reference). The
    policy tables are built once, here, on ``device``.
    """

    cfgs: Tuple[CacheConfig, ...]
    tower_fn: Callable
    miss_budget: int
    fallback_value: float = 0.0
    # "torch" | "cuda"; None resolves from the configs, which must agree
    backend: Optional[str] = None
    device: Any = "cuda"

    def __post_init__(self) -> None:
        if self.backend is None:
            backends = {c.backend for c in self.cfgs}
            if len(backends) != 1:
                raise ValueError(
                    f"configs disagree on backend {sorted(backends)}; pass "
                    "MultiModelServer(backend=...) explicitly")
            object.__setattr__(self, "backend", backends.pop())
        off = [c.model_id for c in self.cfgs if c.failover_write == "off"]
        if off:
            raise ValueError(
                f"models {off} set failover_write='off': the stacked tier's "
                "shared flush (flush_dual_multi) always writes both slabs, "
                "so a per-model cold failover would be silently "
                "overwritten. Serve those models on a single-model server.")
        put = lambda k, v: object.__setattr__(self, k, v)
        policy = cache_lib.policy_from_configs(self.cfgs, self.device)
        put("_policy", policy)
        put("_any_touch", any(c.resolved_touch() for c in self.cfgs))
        put("_any_coalesce", any(c.coalesce_misses for c in self.cfgs))
        any_budget = any(c.infer_budget_per_step is not None
                         for c in self.cfgs)
        put("_any_admission", any_budget)
        put("_budget_bursts", rl_lib.bursts_of(policy.infer_budget,
                                               policy.budget_limited))
        # With admission on any model the failover is probed at the
        # per-model RELAXED TTLs (strict for budget-less models); _replace
        # keeps the bucket-mask aliasing the insert plan tests.
        put("_probe_policy", policy._replace(
            failover_ttl_ms=policy.failover_relax_ttl_ms) if any_budget
            else policy)

    @property
    def policy(self) -> cache_lib.ModelPolicy:
        return self._policy

    @property
    def n_models(self) -> int:
        return len(self.cfgs)

    # ----------------------------------------------------------------- serve
    def serve_step(self, params, state: MultiServerState, slots,
                   keys: Key64, features, now_ms,
                   failure_mask: Optional[torch.Tensor] = None
                   ) -> ServeResult:
        """Serve a MIXED-model batch: ``slots`` (B,) int32 in [0, M)
        assigns each request its model. Steps mirror
        :meth:`CachedEmbeddingServer.serve_step`; step (1) covers every
        model in ONE probe launch and the stats gain per-model (M,)
        breakdowns. Never writes the tables; appends to the rings IN
        PLACE."""
        B = keys.hi.shape[0]
        dev = keys.hi.device
        M = self.n_models
        pol = self.policy
        now = torch.as_tensor(now_ms, dtype=torch.int32, device=dev)
        slots = torch.as_tensor(slots, dtype=torch.int32, device=dev)
        s = slots.long()
        if failure_mask is None:
            failure_mask = torch.zeros(B, dtype=torch.bool, device=dev)

        # (1) direct + failover probe of ALL models: ONE launch
        direct, fo = cache_lib.lookup_dual_multi(
            state.direct, state.failover, self._probe_policy, slots, keys,
            now, backend=self.backend)

        # (1b) POOLED hit coordinates for the deferred last-access bump,
        # gated by each query's model's touch policy
        new_tb = state.touchbuf
        if self._any_touch:
            new_tb = wb_lib.touch_append(new_tb, direct, fo, now,
                                         mask=pol.touch[s])

        # (1c) in-batch coalescing of the models that opt in, salted by
        # slot (the same user queried for two models is two inferences);
        # misses of other models each stand alone
        miss = ~direct.hit
        infer = src_row = None
        if self._any_coalesce:
            co = pol.coalesce[s]
            rep, src_co = cache_lib.dedupe_first_groups(keys, miss & co,
                                                        salt=slots)
            alone = miss & ~co
            unit = rep | alone
            src_row = torch.where(
                alone, torch.arange(B, dtype=torch.int32, device=dev),
                src_co)
        else:
            unit = miss

        # (1d) admission: one vectorized grant for every model; each
        # model's units are admitted in batch order up to its grant, the
        # total then clipped to the miss-budget window in batch order, and
        # each model charged only for the inferences that run
        admit = fo_strict = None
        new_budget = state.budget
        if self._any_admission:
            fo_strict = fo.hit & (fo.age_ms <= pol.failover_ttl_ms[s])
            oh = _one_hot(slots, M)
            demand = _per_model_count(oh, unit)
            refilled = rl_lib.refill(state.budget, pol.infer_budget,
                                     self._budget_bursts)
            grant = rl_lib.grant_from(refilled, pol.budget_limited, demand)
            rank = _per_model_miss_rank(slots, unit, M)
            admit0 = unit & (rank < grant[s])
            a_i = admit0.to(torch.int32)
            global_rank = torch.cumsum(a_i, 0) - a_i          # exclusive
            infer = admit0 & (global_rank < self.miss_budget)
            new_budget = rl_lib.spend(refilled, pol.budget_limited,
                                      _per_model_count(oh, infer))
            if self._any_coalesce:
                admit = miss & infer[src_row.clamp(min=0).long()]
            else:
                admit = infer
        elif self._any_coalesce:
            infer = unit         # window clipping happens in the tail

        # (2)-(4): shared serve tail, model-tagged ring records
        emb, source, age, new_wb, stats = _serve_tail(
            self.tower_fn, self.miss_budget, self.fallback_value, params,
            features, keys, now, failure_mask, direct, fo, state.writebuf,
            model_slots=slots, n_models=M, admit=admit,
            fo_strict_hit=fo_strict, infer=infer, src_row=src_row)
        return ServeResult(
            embeddings=emb, source=source, age_ms=age,
            state=MultiServerState(direct=state.direct,
                                   failover=state.failover,
                                   writebuf=new_wb, touchbuf=new_tb,
                                   budget=new_budget),
            stats=stats)

    # ------------------------------------------------------------ serve_many
    def serve_many(self, params, state: MultiServerState, slots,
                   keys: Key64, features, now_ms,
                   failure_mask: Optional[torch.Tensor] = None, *,
                   flush_every: int = 1, collect: bool = True):
        """S mixed-model serve steps over a stream staged on the device:
        the contract of :meth:`CachedEmbeddingServer.serve_many` with an
        extra (S, B) ``slots`` stream; the counters include the per-model
        (M,) breakdowns."""
        dev = keys.hi.device
        now_ms = torch.as_tensor(now_ms, dtype=torch.int32, device=dev)
        slots = torch.as_tensor(slots, dtype=torch.int32, device=dev)
        if failure_mask is None:
            failure_mask = torch.zeros(keys.hi.shape, dtype=torch.bool,
                                       device=dev)

        def step(st, i):
            return self.serve_step(params, st, slots[i],
                                   Key64(keys.hi[i], keys.lo[i]),
                                   take_rows(features, i),
                                   now_ms[i], failure_mask[i])

        return _serve_many_loop(step, lambda st, i: self.flush(st, now_ms[i]),
                                state, now_ms.shape[0],
                                _zero_acc(dev, self.n_models),
                                flush_every=int(flush_every),
                                collect=collect)

    # ----------------------------------------------------------------- flush
    def flush(self, state: MultiServerState, now_ms) -> MultiServerState:
        """Apply the mixed-model write ring to both stacked tiers, IN
        PLACE, with ONE shared insert plan, each record under its model's
        TTL and eviction policy, after the touch ring's recency bumps."""
        wb_lib.flush_dual_multi(
            state.writebuf, state.direct, state.failover, self.policy,
            now_ms, touchbuf=state.touchbuf if self._any_touch else None)
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
