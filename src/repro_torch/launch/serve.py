"""Serving launcher: request stream -> ERCache -> tower, end to end, on the
card.

Twin of the basic, ``--no-cache``, ``--multi`` and ``--overload`` modes of
``repro/launch/serve.py``: the Fig. 2-calibrated access-pattern generator
drives one ``CachedEmbeddingServer`` fronting a recsys user tower
(``--arch``: Wide&Deep, SASRec, BST or MIND; or, with ``--multi``, one
``MultiModelServer`` fronting the whole per-model registry, each request
fanned out to one model); the stream is staged on
the device in (S, B) chunks and each chunk is ONE ``jit_serve_many`` call
(on the card one CUDA graph replay, captured at the chunk shape's first
call) whose counters come back with ONE host transfer; the ``--no-cache``
baseline runs eagerly, as the reference's. ``--coalesce`` dedupes
each batch's missed users so the tower runs once per distinct user.
``--overload`` replays the stream against a constrained inference budget
(SLA admission control): a capacity outage with a flash crowd, whose
deferred misses degrade through the relaxed-TTL failover tier, reported
phase by phase. The ``--restart``, ``--shards``, ``--regions`` and
``--chaos`` modes join with their slices.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch sasrec|wide-deep|bst|mind --minutes 120 --users 5000 \\
        --ttl-min 5 [--no-cache] [--coalesce]
    PYTHONPATH=src python -m repro_torch.launch.serve --multi \\
        --minutes 30 --users 1000 [--multi-buckets 4096] [--coalesce]
    PYTHONPATH=src python -m repro_torch.launch.serve --overload \\
        --minutes 60 --users 2000 [--budget-frac 0.5] \\
        [--failure-rate 0.02 --failure-burst-rate 0.2]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import server as srv_lib
from repro_torch.core.cache import resolve_device
from repro_torch.core.config import (CacheConfig, HOUR_MS, MINUTE_MS,
                                     multi_model_tier_configs)
from repro_torch.core.hashing import Key64
from repro_torch.core.metrics import ServingCounters, power_savings
from repro_torch.data.access_patterns import (FIG6_KNOTS, InterArrivalDist,
                                              StreamConfig,
                                              generate_stream_fast,
                                              simulate_hit_rate)
from repro_torch.ft.failure import FailureInjector
from repro_torch.models import recsys as rec_lib


def build_tower(arch: str, backend: str = "cuda", device="cuda",
                smoke: bool = True, seed: int = 0):
    """A recsys tower (``wide-deep``, ``sasrec``, ``bst`` or ``mind``; the
    SMOKE config by default, as the reference launcher serves;
    ``smoke=False`` for the published widths) with random weights from
    ``seed``, plus a feature synthesizer for serving. The tower's gathers
    run ``backend``'s embedding bag ("cuda": the kernel)."""
    cfg = get_config(arch, smoke=smoke)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = rec_lib.init_params(gen, cfg, device)

    def features_of(user_ids: np.ndarray, now_ms: int):
        """Synthetic features (numpy, staged by the caller), the
        reference's draws: Wide&Deep's multi-hot field ids (B, F, nnz),
        the other towers' behaviour sequences (B, S)."""
        rng = np.random.default_rng(now_ms % (2 ** 31))
        if cfg.arch_id.startswith("wide-deep"):
            ids = rng.integers(0, cfg.vocab, (user_ids.size, cfg.n_sparse,
                                              cfg.nnz_per_field))
            return {"sparse_ids": ids.astype(np.int32)}
        seq = rng.integers(0, cfg.vocab, (user_ids.size, cfg.seq_len))
        return {"seq": seq.astype(np.int32)}

    def tower_fn(p, feats):
        return rec_lib.tower_step(p, feats, cfg, impl=backend)

    return cfg, params, tower_fn, features_of


def _stage_chunk(uids, times_ms, features_of, lo: int, n_steps: int,
                 batch: int, device, injector=None, override_ids=None):
    """Stage ``n_steps`` consecutive serve batches as (S, B) tensors on the
    device, one host-to-device copy per array. ``override_ids`` (S, B)
    substitutes the user ids (the overload flash crowd) while keeping the
    clock. The failure mask is staged only when an injector rides along
    (None otherwise)."""
    ids = (np.stack([uids[lo + s * batch: lo + (s + 1) * batch]
                     for s in range(n_steps)]) if override_ids is None
           else np.asarray(override_ids, np.int64))
    nows = [int(times_ms[lo + (s + 1) * batch - 1]) for s in range(n_steps)]
    feats = [features_of(ids[s], nows[s]) for s in range(n_steps)]
    feats = {k: torch.as_tensor(np.stack([f[k] for f in feats]),
                                device=device) for k in feats[0]}
    fails = (None if injector is None else torch.as_tensor(
        np.stack([injector.mask(batch, now) for now in nows]),
        device=device))
    return (Key64.from_int(ids, device=device), feats,
            torch.as_tensor(np.asarray(nows, np.int32), device=device), fails)


def _chunks(n_batches: int, chunk_steps: int):
    """(lo_batch, n_steps) chunk spans covering ``n_batches``."""
    lo = 0
    while lo < n_batches:
        yield lo, min(chunk_steps, n_batches - lo)
        lo += chunk_steps


def run_serving(arch: str = "sasrec", minutes: int = 60, users: int = 2000,
                ttl_min: float = 5.0, failover_ttl_h: float = 1.0,
                batch: int = 256, miss_budget_frac: float = 0.75,
                failure_rate: float = 0.0, use_cache: bool = True,
                backend: str = "cuda", eviction: str = "ttl",
                coalesce: bool = False, chunk_steps: int = 64,
                n_buckets: int = 1 << 14, seed: int = 0, device="cuda",
                log=print):
    device = resolve_device(device)
    tower_cfg, params, tower_fn, features_of = build_tower(
        arch, backend=backend, device=device, seed=seed)
    cache_cfg = CacheConfig(
        model_id=1, model_type="ctr",
        cache_ttl_ms=int(ttl_min * MINUTE_MS),
        failover_ttl_ms=int(failover_ttl_h * HOUR_MS),
        n_buckets=n_buckets, ways=8,
        value_dim=tower_cfg.user_embed_dim,
        miss_budget_frac=miss_budget_frac,
        backend=backend, eviction=eviction, coalesce_misses=coalesce)
    server = srv_lib.CachedEmbeddingServer(
        cfg=cache_cfg, tower_fn=tower_fn,
        miss_budget=max(int(batch * miss_budget_frac), 1))
    state = srv_lib.init_server_state(cache_cfg, writebuf_capacity=batch * 4,
                                      device=device)

    stream_cfg = StreamConfig(n_users=users, horizon_s=minutes * 60.0,
                              seed=seed)
    times_ms, uids = generate_stream_fast(
        stream_cfg, InterArrivalDist(FIG6_KNOTS))
    injector = FailureInjector(base_rate=failure_rate, seed=seed)

    counters = ServingCounters()
    t0 = time.perf_counter()
    n_batches = len(uids) // batch
    if use_cache:
        # one serve_many call + ONE counter fetch per chunk
        for lo, n_steps in _chunks(n_batches, chunk_steps):
            keys, feats, nows, fails = _stage_chunk(
                uids, times_ms, features_of, lo * batch, n_steps, batch,
                device, injector=injector)
            state, acc, _ = server.jit_serve_many(
                params, state, keys, feats, nows, fails, flush_every=1,
                collect=False)
            counters.merge(ServingCounters.from_stats(
                srv_lib.fetch_counters(acc)))
    else:
        # cache-off baseline: the fallback count accumulates on the
        # device, one transfer at the end
        nf_dev = torch.zeros((), dtype=torch.int32, device=device)
        for b in range(n_batches):
            keys, feats, _, fails = _stage_chunk(
                uids, times_ms, features_of, b * batch, 1, batch, device,
                injector=injector)
            _, src = srv_lib.serve_step_no_cache(
                tower_fn, params, Key64(keys.hi[0], keys.lo[0]),
                {k: v[0] for k, v in feats.items()}, fails[0])
            nf_dev += (src == srv_lib.SRC_FALLBACK).sum(dtype=torch.int32)
        nf = int(nf_dev.item())
        counters.merge(ServingCounters(
            requests=n_batches * batch, tower_inferences=n_batches * batch,
            tower_failures=nf, fallbacks=nf))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    d = counters.as_dict()
    d["wall_s"] = round(wall, 2)
    d["batches"] = n_batches
    d["req_per_s"] = round(counters.requests / max(wall, 1e-9), 1)
    d["power_savings_at_0.8_tower_share"] = round(
        power_savings(counters.hit_rate, 0.8), 4)
    d["device"] = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    log(f"[serve {arch}] ttl={ttl_min}min evict={eviction}"
        f" cache={'on' if use_cache else 'off'}"
        f" coalesce={'on' if coalesce else 'off'}"
        f" backend={backend} device={d['device']}"
        f" requests={d['requests']} hit_rate={d['hit_rate']:.3f}"
        f" fallback_rate={d['fallback_rate']:.4f}"
        f" tower_inferences={d['tower_inferences']}"
        f" ({wall:.1f}s, {d['req_per_s']:.0f} req/s)")
    return d


def run_serving_multi(arch: str = "sasrec", minutes: int = 60,
                      users: int = 2000, batch: int = 256,
                      miss_budget_frac: float = 0.75,
                      n_buckets: int = 1 << 12, failure_rate: float = 0.0,
                      backend: str = "cuda", coalesce: bool = False,
                      chunk_steps: int = 64, seed: int = 0, device="cuda",
                      log=print):
    """Replay one access stream across the whole model registry: each
    request is fanned out to one registry model (round-robin within the
    batch, phased by the batch index), so every batch is a mixed-model
    batch served by ONE ``MultiModelServer`` step; chunks of
    ``chunk_steps`` batches run as one ``serve_many`` call each. Reports
    the global counters and the per-model hit rates (Table 2's shape)."""
    device = resolve_device(device)
    tower_cfg, params, tower_fn, features_of = build_tower(
        arch, backend=backend, device=device, seed=seed)
    cfgs = multi_model_tier_configs(value_dim=tower_cfg.user_embed_dim,
                                    n_buckets=n_buckets)
    cfgs = [dataclasses.replace(c, backend=backend,
                                coalesce_misses=coalesce) for c in cfgs]
    server = srv_lib.MultiModelServer(
        cfgs=tuple(cfgs), tower_fn=tower_fn,
        miss_budget=max(int(batch * miss_budget_frac), 1), backend=backend,
        device=device)
    state = srv_lib.init_multi_server_state(
        cfgs, writebuf_capacity=batch * 4, device=device)
    n_models = server.n_models

    stream_cfg = StreamConfig(n_users=users, horizon_s=minutes * 60.0,
                              seed=seed)
    times_ms, uids = generate_stream_fast(
        stream_cfg, InterArrivalDist(FIG6_KNOTS))
    injector = FailureInjector(base_rate=failure_rate, seed=seed)

    counters = ServingCounters()
    pm_requests = np.zeros(n_models, np.int64)
    pm_hits = np.zeros(n_models, np.int64)
    pm_fallbacks = np.zeros(n_models, np.int64)
    t0 = time.perf_counter()
    n_batches = len(uids) // batch
    for lo, n_steps in _chunks(n_batches, chunk_steps):
        keys, feats, nows, fails = _stage_chunk(
            uids, times_ms, features_of, lo * batch, n_steps, batch,
            device, injector=injector)
        slots = torch.as_tensor(
            (np.arange(batch)[None, :] + lo + np.arange(n_steps)[:, None])
            % n_models, dtype=torch.int32, device=device)
        state, acc, _ = server.jit_serve_many(
            params, state, slots, keys, feats, nows, fails, flush_every=1,
            collect=False)
        c = srv_lib.fetch_counters(acc)      # one transfer per chunk
        counters.merge(ServingCounters.from_stats(c))
        pm_requests += np.asarray(c["per_model_requests"], np.int64)
        pm_hits += np.asarray(c["per_model_direct_hits"], np.int64)
        pm_fallbacks += np.asarray(c["per_model_fallbacks"], np.int64)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    d = counters.as_dict()
    d["wall_s"] = round(wall, 2)
    d["batches"] = n_batches
    d["n_models"] = n_models
    d["req_per_s"] = round(counters.requests / max(wall, 1e-9), 1)
    d["device"] = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    d["per_model"] = {
        cfg.model_id: {
            "model_type": cfg.model_type,
            "eviction": cfg.eviction,
            "ttl_min": cfg.cache_ttl_ms / MINUTE_MS,
            "requests": int(pm_requests[i]),
            "hit_rate": round(pm_hits[i] / max(pm_requests[i], 1), 4),
            "fallback_rate": round(
                pm_fallbacks[i] / max(pm_requests[i], 1), 4),
        }
        for i, cfg in enumerate(cfgs)
    }
    log(f"[serve-multi {arch}] models={n_models} backend={backend}"
        f" device={d['device']} requests={d['requests']}"
        f" hit_rate={d['hit_rate']:.3f}"
        f" fallback_rate={d['fallback_rate']:.4f}"
        f" ({wall:.1f}s, {d['req_per_s']:.0f} req/s)")
    for mid, pm in d["per_model"].items():
        log(f"  model {mid} ({pm['model_type']}, ttl={pm['ttl_min']:g}min,"
            f" {pm['eviction']}): hit_rate={pm['hit_rate']:.3f}"
            f" requests={pm['requests']}")
    return d


@dataclasses.dataclass
class OverloadPlan:
    """What the overload timeline serves, built before its clock starts:
    the tower, both servers, the stream, the calibrated budget, the
    failure injector and the pre / outage / post spans (batch ranges)."""
    arch: str
    users: int
    batch: int
    seed: int
    backend: str
    device: torch.device
    params: object
    features_of: object
    state: srv_lib.ServerState             # the initial state
    times_ms: np.ndarray
    uids: np.ndarray
    budget: float
    budget_frac: float
    miss_rate: float
    failure_rate: float
    failure_burst_rate: float
    injector: FailureInjector | None
    spans: list                            # (phase, lo, hi, server)


def plan_overload(arch: str = "sasrec", minutes: int = 60,
                  users: int = 2000, batch: int = 256,
                  ttl_min: float = 5.0, failover_ttl_h: float = 1.0,
                  budget_frac: float = 0.5, burst_start_frac: float = 0.4,
                  burst_len_frac: float = 0.2, failure_rate: float = 0.0,
                  failure_burst_rate: float = None,
                  n_buckets: int = 1 << 14, backend: str = "cuda",
                  smoke: bool = True, seed: int = 0,
                  device="cuda") -> OverloadPlan:
    """Set up the overload scenario of :func:`run_serving_overload` (same
    arguments) without serving a step."""
    device = resolve_device(device)
    tower_cfg, params, tower_fn, features_of = build_tower(
        arch, backend=backend, device=device, smoke=smoke, seed=seed)
    stream_cfg = StreamConfig(n_users=users, horizon_s=minutes * 60.0,
                              seed=seed)
    times_ms, uids = generate_stream_fast(
        stream_cfg, InterArrivalDist(FIG6_KNOTS))
    ttl_ms = int(ttl_min * MINUTE_MS)
    # provision: steady-state miss demand per batch, from the exact
    # infinite-capacity TTL simulation of THIS stream (warm-up excluded)
    warm_ms = int(times_ms[len(times_ms) // 4]) if len(times_ms) else 0
    miss_rate = 1.0 - simulate_hit_rate(times_ms, uids, ttl_ms,
                                        measure_from_ms=warm_ms)
    budget = max(budget_frac * miss_rate * batch, 1.0)

    cache_cfg = CacheConfig(
        model_id=1, model_type="ctr", cache_ttl_ms=ttl_ms,
        failover_ttl_ms=int(failover_ttl_h * HOUR_MS),
        n_buckets=n_buckets, ways=8, value_dim=tower_cfg.user_embed_dim,
        backend=backend, infer_budget_per_step=budget,
        failover_ttl_relax=None)
    outage_srv = srv_lib.CachedEmbeddingServer(
        cfg=cache_cfg, tower_fn=tower_fn, miss_budget=batch)
    full_srv = srv_lib.CachedEmbeddingServer(
        cfg=dataclasses.replace(cache_cfg, infer_budget_per_step=None),
        tower_fn=tower_fn, miss_budget=batch)
    state = srv_lib.init_server_state(cache_cfg, writebuf_capacity=batch * 4,
                                      device=device)

    # a stream shorter than one batch yields zero spans (an all-zero
    # report) instead of staging past its end
    n_batches_total = len(uids) // batch
    burst_lo = int(n_batches_total * burst_start_frac)
    burst_hi = int(n_batches_total * (burst_start_frac + burst_len_frac))

    # inference-failure stream: burst window aligned to the outage phase
    injector = None
    if failure_rate > 0 or failure_burst_rate is not None:
        lo_ms = int(times_ms[min(burst_lo * batch, len(times_ms) - 1)])
        hi_ms = int(times_ms[min(burst_hi * batch, len(times_ms) - 1)]) + 1
        injector = FailureInjector(
            base_rate=failure_rate,
            burst_rate=(failure_rate if failure_burst_rate is None
                        else failure_burst_rate),
            burst_windows_ms=((lo_ms, hi_ms),), seed=seed)
    return OverloadPlan(
        arch=arch, users=users, batch=batch, seed=seed, backend=backend,
        device=device, params=params, features_of=features_of, state=state,
        times_ms=times_ms, uids=uids, budget=budget, budget_frac=budget_frac,
        miss_rate=miss_rate, failure_rate=failure_rate,
        failure_burst_rate=(failure_rate if failure_burst_rate is None
                            else failure_burst_rate),
        injector=injector,
        spans=[("pre", 0, burst_lo, full_srv),
               ("outage", burst_lo, burst_hi, outage_srv),
               ("post", burst_hi, n_batches_total, full_srv)])


def overload_chunks(plan: OverloadPlan, chunk_steps: int = 64):
    """The plan's serve chunks in order: (phase, server, (keys, feats,
    nows, fails)) staged on the device, the outage's with the flash crowd
    (same population, arrival order decorrelated) in place of the
    stream's ids."""
    burst_rng = np.random.default_rng(plan.seed + 1)
    for phase, p_lo, p_hi, server in plan.spans:
        for lo, n_steps in _chunks(p_hi - p_lo, chunk_steps):
            override = None
            if phase == "outage":
                override = burst_rng.integers(0, plan.users,
                                              size=(n_steps, plan.batch))
            yield phase, server, _stage_chunk(
                plan.uids, plan.times_ms, plan.features_of,
                (p_lo + lo) * plan.batch, n_steps, plan.batch, plan.device,
                injector=plan.injector, override_ids=override)


def overload_timeline(plan: OverloadPlan, chunk_steps: int = 64,
                      log=print):
    """Serve ``plan`` end to end: the report of :func:`run_serving_overload`
    and the final ``ServerState`` (both cache tiers and the admission
    token bucket, after the last flush)."""
    phases = {p: ServingCounters() for p, *_ in plan.spans}
    stale = {p: [0.0, 0] for p in phases}          # [age sum, serve count]
    state = plan.state
    t0 = time.perf_counter()
    for phase, server, staged in overload_chunks(plan, chunk_steps):
        state, acc, _ = server.jit_serve_many(plan.params, state, *staged,
                                              flush_every=1, collect=False)
        c = srv_lib.fetch_counters(acc)          # one transfer per chunk
        phases[phase].merge(ServingCounters.from_stats(c))
        stale[phase][0] += c["failover_stale_sum_ms"]
        stale[phase][1] += c["failover_serves"]
    if plan.device.type == "cuda":
        torch.cuda.synchronize(plan.device)
    wall = time.perf_counter() - t0

    n_batches = plan.spans[-1][2]
    burst_lo, burst_hi = plan.spans[1][1:3]
    out = {"budget_per_step": round(plan.budget, 2),
           "budget_frac": plan.budget_frac,
           "provisioned_miss_rate": round(plan.miss_rate, 4),
           "failure_rate": plan.failure_rate,
           "failure_burst_rate": plan.failure_burst_rate,
           "wall_s": round(wall, 2), "batches": n_batches,
           "step_ms": wall * 1e3 / max(n_batches, 1),
           "device": (torch.cuda.get_device_name(plan.device)
                      if plan.device.type == "cuda" else "cpu"),
           "phases": {}}
    log(f"[serve-overload {plan.arch}] budget={plan.budget:.1f}/step "
        f"({plan.budget_frac:g}x of {plan.miss_rate:.3f} miss demand) "
        f"burst=batches[{burst_lo}:{burst_hi}]"
        + (f" failures={plan.failure_rate:g}/"
           f"{plan.failure_burst_rate:g}" if plan.injector else "")
        + f" backend={plan.backend} device={out['device']} ({wall:.1f}s)")
    for p, c in phases.items():
        d = c.as_dict()
        d["mean_failover_stale_ms"] = round(stale[p][0] / max(stale[p][1], 1),
                                            1)
        # Table 3's counterfactual: without the failover tier, every
        # degradation-chain failover serve would have been a default
        # embedding
        d["fallback_rate_wo_failover"] = round(
            (c.fallbacks + c.failover_serves) / max(c.requests, 1), 6)
        out["phases"][p] = d
        log(f"  {p:>5}: requests={d['requests']} hit={d['hit_rate']:.3f}"
            f" deferred={d['deferred']}"
            f" failures={d['tower_failures']}"
            f" failover_serves={d['failover_serves']}"
            f" (stale {d['mean_failover_stale_ms']:.0f}ms)"
            f" defaults={d['fallbacks']}"
            f" fallback_rate={d['fallback_rate']:.4f}"
            f"/wo_failover={d['fallback_rate_wo_failover']:.4f}"
            f" sla_served={d['sla_served_rate']:.4f}")
    return out, state


def run_serving_overload(arch: str = "sasrec", minutes: int = 60,
                         users: int = 2000, batch: int = 256,
                         ttl_min: float = 5.0, failover_ttl_h: float = 1.0,
                         budget_frac: float = 0.5,
                         burst_start_frac: float = 0.4,
                         burst_len_frac: float = 0.2,
                         failure_rate: float = 0.0,
                         failure_burst_rate: float = None,
                         chunk_steps: int = 64, n_buckets: int = 1 << 14,
                         backend: str = "cuda", smoke: bool = True,
                         seed: int = 0, device="cuda", log=print) -> dict:
    """The capacity-outage / overload scenario, end to end.

    Timeline: the run starts at FULL capacity (no admission gate) so the
    dual-tier caches warm; at ``burst_start_frac`` the capacity OUTAGE
    begins: the serving tier is swapped for one whose per-step token
    budget is ``budget_frac`` x the stream's own steady-state miss demand
    (the exact TTL-cache simulator on the generated stream, warm-up
    excluded) while a flash crowd of uniform re-accesses from the same
    population spikes demand; after ``burst_len_frac`` capacity recovers.
    Deferred misses degrade through the relaxed-TTL failover tier
    (``failover_ttl_relax=None``: staleness unbounded, SLA defended). Each
    phase is a contiguous batch range behind ONE server, chunked onto
    ``serve_many`` with one counter fetch per chunk.

    ``failure_rate`` / ``failure_burst_rate`` wire a ``FailureInjector``
    in (paper Table 3's inference failures): a base Bernoulli rate
    everywhere, the burst rate inside the outage window. Each phase then
    reports ``fallback_rate`` (with the failover tier assisting) beside
    ``fallback_rate_wo_failover`` (every failover-tier serve would have
    been a default embedding without it).

    The tower is the SMOKE config by default, as the reference launcher
    serves; ``smoke=False`` serves the published widths. Returns
    ``budget_per_step``, ``provisioned_miss_rate`` and, per phase
    (``pre``, ``outage``, ``post``), the ``ServingCounters`` fields with
    ``mean_failover_stale_ms`` and ``fallback_rate_wo_failover``.
    """
    plan = plan_overload(
        arch=arch, minutes=minutes, users=users, batch=batch,
        ttl_min=ttl_min, failover_ttl_h=failover_ttl_h,
        budget_frac=budget_frac, burst_start_frac=burst_start_frac,
        burst_len_frac=burst_len_frac, failure_rate=failure_rate,
        failure_burst_rate=failure_burst_rate, n_buckets=n_buckets,
        backend=backend, smoke=smoke, seed=seed, device=device)
    return overload_timeline(plan, chunk_steps, log)[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="sasrec",
                    help="the recsys user tower behind the cache: "
                         "wide-deep, sasrec, bst or mind")
    ap.add_argument("--minutes", type=int, default=60)
    ap.add_argument("--users", type=int, default=2000)
    ap.add_argument("--ttl-min", type=float, default=None,
                    help="direct-cache TTL in minutes (default 5; per-model "
                         "in --multi mode)")
    ap.add_argument("--failure-rate", type=float, default=0.0)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--chunk-steps", type=int, default=64,
                    help="serve steps per serve_many call")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--coalesce", action="store_true",
                    help="in-batch inference coalescing: one tower run "
                         "per distinct missed user per batch "
                         "(incompatible with --no-cache/--overload)")
    ap.add_argument("--multi", action="store_true",
                    help="serve the whole per-model registry as one "
                         "multi-model tier (mixed-model batches, one probe "
                         "launch per batch)")
    ap.add_argument("--overload", action="store_true",
                    help="SLA admission-control scenario: constrained "
                         "inference budget + mid-run re-access burst; "
                         "deferred misses degrade through the relaxed-TTL "
                         "failover tier")
    ap.add_argument("--budget-frac", type=float, default=0.5,
                    help="--overload: inference budget as a fraction of "
                         "the stream's steady-state miss demand")
    ap.add_argument("--failure-burst-rate", type=float, default=None,
                    help="--overload: failure probability inside the "
                         "outage window (FailureInjector burst; default: "
                         "same as --failure-rate)")
    ap.add_argument("--multi-buckets", type=int, default=1 << 12,
                    help="per-model direct-cache buckets in --multi mode")
    ap.add_argument("--backend", default="cuda", choices=["torch", "cuda"],
                    help="cuda: the hand-written kernels; torch: plain ops")
    ap.add_argument("--eviction", default="ttl", choices=["ttl", "lru"],
                    help="direct/failover victim order (paper §3.3); lru "
                         "enables access-recency touches (incompatible "
                         "with --multi: the registry sets it per model)")
    args = ap.parse_args(argv)
    if args.overload:
        if args.multi:
            ap.error("--overload drives the single-model server; the "
                     "multi-model registry sets budgets per model "
                     "(CacheConfig.infer_budget_per_step)")
        if args.no_cache:
            ap.error("--overload is a cache-tier scenario; drop --no-cache")
        if args.coalesce:
            ap.error("--overload isolates admission control; run "
                     "--coalesce on the plain/--multi modes")
        if args.eviction != "ttl":
            ap.error("--overload fixes eviction=ttl (the scenario "
                     "isolates admission, not victim order)")
        return run_serving_overload(
            arch=args.arch, minutes=args.minutes, users=args.users,
            batch=args.batch,
            ttl_min=5.0 if args.ttl_min is None else args.ttl_min,
            budget_frac=args.budget_frac, failure_rate=args.failure_rate,
            failure_burst_rate=args.failure_burst_rate,
            backend=args.backend, chunk_steps=args.chunk_steps)
    if args.multi:
        # flags the multi tier cannot honor: TTLs and eviction come from
        # the per-model registry, and the tier has no cache-off baseline
        if args.no_cache:
            ap.error("--no-cache has no multi-model baseline; drop --multi")
        if args.ttl_min is not None:
            ap.error("--ttl-min is per-model in --multi mode; it cannot be "
                     "overridden")
        if args.eviction != "ttl":
            ap.error("--eviction is per-model in --multi mode (registry "
                     "second-stage models already run lru)")
        return run_serving_multi(
            arch=args.arch, minutes=args.minutes, users=args.users,
            batch=args.batch, n_buckets=args.multi_buckets,
            failure_rate=args.failure_rate, backend=args.backend,
            coalesce=args.coalesce, chunk_steps=args.chunk_steps)
    if args.no_cache and args.coalesce:
        ap.error("--coalesce dedupes cache misses; drop --no-cache")
    return run_serving(arch=args.arch, minutes=args.minutes,
                       users=args.users,
                       ttl_min=5.0 if args.ttl_min is None else args.ttl_min,
                       failure_rate=args.failure_rate, batch=args.batch,
                       use_cache=not args.no_cache, backend=args.backend,
                       eviction=args.eviction, coalesce=args.coalesce,
                       chunk_steps=args.chunk_steps)


if __name__ == "__main__":
    main()
