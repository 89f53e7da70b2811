"""Serving launcher: request stream -> ERCache -> tower, end to end, on the
card.

Twin of the basic, ``--no-cache``, ``--multi``, ``--overload``,
``--chaos``, ``--regions`` and ``--restart`` modes of
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
phase by phase. ``--chaos`` compiles a preset multi-fault scenario into
a schedule staged on the device and replays it against the multi-model
tier with retry/backoff, reporting the degradation ledger window by
window. ``--regions N`` stacks N regions over the tier with sticky
routing on the device; ``--drain`` drains one mid-run (the Fig. 10
test). ``--restart`` is the kill/restore harness: it snapshots the cache
every ``--checkpoint-every`` steps, kills the server mid-incident, and
measures recovery after a bit-exact, a grown, a shrunk and a cold
restore. ``--shards N`` splits the plain and ``--multi`` modes' cache
tier by bucket range over N shards (``launch/mesh.make_cache_mesh``: the
first N cards, or round-robin over fewer; on one card all N share it).
The reference's ``ensure_shard_devices`` re-exec has no counterpart: JAX
fixes its host device count before the flags are parsed, torch needs no
forced device count.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch sasrec|wide-deep|bst|mind --minutes 120 --users 5000 \\
        --ttl-min 5 [--no-cache] [--coalesce]
    PYTHONPATH=src python -m repro_torch.launch.serve --multi \\
        --minutes 30 --users 1000 [--multi-buckets 4096] [--coalesce]
    PYTHONPATH=src python -m repro_torch.launch.serve [--multi] --shards 4
    PYTHONPATH=src python -m repro_torch.launch.serve --overload \\
        --minutes 60 --users 2000 [--budget-frac 0.5] \\
        [--failure-rate 0.02 --failure-burst-rate 0.2]
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --chaos incident|cascade|rolling [--chaos-models 4] \\
        [--chaos-steps 240] [--chaos-retries 2] [--hedge-after-ms 25]
    PYTHONPATH=src python -m repro_torch.launch.serve --regions 4 \\
        --drain [--locality 0.98] [--minutes 60 --users 2000]
    PYTHONPATH=src python -m repro_torch.launch.serve --restart \\
        [--checkpoint-every 40] [--users 3000 --batch 256]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import cache as cache_lib
from repro_torch.core import graph as graph_lib
from repro_torch.core import regional as rg_lib
from repro_torch.core import server as srv_lib
from repro_torch.core.cache import resolve_device
from repro_torch.core.config import (CacheConfig, HOUR_MS, MINUTE_MS,
                                     multi_model_tier_configs)
from repro_torch.core.hashing import Key64
from repro_torch.core.metrics import ServingCounters, power_savings
from repro_torch.data.access_patterns import (FIG6_KNOTS, InterArrivalDist,
                                              StreamConfig,
                                              generate_stream_fast,
                                              simulate_hit_rate,
                                              thin_diurnal)
from repro_torch.ft import chaos as chaos_lib
from repro_torch.ft import snapshot as snap_lib
from repro_torch.ft.failure import FailureInjector, StragglerHedger
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


def _stage_steps(ids, nows_ms, features_of, device):
    """Stage an explicit (S, B) id matrix and (S,) clock as tensors on the
    device (a stream with no underlying renewal stream to index into;
    cf. :func:`_stage_chunk`)."""
    ids = np.asarray(ids, np.int64)
    feats = [features_of(ids[s], int(nows_ms[s]))
             for s in range(ids.shape[0])]
    feats = {k: torch.as_tensor(np.stack([f[k] for f in feats]),
                                device=device) for k in feats[0]}
    return (Key64.from_int(ids, device=device), feats,
            torch.as_tensor(np.asarray(nows_ms, np.int32), device=device))


def _cache_mesh(n_shards: int, device: torch.device):
    """The cache tier's mesh of ``n_shards`` shards (None: unsharded). On
    the card :func:`~repro_torch.launch.mesh.make_cache_mesh` places them;
    on the CPU every shard is ``device``."""
    if n_shards <= 1:
        return None
    from repro_torch.launch.mesh import make_cache_mesh

    if device.type == "cuda":
        return make_cache_mesh(n_shards)
    return make_cache_mesh(n_shards, devices=[device] * n_shards)


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
                n_buckets: int = 1 << 14, n_shards: int = 1, seed: int = 0,
                device="cuda", log=print):
    device = resolve_device(device)
    mesh = _cache_mesh(n_shards, device)
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
        miss_budget=max(int(batch * miss_budget_frac), 1), mesh=mesh)
    state = srv_lib.init_server_state(cache_cfg, writebuf_capacity=batch * 4,
                                      device=device, mesh=mesh)

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
    d["n_shards"] = n_shards
    return d


def run_serving_multi(arch: str = "sasrec", minutes: int = 60,
                      users: int = 2000, batch: int = 256,
                      miss_budget_frac: float = 0.75,
                      n_buckets: int = 1 << 12, failure_rate: float = 0.0,
                      backend: str = "cuda", coalesce: bool = False,
                      chunk_steps: int = 64, n_shards: int = 1,
                      seed: int = 0, device="cuda", log=print):
    """Replay one access stream across the whole model registry: each
    request is fanned out to one registry model (round-robin within the
    batch, phased by the batch index), so every batch is a mixed-model
    batch served by ONE ``MultiModelServer`` step; chunks of
    ``chunk_steps`` batches run as one ``serve_many`` call each. Reports
    the global counters and the per-model hit rates (Table 2's shape).
    ``n_shards`` splits the stacked tiers by bucket range."""
    device = resolve_device(device)
    mesh = _cache_mesh(n_shards, device)
    tower_cfg, params, tower_fn, features_of = build_tower(
        arch, backend=backend, device=device, seed=seed)
    cfgs = multi_model_tier_configs(value_dim=tower_cfg.user_embed_dim,
                                    n_buckets=n_buckets)
    cfgs = [dataclasses.replace(c, backend=backend,
                                coalesce_misses=coalesce) for c in cfgs]
    server = srv_lib.MultiModelServer(
        cfgs=tuple(cfgs), tower_fn=tower_fn,
        miss_budget=max(int(batch * miss_budget_frac), 1), backend=backend,
        device=device, mesh=mesh)
    state = srv_lib.init_multi_server_state(
        cfgs, writebuf_capacity=batch * 4, device=device, mesh=mesh)
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
    d["n_shards"] = n_shards
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


# ------------------------------------------------------------------ chaos
def restart_timeline(arch: str = "sasrec", pre_steps: int = 240,
                     recovery_steps: int = 120, users: int = 3000,
                     batch: int = 256, ttl_min: float = 5.0,
                     checkpoint_every: int = 40, step_ms: int = 250,
                     zipf_a: float = 1.2, n_buckets: int = 1 << 12,
                     backend: str = "cuda", chunk_steps: int = 40,
                     workdir: str = None, smoke: bool = True, seed: int = 0,
                     device="cuda", jit: bool = True, log=print):
    """The kill/restore harness of :func:`run_serving_restart` (same
    arguments; ``jit=False`` serves through the eager ``serve_many``).
    Returns ``(report, variants)``: ``variants`` maps each variant to its
    restore's ``detail`` (None when cold), every tensor of its cache image
    cloned right after the restore (``restored``) and its final state."""
    device = resolve_device(device)
    tower_cfg, params, tower_fn, features_of = build_tower(
        arch, backend=backend, device=device, smoke=smoke, seed=seed)
    ttl_ms = int(ttl_min * MINUTE_MS)
    base_cfg = CacheConfig(
        model_id=1, model_type="ctr", cache_ttl_ms=ttl_ms,
        failover_ttl_ms=int(2 * HOUR_MS), n_buckets=n_buckets, ways=8,
        value_dim=tower_cfg.user_embed_dim, backend=backend)

    total = pre_steps + recovery_steps
    rng = np.random.default_rng(seed)
    ids_all = rng.zipf(zipf_a, size=(total, batch)).astype(np.int64) % users
    nows_all = (np.arange(total, dtype=np.int64) + 1) * step_ms

    # the incident: a failure burst over the back half of the pre phase;
    # the process dies at the first checkpoint boundary inside it
    burst = (int(nows_all[pre_steps // 2]), int(nows_all[pre_steps - 1]) + 1)
    injector = FailureInjector(base_rate=0.0, burst_rate=1.0,
                               burst_windows_ms=(burst,), seed=seed)
    kill = injector.kill_step(nows_all, checkpoint_every)
    if kill is None or kill > pre_steps:
        kill = max((pre_steps // checkpoint_every) * checkpoint_every,
                   checkpoint_every)
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="ercache-restart-")

    def make_server(nb):
        cfg = dataclasses.replace(base_cfg, n_buckets=nb)
        return srv_lib.CachedEmbeddingServer(
            cfg=cfg, tower_fn=tower_fn, miss_budget=batch), cfg

    def serve(server, state, ids, nows):
        """One chunk: one serve_many call and one counter fetch."""
        keys, feats, nows = _stage_steps(ids, nows, features_of, device)
        run = server.jit_serve_many if jit else server.serve_many
        state, acc, _ = run(params, state, keys, feats, nows, flush_every=1,
                            collect=False)
        return state, ServingCounters.from_stats(srv_lib.fetch_counters(acc))

    server, cfg0 = make_server(n_buckets)
    state = srv_lib.init_server_state(cfg0, writebuf_capacity=batch * 4,
                                      device=device)

    # ---- phase 1: serve to the kill, snapshotting at every boundary ----
    t0 = time.perf_counter()
    pre_counters = ServingCounters()
    for seg_lo in range(0, kill, checkpoint_every):
        n = min(checkpoint_every, kill - seg_lo)
        state, c = serve(server, state, ids_all[seg_lo:seg_lo + n],
                         nows_all[seg_lo:seg_lo + n])
        pre_counters.merge(c)
        state = snap_lib.snapshot_server(
            workdir, seg_lo + n, server, state,
            int(nows_all[seg_lo + n - 1]), counters=pre_counters,
            retain_last_k=3)
    # the crash: the in-memory state dies, and a save that was in flight
    # is left torn (manifest truncated, no COMMITTED marker)
    torn = os.path.join(workdir, f"step_{kill + checkpoint_every:08d}")
    os.makedirs(torn, exist_ok=True)
    with open(os.path.join(torn, "manifest.json"), "w") as f:
        f.write("{")
    del state
    restore_now = int(nows_all[kill - 1])

    # ---- phase 2: restore (3 geometries) + cold, replay the SAME stream
    rec_ids = ids_all[kill:kill + recovery_steps]
    rec_nows = nows_all[kill:kill + recovery_steps]
    specs = [("warm_same", n_buckets, True),
             ("warm_grow", n_buckets * 2, True),
             ("warm_shrink", max(n_buckets // 2, 1), True),
             ("cold", n_buckets, False)]
    variants, probes, states = {}, {}, {}
    uniq = np.unique(ids_all[:kill])
    probe_keys = Key64.from_int(uniq.astype(np.int64), device=device)
    for name, nb, warm in specs:
        vsrv, vcfg = make_server(nb)
        detail = None
        if warm:
            r = snap_lib.restore_server(workdir, vsrv, now_ms=restore_now,
                                        writebuf_capacity=batch * 4,
                                        device=device)
            vstate, ledger = r.state, r.counters
            mode, restored_step, detail = r.mode, r.step, r.detail
            # probe BEFORE serving writes the restored table
            res = cache_lib.lookup(vstate.direct, probe_keys, restore_now,
                                   ttl_ms, backend=backend)
            probes[name] = (res.hit.cpu().numpy(), res.values.cpu().numpy())
        else:
            vstate = srv_lib.init_server_state(
                vcfg, writebuf_capacity=batch * 4, device=device)
            ledger, mode, restored_step = ServingCounters(), "cold", None
        restored = [t.clone() for t in graph_lib.tensors_of(
            srv_lib.cache_image(vstate))]
        resumed = ledger.requests
        rec = ServingCounters()
        curve = []
        for lo, n in _chunks(recovery_steps, chunk_steps):
            vstate, c = serve(vsrv, vstate, rec_ids[lo:lo + n],
                              rec_nows[lo:lo + n])
            curve.append(round(c.hit_rate, 4))
            rec.merge(c)
        ledger.merge(rec)
        states[name] = {"detail": detail, "restored": restored,
                        "final": vstate}
        variants[name] = {
            "mode": mode, "restored_step": restored_step, "n_buckets": nb,
            "recovery_hit_rate": round(rec.hit_rate, 4),
            "recovery_curve": curve,
            "recovery_tower_inferences": rec.tower_inferences,
            "resumed_requests": resumed,
            "total_requests": ledger.requests,
        }
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    # ---- resized-restore probe parity (on the pre-kill key population) -
    h_same, v_same = probes["warm_same"]
    h_grow, v_grow = probes["warm_grow"]
    h_shr, v_shr = probes["warm_shrink"]
    both_g = h_same & h_grow
    both_s = h_same & h_shr
    parity = {
        "probed_keys": int(uniq.size),
        "snapshot_live": int(h_same.sum()),
        "grow_survivors": int(h_grow.sum()),
        "shrink_survivors": int(h_shr.sum()),
        "grow_preserves_all_live": bool((h_grow | ~h_same).all()),
        "shrink_serves_subset": bool((~h_shr | h_same).all()),
        "values_bit_exact": bool(
            np.array_equal(v_grow[both_g], v_same[both_g])
            and np.array_equal(v_shr[both_s], v_same[both_s])),
    }
    parity["pass"] = (parity["grow_preserves_all_live"]
                      and parity["shrink_serves_subset"]
                      and parity["values_bit_exact"])

    out = {
        "pre_steps": kill, "recovery_steps": recovery_steps,
        "kill_step": kill, "checkpoint_every": checkpoint_every,
        "step_ms": step_ms, "users": users, "batch": batch,
        "zipf_a": zipf_a, "ttl_min": ttl_min, "n_buckets": n_buckets,
        "backend": backend,
        "pre_hit_rate": round(pre_counters.hit_rate, 4),
        "torn_step_skipped": all(
            variants[n]["restored_step"] == kill
            for n in ("warm_same", "warm_grow", "warm_shrink")),
        "ledger_continuous": (
            variants["warm_same"]["total_requests"]
            == (kill + recovery_steps) * batch),
        "warm_vs_cold_gain": round(
            variants["warm_same"]["recovery_hit_rate"]
            - variants["cold"]["recovery_hit_rate"], 4),
        "variants": variants, "parity": parity,
        "wall_s": round(wall, 2), "workdir": workdir,
    }
    log(f"[serve-restart {arch}] kill@step {kill} "
        f"(ckpt every {checkpoint_every}), recovery {recovery_steps} steps,"
        f" pre_hit={out['pre_hit_rate']:.3f} ({wall:.1f}s)")
    for name, v in variants.items():
        log(f"  {name:>11}: mode={v['mode']:<8}"
            f" recovery_hit={v['recovery_hit_rate']:.3f}"
            f" tower_inferences={v['recovery_tower_inferences']}"
            f" curve={v['recovery_curve'][:4]}")
    log(f"  parity: live={parity['snapshot_live']}"
        f" grow={parity['grow_survivors']}"
        f" shrink={parity['shrink_survivors']}"
        f" pass={parity['pass']} | warm-vs-cold gain "
        f"{out['warm_vs_cold_gain']:+.3f} | torn skipped "
        f"{out['torn_step_skipped']} | ledger continuous "
        f"{out['ledger_continuous']}")
    return out, states


def run_serving_restart(arch: str = "sasrec", pre_steps: int = 240,
                        recovery_steps: int = 120, users: int = 3000,
                        batch: int = 256, ttl_min: float = 5.0,
                        checkpoint_every: int = 40, step_ms: int = 250,
                        zipf_a: float = 1.2, n_buckets: int = 1 << 12,
                        backend: str = "cuda", chunk_steps: int = 40,
                        workdir: str = None, smoke: bool = True,
                        seed: int = 0, device="cuda", log=print) -> dict:
    """Kill/restore fault-injection harness (paper §3.6–3.7).

    Replays a Zipf-skewed request stream while snapshotting the cache at
    every checkpoint boundary (``ft/snapshot.snapshot_server``, last-3
    retention); each chunk is one ``jit_serve_many`` call (on the card one
    CUDA graph replay). A ``FailureInjector`` burst window covering the
    back half of the pre phase models the incident; the process is killed
    at the first checkpoint boundary inside it
    (``FailureInjector.kill_step``): the in-memory state is discarded and
    the NEXT save is left torn (a directory without its COMMITTED marker),
    which the restore must skip.

    Recovery is then measured four ways over the SAME post-kill stream:

    * **warm_same**: restore into the identical geometry (bit-exact);
    * **warm_grow** / **warm_shrink**: restore into a 2x / half table
      through the elastic rehash;
    * **cold**: a fresh table, the restart without the durability layer.

    The report carries per-chunk hit-rate recovery curves, the
    resized-restore probe-parity check (every live snapshot entry the
    grown table must still serve bit-exactly; the shrunk table serves a
    subset, values bit-exact on survivors), and the counters-provenance
    check (the restored ledger resumes additively across the kill). The
    tower is the SMOKE config by default, as the reference launcher
    serves; ``smoke=False`` serves the published widths. Snapshots go to
    ``workdir`` (a new temporary directory by default), which is kept.
    """
    return restart_timeline(
        arch=arch, pre_steps=pre_steps, recovery_steps=recovery_steps,
        users=users, batch=batch, ttl_min=ttl_min,
        checkpoint_every=checkpoint_every, step_ms=step_ms, zipf_a=zipf_a,
        n_buckets=n_buckets, backend=backend, chunk_steps=chunk_steps,
        workdir=workdir, smoke=smoke, seed=seed, device=device, log=log)[0]


def _window_steps(windows_ms, nows_ms, tail_win: int):
    """Map the fault-edge windows (ms spans from ``chaos.fault_windows``)
    onto step ranges of the staged clock, cutting the trailing quiet span
    into ``tail_win``-step recovery windows. Returns [(lo, hi, label),
    ...] in steps; empty spans are dropped."""
    nows = np.asarray(nows_ms, np.int64)
    spans = []
    for a, b, label in windows_ms:
        steps = np.nonzero((nows >= a) & (nows < b))[0]
        if steps.size:
            spans.append((int(steps[0]), int(steps[-1]) + 1, label))
    if spans and spans[-1][2] == "quiet" and len(spans) > 1:
        lo, hi, _ = spans.pop()
        for s in range(lo, hi, tail_win):
            spans.append((s, min(s + tail_win, hi), "recovery"))
    return spans


@dataclasses.dataclass
class ChaosPlan:
    """What a chaos scenario serves, built before its clock starts: the
    tower, the multi-model server and its state, the Zipf stream, the
    compiled schedule, the skewed clock and the reporting windows."""
    config: dict                           # the report's settings
    device: torch.device
    params: object
    features_of: object
    server: srv_lib.MultiModelServer
    state: srv_lib.MultiServerState        # the initial state
    faults: list
    sched: chaos_lib.ChaosSchedule
    ids: np.ndarray                        # (S, B) user ids
    nows: np.ndarray                       # (S,) serve clock before skew
    snow: np.ndarray                       # (S,) the skewed clock served
    slots: torch.Tensor                    # (S, B) model slots
    spans: list                            # (lo, hi, label) step windows


def plan_chaos(arch: str = "sasrec", scenario: str = "incident",
               n_models: int = 4, steps: int = 240, users: int = 1000,
               batch: int = 256, step_ms: int = 250, ttl_min: float = 0.2,
               failover_ttl_h: float = 2.0, zipf_a: float = 1.2,
               n_buckets: int = 1 << 10, backend: str = "cuda",
               fail_rate: float = 0.9, max_retries: int = 2,
               backoff_ms: int = 500, recovery_win: int = 24,
               smoke: bool = True, seed: int = 0,
               device="cuda") -> ChaosPlan:
    """Set up the scenario of :func:`run_serving_chaos` (same arguments)
    without serving a step."""
    device = resolve_device(device)
    tower_cfg, params, tower_fn, features_of = build_tower(
        arch, backend=backend, device=device, smoke=smoke, seed=seed)
    cfgs = [CacheConfig(
        model_id=m + 1, model_type="ctr",
        cache_ttl_ms=int(ttl_min * MINUTE_MS),
        failover_ttl_ms=int(failover_ttl_h * HOUR_MS),
        n_buckets=n_buckets, ways=8, value_dim=tower_cfg.user_embed_dim,
        backend=backend, infer_budget_per_step=float(batch),
        failover_ttl_relax=None) for m in range(n_models)]
    server = srv_lib.MultiModelServer(cfgs=tuple(cfgs), tower_fn=tower_fn,
                                      miss_budget=batch, device=device)
    state = srv_lib.init_multi_server_state(
        cfgs, writebuf_capacity=batch * 4, device=device)

    rng = np.random.default_rng(seed)
    ids = rng.zipf(zipf_a, size=(steps, batch)).astype(np.int64) % users
    nows = (np.arange(steps, dtype=np.int64) + 1) * step_ms
    slots = ((np.arange(batch)[None, :] + np.arange(steps)[:, None])
             % n_models).astype(np.int32)
    horizon_ms = int(nows[-1]) + step_ms
    pooled = n_models * n_buckets          # the POOLED direct bucket space
    faults = chaos_lib.preset_faults(scenario, horizon_ms,
                                     n_models=n_models, n_buckets=pooled,
                                     fail_rate=fail_rate)
    sched = chaos_lib.compile_schedule(
        faults, nows, batch, n_models=n_models, n_buckets=pooled,
        slots=slots, retry=chaos_lib.RetryPolicy(
            max_retries=max_retries, backoff_ms=backoff_ms),
        seed=seed + 1, device=device)
    snow = chaos_lib.skewed_now(sched, nows).cpu().numpy()
    spans = _window_steps(chaos_lib.fault_windows(faults, horizon_ms),
                          nows, recovery_win)
    config = {"scenario": scenario, "arch": arch, "backend": backend,
              "n_models": n_models, "steps": steps, "batch": batch,
              "users": users, "step_ms": step_ms, "zipf_a": zipf_a,
              "ttl_min": ttl_min, "n_buckets": n_buckets,
              "fail_rate": fail_rate, "max_retries": max_retries,
              "backoff_ms": backoff_ms, "horizon_ms": horizon_ms,
              "seed": seed}
    return ChaosPlan(config=config, device=device, params=params,
                     features_of=features_of, server=server, state=state,
                     faults=faults, sched=sched, ids=ids, nows=nows,
                     snow=snow,
                     slots=torch.as_tensor(slots, device=device),
                     spans=spans)


def chaos_chunks(plan: ChaosPlan, chunk_steps: int = 64):
    """The plan's serve calls in order: (window index, (lo, n), inputs of
    ``serve_many`` after the state), each window cut into chunks of at
    most ``chunk_steps`` steps, staged on the device, served on the
    skewed clock with the schedule's rows."""
    for wi, (w_lo, w_hi, _) in enumerate(plan.spans):
        for lo, n in _chunks(w_hi - w_lo, chunk_steps):
            a = w_lo + lo
            keys, feats, nows = _stage_steps(plan.ids[a:a + n],
                                             plan.snow[a:a + n],
                                             plan.features_of, plan.device)
            yield wi, (a, n), (plan.slots[a:a + n], keys, feats, nows, None,
                               chaos_lib.slice_schedule(plan.sched, a,
                                                        a + n))


def chaos_timeline(plan: ChaosPlan, chunk_steps: int = 64,
                   hedge_after_ms: float = 25.0, checkpoint_every: int = 40,
                   recovery_tol_pp: float = 2.0, jit: bool = True,
                   log=print):
    """Serve ``plan`` end to end through ``jit_serve_many`` (``jit=False``:
    eager ``serve_many``). Returns the report of
    :func:`run_serving_chaos`, the final state and every chunk's fetched
    counters (per-model vectors included)."""
    cf = plan.config
    seed = cf["seed"]
    run = plan.server.jit_serve_many if jit else plan.server.serve_many
    state = plan.state
    sums = [dict() for _ in plan.spans]
    chunks = []
    t0 = time.perf_counter()
    for wi, _, inputs in chaos_chunks(plan, chunk_steps):
        state, acc, _ = run(plan.params, state, *inputs, flush_every=1,
                            collect=False)
        c = srv_lib.fetch_counters(acc)          # one transfer per chunk
        chunks.append(c)
        for k, v in c.items():
            if not isinstance(v, list):
                sums[wi][k] = sums[wi].get(k, 0) + float(v)
    if plan.device.type == "cuda":
        torch.cuda.synchronize(plan.device)
    wall = time.perf_counter() - t0

    windows = []
    lat_hedged, lat_plain, extra_frac = [], [], []
    for wi, ((w_lo, w_hi, label), acc_sum) in enumerate(zip(plan.spans,
                                                            sums)):
        g = lambda k: acc_sum.get(k, 0.0)
        req = max(g("requests"), 1.0)
        # paired latency draws: same seed, the hedged run samples backups
        n_lat = int(g("tower_inferences") + g("retries"))
        p99 = p99_plain = None
        if n_lat:
            hd = StragglerHedger(hedge_after_ms=hedge_after_ms,
                                 seed=seed + 100 + wi).latencies(n_lat)
            pl = StragglerHedger(hedge_after_ms=None,
                                 seed=seed + 100 + wi).latencies(n_lat)
            lat_hedged.append(hd["latency_ms"])
            lat_plain.append(pl["latency_ms"])
            extra_frac.append((hd["extra_compute_frac"], n_lat))
            p99 = round(float(np.percentile(hd["latency_ms"], 99)), 2)
            p99_plain = round(float(np.percentile(pl["latency_ms"], 99)), 2)
        windows.append({
            "label": label, "steps": [w_lo, w_hi],
            "t0_ms": int(plan.nows[w_lo]), "t1_ms": int(plan.nows[w_hi - 1]),
            "requests": int(g("requests")),
            "hit_rate": round(g("direct_hits") / req, 4),
            "sla_served_rate": round(1.0 - g("fallbacks") / req, 4),
            "deferred": int(g("deferred")),
            "failover_serves": int(g("failover_serves")),
            "mean_failover_stale_ms": round(
                g("failover_stale_sum_ms")
                / max(g("failover_serves"), 1), 1),
            "fallbacks": int(g("fallbacks")),
            "tower_inferences": int(g("tower_inferences")),
            "tower_failures": int(g("tower_failures")),
            "computed_serves": int(g("computed_serves")),
            "retries": int(g("retries")),
            "retry_successes": int(g("retry_successes")),
            "blackout_write_drops": int(g("blackout_write_drops")),
            "write_ring_drops": int(g("write_ring_drops")),
            "touch_ring_drops": int(g("touch_ring_drops")),
            "p99_ms": p99, "p99_unhedged_ms": p99_plain,
            "conservation_ok": int(g("requests")) == int(
                g("direct_hits") + g("computed_serves")
                + g("failover_serves") + g("fallbacks")),
        })

    tot = lambda k: sum(w[k] for w in windows)
    requests = tot("requests")
    sla = 1.0 - tot("fallbacks") / max(requests, 1)
    pre = next((w for w in windows if w["label"] == "quiet"), None)
    tail = [w for w in windows if w["label"] == "recovery"]
    recovered_after = None
    if pre is not None:
        floor_hit = pre["hit_rate"] - recovery_tol_pp / 100.0
        for i, w in enumerate(tail):
            if w["hit_rate"] >= floor_hit:
                recovered_after = i + 1
                break
    lat_h = np.concatenate(lat_hedged) if lat_hedged else np.zeros(1)
    lat_p = np.concatenate(lat_plain) if lat_plain else np.zeros(1)
    n_extra = max(sum(n for _, n in extra_frac), 1)
    out = {k: v for k, v in cf.items() if k != "seed"}
    out.update({
        "requests": requests,
        "sla_served_rate": round(sla, 5),
        "fallbacks": tot("fallbacks"),
        "failover_serves": tot("failover_serves"),
        "retries": tot("retries"),
        "retry_successes": tot("retry_successes"),
        "blackout_write_drops": tot("blackout_write_drops"),
        "write_ring_drops": tot("write_ring_drops"),
        "touch_ring_drops": tot("touch_ring_drops"),
        "conservation_ok": all(w["conservation_ok"] for w in windows),
        "windows": windows,
        "recovery": {
            "pre_fault_hit_rate": None if pre is None else pre["hit_rate"],
            "tol_pp": recovery_tol_pp,
            "tail_windows": len(tail),
            "recovered_after_windows": recovered_after,
            "recovered": recovered_after is not None,
        },
        "hedging": {
            "hedge_after_ms": hedge_after_ms,
            "p99_ms": round(float(np.percentile(lat_h, 99)), 2),
            "p99_unhedged_ms": round(float(np.percentile(lat_p, 99)), 2),
            "extra_compute_frac": round(
                sum(f * n for f, n in extra_frac) / n_extra, 4),
        },
        "wall_s": round(wall, 2),
        "step_ms": cf["step_ms"],
        "host_ms_per_step": wall * 1e3 / max(cf["steps"], 1),
        "device": (torch.cuda.get_device_name(plan.device)
                   if plan.device.type == "cuda" else "cpu"),
    })
    if cf["scenario"] == "rolling":
        outages = [f for f in plan.faults if isinstance(f, chaos_lib.Outage)]
        inj = FailureInjector(
            base_rate=0.0, burst_rate=1.0,
            burst_windows_ms=tuple((f.t0_ms, f.t1_ms) for f in outages),
            seed=seed)
        out["kill_boundaries"] = inj.kill_steps(plan.nows, checkpoint_every)
    log(f"[serve-chaos {cf['arch']}] scenario={cf['scenario']}"
        f" models={cf['n_models']} steps={cf['steps']} requests={requests}"
        f" sla_served={out['sla_served_rate']:.4f}"
        f" retries={out['retries']}"
        f" (succ {out['retry_successes']})"
        f" conservation={'ok' if out['conservation_ok'] else 'VIOLATED'}"
        f" p99={out['hedging']['p99_ms']}ms"
        f" (unhedged {out['hedging']['p99_unhedged_ms']}ms,"
        f" +{out['hedging']['extra_compute_frac']:.1%} compute)"
        f" backend={cf['backend']} device={out['device']} ({wall:.1f}s)")
    for w in windows:
        log(f"  [{w['t0_ms']:>7}-{w['t1_ms']:>7}ms] {w['label']:<32}"
            f" hit={w['hit_rate']:.3f} sla={w['sla_served_rate']:.4f}"
            f" defer={w['deferred']} fo={w['failover_serves']}"
            f" (stale {w['mean_failover_stale_ms']:.0f}ms)"
            f" defaults={w['fallbacks']} retry={w['retries']}"
            f"/{w['retry_successes']}"
            f" drops={w['blackout_write_drops']}"
            f"+{w['write_ring_drops']}+{w['touch_ring_drops']}")
    rec = out["recovery"]
    log(f"  recovery: pre_hit={rec['pre_fault_hit_rate']}"
        f" recovered_after={rec['recovered_after_windows']}"
        f"/{rec['tail_windows']} windows (tol {recovery_tol_pp}pp)")
    return out, state, chunks


def run_serving_chaos(arch: str = "sasrec", scenario: str = "incident",
                      n_models: int = 4, steps: int = 240,
                      users: int = 1000, batch: int = 256,
                      step_ms: int = 250, ttl_min: float = 0.2,
                      failover_ttl_h: float = 2.0, zipf_a: float = 1.2,
                      n_buckets: int = 1 << 10, backend: str = "cuda",
                      chunk_steps: int = 64, fail_rate: float = 0.9,
                      max_retries: int = 2, backoff_ms: int = 500,
                      hedge_after_ms: float = 25.0,
                      checkpoint_every: int = 40, recovery_win: int = 24,
                      recovery_tol_pp: float = 2.0, smoke: bool = True,
                      seed: int = 0, device="cuda", log=print) -> dict:
    """The chaos engine end to end: a preset multi-fault scenario
    (``incident``, ``cascade`` or ``rolling``) compiled into a fault
    schedule on the device and replayed against the multi-model tier in
    chunked ``jit_serve_many`` calls, one counter fetch a chunk.

    A Zipf-skewed stream over ``n_models`` (round-robin fan-out) serves on
    the schedule's SKEWED clock; every model runs admission control
    (ample budget; ``Outage`` windows force its grant to 0) with bounded
    retry/backoff for failed inferences. The ledger reports every fault
    window and the recovery tail: SLA-served rate, failover serves and
    staleness, defaults, retry and drop accounting, and the conservation
    identity (requests == direct + computed + failover + defaults). The
    ``StragglerHedger`` adds per-window p99 inference latency with and
    without hedging (paired draws) and the extra compute it costs.
    Recovery is the first ``recovery_win``-step tail window whose hit
    rate is back within ``recovery_tol_pp`` of the pre-fault window's
    (``recovered_after_windows``); ``rolling`` also reports the
    checkpoint boundaries ``FailureInjector.kill_steps`` lands inside the
    outages. The tower is the SMOKE config by default, as the reference
    launcher serves; ``smoke=False`` serves the published widths."""
    plan = plan_chaos(
        arch=arch, scenario=scenario, n_models=n_models, steps=steps,
        users=users, batch=batch, step_ms=step_ms, ttl_min=ttl_min,
        failover_ttl_h=failover_ttl_h, zipf_a=zipf_a, n_buckets=n_buckets,
        backend=backend, fail_rate=fail_rate, max_retries=max_retries,
        backoff_ms=backoff_ms, recovery_win=recovery_win, smoke=smoke,
        seed=seed, device=device)
    return chaos_timeline(plan, chunk_steps, hedge_after_ms,
                          checkpoint_every, recovery_tol_pp, log=log)[0]


# ---------------------------------------------------------------- regions
@dataclasses.dataclass
class RegionalPlan:
    """What the regional drain serves, built before its clock starts: the
    tower, the regional server and its state, the diurnal stream, the
    drain window (chunk-aligned batch range) and its staged schedule."""
    config: dict                           # the report's settings
    device: torch.device
    params: object
    features_of: object
    server: rg_lib.RegionalServer
    state: rg_lib.RegionalState            # the initial state
    times_ms: np.ndarray
    uids: np.ndarray
    n_batches: int
    drain_lo: int
    drain_hi: int
    drained: torch.Tensor                  # (n_batches, R) bool
    epoch: torch.Tensor                    # (n_batches,) int32
    ebase: torch.Tensor                    # (n_batches,) int32


def plan_regional(arch: str = "sasrec", n_regions: int = 4,
                  minutes: int = 60, users: int = 2000, batch: int = 256,
                  ttl_min: float = 5.0, failover_ttl_h: float = 1.0,
                  locality: float = 0.98, drain: bool = False,
                  drain_start_frac: float = 0.4,
                  drain_len_frac: float = 0.25, n_buckets: int = 1 << 12,
                  backend: str = "cuda", eviction: str = "ttl",
                  chunk_steps: int = 64, smoke: bool = True, seed: int = 0,
                  device="cuda") -> RegionalPlan:
    """Set up the scenario of :func:`run_serving_regional` (same
    arguments) without serving a step."""
    device = resolve_device(device)
    tower_cfg, params, tower_fn, features_of = build_tower(
        arch, backend=backend, device=device, smoke=smoke, seed=seed)
    cache_cfg = CacheConfig(
        model_id=1, model_type="ctr",
        cache_ttl_ms=int(ttl_min * MINUTE_MS),
        failover_ttl_ms=int(failover_ttl_h * HOUR_MS),
        n_buckets=n_buckets, ways=8, value_dim=tower_cfg.user_embed_dim,
        backend=backend, eviction=eviction)
    server = rg_lib.RegionalServer(
        cfgs=(cache_cfg,), n_regions=n_regions, n_users=users,
        tower_fn=tower_fn, miss_budget=batch, locality=locality, seed=seed,
        device=device)
    state = server.init_state(writebuf_capacity=batch * 4)

    times_ms, uids = generate_stream_fast(
        StreamConfig(n_users=users, horizon_s=minutes * 60.0, seed=seed),
        InterArrivalDist(FIG6_KNOTS))
    # one day/night cycle compressed into the horizon, peak mid-run (so
    # the drain window lands on non-trivial load)
    horizon_h = max(minutes / 60.0, 1e-9)
    times_ms, uids = thin_diurnal(times_ms, uids, seed=seed + 1,
                                  period_h=horizon_h,
                                  peak_h=horizon_h / 2.0)
    n_batches = len(uids) // batch
    align = lambda b: (b // chunk_steps) * chunk_steps
    drain_lo = align(int(n_batches * drain_start_frac))
    drain_hi = align(int(n_batches * (drain_start_frac + drain_len_frac)))
    if drain:
        # at least one pre chunk and one in-window chunk on short runs
        # (the window stays chunk-aligned: a chunk is in one phase)
        drain_lo = max(drain_lo, chunk_steps)
        drain_hi = max(drain_hi, drain_lo + chunk_steps)
    drain_region = n_regions - 1
    events = []
    if drain and n_regions > 1 and drain_lo < n_batches:
        events.append((drain_lo, "drain", drain_region))
        if drain_hi < n_batches:
            events.append((drain_hi, "undrain", drain_region))
    drained, epoch = rg_lib.stage_drain_schedule(
        max(n_batches, 1), n_regions, events, device=device)
    ebase = rg_lib.event_bases(0, max(n_batches, 1), batch, device=device)
    config = {"arch": arch, "backend": backend, "n_regions": n_regions,
              "users": users, "batch": batch, "locality": locality,
              "drain": bool(drain), "drain_region": drain_region,
              "chunk_steps": chunk_steps, "seed": seed}
    return RegionalPlan(config=config, device=device, params=params,
                        features_of=features_of, server=server, state=state,
                        times_ms=times_ms, uids=uids, n_batches=n_batches,
                        drain_lo=drain_lo, drain_hi=drain_hi,
                        drained=drained, epoch=epoch, ebase=ebase)


def regional_chunks(plan: RegionalPlan):
    """The plan's serve calls in order: (lo batch, phase, inputs of
    ``serve_many`` after the state) staged on the device; inside the
    drain window a flash crowd of uniform re-accesses over a hot user
    pool replaces half the slots."""
    cf = plan.config
    batch = cf["batch"]
    crowd_rng = np.random.default_rng(cf["seed"] + 2)
    hot = crowd_rng.integers(0, cf["users"], size=max(cf["users"] // 50, 1))
    for lo, n_steps in _chunks(plan.n_batches, cf["chunk_steps"]):
        ids = plan.uids[lo * batch:(lo + n_steps) * batch].reshape(
            n_steps, batch).astype(np.int64)
        if plan.drain_lo <= lo < plan.drain_hi:
            mix = crowd_rng.random(ids.shape) < 0.5
            ids = np.where(
                mix, hot[crowd_rng.integers(0, hot.size, ids.shape)], ids)
        keys, feats, nows, _ = _stage_chunk(
            plan.uids, plan.times_ms, plan.features_of, lo * batch, n_steps,
            batch, plan.device, override_ids=ids)
        phase = ("pre" if lo < plan.drain_lo
                 else "drain" if lo < plan.drain_hi else "post")
        sl = slice(lo, lo + n_steps)
        yield lo, phase, (
            torch.as_tensor(ids.astype(np.int32), device=plan.device),
            torch.zeros((n_steps, batch), dtype=torch.int32,
                        device=plan.device),
            keys, feats, nows, plan.drained[sl], plan.epoch[sl],
            plan.ebase[sl])


def regional_timeline(plan: RegionalPlan, jit: bool = True, log=print):
    """Serve ``plan`` end to end through ``jit_serve_many`` (``jit=False``:
    eager ``serve_many``). Returns the report of
    :func:`run_serving_regional`, the final state and every chunk's
    fetched counters."""
    cf = plan.config
    R = cf["n_regions"]
    run = plan.server.jit_serve_many if jit else plan.server.serve_many
    state = plan.state
    counters = ServingCounters()
    curve, chunks = [], []
    region_load = np.zeros(R, np.int64)
    drained_load = rehomed = excursions = 0
    t0 = time.perf_counter()
    for lo, phase, inputs in regional_chunks(plan):
        state, acc, _ = run(plan.params, state, *inputs, flush_every=1,
                            collect=False)
        s = srv_lib.fetch_counters(acc)          # one transfer per chunk
        chunks.append(s)
        c = ServingCounters.from_stats(s)
        counters.merge(c)
        pr = np.asarray(s["per_model_requests"], np.int64).reshape(
            R, -1).sum(axis=1)
        region_load += pr
        if cf["drain"] and phase == "drain":
            drained_load += int(pr[cf["drain_region"]])
        rehomed += s["rehomed"]
        excursions += s["excursions"]
        curve.append({"batch_lo": lo, "phase": phase,
                      "hit_rate": round(c.hit_rate, 4)})
    if plan.device.type == "cuda":
        torch.cuda.synchronize(plan.device)
    wall = time.perf_counter() - t0

    def phase_mean(p):
        xs = [pt["hit_rate"] for pt in curve if pt["phase"] == p]
        return round(float(np.mean(xs)), 4) if xs else None

    d = counters.as_dict()
    d["wall_s"] = round(wall, 2)
    d["batches"] = plan.n_batches
    d["step_ms"] = wall * 1e3 / max(plan.n_batches, 1)
    d["req_per_s"] = round(counters.requests / max(wall, 1e-9), 1)
    d["device"] = (torch.cuda.get_device_name(plan.device)
                   if plan.device.type == "cuda" else "cpu")
    d["n_regions"] = R
    d["locality"] = cf["locality"]
    d["drain"] = cf["drain"]
    d["drain_region"] = cf["drain_region"] if cf["drain"] else None
    d["drain_batches"] = [plan.drain_lo, plan.drain_hi]
    d["rehomed"] = rehomed
    d["excursions"] = excursions
    d["region_load"] = region_load.tolist()
    d["drained_load_during_drain"] = drained_load
    d["hit_rate_pre"] = phase_mean("pre")
    d["hit_rate_drain"] = phase_mean("drain")
    d["hit_rate_post"] = phase_mean("post")
    d["dip_pp"] = (round((d["hit_rate_pre"] - d["hit_rate_drain"]) * 100, 2)
                   if d["hit_rate_pre"] is not None
                   and d["hit_rate_drain"] is not None else None)
    d["hit_rate_curve"] = [pt["hit_rate"] for pt in curve]
    log(f"[serve-regional {cf['arch']}] regions={R}"
        f" locality={cf['locality']:g}"
        f" drain={'batches[%d:%d]' % (plan.drain_lo, plan.drain_hi) if cf['drain'] else 'off'}"
        f" requests={d['requests']} hit_rate={d['hit_rate']:.3f}"
        f" pre/drain/post={d['hit_rate_pre']}/{d['hit_rate_drain']}"
        f"/{d['hit_rate_post']} dip_pp={d['dip_pp']}"
        f" rehomed={rehomed} excursions={excursions}"
        f" drained_load={drained_load} backend={cf['backend']}"
        f" device={d['device']}"
        f" ({wall:.1f}s, {d['req_per_s']:.0f} req/s)")
    return d, state, chunks


def run_serving_regional(arch: str = "sasrec", n_regions: int = 4,
                         minutes: int = 60, users: int = 2000,
                         batch: int = 256, ttl_min: float = 5.0,
                         failover_ttl_h: float = 1.0,
                         locality: float = 0.98, drain: bool = False,
                         drain_start_frac: float = 0.4,
                         drain_len_frac: float = 0.25,
                         n_buckets: int = 1 << 12, backend: str = "cuda",
                         eviction: str = "ttl", chunk_steps: int = 64,
                         smoke: bool = True, seed: int = 0, device="cuda",
                         log=print) -> dict:
    """The regional drain scenario on the device (paper §3.6–3.7,
    Fig. 10): R regions stacked over the cache tier
    (``core/regional.py``), sticky routing through the home table on the
    device, the drain schedule staged beside the stream, chunked
    ``jit_serve_many`` calls with one counter fetch a chunk.

    The renewal stream is thinned to a day/night envelope compressed into
    the horizon (``thin_diurnal``); at ``drain_start_frac`` (a batch
    index aligned to the chunks) region R-1 drains and a flash crowd of
    uniform re-accesses over a hot user pool mixes into the window; after
    ``drain_len_frac`` the region undrains. Its users re-home lazily and
    permanently. The report carries the per-chunk hit-rate curve,
    pre/drain/post means and the dip, per-region load, and the drained
    region's in-window load (0: routing never targets a drained region).
    The tower is the SMOKE config by default; ``smoke=False`` serves the
    published widths."""
    plan = plan_regional(
        arch=arch, n_regions=n_regions, minutes=minutes, users=users,
        batch=batch, ttl_min=ttl_min, failover_ttl_h=failover_ttl_h,
        locality=locality, drain=drain, drain_start_frac=drain_start_frac,
        drain_len_frac=drain_len_frac, n_buckets=n_buckets,
        backend=backend, eviction=eviction, chunk_steps=chunk_steps,
        smoke=smoke, seed=seed, device=device)
    return regional_timeline(plan, log=log)[0]


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
    ap.add_argument("--restart", action="store_true",
                    help="kill/restore fault-injection harness: snapshot "
                         "at checkpoint boundaries, kill mid-stream, "
                         "restore same/grown/shrunk geometries and "
                         "compare hit-rate recovery vs a cold restart")
    ap.add_argument("--checkpoint-every", type=int, default=40,
                    help="serve steps between checkpoint boundaries: "
                         "--restart snapshots at each; --chaos rolling "
                         "reports them as its kill points")
    ap.add_argument("--chaos", default=None,
                    choices=list(chaos_lib.PRESETS),
                    help="chaos engine: compile the named multi-fault "
                         "scenario into a schedule on the device and replay "
                         "it against the multi-model tier with "
                         "retry/backoff, reporting the per-window "
                         "degradation ledger")
    ap.add_argument("--chaos-models", type=int, default=4,
                    help="--chaos: registry size for the fan-out")
    ap.add_argument("--chaos-steps", type=int, default=240,
                    help="--chaos: serve steps in the scenario horizon")
    ap.add_argument("--chaos-retries", type=int, default=2,
                    help="--chaos: max retry attempts per failed inference")
    ap.add_argument("--hedge-after-ms", type=float, default=25.0,
                    help="--chaos: straggler hedge deadline for the "
                         "p99-with/without-hedging report")
    ap.add_argument("--regions", type=int, default=None,
                    help="regional serving on the device: stack N regions "
                         "as a leading axis over the cache tier, sticky "
                         "routing through a home table on the device")
    ap.add_argument("--drain", action="store_true",
                    help="--regions: drain one region mid-run (the Fig. 10 "
                         "drain test): its users re-home lazily while a "
                         "flash crowd coincides with the window")
    ap.add_argument("--locality", type=float, default=0.98,
                    help="--regions: probability a request stays in its "
                         "home region (paper: 'good locality')")
    ap.add_argument("--multi-buckets", type=int, default=1 << 12,
                    help="per-model direct-cache buckets in --multi mode")
    ap.add_argument("--backend", default="cuda", choices=["torch", "cuda"],
                    help="cuda: the hand-written kernels; torch: plain ops")
    ap.add_argument("--eviction", default="ttl", choices=["ttl", "lru"],
                    help="direct/failover victim order (paper §3.3); lru "
                         "enables access-recency touches (incompatible "
                         "with --multi: the registry sets it per model)")
    ap.add_argument("--shards", type=int, default=1,
                    help="bucket-shard the cache tier over N shards (the "
                         "first N cards; on one card every shard shares "
                         "it)")
    args = ap.parse_args(argv)
    if args.shards > 1:
        if args.restart or args.overload or args.no_cache:
            ap.error("--shards drives the plain/--multi serving modes")
    if args.drain and args.regions is None:
        ap.error("--drain requires --regions")
    if args.chaos is not None:
        if (args.restart or args.overload or args.multi
                or args.regions is not None):
            ap.error("--chaos is its own scenario; drop "
                     "--restart/--overload/--multi/--regions")
        if args.no_cache or args.coalesce:
            ap.error("--chaos is a cache-tier scenario; drop "
                     "--no-cache/--coalesce")
        if args.shards > 1:
            ap.error("--chaos runs on one device; drop --shards")
        if args.eviction != "ttl":
            ap.error("--chaos fixes eviction=ttl (the scenario isolates "
                     "fault handling, not victim order)")
        return run_serving_chaos(
            arch=args.arch, scenario=args.chaos,
            n_models=args.chaos_models, steps=args.chaos_steps,
            users=args.users, batch=args.batch,
            ttl_min=0.2 if args.ttl_min is None else args.ttl_min,
            backend=args.backend, chunk_steps=args.chunk_steps,
            max_retries=args.chaos_retries,
            hedge_after_ms=args.hedge_after_ms,
            checkpoint_every=args.checkpoint_every)
    if args.regions is not None:
        if args.regions < 1:
            ap.error("--regions must be >= 1")
        if args.restart or args.overload or args.multi:
            ap.error("--regions drives the regional server; drop "
                     "--restart/--overload/--multi")
        if args.no_cache or args.coalesce:
            ap.error("--regions is a cache-tier scenario; drop "
                     "--no-cache/--coalesce")
        if args.shards > 1:
            ap.error("--regions stacks regions on one device; drop --shards")
        return run_serving_regional(
            arch=args.arch, n_regions=args.regions, minutes=args.minutes,
            users=args.users, batch=args.batch,
            ttl_min=5.0 if args.ttl_min is None else args.ttl_min,
            locality=args.locality, drain=args.drain,
            backend=args.backend, eviction=args.eviction,
            chunk_steps=args.chunk_steps)
    if args.restart:
        if args.multi or args.overload:
            ap.error("--restart drives the single-model server; drop "
                     "--multi/--overload")
        if args.no_cache or args.coalesce:
            ap.error("--restart is a cache-durability scenario; drop "
                     "--no-cache/--coalesce")
        return run_serving_restart(
            arch=args.arch, users=args.users, batch=args.batch,
            ttl_min=5.0 if args.ttl_min is None else args.ttl_min,
            checkpoint_every=args.checkpoint_every, backend=args.backend,
            chunk_steps=args.chunk_steps)
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
            coalesce=args.coalesce, chunk_steps=args.chunk_steps,
            n_shards=args.shards)
    if args.no_cache and args.coalesce:
        ap.error("--coalesce dedupes cache misses; drop --no-cache")
    return run_serving(arch=args.arch, minutes=args.minutes,
                       users=args.users,
                       ttl_min=5.0 if args.ttl_min is None else args.ttl_min,
                       failure_rate=args.failure_rate, batch=args.batch,
                       use_cache=not args.no_cache, backend=args.backend,
                       eviction=args.eviction, coalesce=args.coalesce,
                       chunk_steps=args.chunk_steps, n_shards=args.shards)


if __name__ == "__main__":
    main()
