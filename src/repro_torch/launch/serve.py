"""Serving launcher: request stream -> ERCache -> tower, end to end, on the
card.

Twin of the basic and ``--no-cache`` modes of ``repro/launch/serve.py``:
the Fig. 2-calibrated access-pattern generator drives one
``CachedEmbeddingServer`` fronting a SASRec user tower; the stream is
staged on the device in (S, B) chunks and each chunk is ONE
``serve_many`` call whose counters come back with ONE host transfer.
``--coalesce`` dedupes each batch's missed users so the tower runs once
per distinct user. The ``--multi``, ``--overload``, ``--restart``,
``--shards``, ``--regions`` and ``--chaos`` modes join with their slices.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch sasrec \\
        --minutes 120 --users 5000 --ttl-min 5 [--no-cache] [--coalesce]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import server as srv_lib
from repro_torch.core.cache import resolve_device
from repro_torch.core.config import CacheConfig, HOUR_MS, MINUTE_MS
from repro_torch.core.hashing import Key64
from repro_torch.core.metrics import ServingCounters, power_savings
from repro_torch.data.access_patterns import (FIG6_KNOTS, InterArrivalDist,
                                              StreamConfig,
                                              generate_stream_fast)
from repro_torch.ft.failure import FailureInjector
from repro_torch.models import recsys as rec_lib


def build_tower(arch: str, backend: str = "cuda", device="cuda",
                smoke: bool = True, seed: int = 0):
    """A tower (the SMOKE config by default, as the reference launcher
    serves; ``smoke=False`` for the published widths) with random weights
    from ``seed``, plus a feature synthesizer for serving. The tower's
    item gather runs ``backend``'s embedding bag ("cuda": the kernel)."""
    cfg = get_config(arch, smoke=smoke)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = rec_lib.init_params(gen, cfg, device)

    def features_of(user_ids: np.ndarray, now_ms: int):
        """Synthetic behaviour sequences (numpy, staged by the caller)."""
        rng = np.random.default_rng(now_ms % (2 ** 31))
        seq = rng.integers(0, cfg.vocab, (user_ids.size, cfg.seq_len))
        return {"seq": seq.astype(np.int32)}

    def tower_fn(p, feats):
        return rec_lib.tower_step(p, feats, cfg, impl=backend)

    return cfg, params, tower_fn, features_of


def _stage_chunk(uids, times_ms, features_of, lo: int, n_steps: int,
                 batch: int, device, injector=None):
    """Stage ``n_steps`` consecutive serve batches as (S, B) tensors on the
    device, one host-to-device copy per array. The failure mask is staged
    only when an injector rides along (None otherwise)."""
    ids = np.stack([uids[lo + s * batch: lo + (s + 1) * batch]
                    for s in range(n_steps)])
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
            state, acc, _ = server.serve_many(
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="sasrec")
    ap.add_argument("--minutes", type=int, default=60)
    ap.add_argument("--users", type=int, default=2000)
    ap.add_argument("--ttl-min", type=float, default=5.0,
                    help="direct-cache TTL in minutes")
    ap.add_argument("--failure-rate", type=float, default=0.0)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--chunk-steps", type=int, default=64,
                    help="serve steps per serve_many call")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--coalesce", action="store_true",
                    help="in-batch inference coalescing: one tower run "
                         "per distinct missed user per batch "
                         "(incompatible with --no-cache)")
    ap.add_argument("--backend", default="cuda", choices=["torch", "cuda"],
                    help="cuda: the hand-written kernels; torch: plain ops")
    ap.add_argument("--eviction", default="ttl", choices=["ttl", "lru"],
                    help="direct/failover victim order (paper §3.3); lru "
                         "enables access-recency touches")
    args = ap.parse_args(argv)
    if args.no_cache and args.coalesce:
        ap.error("--coalesce dedupes cache misses; drop --no-cache")
    return run_serving(arch=args.arch, minutes=args.minutes,
                       users=args.users, ttl_min=args.ttl_min,
                       failure_rate=args.failure_rate, batch=args.batch,
                       use_cache=not args.no_cache, backend=args.backend,
                       eviction=args.eviction, coalesce=args.coalesce,
                       chunk_steps=args.chunk_steps)


if __name__ == "__main__":
    main()
