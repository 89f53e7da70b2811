"""Regional consistency + drain-test simulation (paper §3.6–3.7, Fig. 10).

The production deployment spans 13 main regions; requests are routed to the
region that served the user previously ("good locality"), each region holds
its own cache, and a regional rate limiter sheds QPS spikes. The paper's
reliability evidence is a 6-hour drain test: one region is taken down, its
traffic redistributes, and the global cache hit rate stays stable.

A numpy copy of ``repro/core/regions.py`` (the port imports nothing of the
JAX package; a test holds the two to the same outputs): a deterministic
discrete-time simulator that drives one ``CachedEmbeddingServer`` per
region with a shared request stream, and the host router whose "hash"
sampler the device router (``core/regional.py``) replays bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.ratelimit import RegionalRateLimiter


class AllRegionsDrainedError(RuntimeError):
    """Every region is drained — there is nowhere to route a request.

    Raised by :meth:`RegionRouter.route` (and the device-path drain-
    schedule staging, core/regional.py) instead of crashing inside
    ``rng.choice`` on an empty live list: an operator draining the LAST
    region is a config error that must be loud, not an index error."""


# ------------------------------------------------- deterministic sampling
# The "hash" sampler below replaces the router's RNG draws with pure
# functions of (seed, uid, counter) so the on-device router
# (core/regional.py) can replay the EXACT same decisions in torch: both
# sides compute the same xxhash32-style avalanche (core/hashing.hash_u32
# with hi=counter, lo=uid) in uint32 arithmetic. This host twin uses
# plain python ints masked to 32 bits — bit-identical by construction.
_P2, _P3, _P4, _P5 = 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1
HOME_SALT = 0x9E3779B9     # re-home draw (keyed by drain epoch)
EXC_SALT = 0x7F4A7C15      # excursion coin (keyed by event index)
TGT_SALT = 0x94D049BB      # excursion target (keyed by event index)


def _u32(x: int) -> int:
    return x & 0xFFFFFFFF


def _rotl32_host(x: int, r: int) -> int:
    return _u32((x << r) | (x >> (32 - r)))


def hash_u32_host(lo: int, hi: int, seed: int) -> int:
    """Host twin of ``hashing.hash_u32`` on a (hi, lo) word pair."""
    h = _u32(seed + _P5 + 8)
    h = _u32(h + _u32(lo) * _P3)
    h = _u32(_rotl32_host(h, 17) * _P4)
    h = _u32(h + _u32(hi) * _P3)
    h = _u32(_rotl32_host(h, 17) * _P4)
    h ^= h >> 15
    h = _u32(h * _P2)
    h ^= h >> 13
    h = _u32(h * _P3)
    h ^= h >> 16
    return h


def excursion_threshold(locality: float) -> int:
    """uint32 cutoff shared by both routers: a request excurses iff its
    excursion hash is >= this, so P(excursion) = 1 - locality."""
    return _u32(int(locality * 4294967296.0))


@dataclasses.dataclass
class RegionRouter:
    """Sticky routing: a user keeps hitting their home region until a drain
    (or random re-shuffle with prob. 1-locality) moves them.

    ``sampler`` picks how the routing randomness is drawn: ``"rng"`` (the
    default, a seeded numpy Generator) or ``"hash"`` — deterministic
    counter-keyed hashing (re-home keyed by the drain EPOCH, a counter
    bumped on every drain/undrain; excursions keyed by the global EVENT
    index) that the device router in core/regional.py replays bit-exactly.
    """

    n_regions: int
    locality: float = 0.98           # prob. request lands in home region
    seed: int = 0
    sampler: str = "rng"             # "rng" | "hash"

    def __post_init__(self) -> None:
        if self.sampler not in ("rng", "hash"):
            raise ValueError(f"unknown sampler {self.sampler!r}")
        self._rng = np.random.default_rng(self.seed)
        self._home: Dict[int, int] = {}
        self.drained: set = set()
        self._epoch = 0              # bumped on every drain/undrain
        self._event = 0              # bumped on every route() call

    def _live(self) -> List[int]:
        return [r for r in range(self.n_regions) if r not in self.drained]

    def _fresh_region(self, exclude: Optional[set] = None) -> int:
        if len(self.drained) >= self.n_regions:
            raise AllRegionsDrainedError(
                f"all {self.n_regions} regions are drained")
        live = [r for r in self._live() if r not in (exclude or set())]
        return int(self._rng.choice(live))

    def route(self, user_id: int) -> int:
        event = self._event
        self._event += 1
        live = self._live()
        if not live:
            raise AllRegionsDrainedError(
                f"all {self.n_regions} regions are drained")
        home = self._home.get(user_id)
        if home is None or home in self.drained:
            if self.sampler == "hash":
                h = hash_u32_host(user_id, self._epoch,
                                  _u32(self.seed + HOME_SALT))
                home = live[h % len(live)]
            else:
                home = self._fresh_region()
            self._home[user_id] = home
        # cross-region excursion (does NOT move home — the paper's "most
        # of the time" qualifier). The target EXCLUDES the home region:
        # an "excursion" to the region already serving you is a no-op
        # that would under-count real cross-region traffic. With no other
        # live region the request stays home.
        if self.locality < 1.0 and len(live) > 1:
            if self.sampler == "hash":
                u = hash_u32_host(user_id, event,
                                  _u32(self.seed + EXC_SALT))
                if u >= excursion_threshold(self.locality):
                    j = hash_u32_host(user_id, event,
                                      _u32(self.seed + TGT_SALT)) \
                        % (len(live) - 1)
                    hrank = live.index(home)
                    return live[j + (1 if j >= hrank else 0)]
            elif self._rng.random() > self.locality:
                return self._fresh_region(exclude={home})
        return home

    def drain(self, region: int) -> None:
        """Take a region down; its users re-home lazily on next request."""
        self.drained.add(region)
        self._epoch += 1

    def undrain(self, region: int) -> None:
        self.drained.discard(region)
        self._epoch += 1


@dataclasses.dataclass
class DrainTestHarness:
    """Runs a request stream through per-region servers and reports the
    hit-rate timeline (the Fig. 10 reproduction)."""

    servers: list                    # one CachedEmbeddingServer per region
    states: list                     # matching ServerState list
    params: object
    router: RegionRouter
    limiter: RegionalRateLimiter
    feature_fn: object               # (user_ids ndarray, now_ms) -> features
    key_fn: object                   # (user_ids ndarray) -> Key64
    batch: int = 256
    flush_every_ms: int = 1_000

    def run(self, events: np.ndarray, times_ms: np.ndarray,
            drain_region: Optional[int] = None,
            drain_window_ms: Optional[tuple] = None,
            bucket_ms: int = 600_000) -> Dict[str, List[float]]:
        """events: (N,) user ids ordered by times_ms. Returns per-time-bucket
        hit rate + per-region load trace."""
        n_regions = len(self.servers)
        # accumulate per-bucket counters
        timeline: Dict[int, List[int]] = {}
        region_load: Dict[int, np.ndarray] = {}
        pending: Dict[int, List[int]] = {r: [] for r in range(n_regions)}
        pending_t: Dict[int, List[int]] = {r: [] for r in range(n_regions)}
        last_flush = {r: 0 for r in range(n_regions)}
        drained_now = False

        def bucket_of(t: int) -> int:
            return int(t // bucket_ms)

        def ensure(b: int) -> None:
            if b not in timeline:
                timeline[b] = [0, 0]                  # [hits, requests]
                region_load[b] = np.zeros(n_regions, np.int64)

        def serve_region(r: int) -> None:
            ids = pending[r][:self.batch]
            ts = pending_t[r][:self.batch]
            del pending[r][:len(ids)], pending_t[r][:len(ids)]
            if not ids:
                return
            now = int(ts[-1])
            ids_np = np.asarray(ids, np.int64)
            pad = self.batch - len(ids)
            if pad:
                ids_np = np.concatenate([ids_np, np.full(pad, -1, np.int64)])
            keys = self.key_fn(ids_np)
            feats = self.feature_fn(ids_np, now)
            res = self.servers[r].jit_serve_step(
                self.params, self.states[r], keys, feats, now)
            self.states[r] = res.state
            src = res.source[:len(ids)].cpu().numpy()
            b = bucket_of(now)
            ensure(b)
            timeline[b][0] += int((src == 0).sum())
            timeline[b][1] += len(ids)
            region_load[b][r] += len(ids)
            if now - last_flush[r] >= self.flush_every_ms:
                self.states[r] = self.servers[r].jit_flush(self.states[r], now)
                last_flush[r] = now

        for uid, t in zip(events, times_ms):
            t = int(t)
            if drain_window_ms is not None and drain_region is not None:
                lo, hi = drain_window_ms
                if lo <= t < hi and not drained_now:
                    self.router.drain(drain_region)
                    drained_now = True
                elif t >= hi and drained_now:
                    self.router.undrain(drain_region)
                    drained_now = False
            r = self.router.route(int(uid))
            if self.limiter.admit(r, t, 1) == 0:
                b = bucket_of(t)
                ensure(b)
                timeline[b][1] += 1          # shed request counts as non-hit
                continue
            pending[r].append(int(uid))
            pending_t[r].append(t)
            if len(pending[r]) >= self.batch:
                serve_region(r)
        for r in range(n_regions):
            while pending[r]:
                serve_region(r)

        buckets = sorted(timeline)
        return {
            "bucket_ms": [b * bucket_ms for b in buckets],
            "hit_rate": [timeline[b][0] / max(timeline[b][1], 1)
                         for b in buckets],
            "region_load": [region_load[b].tolist() for b in buckets],
        }
