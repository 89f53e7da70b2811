"""User access-pattern model (paper §2.3, Fig. 2) + request-stream generator.

The paper's observation — the load-bearing empirical fact behind ERCache:

    52% of consecutive user-tower inference intervals are ≤ 1 minute,
    76% ≤ 10 minutes, 88% ≤ 1 hour.

We model the inter-arrival distribution as a monotone piecewise log-linear
CDF anchored exactly on those three quantiles, with free knots (sub-minute
head, multi-hour tail) calibrated so that *simulated TTL hit rates* land on
the paper's Fig. 6 (51.6% @ 1 min, 68.7% @ 5 min, 89.7% @ 1 h, 97.1% @ 6 h,
97.9% @ 12 h). Sampling is inverse-transform in log-time, deterministic under
a seeded numpy Generator.

A request stream is the superposition of per-user renewal processes whose
intervals are iid from this distribution, so the stream's consecutive-access
CDF matches Fig. 2 by construction.

A numpy copy of ``repro/data/access_patterns.py`` (the port imports nothing
of the JAX package); a test holds the two to the same outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

MINUTE_S = 60.0
HOUR_S = 3600.0

# (t seconds, CDF). The 1 min / 10 min / 1 h entries are the paper's stated
# quantiles; sub-minute knots model same-pageview inference bursts (several
# ad candidates → several user-tower inferences within seconds), which is
# what makes hit rate track the CDF so closely at short TTLs.
FIG2_KNOTS = (
    (0.2, 0.0),
    (1.0, 0.30),
    (5.0, 0.44),
    (20.0, 0.50),
    (60.0, 0.52),        # paper: 52% ≤ 1 min
    (300.0, 0.70),
    (600.0, 0.76),       # paper: 76% ≤ 10 min
    (3600.0, 0.88),      # paper: 88% ≤ 1 h
    (6 * HOUR_S, 0.975),
    (12 * HOUR_S, 0.985),
    (48 * HOUR_S, 0.998),
    (14 * 24 * HOUR_S, 1.0),
)

# Hit-rate-calibrated preset: in a renewal model the TTL hit rate is strictly
# ≤ CDF(TTL), yet the paper reports hit 89.7% @ 1 h against CDF 88% @ 1 h —
# Figs. 2 and 6 were evidently measured on different traffic/models. This
# preset reproduces Fig. 6 hit rates (51.6/68.7/89.7/97.1/97.9 % at
# 1 min/5 min/1 h/6 h/12 h) to within 0.5 pp under steady-state simulation
# (96 h horizon, 36 h warm-up; see benchmarks/bench_hit_rate.py).
FIG6_KNOTS = (
    (0.2, 0.0),
    (1.0, 0.29),
    (5.0, 0.44),
    (20.0, 0.50),
    (60.0, 0.52),
    (300.0, 0.73),
    (600.0, 0.795),
    (3600.0, 0.956),
    (6 * HOUR_S, 0.992),
    (12 * HOUR_S, 0.9965),
    (48 * HOUR_S, 0.9995),
    (14 * 24 * HOUR_S, 1.0),
)


@dataclasses.dataclass(frozen=True)
class InterArrivalDist:
    """Monotone piecewise log-linear CDF over inter-arrival seconds."""

    knots: Tuple[Tuple[float, float], ...] = FIG2_KNOTS

    def __post_init__(self):
        ts = [t for t, _ in self.knots]
        fs = [f for _, f in self.knots]
        assert ts == sorted(ts) and fs == sorted(fs)
        assert abs(fs[-1] - 1.0) < 1e-9

    def _arrays(self):
        t = np.array([k[0] for k in self.knots])
        f = np.array([k[1] for k in self.knots])
        return np.log(t), f

    def cdf(self, t_s: np.ndarray) -> np.ndarray:
        logt, f = self._arrays()
        x = np.log(np.clip(np.asarray(t_s, np.float64), 1e-9, None))
        return np.clip(np.interp(x, logt, f, left=0.0), 0.0, 1.0)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Inverse-transform sample of n intervals (seconds)."""
        logt, f = self._arrays()
        u = rng.uniform(f[0], 1.0, size=n)   # below first knot: clamp to head
        x = np.interp(u, f, logt)
        return np.exp(x)


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Per-(model, stage) traffic profile.

    ``thinning`` models funnel stages: a second-stage model only sees the
    fraction of requests that survive earlier stages (the paper notes
    per-model "distinct access patterns"). Thinning a renewal stream
    lengthens observed intervals, lowering hit rate at a given TTL.
    """

    n_users: int = 20_000
    horizon_s: float = 24 * HOUR_S
    thinning: float = 1.0          # keep-probability per request
    seed: int = 0


def generate_stream(cfg: StreamConfig,
                    dist: Optional[InterArrivalDist] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Superpose per-user renewal processes.

    Returns (times_ms int64 sorted ascending, user_ids int64). Users start at
    a uniform random phase so the merged stream is stationary over the
    horizon.
    """
    dist = dist or InterArrivalDist()
    rng = np.random.default_rng(cfg.seed)
    times, users = [], []
    # Draw intervals in vectorized chunks per user cohort for speed.
    for u in range(cfg.n_users):
        t = rng.uniform(0.0, cfg.horizon_s)
        # Expected events/user modest; draw geometrically-growing chunks.
        user_times = []
        while t < cfg.horizon_s and len(user_times) < 10_000:
            user_times.append(t)
            t += float(dist.sample(rng, 1)[0])
        if cfg.thinning < 1.0 and user_times:
            keep = rng.uniform(size=len(user_times)) < cfg.thinning
            user_times = [x for x, k in zip(user_times, keep) if k]
        times.extend(user_times)
        users.extend([u] * len(user_times))
    times = np.asarray(times, np.float64)
    users = np.asarray(users, np.int64)
    order = np.argsort(times, kind="stable")
    return (times[order] * 1e3).astype(np.int64), users[order]


def generate_stream_fast(cfg: StreamConfig,
                         dist: Optional[InterArrivalDist] = None,
                         max_events_per_user: int = 512
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized variant: caps events/user, orders of magnitude faster for
    large cohorts. Bias is negligible for horizons ≤ 48 h (P[>512 events] ≈ 0
    under the Fig. 2 mixture)."""
    dist = dist or InterArrivalDist()
    rng = np.random.default_rng(cfg.seed)
    start = rng.uniform(0.0, cfg.horizon_s, size=(cfg.n_users, 1))
    gaps = dist.sample(rng, cfg.n_users * max_events_per_user)
    gaps = gaps.reshape(cfg.n_users, max_events_per_user)
    t = start + np.concatenate(
        [np.zeros((cfg.n_users, 1)), np.cumsum(gaps, axis=1)[:, :-1]], axis=1)
    uid = np.broadcast_to(np.arange(cfg.n_users, dtype=np.int64)[:, None],
                          t.shape)
    live = t < cfg.horizon_s
    if cfg.thinning < 1.0:
        live &= rng.uniform(size=t.shape) < cfg.thinning
    t, uid = t[live], uid[live]
    order = np.argsort(t, kind="stable")
    return (t[order] * 1e3).astype(np.int64), uid[order]


def consecutive_interval_cdf(times_ms: np.ndarray, users: np.ndarray,
                             probe_s: np.ndarray) -> np.ndarray:
    """Empirical Fig. 2: CDF of per-user consecutive intervals at probe_s."""
    order = np.lexsort((times_ms, users))
    t, u = times_ms[order], users[order]
    same = u[1:] == u[:-1]
    gaps_s = (t[1:] - t[:-1])[same] / 1e3
    if gaps_s.size == 0:
        return np.zeros_like(np.asarray(probe_s, np.float64))
    gaps_s = np.sort(gaps_s)
    return np.searchsorted(gaps_s, probe_s, side="right") / gaps_s.size


def simulate_hit_rate(times_ms: np.ndarray, users: np.ndarray,
                      ttl_ms: int, measure_from_ms: int = 0) -> float:
    """Exact TTL-cache hit rate on a stream (infinite capacity, no failures):
    an access hits iff the last *write* for that user is ≤ TTL old; a miss
    writes (no read-refresh — paper §3.2). ``measure_from_ms`` discards the
    cold-start warm-up from the measurement (steady-state, like production).
    Pure python/numpy — used to calibrate the generator against Fig. 6."""
    last_write = {}
    hits = total = 0
    for t, u in zip(times_ms.tolist(), users.tolist()):
        w = last_write.get(u)
        h = w is not None and t - w <= ttl_ms
        if t >= measure_from_ms:
            total += 1
            hits += h
        if not h:
            last_write[u] = t
    return hits / max(total, 1)


def diurnal_weight(times_ms: np.ndarray, period_h: float = 24.0,
                   trough: float = 0.3, peak_h: float = 20.0) -> np.ndarray:
    """Relative traffic intensity in [trough, 1] at each timestamp — a
    cosine day/night envelope peaking at ``peak_h`` hours into the day
    (ads traffic peaks in the evening). Drives the drain scenario's
    diurnal mix: the renewal-process generator is stationary, so the
    time-of-day shape is applied by thinning (below)."""
    t_h = np.asarray(times_ms, np.float64) / 3_600_000.0
    phase = 2.0 * np.pi * (t_h - peak_h) / period_h
    return trough + (1.0 - trough) * 0.5 * (1.0 + np.cos(phase))


def thin_diurnal(times_ms: np.ndarray, users: np.ndarray, seed: int = 0,
                 period_h: float = 24.0, trough: float = 0.3,
                 peak_h: float = 20.0) -> Tuple[np.ndarray, np.ndarray]:
    """Thin a stationary stream to the diurnal envelope: each event is
    kept with probability ``diurnal_weight`` at its timestamp (independent
    thinning — the standard way to modulate a renewal process without
    touching per-user interval structure). Returns (times_ms, users)."""
    w = diurnal_weight(times_ms, period_h, trough, peak_h)
    keep = np.random.default_rng(seed).random(w.shape[0]) < w
    return times_ms[keep], users[keep]
