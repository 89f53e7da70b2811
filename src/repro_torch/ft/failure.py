"""Failure injection + straggler mitigation for the serving tier.

Table 3 of the paper measures the model-fallback rate with/without the
failover cache under real inference failures (0.05%–6.5% per model×stage).
``FailureInjector`` reproduces those regimes deterministically; the serving
step consumes its mask and routes failed requests through the failover
cache (core/server.py step 3).

``StragglerHedger`` models the latency side: per-request inference latency
is sampled from a heavy-tailed distribution; requests slower than the hedge
deadline are duplicated ("hedged") and the earliest completion wins — the
standard tail-at-scale mitigation, accounted per batch so the benchmark can
report p99 with/without hedging.

A numpy copy of ``repro/ft/failure.py`` (the port imports nothing of the
JAX package); a test holds the two to the same outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class FailureInjector:
    """Bernoulli per-request inference failures + optional burst windows
    (regional incident: failure prob jumps to ``burst_rate`` inside the
    window — the drain-test companion)."""

    base_rate: float = 0.01
    burst_rate: float = 0.5
    burst_windows_ms: tuple = ()          # ((lo, hi), ...)
    seed: int = 0

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)

    def rate_at(self, now_ms: int) -> float:
        for lo, hi in self.burst_windows_ms:
            if lo <= now_ms < hi:
                return self.burst_rate
        return self.base_rate

    def in_burst(self, now_ms: int) -> bool:
        return any(lo <= now_ms < hi for lo, hi in self.burst_windows_ms)

    def mask(self, n: int, now_ms: int = 0) -> np.ndarray:
        """(n,) bool — True = this inference request fails."""
        return self._rng.uniform(size=n) < self.rate_at(now_ms)

    def kill_steps(self, step_times_ms, checkpoint_every: int
                   ) -> List[int]:
        """EVERY checkpoint-boundary step whose clock falls inside a
        burst window, in stream order — the rolling-restart chaos
        scenario (launch/serve.py --chaos rolling) kills at each one in
        turn. Empty when no boundary lands in a window."""
        return [s for s in range(checkpoint_every, len(step_times_ms),
                                 checkpoint_every)
                if self.in_burst(int(step_times_ms[s]))]

    def kill_step(self, step_times_ms, checkpoint_every: int
                  ) -> Optional[int]:
        """The FIRST checkpoint-boundary step whose clock falls inside a
        burst window — where the kill/restore harness (launch/serve.py
        --restart) crashes the server: a process death mid-incident,
        landing exactly on a snapshot boundary so the restore's recovery
        is measured from a committed checkpoint. None when no boundary
        lands in a window (the head of :meth:`kill_steps`)."""
        steps = self.kill_steps(step_times_ms, checkpoint_every)
        return steps[0] if steps else None


@dataclasses.dataclass
class StragglerHedger:
    """Hedged-request latency model.

    Latency ~ lognormal(median, sigma) with a pareto tail; a request still
    incomplete at ``hedge_after_ms`` is re-issued and min() wins. Returns
    per-request effective latency + the extra-compute fraction (the cost of
    hedging, to report alongside the p99 win).
    """

    median_ms: float = 5.0
    sigma: float = 0.5
    tail_frac: float = 0.02              # fraction hitting the pareto tail
    tail_scale_ms: float = 50.0
    hedge_after_ms: Optional[float] = None   # None = no hedging
    seed: int = 0

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)

    def _sample(self, n: int) -> np.ndarray:
        lat = self._rng.lognormal(np.log(self.median_ms), self.sigma, n)
        tail = self._rng.uniform(size=n) < self.tail_frac
        lat = np.where(tail, self.tail_scale_ms *
                       (1 + self._rng.pareto(2.0, n)), lat)
        return lat

    def latencies(self, n: int) -> Dict[str, np.ndarray]:
        first = self._sample(n)
        if self.hedge_after_ms is None:
            return {"latency_ms": first,
                    "hedged": np.zeros(n, bool),
                    "extra_compute_frac": 0.0}
        hedged = first > self.hedge_after_ms
        second = self._sample(n)
        eff = np.where(hedged,
                       np.minimum(first, self.hedge_after_ms + second),
                       first)
        return {"latency_ms": eff, "hedged": hedged,
                "extra_compute_frac": float(hedged.mean())}
