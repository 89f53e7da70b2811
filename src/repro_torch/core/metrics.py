"""Serving metrics: hit rate, fallback rate, power-savings model, latency
percentiles, NE (normalized cross-entropy) — the quantities in the paper's
Tables 2–4 and Figs. 6–9.

A numpy copy of ``repro/core/metrics.py`` (the port imports nothing of the
JAX package); a test holds the two to the same outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class ServingCounters:
    """Accumulated over a served request stream (one model namespace)."""

    requests: int = 0
    direct_hits: int = 0
    tower_inferences: int = 0       # actual tower forward passes issued
    tower_failures: int = 0         # injected/real inference failures
    overflow: int = 0               # misses beyond the miss budget
    failover_hits: int = 0          # failures/overflow recovered from failover
    fallbacks: int = 0              # requests served by the *model fallback*
                                    # (default embedding) — the paper's
                                    # "model fallback rate"
    cache_writes: int = 0
    combined_writes: int = 0
    # SLA admission-control ledger (DESIGN.md §8). Without a configured
    # inference budget every miss is admitted: `admitted` then equals the
    # miss count and `deferred`/`failover_serves` stay zero.
    admitted: int = 0               # misses granted a tower inference
    deferred: int = 0               # misses the budget gated off
    failover_serves: int = 0        # degradation-chain failover serves
                                    # (incl. beyond the strict failover TTL)

    def merge(self, o: "ServingCounters") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(o, f.name))

    @classmethod
    def from_stats(cls, stats) -> "ServingCounters":
        """Build counters from a ``serve_step`` stats dict or a
        ``serve_many`` device-resident accumulator (DESIGN.md §9).

        Callers fetch the whole accumulator with ONE host transfer
        (``core.server.fetch_counters``) and hand it over — no per-key
        host syncs. ``steps`` (the scan
        driver's iteration count) maps to ``combined_writes``: one
        grouped async write per serve step, the paper's §3.5 combining
        unit.
        """
        g = lambda k: int(stats[k]) if k in stats else 0
        return cls(
            requests=g("requests"), direct_hits=g("direct_hits"),
            tower_inferences=g("tower_inferences"),
            tower_failures=g("tower_failures"), overflow=g("overflow"),
            failover_hits=g("failover_hits"), fallbacks=g("fallbacks"),
            admitted=g("admitted"), deferred=g("deferred"),
            failover_serves=g("failover_serves"),
            combined_writes=g("steps") or g("combined_writes"))

    @classmethod
    def from_dict(cls, d: Dict) -> "ServingCounters":
        """Inverse of :meth:`as_dict` — the restore side of checkpointed
        counters (ft/snapshot.py). Only dataclass fields are read; derived
        rates and unknown keys are ignored, missing fields default to 0,
        so counters restored from an older snapshot schema still resume
        additively."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: int(v) for k, v in d.items() if k in names})

    @property
    def hit_rate(self) -> float:
        return self.direct_hits / max(self.requests, 1)

    @property
    def fallback_rate(self) -> float:
        return self.fallbacks / max(self.requests, 1)

    @property
    def sla_served_rate(self) -> float:
        """Fraction served with a REAL embedding (direct, computed, or
        failover — everything except the default-embedding fallback): the
        SLA-compliance number the admission degradation chain defends."""
        return 1.0 - self.fallback_rate

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate
        d["fallback_rate"] = self.fallback_rate
        d["sla_served_rate"] = self.sla_served_rate
        return d


def power_savings(hit_rate: float, tower_power_share: float) -> float:
    """Paper §4.2 measures power w/ and w/o direct cache. A hit removes the
    user-tower inference but none of the rest of the request (feature
    extraction, ads-side compute, final ranking). With the tower consuming
    ``tower_power_share`` of per-request inference power:

        savings = hit_rate × tower_power_share

    Table 2's 43–64% savings at 68.7% hit (5-min TTL, Fig. 6) imply tower
    shares of ~0.63–0.93 depending on the model — consistent with the user
    tower dominating ranking-model inference cost.
    """
    return hit_rate * tower_power_share


def percentile(xs: List[float], p: float) -> float:
    if not xs:
        return float("nan")
    return float(np.percentile(np.asarray(xs), p))


def ne(labels: np.ndarray, preds: np.ndarray, eps: float = 1e-12) -> float:
    """Normalized cross-entropy (paper's model-performance metric).

    NE = CE(labels, preds) / CE(labels, base_rate): 1.0 == predicting the
    prior; lower is better.
    """
    labels = np.asarray(labels, np.float64)
    preds = np.clip(np.asarray(preds, np.float64), eps, 1 - eps)
    ce = -(labels * np.log(preds) + (1 - labels) * np.log(1 - preds)).mean()
    p = np.clip(labels.mean(), eps, 1 - eps)
    ce_base = -(p * np.log(p) + (1 - p) * np.log(1 - p))
    return float(ce / max(ce_base, eps))
