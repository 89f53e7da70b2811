"""Token-bucket rate limiting: regional QPS thresholds and per-model
inference admission (paper §3.7 and §4.4).

Twin of ``repro/core/ratelimit.py``:

* :class:`TokenBucket` / :class:`RegionalRateLimiter`: the paper's
  regional QPS filter, a deterministic host-side bucket per region on
  the simulated clock (plain Python, as in the reference).
* :class:`InferBudget` and its refill -> grant -> spend primitives: the
  same partial-admission math vectorized over the model registry on the
  device (DESIGN.md §8). Everything there is elementwise float32, so the
  token state is bit-exact with the reference. Functions return new
  tensors, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass
class TokenBucket:
    rate_per_s: float           # sustained regional threshold
    burst: float                # bucket capacity
    tokens: float = 0.0
    last_ms: int = 0
    admitted: int = 0
    rejected: int = 0

    def __post_init__(self) -> None:
        if self.tokens == 0.0:
            self.tokens = self.burst

    def admit(self, now_ms: int, n: int = 1) -> int:
        """Try to admit ``n`` requests at ``now_ms``; returns how many were
        admitted (a batch may be trimmed: the spike's excess is shed)."""
        dt = max(now_ms - self.last_ms, 0) / 1e3
        self.tokens = min(self.burst, self.tokens + dt * self.rate_per_s)
        self.last_ms = max(self.last_ms, now_ms)
        ok = int(min(n, self.tokens))
        self.tokens -= ok
        self.admitted += ok
        self.rejected += n - ok
        return ok


@dataclasses.dataclass
class RegionalRateLimiter:
    """One bucket per region; thresholds provisioned per region."""

    buckets: dict

    @staticmethod
    def uniform(regions, rate_per_s: float, burst_s: float = 1.0
                ) -> "RegionalRateLimiter":
        return RegionalRateLimiter(buckets={
            r: TokenBucket(rate_per_s=rate_per_s, burst=rate_per_s * burst_s)
            for r in regions})

    def admit(self, region, now_ms: int, n: int = 1) -> int:
        return self.buckets[region].admit(now_ms, n)

    def stats(self):
        return {r: (b.admitted, b.rejected) for r, b in self.buckets.items()}


class InferBudget(NamedTuple):
    """Vectorized per-model inference token bucket, carried in the server
    state so the budget survives across steps."""

    tokens: torch.Tensor      # (M,) float32 — fractional tokens available


def bursts_of(rates: torch.Tensor, limited: torch.Tensor) -> torch.Tensor:
    """Bucket capacity per model: ``rate + 1`` for limited models, so the
    sub-1 residue left by ``floor`` is never clipped by the next refill and
    the long-run admitted rate equals the provisioned rate exactly;
    unlimited models never read their tokens (1 keeps them well-formed)."""
    return torch.where(limited, rates + 1.0, torch.ones_like(rates))


def budget_table(cfgs: Sequence, device="cuda"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rates, bursts, limited) (M,) tensors from an ordered CacheConfig
    sequence: ``rate`` is ``infer_budget_per_step`` (0 for unlimited
    models, which ``limited`` masks off)."""
    rates = torch.tensor([0.0 if c.infer_budget_per_step is None
                          else float(c.infer_budget_per_step) for c in cfgs],
                         dtype=torch.float32, device=device)
    limited = torch.tensor([c.infer_budget_per_step is not None
                            for c in cfgs], dtype=torch.bool, device=device)
    return rates, bursts_of(rates, limited), limited


def init_infer_budget(cfgs: Sequence, device="cuda") -> InferBudget:
    """Buckets start full (one burst's worth)."""
    _, bursts, _ = budget_table(cfgs, device)
    return InferBudget(tokens=bursts)


def refill(budget: InferBudget, rates: torch.Tensor, bursts: torch.Tensor
           ) -> InferBudget:
    """Add one serve step's tokens, capped at the burst."""
    return InferBudget(tokens=torch.minimum(bursts, budget.tokens + rates))


def grant_from(budget: InferBudget, limited: torch.Tensor,
               demand: torch.Tensor,
               blocked: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-model grant against a REFILLED bucket: ``min(demand,
    floor(tokens))`` for limited models, the demand otherwise; ``blocked``
    (M,) bool forces a grant to 0. Does not spend."""
    demand = torch.as_tensor(demand, dtype=torch.int32,
                             device=budget.tokens.device)
    cap = torch.floor(budget.tokens).to(torch.int32)
    grant = torch.where(limited, torch.minimum(demand, cap), demand)
    if blocked is not None:
        grant = torch.where(blocked, torch.zeros_like(grant), grant)
    return grant


def spend(budget: InferBudget, limited: torch.Tensor, used: torch.Tensor
          ) -> InferBudget:
    """Charge the bucket for the inferences that ran (failed attempts
    included); unlimited models' tokens never move."""
    used = torch.as_tensor(used, dtype=torch.int32,
                           device=budget.tokens.device)
    charge = torch.where(limited, used, torch.zeros_like(used))
    return InferBudget(tokens=budget.tokens - charge.to(torch.float32))


def admit_step(budget: InferBudget, rates: torch.Tensor,
               bursts: torch.Tensor, limited: torch.Tensor,
               demand: torch.Tensor) -> Tuple[torch.Tensor, InferBudget]:
    """One refill -> grant -> spend round, every model at once. Returns
    (grant (M,) int32, new budget)."""
    b = refill(budget, rates, bursts)
    grant = grant_from(b, limited, demand)
    return grant, spend(b, limited, grant)
