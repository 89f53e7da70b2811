"""Per-model inference admission: a vectorized token bucket on the device.

Twin of the device part of ``repro/core/ratelimit.py`` (``InferBudget``
and its refill -> grant -> spend primitives, DESIGN.md §8); the host-side
regional ``TokenBucket`` / ``RegionalRateLimiter`` join with the regions
slice. Everything here is elementwise float32, so the token state is
bit-exact with the reference. Functions return new tensors, as the
reference does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch


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
