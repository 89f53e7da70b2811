"""Normalized (cross-)Entropy, the paper's model-performance metric.

Twin of ``repro/training/ne.py``. NE = CE(labels, preds) / CE(labels,
base_rate): 1.0 is predicting the prior, lower is better. Table 4 reports
the NE difference between cache-enabled and cache-disabled serving arms;
:class:`NEAccumulator` (a numpy copy) does that A/B accounting over a
streamed evaluation.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def ne(labels: torch.Tensor, preds: torch.Tensor,
       eps: float = 1e-12) -> torch.Tensor:
    """NE of probabilities ``preds`` against 0/1 ``labels``, in float32
    (the twin of ``ne_jnp``)."""
    labels = labels.to(torch.float32)
    preds = torch.clamp(preds.to(torch.float32), eps, 1 - eps)
    ce = -(labels * torch.log(preds)
           + (1 - labels) * torch.log1p(-preds)).mean()
    p = torch.clamp(labels.mean(), eps, 1 - eps)
    ce_base = -(p * torch.log(p) + (1 - p) * torch.log1p(-p))
    return ce / torch.clamp(ce_base, min=eps)


@dataclasses.dataclass
class NEAccumulator:
    """Streaming NE: accumulate (sum CE terms, sum labels, count)."""

    ce_sum: float = 0.0
    label_sum: float = 0.0
    count: int = 0
    eps: float = 1e-12

    def add(self, labels: np.ndarray, preds: np.ndarray) -> None:
        labels = np.asarray(labels, np.float64)
        preds = np.clip(np.asarray(preds, np.float64), self.eps, 1 - self.eps)
        self.ce_sum += float(-(labels * np.log(preds)
                               + (1 - labels) * np.log1p(-preds)).sum())
        self.label_sum += float(labels.sum())
        self.count += labels.size

    @property
    def ne(self) -> float:
        if self.count == 0:
            return float("nan")
        p = np.clip(self.label_sum / self.count, self.eps, 1 - self.eps)
        ce_base = -(p * np.log(p) + (1 - p) * np.log1p(-p))
        return (self.ce_sum / self.count) / max(ce_base, self.eps)


def ne_diff_pct(ne_cached: float, ne_fresh: float) -> float:
    """Table 4's quantity: (NE_cached - NE_fresh) / NE_fresh x 100."""
    return 100.0 * (ne_cached - ne_fresh) / ne_fresh
