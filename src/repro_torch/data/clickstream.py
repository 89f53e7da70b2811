"""Synthetic CTR/CVR clickstream with drifting user interest (Table 4 repro).

The NE-vs-TTL experiment needs a world where embedding *staleness* actually
costs accuracy. We model each user's latent interest as an Ornstein-Uhlenbeck
process over d dimensions:

    θ_u(t+δ) = ρ θ_u(t) + √(1-ρ²) ε,   ρ = exp(-δ/τ)

with drift time-constant τ. The user tower observes behavior features
b_u(t) = θ_u(t) + obs-noise and must embed them; ads carry static vectors
a_j; click prob = σ(s·⟨θ_u(t), a_j⟩ + b₀) with b₀ set for a realistic ~2% CTR
base rate.

Serving with an embedding cached Δ ms ago degrades the logit by the interest
drift over Δ — tiny for Δ ≤ 5 min and visible at ≥ 10 min when τ is a few
hours, which is exactly the paper's Table 4 shape.

A numpy copy of ``repro/data/clickstream.py`` (the port imports nothing
of the JAX package): the same seed gives the same stream, byte for
byte, and a test holds the two to it.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClickWorld:
    n_users: int = 4096
    n_ads: int = 2048
    dim: int = 32
    tau_s: float = 4 * 3600.0        # interest drift time-constant
    obs_noise: float = 0.15          # behavior-feature observation noise
    logit_scale: float = 1.3
    logit_bias: float = -4.2         # ≈ 2% base CTR
    seed: int = 0


class ClickSimulator:
    """Stateful world. ``advance(user_ids, dt_ms)`` drifts those users;
    ``impressions`` draws labeled (user, ad, click) events at current θ."""

    def __init__(self, world: ClickWorld):
        self.w = world
        rng = np.random.default_rng(world.seed)
        self.rng = rng
        self.theta = rng.standard_normal((world.n_users, world.dim))
        self.ads = rng.standard_normal((world.n_ads, world.dim)) / np.sqrt(world.dim)
        self.last_t_ms = np.zeros(world.n_users, np.int64)

    # ------------------------------------------------------------- dynamics
    def advance_to(self, user_ids: np.ndarray, now_ms: int) -> None:
        """OU-drift the given users from their last update time to now."""
        u = np.unique(user_ids)
        dt_s = (now_ms - self.last_t_ms[u]) / 1e3
        rho = np.exp(-np.maximum(dt_s, 0.0) / self.w.tau_s)[:, None]
        eps = self.rng.standard_normal((u.size, self.w.dim))
        self.theta[u] = rho * self.theta[u] + np.sqrt(1 - rho ** 2) * eps
        self.last_t_ms[u] = now_ms

    # ------------------------------------------------------------- features
    def behavior_features(self, user_ids: np.ndarray) -> np.ndarray:
        """What the user tower sees at inference time (current interest +
        observation noise). Shape (B, dim) float32."""
        th = self.theta[user_ids]
        return (th + self.w.obs_noise *
                self.rng.standard_normal(th.shape)).astype(np.float32)

    def click_prob(self, user_ids: np.ndarray, ad_ids: np.ndarray
                   ) -> np.ndarray:
        logits = (self.theta[user_ids] * self.ads[ad_ids]).sum(-1)
        logits = self.w.logit_scale * logits + self.w.logit_bias
        return 1.0 / (1.0 + np.exp(-logits))

    def impressions(self, user_ids: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Sample (ad_ids, click labels) for a batch of users at current θ."""
        ads = self.rng.integers(0, self.w.n_ads, size=user_ids.shape[0])
        p = self.click_prob(user_ids, ads)
        y = (self.rng.uniform(size=p.shape) < p).astype(np.float32)
        return ads, y


def training_batches(sim: ClickSimulator, times_ms: np.ndarray,
                     users: np.ndarray, batch: int):
    """Iterate the request stream in time order, yielding fully-fresh
    training batches (features computed at impression time — the training
    pipeline never sees cache staleness, matching production training on
    logged fresh features)."""
    for i in range(0, len(times_ms) - batch + 1, batch):
        uid = users[i:i + batch].astype(np.int64)
        now = int(times_ms[i + batch - 1])
        sim.advance_to(uid, now)
        feats = sim.behavior_features(uid)
        ads, y = sim.impressions(uid)
        yield now, uid, feats, ads, y
