"""Training script: a CTR tower on the OU-drift click world, then the
NE-vs-TTL ablation (the paper's Table 4 experiment as a runnable script).

    PYTHONPATH=src python -m repro_torch.examples.train_ctr_tower [--device cpu]

Twin of ``examples/train_ctr_tower.py`` together with the experiment it
runs (``benchmarks/bench_ttl_ne.py``): a two-tower CTR model is trained
on FRESH behaviour features from the click world
(``data/clickstream.py``), then evaluated in two serving arms over the
same impression stream:

  * fresh arm: tower inference on every impression;
  * cached arm: ERCache semantics at the given TTL (a hit serves the
    features of the last tower run, however stale).

NE difference = (NE_cached - NE_fresh) / NE_fresh. The paper's shape: about
0 (a few thousandths of a %) for TTL <= 5 min, degrading at >= 10 min. The
cache's TTL is simulated in numpy, as in the reference; the server is not
called. Training is torch autograd with plain SGD on ``device`` (the card
by default; ``--device cpu`` runs on the CPU), and the tower's two small
products are plain torch ops.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cache import resolve_device
from repro_torch.data.access_patterns import (FIG6_KNOTS, InterArrivalDist,
                                              StreamConfig,
                                              generate_stream_fast)
from repro_torch.data.clickstream import ClickSimulator, ClickWorld
from repro_torch.training.ne import NEAccumulator, ne_diff_pct

TTLS_MIN = [0.5, 1, 2, 5, 10]
PAPER = {0.5: 0.002, 1: -0.001, 2: -0.007, 5: 0.003, 10: 0.06}
W0_SEED = 0


class Report:
    """Collects ``name,us_per_call,derived`` rows, as the benchmarks'
    report prints them."""

    def __init__(self):
        self.rows: List[Tuple[str, float, str]] = []

    def add(self, name: str, us_per_call: float = 0.0, derived: str = ""):
        self.rows.append((name, us_per_call, derived))

    def print_csv(self, header: bool = False):
        if header:
            print("name,us_per_call,derived")
        for name, us, derived in self.rows:
            print(f"{name},{us:.2f},{derived}")


def initial_w(dim: int, seed: int = W0_SEED) -> torch.Tensor:
    """The tower's starting projection: identity plus N(0, 0.01^2) noise
    drawn from a seeded CPU generator."""
    g = torch.Generator().manual_seed(seed)
    return torch.eye(dim) + 0.01 * torch.randn((dim, dim), generator=g)


def _bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def _logits(W, s, b0, ads, feats, ad_ids):
    emb = feats @ W
    return s * (emb * ads[ad_ids]).sum(dim=-1) + b0


def train_tower(sim: ClickSimulator, times, users, dim: int,
                steps: int = 300, batch: int = 512, lr: float = 0.05,
                w0: Optional[torch.Tensor] = None, device="cuda"):
    """Logistic two-tower: emb = b_u W; p = sigmoid(s <emb, a> + b0),
    trained with plain SGD on fresh features. ``w0`` (dim, dim) is the
    start (default :func:`initial_w`). Returns (W, s, b0) float32 tensors
    on ``device``."""
    device = resolve_device(device)
    w0 = initial_w(dim) if w0 is None else torch.as_tensor(w0)
    W = w0.to(device=device, dtype=torch.float32).clone().requires_grad_()
    s = torch.tensor(1.0, device=device, requires_grad=True)
    b0 = torch.tensor(-3.0, device=device, requires_grad=True)
    ads = torch.as_tensor(sim.ads, dtype=torch.float32, device=device)
    n = min(len(users), steps * batch)
    for lo in range(0, n - batch + 1, batch):
        uid = users[lo:lo + batch]
        sim.advance_to(uid, int(times[lo + batch - 1]))
        feats = torch.as_tensor(sim.behavior_features(uid), device=device)
        ad_ids, y = sim.impressions(uid)
        loss = _bce(_logits(W, s, b0, ads, feats,
                            torch.as_tensor(ad_ids, device=device)),
                    torch.as_tensor(y, device=device))
        gW, gs, gb = torch.autograd.grad(loss, (W, s, b0))
        with torch.no_grad():
            W = (W - lr * gW).requires_grad_()
            s = (s - lr * gs).requires_grad_()
            b0 = (b0 - lr * gb).requires_grad_()
    return W.detach(), s.detach(), b0.detach()


def run(report: Optional[Report] = None, n_users: int = 3000,
        horizon_h: float = 30.0, batch: int = 512, *,
        w0: Optional[torch.Tensor] = None, device="cuda") -> dict:
    """Table 4: train on the first third of the stream, then score the
    rest in the fresh arm and one cached arm per TTL of ``TTLS_MIN``.
    Returns ``{"table4_ne_diff_ttl_<ttl>min": {"ne_diff_pct", "paper",
    "ne", "ne_fresh"}}`` and adds one row a TTL to ``report``."""
    report = report or Report()
    device = resolve_device(device)
    # tau = 24 h interest drift; obs noise low enough that two tower calls
    # on the same user minutes apart are near-identical (the paper's
    # +-0.00x% noise floor below 5-min TTL), leaving staleness as the only
    # signal.
    world = ClickWorld(n_users=n_users, dim=16, tau_s=24 * 3600.0,
                       obs_noise=0.04, logit_scale=1.6, logit_bias=-3.4,
                       seed=2)
    stream_cfg = StreamConfig(n_users=n_users, horizon_s=horizon_h * 3600,
                              seed=9)
    times, users = generate_stream_fast(stream_cfg,
                                        InterArrivalDist(FIG6_KNOTS))

    split = len(users) // 3
    sim = ClickSimulator(world)
    W, s, b0 = train_tower(sim, times[:split], users[:split], world.dim,
                           w0=w0, device=device)
    ads = torch.as_tensor(sim.ads, dtype=torch.float32, device=device)

    def predict(feats: np.ndarray, ad_ids: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            p = torch.sigmoid(_logits(
                W, s, b0, ads, torch.as_tensor(feats, device=device),
                torch.as_tensor(ad_ids, device=device)))
        return p.cpu().numpy()

    arms = {ttl: NEAccumulator() for ttl in TTLS_MIN}
    fresh_acc = NEAccumulator()
    # cached embedding state per arm: features at the last tower run and
    # its time
    cached_feats = {ttl: np.zeros((n_users, world.dim), np.float32)
                    for ttl in TTLS_MIN}
    cached_at = {ttl: np.full(n_users, -10**12, np.int64)
                 for ttl in TTLS_MIN}

    for lo in range(split, len(users) - batch + 1, batch):
        uid = users[lo:lo + batch]
        t_ev = times[lo:lo + batch]              # per-event timestamps
        sim.advance_to(uid, int(t_ev[-1]))       # tau >> batch window
        fresh = sim.behavior_features(uid)
        # the cached arm's tower call sees an independent observation-noise
        # draw: at age ~0 the arms differ only by this noise floor
        cache_draw = sim.behavior_features(uid)
        ad_ids, y = sim.impressions(uid)
        fresh_acc.add(y, predict(fresh, ad_ids))
        for ttl in TTLS_MIN:
            ttl_ms = int(ttl * 60_000)
            hit = t_ev - cached_at[ttl][uid] <= ttl_ms
            feats = np.where(hit[:, None], cached_feats[ttl][uid],
                             cache_draw)
            # misses refresh the cache (ERCache update on inference)
            miss_ids = uid[~hit]
            cached_feats[ttl][miss_ids] = cache_draw[~hit]
            cached_at[ttl][miss_ids] = t_ev[~hit]
            arms[ttl].add(y, predict(feats, ad_ids))

    out = {}
    for ttl in TTLS_MIN:
        diff = ne_diff_pct(arms[ttl].ne, fresh_acc.ne)
        label = f"table4_ne_diff_ttl_{ttl}min"
        report.add(label, 0.0,
                   f"ne_diff={diff:+.4f}% paper={PAPER[ttl]:+.3f}% "
                   f"(ne_fresh={fresh_acc.ne:.4f})")
        out[label] = {"ne_diff_pct": diff, "paper": PAPER[ttl],
                      "ne": arms[ttl].ne, "ne_fresh": fresh_acc.ne}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=2000)
    ap.add_argument("--hours", type=float, default=24.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    report = Report()
    out = run(report, n_users=args.users, horizon_h=args.hours,
              device=args.device)
    report.print_csv(header=True)
    print("\nReading: ne_diff ~ 0 for TTL <= 5 min (cache is NE-neutral), "
          "degrading at 10 min: the paper's Table 4 shape.")
    return out


if __name__ == "__main__":
    main()
