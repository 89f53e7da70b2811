"""Quickstart: ERCache in 60 seconds.

Twin of ``examples/quickstart.py``. Creates a cache, serves a batch through
the direct -> tower -> failover pipeline, and shows the provenance
accounting: the paper's Fig. 3 in miniature. Each step is one
``serve_step`` (and one ``flush``); the hit rate comes from one counter
fetch.

    PYTHONPATH=src python -m repro_torch.examples.quickstart

The command runs on the card (the probe kernel); :func:`main` runs the
plain versions on the CPU with ``device="cpu", backend="torch"``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import server as srv
from repro_torch.core.cache import resolve_device
from repro_torch.core.config import CacheConfig, HOUR_MS, MINUTE_MS
from repro_torch.core.hashing import Key64

DIM = 16


def user_tower(params, features):
    """Stand-in user tower: any (params, features) -> (B, DIM) works;
    ``serve_lm_tower.py`` plugs in a real transformer."""
    return torch.tanh(features @ params)


def main(device="cuda", backend: str = "cuda") -> None:
    device = resolve_device(device)
    cfg = CacheConfig(
        model_id=42, model_type="ctr",
        cache_ttl_ms=5 * MINUTE_MS,        # direct cache: short TTL
        failover_ttl_ms=1 * HOUR_MS,       # failover cache: long TTL
        n_buckets=1 << 10, ways=8, value_dim=DIM, backend=backend)
    server = srv.CachedEmbeddingServer(cfg=cfg, tower_fn=user_tower,
                                       miss_budget=6)
    state = srv.init_server_state(cfg, device=device)
    params = torch.eye(DIM, device=device) * 0.5

    user_ids = np.array([101, 102, 103, 104, 105, 106, 107, 108])
    keys = Key64.from_int(user_ids, device=device)
    feats = torch.as_tensor(np.random.default_rng(0)
                            .standard_normal((8, DIM)), dtype=torch.float32,
                            device=device)

    names = {0: "DIRECT", 1: "COMPUTED", 2: "FAILOVER", 3: "FALLBACK"}

    def sources(res):
        return [names[s] for s in res.source.tolist()]

    # t=0: cold cache; towers run (up to the miss budget of 6)
    res = server.serve_step(params, state, keys, feats, 0)
    state = server.flush(res.state, 0)             # async write, off path
    print("t=0    :", sources(res))

    # t=+1min: every request hits the direct cache
    res = server.serve_step(params, state, keys, feats, 60_000)
    state = server.flush(res.state, 60_000)
    print("t=+1min:", sources(res))
    stats = srv.fetch_counters(res.stats)          # one transfer
    print("         hit rate:", stats["direct_hits"] / 8)

    # t=+10min: direct TTL expired; towers fail, failover cache recovers
    t = 10 * MINUTE_MS
    res = server.serve_step(params, state, keys, feats, t,
                            failure_mask=torch.ones(8, dtype=torch.bool,
                                                    device=device))
    print("t=+10m :", sources(res),
          "(all inferences failed; failover TTL=1h recovered them)")
    print("ages   :", [a // 1000 for a in res.age_ms.tolist()], "seconds")


if __name__ == "__main__":
    main()
