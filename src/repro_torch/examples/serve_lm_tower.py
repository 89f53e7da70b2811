"""End-to-end serving example: a transformer user tower behind ERCache.

Twin of ``examples/serve_lm_tower.py``. A LLaMA-family LM (the reduced
TinyLlama by default) produces pooled user representations (paper ref
[24], Scaling User Modeling); ERCache fronts it over the Fig. 2-calibrated
request stream with injected inference failures. Each step is one
``jit_serve_step`` and one ``jit_flush`` (on the card CUDA graph
replays), with one counter fetch; the tower's features are the bare
(B, S) token tensor. Reports the Table 2/3
quantities for this deployment.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm_tower [--minutes 90]

The command runs on the card. :func:`run` takes the tower config and
sequence length (``chip_smoke.py`` drives it at TinyLlama's full width) and
runs the plain versions on the CPU with ``device="cpu", backend="torch"``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import server as srv
from repro_torch.core.cache import resolve_device
from repro_torch.core.config import CacheConfig, HOUR_MS, MINUTE_MS
from repro_torch.core.hashing import Key64
from repro_torch.core.metrics import power_savings
from repro_torch.data.access_patterns import (FIG6_KNOTS, InterArrivalDist,
                                              StreamConfig,
                                              generate_stream_fast)
from repro_torch.ft.failure import FailureInjector
from repro_torch.models import transformer as tfm

SEQ = 32
BATCH = 64


def tokens_of(ids, seq: int, vocab: int, device) -> torch.Tensor:
    """Deterministic per-user behaviour history (stable across calls):
    token t of user i is t * (7 + i) mod vocab."""
    ids = np.asarray(ids, np.int64)
    tokens = (np.arange(seq)[None, :] * (7 + ids[:, None])) % vocab
    return torch.as_tensor(tokens.astype(np.int32), device=device)


def deployment(cfg, seq: int = SEQ, batch: int = BATCH, minutes: int = 90,
               users: int = 1200, failure_rate: float = 0.02,
               device="cuda", backend: str = "cuda"):
    """The example's deployment before its first step: ``(server, state,
    batches)``, ``batches`` yielding each step's ``(keys, tokens, now_ms,
    failure_mask)`` on the device."""
    device = resolve_device(device)

    def tower_fn(p, tokens):
        return tfm.user_tower_step(p, tokens, cfg, backend=backend)

    cache_cfg = CacheConfig(model_id=7, model_type="ctr",
                            cache_ttl_ms=5 * MINUTE_MS,
                            failover_ttl_ms=1 * HOUR_MS,
                            n_buckets=1 << 12, ways=8,
                            value_dim=cfg.user_embed_dim, backend=backend)
    server = srv.CachedEmbeddingServer(cfg=cache_cfg, tower_fn=tower_fn,
                                       miss_budget=int(batch * 0.75))
    state = srv.init_server_state(cache_cfg, writebuf_capacity=batch * 4,
                                  device=device)
    stream = StreamConfig(n_users=users, horizon_s=minutes * 60.0, seed=0)
    times_ms, uids = generate_stream_fast(stream,
                                          InterArrivalDist(FIG6_KNOTS))
    injector = FailureInjector(base_rate=failure_rate, seed=0)

    def batches():
        for lo in range(0, len(uids) - batch + 1, batch):
            ids = uids[lo:lo + batch]
            now = int(times_ms[lo + batch - 1])
            yield (Key64.from_int(ids, device=device),
                   tokens_of(ids, seq, cfg.vocab, device), now,
                   torch.as_tensor(injector.mask(batch, now), device=device))

    return server, state, batches()


def serve_steps(cfg, params, seq: int = SEQ, batch: int = BATCH,
                minutes: int = 90, users: int = 1200,
                failure_rate: float = 0.02, device="cuda",
                backend: str = "cuda"):
    """The example's deployment, one ``jit_serve_step`` + ``jit_flush``
    per item (on the card CUDA graph replays, each captured at its first
    call): yields ``(ServeResult, stats, state)`` with the step's stats
    fetched to the host in one transfer and the state after the flush.
    ``params`` is the tower (``transformer.init_params`` or
    ``load_jax_params``)."""
    server, state, batches = deployment(cfg, seq, batch, minutes, users,
                                        failure_rate, device, backend)
    for keys, tokens, now, fails in batches:
        res = server.jit_serve_step(params, state, keys, tokens, now, fails)
        state = server.jit_flush(res.state, now)
        yield res, srv.fetch_counters(res.stats), state


def run(cfg=None, seq: int = SEQ, batch: int = BATCH, minutes: int = 90,
        users: int = 1200, failure_rate: float = 0.02, device="cuda",
        backend: str = "cuda") -> dict:
    """Serve the stream through a tower with random weights from seed 0
    (``cfg`` None: the SMOKE TinyLlama), print the report and return the
    totals."""
    device = resolve_device(device)
    cfg = cfg or get_config("tinyllama-1.1b", smoke=True)
    params = tfm.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device)
    totals = {"requests": 0, "hits": 0, "towers": 0, "fallbacks": 0}
    for _, s, _ in serve_steps(cfg, params, seq, batch, minutes, users,
                               failure_rate, device, backend):
        totals["requests"] += s["requests"]
        totals["hits"] += s["direct_hits"]
        totals["towers"] += s["tower_inferences"]
        totals["fallbacks"] += s["fallbacks"]

    n = max(totals["requests"], 1)
    hit_rate = totals["hits"] / n
    print(f"requests           : {totals['requests']}")
    print(f"direct hit rate    : {hit_rate:.3f}")
    print(f"tower inferences   : {totals['towers']} "
          f"({totals['towers'] / n:.2%} of requests)")
    print(f"fallback rate      : {totals['fallbacks'] / n:.4%} "
          f"(failure rate injected: {failure_rate:.1%})")
    print(f"compute savings    : {power_savings(hit_rate, 0.8):.1%} "
          f"(tower share 0.8, Table 2 model)")
    return totals


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=int, default=90)
    ap.add_argument("--users", type=int, default=1200)
    ap.add_argument("--failure-rate", type=float, default=0.02)
    args = ap.parse_args()
    run(minutes=args.minutes, users=args.users,
        failure_rate=args.failure_rate)


if __name__ == "__main__":
    main()
