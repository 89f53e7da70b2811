"""Training launcher: config -> data -> train loop -> checkpoints.

Twin of ``repro/launch/train.py``: trains a model of any architecture
(an LM, the GNN or a recsys tower; SMOKE widths unless ``--full-config``)
on synthetic numpy data with the whole substrate engaged (optimizer,
checkpoint/resume, train loop), on the card unless ``--device cpu``. The
port draws its own init from ``torch.Generator`` seed 0 (``jax.random``
cannot be matched); the data streams are the reference's numpy draws
(the GNN's through the sampler copy, ``models/sampler.py``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 100 --batch 8 --seq 128 --ckpt-dir ckpt
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.cache import resolve_device
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tfm
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train_loop import LoopConfig, run_train_loop


def lm_batches(cfg, batch: int, seq: int, seed: int = 0, device="cuda"):
    """Uniform random tokens: ``{"tokens", "labels"}`` (B, seq) int32, the
    labels the tokens shifted by one."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    while True:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, seq + 1)),
                               dtype=torch.int32, device=device)
        yield {"tokens": toks[:, :-1].contiguous(),
               "labels": toks[:, 1:].contiguous()}


def recsys_batches(cfg, batch: int, seed: int = 0, device="cuda"):
    """The reference's synthetic recsys batches, draw for draw: labels
    (20% positive), then Wide&Deep's field ids or the sequence, target
    and negatives (one for SASRec, eight otherwise)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.int32: torch.as_tensor(a, dtype=dt, device=device)
    while True:
        b = {"labels": t(rng.uniform(size=batch) < 0.2, torch.float32)}
        if cfg.arch_id.startswith("wide-deep"):
            b["sparse_ids"] = t(rng.integers(
                0, cfg.vocab, (batch, cfg.n_sparse, cfg.nnz_per_field)))
        else:
            b["seq"] = t(rng.integers(0, cfg.vocab, (batch, cfg.seq_len)))
            b["target"] = t(rng.integers(0, cfg.vocab, batch))
            b["pos"] = b["target"]
            b["neg"] = (t(rng.integers(0, cfg.vocab, batch))
                        if cfg.arch_id.startswith("sasrec") else
                        t(rng.integers(0, cfg.vocab, (batch, 8))))
        yield b


GNN_D_FEAT = 32                 # the reference launcher's feature width


def gnn_batches(cfg, batch_nodes: int = 64, seed: int = 0, device="cuda"):
    """The reference's sampled GIN batches, draw for draw: a 2,048-node
    power-law graph of 8,192 edges, then per step ``batch_nodes`` seeds
    and a (5, 5)-fanout padded subgraph (node_feats, senders, receivers,
    labels, mask)."""
    from repro_torch.models.sampler import (NeighborSampler,
                                            synthetic_power_law_graph)

    device = resolve_device(device)
    g = synthetic_power_law_graph(2048, 8192, d_feat=GNN_D_FEAT,
                                  n_classes=cfg.n_classes, seed=seed)
    sampler = NeighborSampler(g, fanout=(5, 5), batch_nodes=batch_nodes,
                              seed=seed)
    rng = np.random.default_rng(seed)
    while True:
        seeds = rng.choice(g.n_nodes, batch_nodes, replace=False)
        sub = sampler.sample(seeds)
        yield {k: torch.as_tensor(v, device=device) for k, v in sub.items()
               if k in ("node_feats", "senders", "receivers", "labels",
                        "mask")}


def gnn_train_state(cfg, opt, device="cuda", seed: int = 0):
    """(params, opt_state) of a random GIN over the launcher's features."""
    device = resolve_device(device)
    model = gnn_lib.init_params(
        torch.Generator(device=device).manual_seed(seed), cfg, GNN_D_FEAT,
        device=device)
    params = gnn_lib.param_tree(model)
    return params, opt.init(params)


def lm_train_state(cfg, opt, device="cuda", seed: int = 0
                   ) -> tfm.TrainState:
    """Random init (``torch.Generator`` seed on ``device``) and a fresh
    optimizer state."""
    device = resolve_device(device)
    model = tfm.init_params(torch.Generator(device=device).manual_seed(seed),
                            cfg, device=device)
    params = tfm.param_tree(model)
    return tfm.TrainState(params, opt.init(params),
                          torch.zeros((), dtype=torch.int32, device=device))


def recsys_train_state(cfg, opt, device="cuda", seed: int = 0):
    """(params, opt_state) of a random tower: the reference's recsys
    loop state."""
    device = resolve_device(device)
    model = rec_lib.init_params(
        torch.Generator(device=device).manual_seed(seed), cfg, device=device)
    params = rec_lib.param_tree(model)
    return params, opt.init(params)


def loop_step(inner):
    """The reference's loop adapter of a ``step(params, opt_state,
    batch)``: ``step((params, opt_state), batch)``."""
    def step(state, batch):
        p, o, m = inner(state[0], state[1], batch)
        return (p, o), m
    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=None,
                    help="accepted and unused, as in the reference")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (non-smoke) architecture config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=not args.full_config)
    device = resolve_device(args.device)
    loop_cfg = LoopConfig(total_steps=args.steps, log_every=args.log_every,
                          ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir)

    if cfg.family == "lm":
        opt = opt_lib.for_config(cfg, total_steps=args.steps)
        state = run_train_loop(
            tfm.make_train_step(cfg, opt), lm_train_state(cfg, opt, device),
            lm_batches(cfg, args.batch, args.seq, device=device), loop_cfg)
    elif cfg.family == "recsys":
        opt = opt_lib.for_config(cfg)
        state = run_train_loop(
            loop_step(rec_lib.make_train_step(cfg, opt)),
            recsys_train_state(cfg, opt, device),
            recsys_batches(cfg, args.batch, device=device), loop_cfg)
    else:
        opt = opt_lib.for_config(cfg)
        state = run_train_loop(
            loop_step(gnn_lib.make_train_step(cfg, opt, kind="node")),
            gnn_train_state(cfg, opt, device), gnn_batches(cfg, device=device),
            loop_cfg)
    print("[train] done")
    return state


if __name__ == "__main__":
    main()
