"""Generic train loop: step fn x data iterator x checkpoint cadence.

Twin of ``repro/training/train_loop.py`` over the port's
``ft/checkpoint.CheckpointManager``, in the same on-disk format (a state
trained by either package resumes in the other). Restart/resume: the loop
begins by asking the manager for the newest committed step and continues
from it. The loop body is model-agnostic; the step functions come from
``models/*``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional

from repro_torch.ft import checkpoint as ckpt_lib
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.training.optimizer import tree_leaves


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_last: int = 3


def run_train_loop(step_fn: Callable, state: Any,
                   batches: Iterable[Dict[str, Any]],
                   cfg: LoopConfig,
                   eval_fn: Optional[Callable] = None,
                   log_fn: Callable = print) -> Any:
    """``step_fn(state, batch) -> (state, metrics)``; returns the final
    state. Resumes from the newest committed checkpoint when
    ``cfg.ckpt_dir`` holds one (restored onto the device of ``state``,
    whose leaves it replaces); logs
    ``[step N] k=v ... (x ms/step avg)`` every ``log_every`` steps and at
    the last; ends with a save at ``total_steps`` and a ``gc_old``."""
    mgr = None
    start_step = 0
    if cfg.ckpt_dir:
        mgr = CheckpointManager(cfg.ckpt_dir, every_steps=cfg.ckpt_every,
                                keep_last=cfg.keep_last,
                                device=tree_leaves(state)[0].device)
        step, state = mgr.restore_latest(state)
        if step is not None:
            start_step = step
            log_fn(f"[resume] from checkpoint step {step}")

    it = iter(batches)
    t0 = time.perf_counter()
    for step in range(start_step + 1, cfg.total_steps + 1):
        try:
            batch = next(it)
        except StopIteration:
            log_fn(f"[done] data exhausted at step {step - 1}")
            break
        state, metrics = step_fn(state, batch)
        if step % cfg.log_every == 0 or step == cfg.total_steps:
            m = {k: float(v) for k, v in metrics.items()}
            dt = (time.perf_counter() - t0) / max(step - start_step, 1)
            log_fn(f"[step {step}] " + " ".join(
                f"{k}={v:.4f}" for k, v in m.items())
                + f" ({dt*1e3:.1f} ms/step avg)")
        if mgr is not None:
            mgr.maybe_save(step, state)
        if eval_fn is not None and step % cfg.log_every == 0:
            eval_fn(step, state)
    if mgr is not None:
        # final durable state regardless of cadence
        ckpt_lib.save(cfg.ckpt_dir, cfg.total_steps, state)
        ckpt_lib.gc_old(cfg.ckpt_dir, cfg.keep_last)
    return state
