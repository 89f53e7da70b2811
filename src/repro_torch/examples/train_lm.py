"""End-to-end LM training example: trains a ~100M-parameter LLaMA-family
model with the whole substrate (AdamW + cosine schedule, a microbatched
train step, checkpoint/resume), on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]

Twin of ``examples/train_lm.py``: 12L x d512 x 8H (kv4) x ffn1536 x
vocab32000, float32, two microbatches. Checkpoints go to ``--ckpt-dir``
(default: ``repro_torch_lm_ckpt`` in the temporary directory); a rerun
resumes from the newest one.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.core.cache import resolve_device
from repro_torch.launch.train import lm_batches, lm_train_state
from repro_torch.models import transformer as tfm
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train_loop import LoopConfig, run_train_loop


def llama_100m_config():
    return dataclasses.replace(
        get_config("tinyllama-1.1b"),
        arch_id="llama-100m", n_layers=12, d_model=512, n_heads=8,
        n_kv_heads=4, d_ff=1536, vocab=32000, dtype="float32",
        microbatches=2, user_embed_dim=64)


def main(argv=None, log_fn=print):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = llama_100m_config()
    log_fn(f"[train_lm] {cfg.arch_id}: {cfg.param_count()/1e6:.0f}M params")
    opt = opt_lib.for_config(cfg, total_steps=args.steps)
    state = run_train_loop(
        tfm.make_train_step(cfg, opt), lm_train_state(cfg, opt, device),
        lm_batches(cfg, args.batch, args.seq, device=device),
        LoopConfig(total_steps=args.steps, log_every=20, ckpt_every=100,
                   ckpt_dir=args.ckpt_dir),
        log_fn=log_fn)
    log_fn("[train_lm] done — rerun to resume from the checkpoint")
    return state


if __name__ == "__main__":
    main()
