"""RecSys towers, the ERCache-native family: SASRec so far.

Twin of ``repro/models/recsys.py`` (its SASRec tower; Wide&Deep, BST and
MIND join with their slice). The hot path is the sparse embedding lookup:
on the card the tower's item gather runs the hand-written
``embedding_bag`` kernel (``kernels/embedding_bag.py``), the
"TPU-target implementation" the reference names for it.

The ERCache tower contract is kept as a plain function:
    ``tower_step(params, inputs, cfg, impl) -> (B, cfg.user_embed_dim)``
where ``params`` is the tower's ``nn.Module``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels import ref
from repro_torch.models import layers as L

IMPLS = ("torch", "cuda")


# ---------------------------------------------------------------- embedding
def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mode: str = "sum",
                  impl: str = "cuda") -> torch.Tensor:
    """table (V, D); ids (..., nnz), -1 = padding -> (..., D).

    The leading dims of ``ids`` are flattened into bags before the call
    (the kernel takes 2-D ids). ``impl="cuda"`` launches the kernel and
    needs CUDA tensors; ``"torch"`` runs its plain version anywhere.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    lead, nnz = ids.shape[:-1], ids.shape[-1]
    flat = ids.reshape(-1, nnz).to(torch.int32).contiguous()
    if impl == "cuda":
        if not (flat.is_cuda and table.is_cuda):
            raise ValueError("impl='cuda' runs the CUDA kernel and needs "
                             "CUDA tensors; use impl='torch' on the CPU")
        from repro_torch.kernels import embedding_bag as bag_kernel

        out = bag_kernel.embedding_bag(table, flat, mode=mode)
    else:
        out = ref.embedding_bag_ref(table, flat, mode=mode)
    return out.reshape(*lead, table.shape[1])


# ==================================================================== sasrec
class SASRecBlock(nn.Module):
    """Pre-LN block: single-matrix MHA + pointwise FFN."""

    def __init__(self, d: int, d_ff: Optional[int] = None, device=None):
        super().__init__()
        d_ff = d_ff or d
        p = lambda *s: nn.Parameter(torch.empty(s, device=device),
                                    requires_grad=False)
        self.wq, self.wk, self.wv, self.wo = p(d, d), p(d, d), p(d, d), \
            p(d, d)
        self.w1, self.b1, self.w2, self.b2 = p(d, d_ff), p(d_ff), \
            p(d_ff, d), p(d)
        self.ln1_w, self.ln1_b, self.ln2_w, self.ln2_b = p(d), p(d), p(d), \
            p(d)

    def forward(self, x: torch.Tensor, n_heads: int) -> torch.Tensor:
        B, S, D = x.shape
        hd = D // n_heads
        h = L.layer_norm(x, self.ln1_w, self.ln1_b)
        q = (h @ self.wq).reshape(B, S, n_heads, hd)
        k = (h @ self.wk).reshape(B, S, n_heads, hd)
        v = (h @ self.wv).reshape(B, S, n_heads, hd)
        o = L.attention(q, k, v, causal=True, impl="naive")
        x = x + o.reshape(B, S, D) @ self.wo
        h2 = L.layer_norm(x, self.ln2_w, self.ln2_b)
        return x + F.relu(h2 @ self.w1 + self.b1) @ self.w2 + self.b2


class SASRec(nn.Module):
    """SASRec user tower: item + position embeddings, causal self-attention
    blocks, final layer norm; the last position is the user embedding.
    Parameters are frozen (serving)."""

    def __init__(self, vocab: int, seq_len: int, d: int, n_blocks: int,
                 device=None):
        super().__init__()
        p = lambda *s: nn.Parameter(torch.empty(s, device=device),
                                    requires_grad=False)
        self.item_emb = p(vocab, d)
        self.pos_emb = p(seq_len, d)
        self.blocks = nn.ModuleList(SASRecBlock(d, device=device)
                                    for _ in range(n_blocks))
        self.ln_w, self.ln_b = p(d), p(d)

    def forward(self, seq: torch.Tensor, cfg: RecsysConfig,
                impl: str = "cuda") -> torch.Tensor:
        """seq (B, S) item ids (-1 pad) -> (B, D)."""
        x = embedding_bag(self.item_emb, seq[..., None], impl=impl)
        x = x + self.pos_emb[None, :seq.shape[1]]
        x = torch.where((seq >= 0)[..., None], x, 0.0)
        for blk in self.blocks:
            x = blk(x, cfg.n_heads)
        x = L.layer_norm(x, self.ln_w, self.ln_b)
        return x[:, -1]


def _sasrec_module(cfg: RecsysConfig, device) -> SASRec:
    return SASRec(cfg.vocab, cfg.seq_len, cfg.embed_dim, cfg.n_blocks,
                  device=device)


def init_params(generator: torch.Generator, cfg: RecsysConfig,
                device="cuda") -> SASRec:
    """Random SASRec weights with the reference's shapes and scales
    (``recsys.py:init_sasrec``): embeddings N(0, 0.01^2), projections
    N(0, 1/fan_in), biases 0, norms (1, 0). Drawn on the generator's
    device, then moved to ``device``."""
    if not cfg.arch_id.startswith("sasrec"):
        raise ValueError(f"arch {cfg.arch_id!r} is not ported yet")
    from repro_torch.core.cache import resolve_device

    device = resolve_device(device)
    model = _sasrec_module(cfg, device)
    gdev = generator.device

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=gdev)
                * scale).to(device)

    with torch.no_grad():
        model.item_emb.copy_(normal(model.item_emb.shape, 0.01))
        model.pos_emb.copy_(normal(model.pos_emb.shape, 0.01))
        for blk in model.blocks:
            for name in ("wq", "wk", "wv", "wo", "w1", "w2"):
                w = getattr(blk, name)
                w.copy_(normal(w.shape, w.shape[0] ** -0.5))
            for name in ("b1", "b2", "ln1_b", "ln2_b"):
                getattr(blk, name).zero_()
            blk.ln1_w.fill_(1.0)
            blk.ln2_w.fill_(1.0)
        model.ln_w.fill_(1.0)
        model.ln_b.zero_()
    return model


def load_jax_params(np_tree: Dict, device="cuda") -> SASRec:
    """The JAX package's SASRec parameter pytree (as numpy arrays) as the
    port's module, so both packages compute the same tower."""
    from repro_torch.core.cache import resolve_device

    device = resolve_device(device)
    vocab, d = np.shape(np_tree["item_emb"])
    model = SASRec(vocab, np.shape(np_tree["pos_emb"])[0], d,
                   len(np_tree["blocks"]), device=device)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    with torch.no_grad():
        model.item_emb.copy_(t(np_tree["item_emb"]))
        model.pos_emb.copy_(t(np_tree["pos_emb"]))
        model.ln_w.copy_(t(np_tree["ln_w"]))
        model.ln_b.copy_(t(np_tree["ln_b"]))
        for blk, bp in zip(model.blocks, np_tree["blocks"]):
            for name, arr in bp.items():
                getattr(blk, name).copy_(t(arr))
    return model


def tower_step(params: SASRec, inputs: Dict[str, torch.Tensor],
               cfg: RecsysConfig, impl: str = "cuda") -> torch.Tensor:
    """The ERCache tower contract: ``inputs["seq"]`` (B, S) -> (B, D)."""
    with torch.no_grad():
        return params(inputs["seq"], cfg, impl=impl)
