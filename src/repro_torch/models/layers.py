"""Model building blocks: layer norm, attention, MLP.

Twin of the parts of ``repro/models/layers.py`` that the recsys towers
use. Attention comes only as ``naive`` here (it materializes the (S, S)
scores, as the SASRec tower does in the reference); the chunked and
flash-kernel paths of the LM towers join with their slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(dt)


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, Hkv*n_rep, hd)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def naive_attention(q, k, v, *, causal: bool, q_offset: int = 0
                    ) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd). float32 scores and
    softmax, output in q's dtype."""
    n_rep = q.shape[2] // k.shape[2]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        qi = torch.arange(q.shape[1], device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where((ki <= qi)[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        v.to(torch.float32)).to(q.dtype)


def attention(q, k, v, *, causal: bool, q_offset: int = 0,
              impl: str = "naive") -> torch.Tensor:
    if impl != "naive":
        raise ValueError(f"attention impl {impl!r} is not ported yet "
                         "(only 'naive')")
    return naive_attention(q, k, v, causal=causal, q_offset=q_offset)


def mlp(x, ws, bs, act=F.relu):
    """Plain MLP stack for recsys towers: ws/bs lists."""
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = x @ w + b
        if i < len(ws) - 1:
            x = act(x)
    return x
