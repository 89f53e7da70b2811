"""LLaMA-family decoder LM as an ERCache user tower.

Twin of the user-tower part of ``repro/models/transformer.py``: token
embedding, ``n_layers`` pre-norm decoder layers (RMSNorm, GQA attention with
RoPE, SwiGLU FFN), a final RMSNorm, then the mean-pooled hidden state
through a projection head. The (B, user_embed_dim) result is the
representation ERCache stores (paper ref [24], Scaling User Modeling).

The reference's stacked ``(L, ...)`` layer pytree and ``lax.scan`` become an
``nn.ModuleList`` walked by a Python loop (remat has no meaning without a
backward pass). Weights keep the reference's (in, out) layout, so every
projection is ``x @ w``. Attention follows ``cfg.attn_impl`` through
``layers.attention``: with ``"flash_kernel"`` and more than 2**20 query-key
pairs it runs the hand-written ``flash_attention`` kernel (``backend="cuda"``)
or its plain version (``backend="torch"``).

Dense configs only: the MoE FFN, the unembedding, training, prefill and
decode steps (and their KV cache) join with later slices.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.models import layers as L

BACKENDS = ("torch", "cuda")


def _dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def layer_param_shapes(cfg: LMConfig) -> Dict[str, tuple]:
    """name -> shape of one dense decoder layer (the reference's names)."""
    D, F = cfg.d_model, cfg.d_ff
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"attn_norm": (D,), "wq": (D, Hq * hd), "wk": (D, Hkv * hd),
            "wv": (D, Hkv * hd), "wo": (Hq * hd, D), "ffn_norm": (D,),
            "wg": (D, F), "wu": (D, F), "wd": (F, D)}


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class DecoderLayer(nn.Module):
    """One pre-norm layer: x + attn(norm(x)), then + swiglu(norm(x))."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        for name, shape in layer_param_shapes(cfg).items():
            setattr(self, name, _param(shape, _dtype(cfg), device))

    def forward(self, x, cos, sin, cfg: LMConfig, backend: str):
        B, T, _ = x.shape
        Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        h = L.rms_norm(x, self.attn_norm, cfg.norm_eps)
        q = L.apply_rope((h @ self.wq).reshape(B, T, Hq, hd), cos, sin)
        k = L.apply_rope((h @ self.wk).reshape(B, T, Hkv, hd), cos, sin)
        v = (h @ self.wv).reshape(B, T, Hkv, hd)
        o = L.attention(q, k, v, causal=True, impl=cfg.attn_impl,
                        kv_chunk=cfg.kv_chunk, backend=backend)
        x = x + o.reshape(B, T, Hq * hd) @ self.wo
        h2 = L.rms_norm(x, self.ffn_norm, cfg.norm_eps)
        return x + L.swiglu(h2, self.wg, self.wu, self.wd)


class LMTower(nn.Module):
    """Embedding, decoder layers, final norm and user head. Parameters are
    frozen (serving)."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        if cfg.moe is not None:
            raise ValueError(f"{cfg.arch_id}: the MoE FFN is not ported yet")
        dt = _dtype(cfg)
        self.embed = _param((cfg.vocab, cfg.d_model), dt, device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _param((cfg.d_model,), dt, device)
        self.user_head = _param((cfg.d_model, cfg.user_embed_dim), dt, device)


def init_params(generator: torch.Generator, cfg: LMConfig,
                device="cuda") -> LMTower:
    """Random weights with the reference's shapes and scales
    (``transformer.py:init_params``): embedding N(0, 0.02^2), projections
    N(0, 1/fan_in), user head N(0, 1/d_model), norms 1; drawn in float32
    on the generator's device, cast to ``cfg.dtype`` on ``device``."""
    from repro_torch.core.cache import resolve_device

    device = resolve_device(device)
    model = LMTower(cfg, device)
    gdev = generator.device

    def fill(p, scale):
        p.copy_((torch.randn(p.shape, generator=generator, device=gdev)
                 * scale).to(device=device, dtype=p.dtype))

    with torch.no_grad():
        fill(model.embed, 0.02)
        fill(model.user_head, cfg.d_model ** -0.5)
        model.final_norm.fill_(1.0)
        for layer in model.layers:
            for name, p in layer.named_parameters():
                if p.dim() == 1:
                    p.fill_(1.0)
                else:
                    fill(p, p.shape[0] ** -0.5)
    return model


def load_jax_params(np_tree: Dict, cfg: LMConfig, device="cuda") -> LMTower:
    """The reference's parameter pytree (numpy leaves, stacked ``(L, ...)``
    layers) as the port's module, so both packages compute the same tower.
    Leaves go through float32 (numpy has no bfloat16), which is lossless
    for bfloat16 weights. ``unembed`` is not part of the tower."""
    from repro_torch.core.cache import resolve_device

    device = resolve_device(device)
    model = LMTower(cfg, device)

    def put(p, arr):
        p.copy_(torch.tensor(np.asarray(arr, np.float32)).to(
            device=device, dtype=p.dtype))

    with torch.no_grad():
        for name in ("embed", "final_norm", "user_head"):
            put(getattr(model, name), np_tree[name])
        for i, layer in enumerate(model.layers):
            for name in layer_param_shapes(cfg):
                put(getattr(layer, name), np_tree["layers"][name][i])
    return model


def forward_hidden(params: LMTower, tokens: torch.Tensor, cfg: LMConfig,
                   backend: str = "cuda") -> torch.Tensor:
    """tokens (B, S) -> final hidden (B, S, D): a plain embedding take, the
    layers in order, the final RMSNorm."""
    S = tokens.shape[1]
    x = params.embed[tokens.long()]
    cos, sin = L.rope_tables(torch.arange(S, device=tokens.device), cfg.hd,
                             cfg.rope_theta)
    for layer in params.layers:
        x = layer(x, cos, sin, cfg, backend)
    return L.rms_norm(x, params.final_norm, cfg.norm_eps)


def user_embedding_from_hidden(params: LMTower, x: torch.Tensor
                               ) -> torch.Tensor:
    """Mean-pool over the sequence (reduced in float32, as XLA reduces a
    bfloat16 mean) -> user head: the ERCache-cached representation."""
    pooled = x.to(torch.float32).mean(dim=1).to(x.dtype)
    return pooled @ params.user_head


def user_tower_step(params: LMTower, tokens: torch.Tensor, cfg: LMConfig,
                    backend: str = "cuda") -> torch.Tensor:
    """The LM as an ERCache user tower: tokens (B, S) -> (B,
    user_embed_dim). ``backend="cuda"`` runs the flash kernel and needs
    CUDA tensors; ``"torch"`` runs its plain version on any device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "cuda" and not (tokens.is_cuda and params.embed.is_cuda):
        raise ValueError("backend='cuda' runs the CUDA kernel and needs "
                         "CUDA tensors; use backend='torch' on the CPU")
    with torch.no_grad():
        return user_embedding_from_hidden(
            params, forward_hidden(params, tokens, cfg, backend))
