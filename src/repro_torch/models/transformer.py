"""LLaMA-family decoder LM: an ERCache user tower, and its prefill/decode.

Twin of the serving part of ``repro/models/transformer.py``: token
embedding, ``n_layers`` pre-norm decoder layers (RMSNorm, GQA attention with
RoPE, SwiGLU FFN), a final RMSNorm, then either the mean-pooled hidden state
through a projection head (the (B, user_embed_dim) representation ERCache
stores; paper ref [24], Scaling User Modeling) or the unembedding to
next-token logits (generation: :func:`prefill_step` fills a
:class:`KVCache`, :func:`decode_step` appends one token per call).

The reference's stacked ``(L, ...)`` layer pytree and ``lax.scan`` become an
``nn.ModuleList`` walked by a Python loop (remat has no meaning without a
backward pass). Weights keep the reference's (in, out) layout, so every
projection is ``x @ w``. Attention follows ``cfg.attn_impl`` through
``layers.attention``: with ``"flash_kernel"`` and more than 2**20 query-key
pairs it runs the hand-written ``flash_attention`` kernel (``backend="cuda"``)
or its plain version (``backend="torch"``). A decode step attends through
the hand-written ``decode_attention`` kernel (``backend="cuda"``) or the
reference's ``collectives.decode_attention_local`` (``backend="torch"``).

Dense configs only: the MoE FFN, ``lm_loss`` and the training step join
with later slices.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

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

    def forward(self, x, cos, sin, cfg: LMConfig, backend: str,
                kv_out=None):
        """x (B, T, D) -> (B, T, D). With ``kv_out`` = (k, v) buffers of
        shape (B, >= T, Hkv, hd), the post-RoPE k and the v of the T
        positions are written into their first T rows."""
        B, T, _ = x.shape
        Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        h = L.rms_norm(x, self.attn_norm, cfg.norm_eps)
        q = L.apply_rope((h @ self.wq).reshape(B, T, Hq, hd), cos, sin)
        k = L.apply_rope((h @ self.wk).reshape(B, T, Hkv, hd), cos, sin)
        v = (h @ self.wv).reshape(B, T, Hkv, hd)
        if kv_out is not None:
            kv_out[0][:, :T] = k
            kv_out[1][:, :T] = v
        o = L.attention(q, k, v, causal=True, impl=cfg.attn_impl,
                        kv_chunk=cfg.kv_chunk, backend=backend)
        x = x + o.reshape(B, T, Hq * hd) @ self.wo
        h2 = L.rms_norm(x, self.ffn_norm, cfg.norm_eps)
        return x + L.swiglu(h2, self.wg, self.wu, self.wd)


class LMTower(nn.Module):
    """Embedding, decoder layers, final norm, user head and unembedding.
    Parameters are frozen (serving)."""

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
        self.unembed = _param((cfg.d_model, cfg.vocab), dt, device)


def init_params(generator: torch.Generator, cfg: LMConfig,
                device="cuda") -> LMTower:
    """Random weights with the reference's shapes and scales
    (``transformer.py:init_params``): embedding N(0, 0.02^2), projections
    N(0, 1/fan_in), user head and unembedding N(0, 1/d_model), norms 1;
    drawn in float32 on the generator's device, cast to ``cfg.dtype`` on
    ``device``. The unembedding is drawn last, so the tower's weights are
    those of a generator that draws no unembedding."""
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
        fill(model.unembed, cfg.d_model ** -0.5)
    return model


def load_jax_params(np_tree: Dict, cfg: LMConfig, device="cuda") -> LMTower:
    """The reference's parameter pytree (numpy leaves, stacked ``(L, ...)``
    layers) as the port's module, so both packages compute the same tower.
    Leaves go through float32 (numpy has no bfloat16), which is lossless
    for bfloat16 weights."""
    from repro_torch.core.cache import resolve_device

    device = resolve_device(device)
    model = LMTower(cfg, device)

    def put(p, arr):
        p.copy_(torch.tensor(np.asarray(arr, np.float32)).to(
            device=device, dtype=p.dtype))

    with torch.no_grad():
        for name in ("embed", "final_norm", "user_head", "unembed"):
            put(getattr(model, name), np_tree[name])
        for i, layer in enumerate(model.layers):
            for name in layer_param_shapes(cfg):
                put(getattr(layer, name), np_tree["layers"][name][i])
    return model


def _forward(params: LMTower, tokens: torch.Tensor, cfg: LMConfig,
             backend: str, kv_out=None) -> torch.Tensor:
    """The layers over tokens (B, S); with ``kv_out`` = (k, v) stacked
    (L, B, >= S, Hkv, hd) buffers, layer i writes its k and v into
    ``kv_out[.][i, :, :S]`` (no second copy of the cache)."""
    S = tokens.shape[1]
    x = params.embed[tokens.long()]
    cos, sin = L.rope_tables(torch.arange(S, device=tokens.device), cfg.hd,
                             cfg.rope_theta)
    for i, layer in enumerate(params.layers):
        x = layer(x, cos, sin, cfg, backend,
                  None if kv_out is None else (kv_out[0][i], kv_out[1][i]))
    return L.rms_norm(x, params.final_norm, cfg.norm_eps)


def forward_hidden(params: LMTower, tokens: torch.Tensor, cfg: LMConfig,
                   backend: str = "cuda", collect_kv: bool = False):
    """tokens (B, S) -> final hidden (B, S, D): a plain embedding take, the
    layers in order, the final RMSNorm. With ``collect_kv`` returns
    ``(x, (k, v))``, k and v the stacked (L, B, S, Hkv, hd) post-RoPE keys
    and values (the reference returns them beside its MoE aux loss)."""
    if not collect_kv:
        return _forward(params, tokens, cfg, backend)
    kv = _kv_buffers(cfg, tokens.shape[0], tokens.shape[1], tokens.device,
                     torch.empty)
    return _forward(params, tokens, cfg, backend, kv), kv


def logits_from_hidden(params: LMTower, x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> next-token logits (..., vocab) in the weights' dtype."""
    return x @ params.unembed


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
    _check_backend(backend, tokens, params.embed)
    with torch.no_grad():
        return user_embedding_from_hidden(
            params, forward_hidden(params, tokens, cfg, backend))


def _check_backend(backend: str, *tensors) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "cuda" and not all(t.is_cuda for t in tensors):
        raise ValueError("backend='cuda' runs the CUDA kernels and needs "
                         "CUDA tensors; use backend='torch' on the CPU")


# ------------------------------------------------------------------- decode
class KVCache(NamedTuple):
    k: torch.Tensor        # (L, B, S, Hkv, hd)
    v: torch.Tensor        # (L, B, S, Hkv, hd)
    length: torch.Tensor   # (B,) int32: valid prefix length


def _kv_buffers(cfg: LMConfig, batch: int, max_seq: int, device, alloc
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return (alloc(shape, dtype=_dtype(cfg), device=device),
            alloc(shape, dtype=_dtype(cfg), device=device))


def init_kv_cache(cfg: LMConfig, batch: int, max_seq: int,
                  device="cuda") -> KVCache:
    """An empty cache of ``max_seq`` positions: zeros, length 0."""
    from repro_torch.core.cache import resolve_device

    device = resolve_device(device)
    k, v = _kv_buffers(cfg, batch, max_seq, device, torch.zeros)
    return KVCache(k, v, torch.zeros((batch,), dtype=torch.int32,
                                     device=device))


def prefill_step(params: LMTower, tokens: torch.Tensor, cfg: LMConfig,
                 backend: str = "cuda", max_seq: Optional[int] = None
                 ) -> Tuple[torch.Tensor, KVCache]:
    """tokens (B, S) -> (last-position logits (B, vocab), the filled
    KVCache of length S). The cache holds ``max_seq`` positions (default
    S; the rest zeros, as the reference's padded cache), written layer by
    layer during the forward."""
    _check_backend(backend, tokens, params.embed)
    B, S = tokens.shape
    max_seq = S if max_seq is None else max_seq
    if max_seq < S:
        raise ValueError(f"max_seq={max_seq} is shorter than the prompt {S}")
    with torch.no_grad():
        k, v = _kv_buffers(cfg, B, max_seq, tokens.device,
                           torch.zeros if max_seq > S else torch.empty)
        x = _forward(params, tokens, cfg, backend, (k, v))
        logits = logits_from_hidden(params, x[:, -1])
    return logits, KVCache(k, v, torch.full((B,), S, dtype=torch.int32,
                                            device=tokens.device))


def decode_step(params: LMTower, cache: KVCache, tokens: torch.Tensor,
                cfg: LMConfig, backend: str = "cuda"
                ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step: tokens (B,) at positions ``cache.length`` ->
    (logits (B, vocab), the cache with length + 1).

    Each layer writes its new k and v at row ``length[b]`` of the cache IN
    PLACE (the returned cache shares the given one's tensors; clone first
    to keep a before-image) and attends with ``valid = length + 1``. A row
    whose position is past the cache (``length >= S``) writes nothing, as
    JAX drops an out-of-range ``.at[].set``; it still attends to all S
    positions. ``backend="cuda"`` attends with the hand-written
    ``decode_attention`` kernel and needs CUDA tensors; ``"torch"`` with
    ``collectives.decode_attention_local`` on any device."""
    from repro_torch.distributed.collectives import decode_attention_local
    from repro_torch.kernels.decode_attention import decode_attention

    _check_backend(backend, tokens, params.embed, cache.k, cache.v,
                   cache.length)
    B = tokens.shape[0]
    S = cache.k.shape[2]
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pos = cache.length
    valid = pos + 1
    # rows past the cache rewrite row S-1 with its own old value (no sync)
    rows = torch.arange(B, device=pos.device)
    at = pos.clamp(max=S - 1).long()
    keep = (pos < S)[:, None, None]
    with torch.no_grad():
        x = params.embed[tokens.long()]                         # (B, D)
        # (B, hd/2) tables: apply_rope on (B, H, hd) is the reference's
        # _rope_single (one position per row, broadcast over heads)
        cos, sin = L.rope_tables(pos, hd, cfg.rope_theta)
        for i, layer in enumerate(params.layers):
            h = L.rms_norm(x, layer.attn_norm, cfg.norm_eps)
            q = L.apply_rope((h @ layer.wq).reshape(B, Hq, hd), cos, sin)
            k = L.apply_rope((h @ layer.wk).reshape(B, Hkv, hd), cos, sin)
            v = (h @ layer.wv).reshape(B, Hkv, hd)
            kc, vc = cache.k[i], cache.v[i]
            kc[rows, at] = torch.where(keep, k.to(kc.dtype), kc[rows, at])
            vc[rows, at] = torch.where(keep, v.to(vc.dtype), vc[rows, at])
            if backend == "cuda":
                o = decode_attention(q, kc, vc, valid)
            else:
                o = decode_attention_local(q, kc, vc, kv_valid_len=valid)
            x = x + o.reshape(B, Hq * hd) @ layer.wo
            h2 = L.rms_norm(x, layer.ffn_norm, cfg.norm_eps)
            x = x + L.swiglu(h2, layer.wg, layer.wu, layer.wd)
        x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
        logits = logits_from_hidden(params, x)
    return logits, KVCache(cache.k, cache.v, cache.length + 1)
