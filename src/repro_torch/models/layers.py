"""Model building blocks: norms, RoPE, GQA attention, FFNs.

Twin of ``repro/models/layers.py``. Attention ships in the reference's
three interchangeable implementations, picked by :func:`attention`:

  * ``naive``        materializes the (Sq, Sk) scores;
  * ``chunked``      online softmax over KV chunks (a Python loop in place
                     of ``lax.scan``);
  * ``flash_kernel`` the hand-written CUDA ``flash_attention`` kernel
                     (``kernels/flash_attention.py``) on CUDA tensors, its
                     plain version on CPU tensors.

As in the reference, every shape with ``Sq * Sk <= 2**20`` takes the naive
path whatever the implementation asked for.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
ATTN_IMPLS = ("naive", "chunked", "flash_kernel")


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """In float32, cast back to x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.to(torch.float32)).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(dt)


# -------------------------------------------------------------------- RoPE
def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 cos/sin tables for integer positions; shape (..., hd/2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (..., S, hd/2) broadcast over heads.
    The tables are cast to x's dtype BEFORE the products, as the
    reference does (in bf16 that rounds differently from fp32-then-cast)."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


# --------------------------------------------------------------- attention
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


def chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online softmax over KV chunks; never materializes (Sq, Sk). Peak
    extra memory is (B, Hq, Sq, kv_chunk) float32. A ragged ``Sk`` (not a
    multiple of ``kv_chunk``) falls back to one chunk, as the reference."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    n_rep = Hq // Hkv
    if Sk % kv_chunk != 0:
        kv_chunk = Sk
    scale = hd ** -0.5
    qf = q.to(torch.float32)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    m = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hq, Sq, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, Sk, kv_chunk):
        kc = repeat_kv(k[:, k0:k0 + kv_chunk], n_rep).to(torch.float32)
        vc = repeat_kv(v[:, k0:k0 + kv_chunk], n_rep).to(torch.float32)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc) * scale
        if causal:
            kpos = k0 + torch.arange(kv_chunk, device=q.device)
            s = torch.where((kpos[None, :] <= q_pos[:, None])[None, None], s,
                            NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)                # (B, Sq, Hq, hd)


def attention(q, k, v, *, causal: bool, q_offset: int = 0,
              impl: str = "chunked", kv_chunk: int = 1024,
              backend: str = "cuda") -> torch.Tensor:
    """The reference's dispatch (``layers.py:139-150``): shapes with
    ``Sq * Sk <= 2**20`` take the naive path whatever ``impl`` says.
    ``impl="flash_kernel"`` runs the hand-written kernel with
    ``backend="cuda"`` (its plain version on CPU tensors) and the kernel's
    plain version (``ref.flash_attention_ref``) with ``backend="torch"``
    on any device."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attention impl must be one of {ATTN_IMPLS}, "
                         f"got {impl!r}")
    if backend not in ("torch", "cuda"):
        raise ValueError(f"backend must be 'torch' or 'cuda', got "
                         f"{backend!r}")
    if impl == "naive" or q.shape[1] * k.shape[1] <= 1 << 20:
        return naive_attention(q, k, v, causal=causal, q_offset=q_offset)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                                 kv_chunk=kv_chunk)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    if backend == "torch":
        fa.check_shapes(q, k, v, q_offset)
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_offset)
    return fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)


# -------------------------------------------------------------------- FFN
def swiglu(x, w_gate, w_up, w_down):
    """LLaMA-style gated FFN: silu(x Wg) * (x Wu) Wd."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def mlp(x, ws, bs, act=F.relu):
    """Plain MLP stack for recsys towers: ws/bs lists."""
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = x @ w + b
        if i < len(ws) - 1:
            x = act(x)
    return x
