"""Causal GQA flash attention (FA-2 online softmax) as a CUDA kernel.

Twin of ``repro/kernels/flash_attention.py`` (source
``csrc/flash_attention.cu``): q (B, Sq, Hq, hd) and k, v (B, Sk, Hkv, hd)
in float32 or bfloat16, query head h reading KV head h // n_rep, q scaled
by hd**-0.5 in float32 before the product, masked scores -1e30, blocks
wholly above the diagonal skipped, the softmax state in float32 and the
output ``acc / max(l, 1e-30)`` in q's dtype. ``q_offset`` is the absolute
position of q[0] (chunked prefill).

On a CPU tensor the wrapper runs ``ref.flash_attention_ref``; on a CUDA
tensor it launches the kernel (counted in :data:`LAUNCHES`) or raises.
Both refuse what the reference refuses: ``Sq`` and ``Sk`` must be
multiples of ``min(128, S)`` (its block assert).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"flash_attention": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 64, 128)          # the kernel's template widths
BLOCK = 128                           # the reference's bq = bk


def _entry():
    lib = build.load("flash_attention")
    fn = lib.ercache_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def check_shapes(q, k, v, q_offset: int) -> None:
    """Raise ValueError on what the reference kernel refuses or cannot
    mean: mismatched ranks or widths, Hq not a multiple of Hkv, ``Sq`` or
    ``Sk`` not a multiple of ``min(128, S)``, a negative ``q_offset``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, Sq, Hq, hd) and k, v (B, Sk, Hkv, hd),"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "form a GQA group")
    if Sq == 0 or Sk == 0 or Sq % min(BLOCK, Sq) or Sk % min(BLOCK, Sk):
        raise ValueError(f"Sq={Sq}, Sk={Sk}: each must be a multiple of "
                         f"min({BLOCK}, S), as the reference's blocks")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, Hq, hd); k, v (B, Sk, Hkv, hd) -> (B, Sq, Hq, hd)."""
    check_shapes(q, k, v, q_offset)
    if not (q.is_cuda or k.is_cuda or v.is_cuda):
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_offset)
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"need one dtype of {list(_DTYPE_CODES)} for q, k "
                         f"and v, got {q.dtype}, {k.dtype}, {v.dtype}")
    hd = q.shape[3]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in the kernel's {HEAD_DIMS}")
    for t in (q, k, v):
        if (t.device != q.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("q, k and v must be contiguous, 16-byte "
                             "aligned and on one device")
    B, Sq, Hq, _ = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib, fn = _entry()
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
              Sq, Sk, Hq, Hkv, hd, int(causal), int(q_offset), hd ** -0.5,
              _DTYPE_CODES[q.dtype],
              torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "ercache_flash_attention_strerror", code,
                "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
