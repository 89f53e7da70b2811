"""Causal GQA flash attention (FA-2 online softmax) as a CUDA kernel.

Twin of ``repro/kernels/flash_attention.py`` (source
``csrc/flash_attention.cu``): q and k (B, S, H, hd), v (B, Sk, Hkv, hd_v)
in float32 or bfloat16, query head h reading KV head h // n_rep, q scaled
by hd**-0.5 (q's width) in float32 before the product, masked scores
-1e30, blocks wholly above the diagonal skipped, the softmax state in
float32 and the output (B, Sq, Hq, hd_v) ``acc / max(l, 1e-30)`` in q's
dtype. ``q_offset`` is the absolute position of q[0] (chunked prefill).
The kernel takes the (hd, hd_v) pairs of :data:`HEAD_DIMS`: one width for
q, k and v (the reference's kernel) in both dtypes, and MLA's 192-wide q
and k over a 128-wide v in bfloat16 (the port's, no counterpart in the
reference); the plain version takes any v no wider than q.

On a CPU tensor the wrapper runs ``ref.flash_attention_ref``; on a CUDA
tensor it launches the kernel (counted in :data:`LAUNCHES`) or raises;
either way it refuses inputs that need a gradient while autograd records.
Both refuse what the reference refuses: ``Sq`` and ``Sk`` must be
multiples of ``min(128, S)`` (its block assert).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"flash_attention": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's (q and k width, v width) template pairs; (192, 128) in
# bfloat16 only (the tensor-core body; the float32 body has one width)
HEAD_DIMS = ((8, 8), (16, 16), (64, 64), (128, 128), (192, 128))
_BF16_ONLY = ((192, 128),)
BLOCK = 128                           # the reference's bq = bk


def _entry():
    lib = build.load("flash_attention")
    fn = lib.ercache_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def check_shapes(q, k, v, q_offset: int) -> None:
    """Raise ValueError on what the reference kernel refuses or cannot
    mean: mismatched ranks or widths (a v wider than q and k), Hq not a
    multiple of Hkv, ``Sq`` or ``Sk`` not a multiple of ``min(128, S)``, a
    negative ``q_offset``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3] or v.shape[3] > k.shape[3]:
        raise ValueError(f"need q (B, Sq, Hq, hd), k (B, Sk, Hkv, hd) and v "
                         f"(B, Sk, Hkv, hd_v <= hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
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
    """q (B, Sq, Hq, hd); k (B, Sk, Hkv, hd), v (B, Sk, Hkv, hd_v) ->
    (B, Sq, Hq, hd_v). Inputs that need a gradient raise (the kernel has
    no backward)."""
    build.refuse_grad("flash_attention", "ref.flash_attention_ref", q, k, v)
    check_shapes(q, k, v, q_offset)
    if not (q.is_cuda or k.is_cuda or v.is_cuda):
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_offset)
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"need one dtype of {list(_DTYPE_CODES)} for q, k "
                         f"and v, got {q.dtype}, {k.dtype}, {v.dtype}")
    hd, hd_v = q.shape[3], v.shape[3]
    if (hd, hd_v) not in HEAD_DIMS or (
            (hd, hd_v) in _BF16_ONLY and q.dtype != torch.bfloat16):
        raise ValueError(f"(q/k, v) widths {(hd, hd_v)} in {q.dtype} are not "
                         f"among the kernel's {HEAD_DIMS} ({_BF16_ONLY} "
                         "bfloat16 only)")
    for t in (q, k, v):
        if (t.device != q.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("q, k and v must be contiguous, 16-byte "
                             "aligned and on one device")
    B, Sq, Hq, _ = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = q.new_empty((B, Sq, Hq, hd_v))
    if B == 0:
        return out
    lib, fn = _entry()
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
              Sq, Sk, Hq, Hkv, hd, hd_v, int(causal), int(q_offset),
              hd ** -0.5,
              _DTYPE_CODES[q.dtype],
              torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "ercache_flash_attention_strerror", code,
                "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
