"""Flash-decode of one query token against a KV cache, as a CUDA kernel.

Twin of ``repro/kernels/decode_attention.py`` (source
``csrc/decode_attention.cu``): q (B, Hq, hd) and k, v (B, S, Hkv, hd) in
float32 or bfloat16, query head h reading KV head h // n_rep, positions at
and after ``valid_len[b]`` masked (scores -1e30), q scaled by hd**-0.5 in
float32, the softmax state in float32 and the output
``acc / max(l, 1e-30)`` in q's dtype. A row with ``valid_len <= 0`` gives
zeros, as the Pallas kernel (it skips every block).

``bs`` is the reference's block size and a contract, not the kernel's
tile: the wrapper refuses what the reference refuses (``S`` not a multiple
of ``min(bs, S)``), and the result does not depend on it beyond float
order.

The kernel splits each row's keys across CTAs (:func:`split_plan`) and,
with more than one split, merges the splits' float32 partials in a second
small kernel; ``ref.decode_attention_split_ref`` is that computation in
plain torch. A wrapper call counts one launch whatever the number of device
kernels it runs.

On a CPU tensor the wrapper runs ``ref.decode_attention_ref``; on a CUDA
tensor it launches the kernel (counted in :data:`LAUNCHES`) or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"decode_attention": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 64, 128)          # the kernel's template widths
BLOCK = 512                           # the reference's default bs
TILE = 64                             # split granularity (the kernel kTile)
SPLIT_MAX = 4096                      # keys one CTA walks at most
CTAS_PER_SM = 2                       # the least a launch should offer


def _entry():
    lib = build.load("decode_attention")
    fn = lib.ercache_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def split_plan(B: int, S: int, Hkv: int, n_sm: int) -> Tuple[int, int]:
    """(n_split, split_len): each row's S keys cut into n_split splits of
    split_len keys (whole TILEs, the last split not empty), at least
    CTAS_PER_SM * n_sm CTAs over the B * Hkv (row, KV head) pairs where S
    allows, and no split longer than SPLIT_MAX. S is the longest valid_len
    the host knows without a sync."""
    tiles = -(-S // TILE)
    want = max(-(-CTAS_PER_SM * n_sm // (B * Hkv)), -(-S // SPLIT_MAX), 1)
    per = max(1, tiles // want)            # tiles per split
    return -(-tiles // per), per * TILE


def check_shapes(q, k, v, valid_len, bs: int) -> None:
    """Raise ValueError on what the reference kernel refuses or cannot
    mean: mismatched ranks or widths, Hq not a multiple of Hkv, ``S`` not
    a multiple of ``min(bs, S)``, a ``valid_len`` that is not (B,)."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, Hq, hd) and k, v (B, S, Hkv, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, hd = q.shape
    _, S, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "form a GQA group")
    if bs <= 0 or S == 0 or S % min(bs, S):
        raise ValueError(f"S={S} must be a multiple of min(bs={bs}, S), as "
                         "the reference's blocks")
    if valid_len is not None and tuple(valid_len.shape) != (B,):
        raise ValueError(f"valid_len must have shape ({B},), got "
                         f"{tuple(valid_len.shape)}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: Optional[torch.Tensor] = None, *,
                     bs: int = BLOCK) -> torch.Tensor:
    """q (B, Hq, hd); k, v (B, S, Hkv, hd); valid_len (B,) int32 or None
    (all S valid) -> (B, Hq, hd). Inputs that need a gradient raise (the
    kernel has no backward)."""
    build.refuse_grad("decode_attention", "ref.decode_attention_ref", q, k,
                      v)
    check_shapes(q, k, v, valid_len, bs)
    if not (q.is_cuda or k.is_cuda or v.is_cuda):
        return ref.decode_attention_ref(q, k, v, valid_len)
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"need one dtype of {list(_DTYPE_CODES)} for q, k "
                         f"and v, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in the kernel's {HEAD_DIMS}")
    for t in (q, k, v):
        if (t.device != q.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("q, k and v must be contiguous, 16-byte "
                             "aligned and on one device")
    if valid_len is None:
        valid_len = torch.full((B,), S, dtype=torch.int32, device=q.device)
    if (valid_len.dtype != torch.int32 or valid_len.device != q.device
            or not valid_len.is_contiguous()):
        raise ValueError(f"valid_len must be a contiguous int32 tensor on "
                         f"{q.device}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_split, split_len = split_plan(B, S, Hkv, build.sm_count(q.device))
    part = (torch.empty((B, Hq, n_split, hd + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    lib, fn = _entry()
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_len.data_ptr(),
              out.data_ptr(), None if part is None else part.data_ptr(), B,
              S, Hq, Hkv, hd, n_split, split_len, hd ** -0.5,
              _DTYPE_CODES[q.dtype],
              torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "ercache_decode_attention_strerror", code,
                "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out
