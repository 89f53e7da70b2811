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

:func:`decode_attention_partials` is the same split kernel over one key
range of a longer cache (a sequence shard of
``collectives.seq_sharded_decode_attention``), writing every split's
float32 (m, l, acc) and skipping the merge; its plain version is
``ref.decode_attention_partials_ref``.

On a CPU tensor the wrapper runs ``ref.decode_attention_ref``; on a CUDA
tensor it launches the kernel (counted in :data:`LAUNCHES`) or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"decode_attention": 0, "decode_attention_partials": 0}

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


def _partials_entry():
    lib = build.load("decode_attention")
    fn = lib.ercache_decode_attention_partials
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
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


def splits_of(S: int, n_split: int) -> Tuple[int, int]:
    """(n_split, split_len) of at most ``n_split`` splits of whole TILEs
    covering S keys, none empty."""
    tiles = -(-S // TILE)
    per = -(-tiles // max(1, min(n_split, tiles)))
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


def _check_card_inputs(q, k, v, valid_len) -> None:
    """The dtypes, head dim and valid_len both entries take."""
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"need one dtype of {list(_DTYPE_CODES)} for q, k "
                         f"and v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[2]} not in the kernel's "
                         f"{HEAD_DIMS}")
    if (valid_len.dtype != torch.int32 or valid_len.device != q.device
            or not valid_len.is_contiguous()):
        raise ValueError(f"valid_len must be a contiguous int32 tensor on "
                         f"{q.device}")


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
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    for t in (q, k, v):
        if (t.device != q.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("q, k and v must be contiguous, 16-byte "
                             "aligned and on one device")
    if valid_len is None:
        valid_len = torch.full((B,), S, dtype=torch.int32, device=q.device)
    _check_card_inputs(q, k, v, valid_len)
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


def decode_attention_partials(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              valid_len: Optional[torch.Tensor] = None,
                              pos_offset: int = 0, *,
                              n_split: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The float32 partials of one query token against a key range:
    q (B, Hq, hd); k, v (B, S, Hkv, hd), key j at position ``pos_offset +
    j`` (masked at and after ``valid_len[b]``; None: all S valid) ->
    (m, l) (P, B, Hq) and acc (P, B, Hq, hd), P >= 1 splits of the range.

    k and v may be views of a longer cache along S (each batch row's
    (S, Hkv, hd) block contiguous, rows any stride apart): no copy is
    made. A split at or past valid_len gives m = -1e30, l = 0, acc = 0.
    On the card the splits are ``split_plan``'s, or ``n_split``
    (:func:`splits_of`); on the CPU the plain version gives P = 1 unless
    ``n_split`` asks for more. Inputs that need a gradient raise."""
    build.refuse_grad("decode_attention_partials",
                      "ref.decode_attention_partials_ref", q, k, v)
    if (q.dim() != 3 or k.dim() != 4 or k.shape != v.shape
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[2]
            or k.shape[2] == 0 or q.shape[1] % k.shape[2] or k.shape[1] == 0):
        raise ValueError(f"need q (B, Hq, hd) and k, v (B, S, Hkv, hd) of "
                         f"one GQA group, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if valid_len is not None and tuple(valid_len.shape) != (B,):
        raise ValueError(f"valid_len must have shape ({B},), got "
                         f"{tuple(valid_len.shape)}")
    if not (q.is_cuda or k.is_cuda or v.is_cuda):
        n, split_len = (1, S) if n_split is None else splits_of(S, n_split)
        return ref.decode_attention_partials_ref(q, k, v, valid_len,
                                                 pos_offset, n, split_len)
    if valid_len is None:
        valid_len = torch.full((B,), pos_offset + S, dtype=torch.int32,
                               device=q.device)
    _check_card_inputs(q, k, v, valid_len)
    row = (Hkv * hd, hd, 1)
    for t in (k, v):
        if (t.device != q.device or tuple(t.stride()[1:]) != row
                or t.stride(0) != k.stride(0) or t.stride(0) < S * Hkv * hd
                or t.data_ptr() % 16 or (t.stride(0) * t.element_size()) % 16):
            raise ValueError("k and v must be 16-byte aligned views on "
                             f"{q.device} with contiguous (S, Hkv, hd) rows "
                             "one stride apart")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("q must be contiguous and 16-byte aligned")
    if n_split is None:
        n_split, split_len = split_plan(B, S, Hkv, build.sm_count(q.device))
    else:
        n_split, split_len = splits_of(S, n_split)
    part = torch.empty((B, Hq, n_split, hd + 2), dtype=torch.float32,
                       device=q.device)
    lib, fn = _partials_entry()
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_len.data_ptr(),
              part.data_ptr(), B, S, Hq, Hkv, hd, n_split, split_len,
              k.stride(0), pos_offset, hd ** -0.5, _DTYPE_CODES[q.dtype],
              torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "ercache_decode_attention_strerror", code,
                "decode_attention_partials")
    LAUNCHES["decode_attention_partials"] += 1
    part = part.permute(2, 0, 1, 3)
    return part[..., hd], part[..., hd + 1], part[..., :hd]
