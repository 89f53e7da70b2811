"""EmbeddingBag gather-reduce, the recsys towers' hot path, as a CUDA kernel.

Twin of ``repro/kernels/embedding_bag.py`` (source
``csrc/embedding_bag.cu``). Lanes cover (bag, vector slice) items, each
lane loading the ids and then the rows of several items before it adds;
the grid is one wave of resident blocks, sized from the SM count. Each
item's ids are walked in order with a float32 accumulator and one cast at
the end: for nnz = 1 (SASRec's item gather) the result is exact. On a CPU
tensor the wrapper runs ``ref.embedding_bag_ref``; on a CUDA tensor it
launches the kernel (counted in :data:`LAUNCHES`) or raises. Either way it
refuses a table that needs a gradient while autograd records.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"embedding_bag": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = ("sum", "mean")


def _entry():
    lib = build.load("embedding_bag")
    fn = lib.ercache_embedding_bag
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """table (V, D) float32/bfloat16; ids (B, nnz) int32, -1 pads ->
    (B, D) in the table dtype. Ids must lie in ``[-1, V)``. A table that
    needs a gradient raises (the kernel has no backward)."""
    build.refuse_grad("embedding_bag", "ref.embedding_bag_ref", table)
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if not ids.is_cuda:
        return ref.embedding_bag_ref(table, ids, mode=mode)
    if table.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported table dtype {table.dtype}")
    if table.dim() != 2 or ids.dim() != 2 or ids.dtype != torch.int32:
        raise ValueError("need table (V, D) and int32 ids (B, nnz)")
    if (table.device != ids.device or not table.is_contiguous()
            or not ids.is_contiguous()):
        raise ValueError("table and ids must be contiguous on one device")
    B, nnz = ids.shape
    D = table.shape[1]
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0 or D == 0:
        return out
    lib, fn = _entry()
    code = fn(table.data_ptr(), ids.data_ptr(), B, nnz, D,
              int(mode == "mean"), _DTYPE_CODES[table.dtype], out.data_ptr(),
              build.sm_count(table.device),
              torch.cuda.current_stream(table.device).cuda_stream)
    build.check(lib, "ercache_embedding_bag_strerror", code, "embedding_bag")
    LAUNCHES["embedding_bag"] += 1
    return out
