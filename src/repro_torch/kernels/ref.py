"""Plain PyTorch versions of the hand-written kernels.

Each function is the contract its CUDA kernel must match bit for bit
(integer outputs, copied values, nnz=1 bags) or to float tolerance (bags
that sum several rows). They are the twins of ``repro/kernels/ref.py``:
the CPU tests hold them against the JAX package, and ``chip_smoke.py``
holds the kernels against them on the card. They run on any device.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (JAX's int32
    arithmetic), computed without relying on overflow behaviour."""
    return (((x + 0x80000000) & _M32) - 0x80000000).to(torch.int32)


def cache_probe_ref(key_hi, key_lo, write_ts, values, q_hi, q_lo, buckets,
                    now_ms, ttl_ms):
    """Set-associative TTL probe with precomputed buckets.

    key_hi/key_lo/write_ts: (Nb, W) int32; values: (Nb, W, D);
    q_hi/q_lo/buckets: (B,) int32; ``now_ms`` an int or a 0-d int32
    tensor, ``ttl_ms`` an int or a per-query (B,) int32 tensor (the
    multi-model tier's TTLs). Returns (hit (B,) bool, value (B, D),
    age (B,) int32 -1 on a miss, way (B,) int32 the FIRST valid way, -1 on
    a miss).
    """
    b = buckets.long()
    ts = write_ts[b]                                        # (B, W)
    match = (key_hi[b] == q_hi[:, None]) & (key_lo[b] == q_lo[:, None])
    now = torch.as_tensor(now_ms, device=ts.device).long()
    # TS_EMPTY lanes wrap here but never match a real key (`match` masks).
    age_all = wrap_i32(now - ts.long())
    if isinstance(ttl_ms, torch.Tensor) and ttl_ms.dim() == 1:
        ttl_ms = ttl_ms[:, None]
    valid = match & (age_all <= ttl_ms)
    hit = valid.any(dim=-1)
    way = valid.to(torch.int32).argmax(dim=-1)              # first max
    rows = torch.arange(b.shape[0], device=b.device)
    out = torch.where(hit[:, None], values[b, way],
                      torch.zeros((), dtype=values.dtype,
                                  device=values.device))
    age = torch.where(hit, age_all[rows, way], -1).to(torch.int32)
    return hit, out, age, torch.where(hit, way, -1).to(torch.int32)


def cache_probe_dual_multi_ref(d_key_hi, d_key_lo, d_write_ts, d_values,
                               f_key_hi, f_key_lo, f_write_ts, f_values,
                               q_hi, q_lo, slots, buckets_d, buckets_f,
                               policy, now_ms):
    """The dual probe of a stacked multi-model tier: the tables are the
    pooled (M*Nb, W) views, ``buckets_*`` carry the slot offset, and query
    q is validated at row ``slots[q]`` of the (M, 2) int32 ``policy``
    table (column 0 the direct TTL, column 1 the failover TTL). Returns
    two :func:`cache_probe_ref` quads."""
    s = slots.long()
    return (cache_probe_ref(d_key_hi, d_key_lo, d_write_ts, d_values, q_hi,
                            q_lo, buckets_d, now_ms, policy[s, 0]),
            cache_probe_ref(f_key_hi, f_key_lo, f_write_ts, f_values, q_hi,
                            q_lo, buckets_f, now_ms, policy[s, 1]))


def embedding_bag_ref(table, ids, mode: str = "sum"):
    """table (V, D); ids (B, nnz) int32, -1 = padding -> (B, D).
    Accumulates in float32 and casts once to the table dtype."""
    mask = ids >= 0
    rows = table[ids.clamp(min=0).long()].to(torch.float32)  # (B, nnz, D)
    rows = torch.where(mask[..., None], rows, 0.0)
    out = rows.sum(dim=1)
    if mode == "mean":
        out = out / mask.sum(dim=1, keepdim=True).clamp(min=1)
    return out.to(table.dtype)
