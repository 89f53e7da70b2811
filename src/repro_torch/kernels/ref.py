"""Plain PyTorch versions of the hand-written kernels.

Each function is the contract its CUDA kernel must match bit for bit
(integer outputs, copied values, nnz=1 bags) or to float tolerance (bags
that sum several rows). They are the twins of ``repro/kernels/ref.py``:
the CPU tests hold them against the JAX package, and ``chip_smoke.py``
holds the kernels against them on the card. They run on any device.
"""
from __future__ import annotations

from typing import Optional

import torch

_M32 = 0xFFFFFFFF
NEG_INF = -1e30
# float32 bytes of k and v that decode_attention_ref converts at once
_DECODE_CHUNK_BYTES = 1 << 30


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


def cache_probe_perquery_ref(key_hi, key_lo, write_ts, values, q_hi, q_lo,
                             buckets, now_ms, ttl_ms):
    """The per-query probe's contract: (hit, value, age) of
    :func:`cache_probe_ref`, without the way. The reference kernel builds
    the value as a masked SUM over the ways, so the row is the winning row
    plus 0.0: a stored -0.0 comes back +0.0 (the tiled probe copies the
    bits and keeps -0.0); a miss gives zeros and age -1."""
    hit, out, age, _ = cache_probe_ref(key_hi, key_lo, write_ts, values,
                                       q_hi, q_lo, buckets, now_ms, ttl_ms)
    return hit, out + 0.0, age


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


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q (B, Sq, Hq, hd); k, v (B, Sk, Hkv, hd); GQA by head repetition
    (query head h reads KV head h // n_rep). float32 scores and softmax,
    masked scores -1e30, output in q's dtype.

    Computed one batch row at a time so that no (B, Hq, Sq, Sk) score
    tensor exists at once (25.8 GB at the LM tower's B=48, 32 heads,
    2048 tokens); the rows are independent, so the numbers are those of
    the whole-batch formula."""
    B, Sq, Hq, hd = q.shape
    Sk, n_rep = k.shape[1], Hq // k.shape[2]
    scale = hd ** -0.5
    keep = (torch.arange(Sk, device=q.device)[None, :]
            <= torch.arange(Sq, device=q.device)[:, None] + q_offset)
    out = torch.empty_like(q)
    for b in range(B):
        kr = k[b].repeat_interleave(n_rep, dim=1).to(torch.float32)
        vr = v[b].repeat_interleave(n_rep, dim=1).to(torch.float32)
        s = torch.einsum("qhd,khd->hqk", q[b].to(torch.float32), kr) * scale
        if causal:
            s = torch.where(keep[None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out[b] = torch.einsum("hqk,khd->qhd", p, vr).to(q.dtype)
    return out


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid_len: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """One query token against a KV cache, as the Pallas decode kernel.

    q (B, Hq, hd); k, v (B, S, Hkv, hd); valid_len (B,) int32, positions
    at and after it masked (None: all S). Query head h reads KV head
    h // n_rep. q is scaled by hd**-0.5 in float32 before the product,
    masked scores are -1e30, the softmax is float32 and the output is cast
    to q's dtype. A row with ``valid_len <= 0`` gives ZEROS: the kernel
    skips every block and divides a zero accumulator by max(l, 1e-30)
    (``ref.decode_attention_ref`` and ``decode_attention_local`` of the
    JAX package give the mean of v there instead).

    Computed over chunks of batch rows whose float32 k and v take at most
    1 GiB (the decode_32k cache is 4.3 GB in bfloat16); the rows are
    independent, so the numbers are those of the whole-batch formula."""
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    n_rep = Hq // Hkv
    if valid_len is None:
        valid = torch.full((B,), S, dtype=torch.long, device=q.device)
    else:
        valid = valid_len.to(device=q.device, dtype=torch.long)
    pos = torch.arange(S, device=q.device)
    rows = max(1, _DECODE_CHUNK_BYTES // (S * Hkv * hd * 4 * 2))
    out = torch.empty_like(q)
    for b0 in range(0, B, rows):
        sl = slice(b0, b0 + rows)
        qg = (q[sl].to(torch.float32) * hd ** -0.5).reshape(-1, Hkv, n_rep,
                                                            hd)
        s = torch.einsum("bknd,bskd->bkns", qg, k[sl].to(torch.float32))
        keep = pos[None, :] < valid[sl, None]                 # (b, S)
        s = torch.where(keep[:, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkns,bskd->bknd", p, v[sl].to(torch.float32))
        o = torch.where((valid[sl] > 0)[:, None, None, None], o, 0.0)
        out[sl] = o.reshape(-1, Hq, hd).to(q.dtype)
    return out
