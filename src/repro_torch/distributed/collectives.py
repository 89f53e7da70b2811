"""Single-device decode attention: the reference the sharded decode wraps.

Twin of ``_local_decode_partials`` and ``decode_attention_local`` of
``repro/distributed/collectives.py``: one query token per batch row
against a KV cache, as plain torch. ``transformer.decode_step`` attends
through :func:`decode_attention_local` with ``backend="torch"``. The query
heads are grouped as (B, Hkv, n_rep, hd) against the (B, S, Hkv, hd) cache
without repeating it, so a long cache never grows n_rep-fold. The
sequence-sharded combine (``seq_sharded_decode_attention``) joins with the
scale-out slice; :func:`combine_decode_partials` is its merge, which the
split decode kernel (``csrc/decode_attention.cu``) runs across the splits
of one card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _local_decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, kv_len_mask: Optional[torch.Tensor]
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """One-token attention partials over a local KV slice.

    q: (B, Hq, hd); k, v: (B, Sl, Hkv, hd); kv_len_mask (B, Sl) bool or
    None. Returns (m, l, acc): m, l (B, Hq) float32; acc (B, Hq, hd)
    float32. Query head h reads KV head h // n_rep.
    """
    B, Sl, Hkv, hd = k.shape
    n_rep = q.shape[1] // Hkv
    qg = (q.to(torch.float32) * hd ** -0.5).reshape(B, Hkv, n_rep, hd)
    s = torch.einsum("bknd,bskd->bkns", qg, k.to(torch.float32))
    s = s.reshape(B, Hkv * n_rep, Sl)
    if kv_len_mask is not None:
        s = torch.where(kv_len_mask[:, None, :], s, NEG_INF)
    m = s.amax(dim=-1)                                     # (B, Hq)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkns,bskd->bknd", p.reshape(B, Hkv, n_rep, Sl),
                       v.to(torch.float32))
    return m, l, acc.reshape(B, Hkv * n_rep, hd)


def decode_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_valid_len: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q (B, Hq, hd); k, v (B, S, Hkv, hd); kv_valid_len (B,) masks the
    positions at and after it -> (B, Hq, hd) in q's dtype. A row with
    ``kv_valid_len == 0`` gives the mean of v, as in the reference (the
    Pallas kernel gives zeros there; the decode step always has
    ``valid >= 1``)."""
    mask = None
    if kv_valid_len is not None:
        mask = (torch.arange(k.shape[1], device=k.device)[None, :]
                < kv_valid_len[:, None])
    _, l, acc = _local_decode_partials(q, k, v, kv_len_mask=mask)
    return (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)


def combine_decode_partials(m: torch.Tensor, l: torch.Tensor,
                            acc: torch.Tensor, dtype: torch.dtype
                            ) -> torch.Tensor:
    """The online-softmax merge of ``seq_sharded_decode_attention``'s
    shards: m, l (N, B, Hq) and acc (N, B, Hq, hd) float32 partials of N
    key ranges -> (B, Hq, hd) in ``dtype``. The max of the partial maxima,
    then the partial sums and accumulators scaled by exp(m - max)."""
    m_g = m.amax(dim=0)
    corr = torch.exp(m - m_g)
    l_g = (l * corr).sum(dim=0)
    acc_g = (acc * corr[..., None]).sum(dim=0)
    return (acc_g / torch.clamp(l_g[..., None], min=1e-30)).to(dtype)
