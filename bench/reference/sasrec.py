"""Plain SASRec user tower (Kang and McAuley, arXiv:1808.09781) in float32.

Item embeddings plus learned position embeddings (a padded position, id
-1, is a zero vector), ``n_blocks`` pre-norm blocks of causal single-matrix
self-attention (queries attend to every earlier position, padded ones
included) and a pointwise ReLU feed-forward of width ``d``, a final layer
norm, and the last position as the user's embedding. Weights are the
``(in, out)`` matrices the benchmark makes; every product goes through
``mm`` (``precision.matmul_at``).
"""
from __future__ import annotations

import torch

EPS = 1e-5


def layer_norm(x, w, b):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + EPS) * w + b


def user_embedding(w: dict, seq: torch.Tensor, n_heads: int, mm
                   ) -> torch.Tensor:
    """seq (R, S) item ids, -1 padding -> (R, d) float32."""
    f = lambda t: t.to(torch.float32)
    R, S = seq.shape
    valid = seq >= 0
    x = f(w["item_emb"])[seq.clamp(min=0).long()] + f(w["pos_emb"])[:S]
    x = torch.where(valid[..., None], x, 0.0)
    d = x.shape[-1]
    hd = d // n_heads
    causal = torch.ones(S, S, dtype=torch.bool, device=seq.device).tril()
    for blk in w["blocks"]:
        h = layer_norm(x, f(blk["ln1_w"]), f(blk["ln1_b"]))
        q, k, v = (mm(h.reshape(R * S, d), f(blk[n])).reshape(
            R, S, n_heads, hd).transpose(1, 2) for n in ("wq", "wk", "wv"))
        s = mm(q.reshape(-1, S, hd), k.reshape(-1, S, hd).transpose(1, 2))
        s = s.reshape(R, n_heads, S, S) * hd ** -0.5
        p = torch.softmax(torch.where(causal, s, -torch.inf), dim=-1)
        o = mm(p.reshape(-1, S, S), v.reshape(-1, S, hd)).reshape(
            R, n_heads, S, hd).transpose(1, 2).reshape(R * S, d)
        x = x + mm(o, f(blk["wo"])).reshape(R, S, d)
        h2 = layer_norm(x, f(blk["ln2_w"]), f(blk["ln2_b"])).reshape(R * S, d)
        ff = mm(torch.relu(mm(h2, f(blk["w1"])) + f(blk["b1"])), f(blk["w2"]))
        x = x + ff.reshape(R, S, d) + f(blk["b2"])
    x = layer_norm(x, f(w["ln_w"]), f(w["ln_b"]))
    return x[:, -1]
