"""Plain decoder-LM user tower with sparse experts, in float32.

A LLaMA-style decoder as the configuration states it: token embedding;
``n_layers`` pre-norm layers of RMSNorm, grouped-query causal attention
with rotary positions (the two halves of each head rotated, base
``rope_theta``), and an expert block; a final RMSNorm; the mean over the
positions through the user head.

The expert block routes as GShard does (Lepikhin et al., 2020): the
tokens of a row fall into groups of ``group_size``; a float32 softmax
router; the top ``top_k`` experts (ties to the lower id), their gates
renormalised to sum to one; in each group an expert takes at most
``capacity`` assignments, counted slot by slot (every token's first
choice before any second choice), and an assignment past it contributes
nothing; each expert is a SwiGLU of width ``d_ff``. Only the assignments
kept are computed. Every product goes through ``mm``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def group_and_capacity(n_rows: int, seq: int, group_size: int,
                       n_experts: int, top_k: int, capacity_factor: float):
    """The group a tower call of ``n_rows`` rows of ``seq`` tokens routes
    in (the largest divisor of its tokens up to ``group_size``) and an
    expert's capacity in it (dropless for groups of 64 or fewer, where a
    token's output does not depend on its group). Groups that can drop
    must lie within rows, so that a row's output does not depend on the
    rows beside it in the call."""
    total = n_rows * seq
    g = min(group_size, total)
    while total % g:
        g -= 1
    if g <= 64:
        return g, g
    if seq % g:
        raise ValueError(f"groups of {g} tokens straddle rows of {seq}")
    return g, max(int(capacity_factor * top_k * g / n_experts + 0.999), top_k)


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x (R, S, H, hd): halves (x1, x2) -> (x1 c - x2 s, x1 s + x2 c)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.to(torch.float32)[:, None] * freqs
    c, s = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def attention(q, k, v, mm):
    """Causal GQA, one row at a time: q (R, S, Hq, hd), k/v (R, S, Hkv,
    hd); query head h reads KV head h // (Hq / Hkv)."""
    R, S, Hq, hd = q.shape
    rep = Hq // k.shape[2]
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for r in range(R):
        qh = q[r].transpose(0, 1)                              # (Hq, S, hd)
        kh = k[r].repeat_interleave(rep, dim=1).transpose(0, 1)
        vh = v[r].repeat_interleave(rep, dim=1).transpose(0, 1)
        s = mm(qh, kh.transpose(1, 2)) * hd ** -0.5
        p = torch.softmax(torch.where(causal, s, -torch.inf), dim=-1)
        out[r] = mm(p, vh).transpose(0, 1)
    return out


def experts(x, router, wg, wu, wd, top_k, group, capacity, mm):
    """x (T, D), T a multiple of ``group`` -> (T, D)."""
    T, D = x.shape
    E = router.shape[1]
    probs = torch.softmax(mm(x, router), dim=-1)
    ids = torch.sort(probs, dim=-1, descending=True, stable=True).indices[
        :, :top_k]
    gates = probs.gather(1, ids)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    # place of each (token, slot) in its expert, slot by slot, per group
    G = T // group
    onehot = F.one_hot(ids.reshape(G, group, top_k), E).to(torch.int32)
    before = torch.zeros(G, 1, E, dtype=torch.int32, device=x.device)
    keep = torch.empty(G, group, top_k, dtype=torch.bool, device=x.device)
    for s in range(top_k):
        m = onehot[:, :, s]
        place = (torch.cumsum(m, dim=1) - m + before).gather(
            2, ids.reshape(G, group, top_k)[:, :, s:s + 1])[..., 0]
        keep[:, :, s] = place < capacity
        before = before + m.sum(dim=1, keepdim=True)
    keep = keep.reshape(T, top_k)
    out = torch.zeros_like(x)
    tok = torch.arange(T, device=x.device)[:, None].expand(T, top_k)
    for e in range(E):
        sel = (ids == e) & keep
        t = tok[sel]
        if t.numel() == 0:
            continue
        xe = x[t]
        y = mm(F.silu(mm(xe, wg[e])) * mm(xe, wu[e]), wd[e])
        out.index_add_(0, t, gates[sel][:, None] * y)
    return out


def user_embedding(w: dict, tokens: torch.Tensor, cfg: dict, n_rows_call: int,
                   mm) -> torch.Tensor:
    """tokens (R, S) -> (R, user_embed_dim) float32. ``w`` holds the
    embedding, the stacked ``(L, ...)`` layer leaves, the final norm and
    the user head; ``n_rows_call`` is how many rows the tower's call
    holds, which sets the expert groups."""
    f = lambda t: t.to(torch.float32)
    R, S = tokens.shape
    D, Hq, Hkv = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = D // Hq
    eps = cfg["norm_eps"]
    group, cap = group_and_capacity(n_rows_call, S, cfg["moe_group_size"],
                                    cfg["n_experts"], cfg["top_k"],
                                    cfg["capacity_factor"])
    if cap == group:                       # dropless: one group will do
        group = cap = R * S
    pos = torch.arange(S, device=tokens.device)
    x = f(w["embed"])[tokens.long()]
    lw = w["layers"]
    for i in range(cfg["n_layers"]):
        L = {k: f(v[i]) for k, v in lw.items()}
        h = rms_norm(x, L["attn_norm"], eps).reshape(R * S, D)
        q = rope(mm(h, L["wq"]).reshape(R, S, Hq, hd), pos, cfg["rope_theta"])
        k = rope(mm(h, L["wk"]).reshape(R, S, Hkv, hd), pos,
                 cfg["rope_theta"])
        v = mm(h, L["wv"]).reshape(R, S, Hkv, hd)
        o = attention(q, k, v, mm).reshape(R * S, Hq * hd)
        x = x + mm(o, L["wo"]).reshape(R, S, D)
        h2 = rms_norm(x, L["ffn_norm"], eps).reshape(R * S, D)
        x = x + experts(h2, L["router"], L["moe_wg"], L["moe_wu"],
                        L["moe_wd"], cfg["top_k"], group, cap,
                        mm).reshape(R, S, D)
    x = rms_norm(x, f(w["final_norm"]), eps)
    return mm(x.mean(dim=1), f(w["user_head"]))
