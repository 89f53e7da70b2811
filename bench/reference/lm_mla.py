"""Plain DeepSeek-V3 user tower (Moonlight-16B-A3B) in float32.

The forward as the published DeepSeek-V3 modeling code states it
(``modeling_deepseek.py`` of the configuration's ``model_type``
``deepseek_v3``), with the configuration's keys: token embedding; the
first ``first_k_dense_replace`` layers dense, the rest with experts; each
layer pre-norm:

* RMSNorm, then multi-head latent attention without a query LoRA:
  ``q = x W_q`` (``num_attention_heads`` heads of ``qk_nope_head_dim +
  qk_rope_head_dim``); ``[c, k_pe] = x W_kv_a``; ``c`` RMS-normed, then
  ``c W_kv_b`` gives each head's ``k_nope`` and ``v`` (``v_head_dim``);
  rotary positions (base ``rope_theta``) on ``q_pe`` and on ``k_pe``, one
  key shared by the heads, the pairs ``(x[2i], x[2i+1])`` rotated by
  frequency i and laid out as halves (the published code de-interleaves
  then rotates the halves); causal softmax of ``[q_nope, q_pe] .
  [k_nope, k_pe]`` scaled by ``(qk_nope_head_dim + qk_rope_head_dim) **
  -0.5`` (no rope scaling, so no yarn factor); ``o = attn W_o``;
* RMSNorm, then a SwiGLU ``intermediate_size`` wide (dense layers), or
  the expert block: ``scores = sigmoid(x W_r)`` in float32; the top
  ``num_experts_per_tok`` of ``scores + e_score_correction_bias``
  (``noaux_tc`` with ``n_group`` = ``topk_group`` = 1, ties to the lower
  id); their weights the chosen scores without the bias, over their sum
  + 1e-20 (``norm_topk_prob``), times ``routed_scaling_factor``; each
  expert a SwiGLU ``moe_intermediate_size`` wide; plus the
  ``n_shared_experts`` shared experts, one SwiGLU ``n_shared_experts x
  moe_intermediate_size`` wide, for every token.

Departures, as the benchmark runs the model (the configuration's
``reduced`` and ``notes``):

* routing with GShard capacity (``lm_moe.group_and_capacity``): the
  tokens of a row fall into groups of ``moe_group_size``; in each group an
  expert takes at most ``capacity`` assignments, counted slot by slot
  (every token's first choice, the highest biased score, before any
  second), and an assignment past it contributes nothing; the published
  model is dropless;
* a user tower: the final RMSNorm's output mean-pooled over the
  positions through the user head (no logits).

Attention runs one row at a time (the (16, 8192, 8192) float32 scores of a
row are 4.3 GB); the layers' weights are cast to float32 one layer at a
time. Every product goes through ``mm``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.lm_moe import group_and_capacity, rms_norm


def rope(x, pos, theta):
    """x (R, S, H, d), DeepSeek's interleaved pairs -> rotated, as halves."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = pos.to(torch.float32)[:, None] * inv
    emb = torch.cat([ang, ang], dim=-1)
    cos, sin = torch.cos(emb)[None, :, None], torch.sin(emb)[None, :, None]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def attention(q, k, v, mm):
    """Causal, one row at a time: q, k (R, S, H, dqk), v (R, S, H, dv)."""
    R, S, H, dqk = q.shape
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    out = q.new_empty(R, S, H, v.shape[-1])
    for r in range(R):
        s = mm(q[r].transpose(0, 1), k[r].permute(1, 2, 0)) * dqk ** -0.5
        p = torch.softmax(torch.where(causal, s, -torch.inf), dim=-1)
        del s
        out[r] = mm(p, v[r].transpose(0, 1)).transpose(0, 1)
    return out


def mla(h, L, cfg, pos, mm):
    """h (R, S, D), normed -> the attention's output (R, S, D)."""
    R, S, _ = h.shape
    H, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv = cfg["v_head_dim"]
    q = mm(h, L["wq"]).reshape(R, S, H, dn + dr)
    ckv = mm(h, L["wkv_a"])
    c, k_pe = ckv[..., :r], ckv[..., r:]
    kv = mm(rms_norm(c, L["kv_norm"], cfg["rms_norm_eps"]),
            L["wkv_b"]).reshape(R, S, H, dn + dv)
    q_pe = rope(q[..., dn:], pos, cfg["rope_theta"])
    k_pe = rope(k_pe.reshape(R, S, 1, dr), pos, cfg["rope_theta"])
    q = torch.cat([q[..., :dn], q_pe], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe.expand(R, S, H, dr)], dim=-1)
    o = attention(q, k, kv[..., dn:], mm).reshape(R, S, H * dv)
    return mm(o, L["wo"])


def swiglu(x, wg, wu, wd, mm):
    return mm(F.silu(mm(x, wg)) * mm(x, wu), wd)


def experts(x, L, cfg, group, capacity, mm):
    """x (T, D), T a multiple of ``group`` -> the routed experts' and the
    shared experts' output (T, D)."""
    T, D = x.shape
    E, K = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    scores = torch.sigmoid(mm(x, L["router"]))
    ids = torch.sort(scores + L["router_bias"], dim=-1, descending=True,
                     stable=True).indices[:, :K]
    w = scores.gather(1, ids)
    if cfg["norm_topk_prob"] and K > 1:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    # place of each (token, slot) in its expert, slot by slot, per group
    G = T // group
    onehot = F.one_hot(ids.reshape(G, group, K), E).to(torch.int32)
    before = torch.zeros(G, 1, E, dtype=torch.int32, device=x.device)
    keep = torch.empty(G, group, K, dtype=torch.bool, device=x.device)
    for s in range(K):
        m = onehot[:, :, s]
        place = (torch.cumsum(m, dim=1) - m + before).gather(
            2, ids.reshape(G, group, K)[:, :, s:s + 1])[..., 0]
        keep[:, :, s] = place < capacity
        before = before + m.sum(dim=1, keepdim=True)
    keep = keep.reshape(T, K)
    out = swiglu(x, L["shared_wg"], L["shared_wu"], L["shared_wd"], mm)
    tok = torch.arange(T, device=x.device)[:, None].expand(T, K)
    for e in range(E):
        sel = (ids == e) & keep
        t = tok[sel]
        if t.numel() == 0:
            continue
        y = swiglu(x[t], L["moe_wg"][e], L["moe_wu"][e], L["moe_wd"][e], mm)
        out.index_add_(0, t, w[sel][:, None] * y)
    return out


def user_embedding(w: dict, tokens: torch.Tensor, cfg: dict, n_rows_call: int,
                   mm) -> torch.Tensor:
    """tokens (R, S) -> (R, user_embed_dim) float32. ``w`` holds the
    embedding, the stacked ``(L, ...)`` leaves of the dense layers
    (``w["dense"]``) and of the expert layers (``w["moe"]``), the final
    norm and the user head; ``n_rows_call`` is how many rows the tower's
    call holds, which sets the expert groups."""
    f = lambda t: t.to(torch.float32)
    R, S = tokens.shape
    D, eps = cfg["hidden_size"], cfg["rms_norm_eps"]
    group, cap = group_and_capacity(n_rows_call, S, cfg["moe_group_size"],
                                    cfg["n_routed_experts"],
                                    cfg["num_experts_per_tok"],
                                    cfg["capacity_factor"])
    if cap == group:                       # dropless: one group will do
        group = cap = R * S
    pos = torch.arange(S, device=tokens.device)
    x = f(w["embed"])[tokens.long()]
    n_dense = cfg["first_k_dense_replace"]
    for i in range(cfg["num_hidden_layers"]):
        moe = i >= n_dense
        stack, j = (w["moe"], i - n_dense) if moe else (w["dense"], i)
        L = {k: f(v[j]) for k, v in stack.items()}
        x = x + mla(rms_norm(x, L["attn_norm"], eps), L, cfg, pos, mm)
        h = rms_norm(x, L["ffn_norm"], eps)
        if moe:
            x = x + experts(h.reshape(R * S, D), L, cfg, group, cap,
                            mm).reshape(R, S, D)
        else:
            x = x + swiglu(h, L["wg"], L["wu"], L["wd"], mm)
        del L
    x = rms_norm(x, f(w["final_norm"]), eps)
    return mm(x.mean(dim=1), f(w["user_head"]))
