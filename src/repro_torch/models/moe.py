"""Mixture-of-Experts FFN: grouped GShard-style top-k dispatch/combine.

Twin of ``repro/models/moe.py``. Tokens are reshaped to (G groups, T_g
tokens, D) with per-group expert capacity C ~ cf*k*T_g/E, T_g <= 512.
Groups of 64 tokens or fewer (serving, decode) run dropless.

Routing: softmax router in float32, top-k (ties to the lower expert id, as
``jax.lax.top_k``), renormalized gates, GShard load-balance auxiliary loss,
capacity dropping (a dropped token's slot contributes 0: it passes through
the residual only). Plain torch ops throughout, so autograd differentiates
the block; the one-host-device run has no all-to-all.

Two formulations of one routing, chosen by whether ``moe_ffn`` has a mesh:

* **indexed** (no mesh: serving, decode, training): each (token, slot)'s
  position in its expert (``slot_positions``) gives its row of an
  expert-major (E, G*C, D) capacity buffer; the tokens are copied there,
  the experts run as batched matmuls over E, and each token gathers its K
  rows back, weighted by its gates. Nothing holds a (G, T, E, C) axis.
* **dense** (a ModelMesh: the planner, the mesh runs): the reference's
  GSPMD formulation, (G, T, E, C) dispatch and combine tensors and five
  einsums, whose sharding gives the collectives the planner is held to.
  The tensors are built one top-k slot at a time, each slot a (G, T, E,
  C) tensor: the reference writes them as a (G, T, K, E, C) product
  summed over K, which XLA fuses and never holds, and a token's K experts
  are distinct, so at most one slot is non-zero at each (g, t, e, c) and
  the sums are the same bit for bit.

The two give the same dispatch bit for bit (the dense einsum adds 1.0 * x
to zeros); the combine's K-term sum may run in another order.

The config chooses the gate and what every token adds beside its routed
experts (``MoEConfig.gate`` / ``.shared``): the reference's softmax top-k
and nothing; the port's DeepSeek-V3 block
(:class:`~repro_torch.configs.mla.DeepSeekMoEConfig`, no counterpart in the
reference) routes on sigmoid scores instead (:func:`sigmoid_gating`:
experts chosen on the scores plus the layer's selection bias, weighted by
the unbiased scores), over the same dispatch, and adds its shared experts'
SwiGLU (``params["shared_*"]``); a gate that gives no probabilities keeps
no load-balance loss (the port serves that block, it does not train it).
"""
from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core import trace
from repro_torch.distributed.sharding import UNCONSTRAINED, constrain

# ``moe_ffn``'s runs by formulation, "indexed" or "dense": counted on the
# host once an eager call or a capture (a graph's replay runs no Python).
ROUTES: collections.Counter = collections.Counter()


def pick_group_size(n_tokens: int, max_group: int = 512) -> int:
    """Largest divisor of n_tokens that is <= max_group."""
    g = min(max_group, n_tokens)
    while n_tokens % g:
        g -= 1
    return g


def capacity_for(group_size: int, cfg: MoEConfig) -> int:
    """Per-group expert capacity. Tiny groups (serving) run dropless."""
    if group_size <= 64:
        return group_size
    c = int(cfg.capacity_factor * cfg.top_k * group_size / cfg.n_experts
            + 0.999)
    return max(c, cfg.top_k)


def top_k_gating(logits: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (G, T, E) -> (gate values (G, T, k), expert ids (G, T, k)
    int64, probs (G, T, E)). The top k come from a stable descending sort,
    so equal probabilities keep the lower expert id first, as
    ``jax.lax.top_k`` does (``torch.topk`` promises no order on ties)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    vals = probs.gather(-1, idx)
    vals = vals / vals.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return vals, idx, probs


def sigmoid_gating(logits: torch.Tensor, bias: torch.Tensor, cfg: MoEConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's ``noaux_tc`` router with one group: logits (G, T, E)
    -> (weights (G, T, k), expert ids (G, T, k) int64, scores (G, T, E)),
    all float32. The experts are the top k of ``sigmoid(logits) + bias``
    by a stable descending sort (ties to the lower id, slot 0 the highest,
    as :func:`top_k_gating`); their weights are their scores WITHOUT the
    bias, divided by their sum (+ 1e-20) when ``norm_topk_prob`` and k >
    1, times ``routed_scale``."""
    scores = torch.sigmoid(logits.to(torch.float32))
    idx = torch.sort((scores + bias.to(torch.float32)).detach(), dim=-1,
                     descending=True, stable=True).indices[..., :cfg.top_k]
    w = scores.gather(-1, idx)
    if cfg.norm_topk_prob and cfg.top_k > 1:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * cfg.routed_scale, idx, scores


def dispatch_combine_tensors(idx: torch.Tensor, gates: torch.Tensor,
                             n_experts: int, capacity: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G, T, E, C) float32 dispatch (0/1) and combine (gated) tensors.

    Slot priority is GShard's: a (token, slot)'s position in its expert is
    the running count of earlier assignments to that expert, every token's
    slot 0 counted before any slot 1. Positions are float32 and compared
    with ``arange(C)`` in float32, as ``jax.nn.one_hot`` does; a position
    at or past the capacity matches no column (the token is dropped).
    Each slot adds its (G, T, E, C) share in turn (module docstring)."""
    K = idx.shape[-1]
    oh = F.one_hot(idx, n_experts).to(torch.float32)      # (G, T, K, E)
    cols = torch.arange(capacity, dtype=torch.float32, device=idx.device)
    prev = torch.zeros_like(oh[:, :1, 0])                  # (G, 1, E)
    disp = comb = None
    for s in range(K):
        m = oh[:, :, s]                                    # (G, T, E)
        within = torch.cumsum(m, dim=1) - m                # tokens before me
        pos = within + prev
        prev = prev + m.sum(dim=1, keepdim=True)
        keep = (pos < capacity).to(torch.float32) * m      # dropped -> 0
        kept = keep[..., None] * (pos[..., None] == cols).to(torch.float32)
        gated = gates[:, :, s, None, None] * kept          # (G, T, E, C)
        disp = kept if disp is None else disp + kept
        comb = gated if comb is None else comb + gated
    return disp, comb


def slot_positions(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(G, T, K) expert ids -> (G, T, K) int64: each assignment's position
    in its expert, with ``dispatch_combine_tensors``' priority: the count
    of earlier assignments to the same expert, every token's slot 0
    counted before any slot 1. One cumsum over the one-hot laid out
    slot-major, (G, K*T, E): no capacity axis."""
    G, T, K = idx.shape
    ids = idx.transpose(1, 2).reshape(G, K * T, 1)
    count = torch.cumsum(F.one_hot(ids[..., 0], n_experts), dim=1,
                         dtype=torch.int32)            # inclusive
    pos = count.gather(-1, ids).long() - 1
    return pos.reshape(G, K, T).transpose(1, 2)


def index_routing(idx: torch.Tensor, gates: torch.Tensor, n_experts: int,
                  capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (dest (G, T, K) int64, weights (G, T, K) float32): the entries
    of ``dispatch_combine_tensors``' (G, T, E, C) tensors without their
    zeros. ``dest`` is the assignment's row of the expert-major (E, G*C)
    capacity buffer, ``(e * G + g) * C + position``; an assignment at or
    past the capacity is dropped to the dump row E*G*C, which nothing
    reads. ``weights`` are the gates, 0 where dropped."""
    G = idx.shape[0]
    pos = slot_positions(idx, n_experts)
    keep = pos < capacity
    g = torch.arange(G, device=idx.device)[:, None, None]
    dest = torch.where(keep, (idx * G + g) * capacity + pos,
                       n_experts * G * capacity)
    return dest, gates * keep


def indexed_dispatch(xg: torch.Tensor, dest: torch.Tensor, n_experts: int,
                     capacity: int) -> torch.Tensor:
    """xg (G, T, D) -> the (E, G*C, D) capacity buffer: each kept (token,
    slot) a copy of the token's row, unfilled slots zero."""
    G, _, D = xg.shape
    rows = n_experts * G * capacity
    buf = xg.new_zeros(rows + 1, D)
    buf.index_put_((dest,), xg.unsqueeze(2))      # dropped: the dump row
    return buf[:rows].view(n_experts, G * capacity, D)


def indexed_experts(xg: torch.Tensor, dest: torch.Tensor,
                    weights: torch.Tensor, params: Dict[str, torch.Tensor],
                    capacity: int) -> torch.Tensor:
    """The experts over the capacity buffer, one batched matmul over E a
    projection, then each token's K rows gathered back by ``dest`` and
    summed with its ``weights`` (x's dtype) in one (1, K) x (K, D) matmul a
    token: float32 accumulation, rounded once, as the dense combine's
    GEMM. A dropped assignment reads some row at weight 0."""
    G, T, D = xg.shape
    K = dest.shape[-1]
    xe = indexed_dispatch(xg, dest, params["wg"].shape[0], capacity)
    h = F.silu(torch.bmm(xe, params["wg"])) * torch.bmm(xe, params["wu"])
    ye = torch.bmm(h, params["wd"]).reshape(-1, D)
    picked = ye.index_select(0, dest.clamp(max=ye.shape[0] - 1).reshape(-1))
    y = torch.bmm(weights.reshape(G * T, 1, K), picked.view(G * T, K, D))
    return y.view(G, T, D)


def dense_experts(xg: torch.Tensor, disp: torch.Tensor, comb: torch.Tensor,
                  params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The reference's five einsums over the (G, T, E, C) dispatch and
    combine tensors (x's dtype)."""
    xe = torch.einsum("gtec,gtd->gecd", disp, xg)
    gproj = F.silu(torch.einsum("gecd,edf->gecf", xe, params["wg"]))
    uproj = torch.einsum("gecd,edf->gecf", xe, params["wu"])
    ye = torch.einsum("gecf,efd->gecd", gproj * uproj, params["wd"])
    return torch.einsum("gtec,gecd->gtd", comb, ye)


def moe_ffn(x: torch.Tensor, params: Dict[str, torch.Tensor],
            cfg: MoEConfig, group_size: int = 512, mesh=None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, D) -> (same, float32 aux loss scalar; None where the
    config's gate gives no probabilities).

    params: router (D, E) float32; wg / wu (E, D, F); wd (E, F, D); for a
    ``DeepSeekMoEConfig`` also bias (E,) float32 and shared_wg / shared_wu
    (D, Fs), shared_wd (Fs, D).
    ``mesh`` None routes by index; a ModelMesh takes the dense path (module
    docstring), its dispatch and combine tensors' experts constrained to
    the expert axis, the layout GSPMD gives them from the expert weights,
    their groups and tokens left as they are (``sharding.constrain``:
    checked, no value changes)."""
    B, S, D = x.shape
    T_all = B * S
    g = pick_group_size(T_all, group_size)
    G = T_all // g
    C = capacity_for(g, cfg)
    xg = x.reshape(G, g, D)

    if trace.on:
        trace.begin("moe.route", x.device)
    logits = torch.einsum("gtd,de->gte", xg.to(torch.float32),
                          params["router"].to(torch.float32))
    gates, idx, probs = cfg.gate(logits, params)
    if mesh is None:
        ROUTES["indexed"] += 1
        dest, weights = index_routing(idx, gates, cfg.n_experts, C)
        weights = weights.to(x.dtype)
    else:
        ROUTES["dense"] += 1
        disp, comb = dispatch_combine_tensors(idx, gates, cfg.n_experts, C)
        free = UNCONSTRAINED
        disp, comb = (constrain(t, (free, free, "expert", None), "lm", mesh)
                      for t in (disp, comb))
        disp = disp.to(x.dtype)
        comb = comb.to(x.dtype)
    if trace.on:
        trace.end("moe.route")
        trace.begin("moe.experts", x.device)
    if mesh is None:
        y = indexed_experts(xg, dest, weights, params, C)
    else:
        y = dense_experts(xg, disp, comb, params)
    if trace.on:
        trace.end("moe.experts")
    shared = cfg.shared(xg, params)
    if shared is not None:
        y = y + shared
    if probs is None:
        return y.reshape(B, S, D), None

    # GShard load-balance loss: E * sum_e f_e * P_e, f_e from slot 0
    me = probs.mean(dim=(0, 1))                            # (E,)
    fe = F.one_hot(idx[..., 0], cfg.n_experts).to(torch.float32).mean(
        dim=(0, 1))
    aux = cfg.n_experts * torch.sum(me * fe)
    return y.reshape(B, S, D), aux


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    cfg: MoEConfig, dtype=torch.float32
                    ) -> Dict[str, torch.Tensor]:
    """Random expert weights with the reference's shapes and scales: the
    router N(0, 1/d_model) in float32, wg / wu N(0, 1/d_model) and wd
    N(0, 1/d_ff) in ``dtype``, drawn on the generator's device."""
    E = cfg.n_experts
    gdev = generator.device

    def draw(shape, scale, dt):
        return (torch.randn(shape, generator=generator, device=gdev)
                * scale).to(dt)

    return {
        "router": draw((d_model, E), d_model ** -0.5, torch.float32),
        "wg": draw((E, d_model, d_ff), d_model ** -0.5, dtype),
        "wu": draw((E, d_model, d_ff), d_model ** -0.5, dtype),
        "wd": draw((E, d_ff, d_model), d_ff ** -0.5, dtype),
    }
