"""Where the Moonlight tower's gap to its float32 reference comes from: one
row of the ``moonlight.b8`` cell's weights and shapes (8,192 tokens, the
expert groups and capacity of a 6-row tower call), layer by layer.

Five forwards from the same weights and tokens:

* ``P``: the program (``repro_torch``, bfloat16, the flash kernel), its
  layers called one at a time;
* ``R``: ``bench/reference/lm_mla.py`` in float32, choosing its own
  experts;
* ``F``: the same reference, its experts forced to ``P``'s choices (its
  drops follow from them by the same capacity rule), so ``P`` against
  ``F`` is the precision alone and ``F`` against ``R`` the routing alone;
* ``C``: the reference at float8 (the cell's control), its own experts;
* ``CF``: the reference at float8, its experts forced to ``R``'s.

Per layer it prints one JSON line: the relative L2 gap of the row's mean
hidden state (what the user head reads) and the median and 90th
percentile per-token gap of each forward against ``R``; per MoE layer the
tokens whose top-k set differs from ``R``'s, the (token, expert)
assignments chosen by one and not the other, and the assignments both
chose that one keeps and the other drops past capacity. Then the user
embedding's gap of each forward against ``R``.

    python3 scripts/mla_route_drift.py 3200000101 3200000102   # a card
    python3 scripts/mla_route_drift.py --smoke 5               # CPU, SMOKE
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as Fn

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import harness  # noqa: E402
from bench.reference import lm_mla as ref  # noqa: E402
from bench.reference.lm_moe import group_and_capacity, rms_norm  # noqa: E402
from bench.reference.precision import matmul_at  # noqa: E402
from repro_torch.configs.mla import DeepSeekMoEConfig  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402


def keep_of(ids, group, cap, E):
    """ids (T, K) -> keep (T, K): GShard's capacity rule of
    ``lm_mla.experts``, slot by slot within each group."""
    T, K = ids.shape
    G = T // group
    gid = ids.reshape(G, group, K)
    onehot = Fn.one_hot(gid, E).to(torch.int32)
    before = torch.zeros(G, 1, E, dtype=torch.int32, device=ids.device)
    keep = torch.empty(G, group, K, dtype=torch.bool, device=ids.device)
    for s in range(K):
        m = onehot[:, :, s]
        place = (torch.cumsum(m, dim=1) - m + before).gather(
            2, gid[:, :, s:s + 1])[..., 0]
        keep[:, :, s] = place < cap
        before = before + m.sum(dim=1, keepdim=True)
    return keep.reshape(T, K)


def experts(x, lw, cfg, group, cap, mm, ids=None):
    """``lm_mla.experts`` on x (T, D), its experts ``ids`` (T, K) where
    given -> (output, ids, keep)."""
    T = x.shape[0]
    E, K = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    scores = torch.sigmoid(mm(x, lw["router"]))
    if ids is None:
        ids = torch.sort(scores + lw["router_bias"], dim=-1, descending=True,
                         stable=True).indices[:, :K]
    w = scores.gather(1, ids)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    keep = keep_of(ids, group, cap, E)
    out = ref.swiglu(x, lw["shared_wg"], lw["shared_wu"], lw["shared_wd"], mm)
    tok = torch.arange(T, device=x.device)[:, None].expand(T, K)
    for e in range(E):
        sel = (ids == e) & keep
        if sel.any():
            y = ref.swiglu(x[tok[sel]], lw["moe_wg"][e], lw["moe_wu"][e],
                           lw["moe_wd"][e], mm)
            out.index_add_(0, tok[sel], w[sel][:, None] * y)
    return out, ids, keep


def compare_routing(a, b, E):
    """Two (ids, keep) of one layer -> counts of where they differ."""
    def planes(ids, keep):
        sel = torch.zeros(ids.shape[0], E, dtype=torch.bool,
                          device=ids.device)
        return sel.scatter(1, ids, True), sel.scatter(1, ids, keep)

    (sa, ka), (sb, kb) = planes(*a), planes(*b)
    return {"tokens_set_differs": int((sa != sb).any(1).sum()),
            "assignments_flipped": int((sa & ~sb).sum()),
            "both_chose_drop_differs": int((sa & sb & (ka != kb)).sum()),
            "dropped": int((sb & ~kb).sum())}


def gap(a, b):
    a, b = a.double(), b.double()
    tok = ((a - b).norm(dim=-1) / b.norm(dim=-1)).flatten()
    return {"pooled": float((a.mean(1) - b.mean(1)).norm()
                            / b.mean(1).norm()),
            "token_median": float(tok.median()),
            "token_p90": float(tok.quantile(0.9))}


def drift(seed: int, smoke: bool):
    device = torch.device("cpu" if smoke else "cuda")
    backend = "torch" if smoke else "cuda"
    cell = harness.load_cell("moonlight.b8")
    cfg, S = cell.cfg, cell.traffic.history_len
    if smoke:
        from bench.tests.test_bench_mla import smoke_cfg
        cfg, S = dict(smoke_cfg(), dtype="bfloat16"), 256
    fam = harness.family(cfg, device, backend)
    gen = torch.Generator(device=device).manual_seed(seed)
    w = fam.make_weights(gen)
    params, lcfg = fam.program_params(w), fam.lcfg
    tokens = torch.randint(0, cfg["vocab_size"], (1, S), device=device,
                           generator=gen)
    E, eps = cfg["n_routed_experts"], cfg["rms_norm_eps"]
    group, cap = group_and_capacity(cell.miss_budget, S, cfg["moe_group_size"],
                                    E, cfg["num_experts_per_tok"],
                                    cfg["capacity_factor"])
    chosen = []                       # the program's expert ids, a layer
    gate = DeepSeekMoEConfig.gate

    def recording_gate(self, logits, p):
        out = gate(self, logits, p)
        chosen.append(out[1].reshape(-1, out[1].shape[-1]))
        return out

    f32, f8 = matmul_at("float32"), matmul_at("fp8")
    mms = {"R": f32, "F": f32, "C": f8, "CF": f8}
    pos = torch.arange(S, device=device)
    cos, sin = L.rope_tables(pos, lcfg.qk_rope_head_dim, lcfg.rope_theta)
    layers = ([(v, False) for v in tfm._stack_views(params.dense_stack,
                                                     params.n_dense)]
              + [(v, True) for v in tfm._stack_views(params.moe_stack,
                                                      params.n_moe)])
    xp = tfm._embed_tokens(params, tokens)
    xs = {k: w["embed"].float()[tokens] for k in mms}
    n_dense = cfg["first_k_dense_replace"]
    DeepSeekMoEConfig.gate = recording_gate
    try:
        with torch.no_grad():
            for i, (lp, moe) in enumerate(layers):
                xp = tfm._mla_attention(lp, xp, cos, sin, lcfg, backend)
                xp = tfm._mla_ffn(lp, xp, lcfg, moe)
                stack, j = (w["moe"], i - n_dense) if moe else (w["dense"], i)
                lw = {k: v[j].float() for k, v in stack.items()}
                route = {}
                for name, mm in mms.items():
                    x = xs[name]
                    x = x + ref.mla(rms_norm(x, lw["attn_norm"], eps), lw, cfg,
                                    pos, mm)
                    h = rms_norm(x, lw["ffn_norm"], eps)
                    if moe:
                        forced = {"F": chosen[-1],
                                  "CF": route.get("R", (None,))[0]}.get(name)
                        y, ids, keep = experts(h.reshape(S, -1), lw, cfg,
                                               group, cap, mm, forced)
                        route[name] = (ids, keep)
                        x = x + y.reshape(1, S, -1)
                    else:
                        x = x + ref.swiglu(h, lw["wg"], lw["wu"], lw["wd"], mm)
                    xs[name] = x
                row = {"layer": i, "moe": moe, "P": gap(xp, xs["R"]),
                       "P_vs_F": gap(xp, xs["F"])}
                row.update({k: gap(xs[k], xs["R"]) for k in ("F", "C", "CF")})
                if moe:
                    pid = chosen[-1]
                    row["routing_P"] = compare_routing(
                        (pid, keep_of(pid, group, cap, E)), route["R"], E)
                    row["routing_C"] = compare_routing(route["C"], route["R"],
                                                       E)
                print(json.dumps(row), flush=True)
                del lw
            fn, uh = w["final_norm"].float(), w["user_head"].float()
            emb = {k: f32(rms_norm(v, fn, eps).mean(1), uh)
                   for k, v in xs.items()}
            emb["P"] = tfm.user_embedding_from_hidden(
                params, L.rms_norm(xp, params.final_norm, lcfg.norm_eps))
            tower = tfm.user_tower_step(params, tokens, lcfg, backend=backend)
    finally:
        DeepSeekMoEConfig.gate = gate
    rel = lambda a, b: float((a.double() - b.double()).norm()
                             / b.double().norm())
    final = {k: rel(v, emb["R"]) for k, v in emb.items() if k != "R"}
    final["P_vs_F"] = rel(emb["P"], emb["F"])
    final["P_layer_by_layer_vs_tower"] = rel(emb["P"], tower)
    print(json.dumps({"seed": seed, "embedding": final}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--smoke", action="store_true",
                    help="the SMOKE widths, 256 tokens, on the CPU")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        drift(seed, args.smoke)


if __name__ == "__main__":
    main()
