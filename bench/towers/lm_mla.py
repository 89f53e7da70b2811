"""The DeepSeek-V3 decoder family (Moonlight-16B-A3B): weights made from
the seed, the program's tower (``repro_torch.models.transformer``
``user_tower_step`` over an ``MLATower``: latent attention, sigmoid-routed
experts with shared ones), its plain reference and its work a row.

The configuration file holds the published ``config.json`` keys; the
operations and bytes a row and an attention launch need are counted here
from them."""
from __future__ import annotations

import torch

from bench.reference import lm_mla as ref_mla

_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# what the program runs whatever a file says, so a file must say it: GShard
# capacity routing, and of the published keys the DeepSeek-V3 block as the
# program implements it (no q LoRA, one routing group, sigmoid scores, a
# dense layer before every-layer experts, no extra prediction layers)
AS_RUN = {"routing": "capacity", "model_type": "deepseek_v3",
          "hidden_act": "silu", "q_lora_rank": None, "n_group": 1,
          "topk_group": 1, "topk_method": "noaux_tc",
          "scoring_func": "sigmoid", "moe_layer_freq": 1,
          "num_nextn_predict_layers": 0, "attention_bias": False,
          "ep_size": 1}


class Family:
    def __init__(self, cfg: dict, device, backend: str):
        self.cfg = cfg
        self.device = device
        self.backend = backend
        self.vocab = cfg["vocab_size"]
        self.value_dim = cfg["user_embed_dim"]
        self.dtype = _DT[cfg["dtype"]]
        self.peak = cfg["dtype"]
        for key, v in dict(
                AS_RUN, num_key_value_heads=cfg["num_attention_heads"]).items():
            if cfg.get(key, v) != v:
                raise ValueError(f"{cfg['arch_id']}: {key} {cfg[key]!r}, but "
                                 f"the program runs {v!r}")
        # the program's configuration, built now: a program without the
        # MLA block fails here, before any weight or stream is made
        self.lcfg = self.lm_config()

    # ------------------------------------------------------------ weights
    def _shapes(self):
        """(top leaves, dense-layer leaves, expert-layer leaves): each
        (name, shape, scale, shift, float32?) with the layer axis first."""
        c = self.cfg
        D, H, r = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
        dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
        E, Fe = c["n_routed_experts"], c["moe_intermediate_size"]
        Fs, F = c["n_shared_experts"] * Fe, c["intermediate_size"]
        n_dense = c["first_k_dense_replace"]
        n_moe = c["num_hidden_layers"] - n_dense
        top = [("embed", (self.vocab, D), 0.02, 0.0, False),
               ("final_norm", (D,), 0.05, 1.0, False),
               ("user_head", (D, c["user_embed_dim"]), D ** -0.5, 0.0, False)]

        def attn(n):
            return [("attn_norm", (n, D), 0.05, 1.0, False),
                    ("wq", (n, D, H * (dn + dr)), D ** -0.5, 0.0, False),
                    ("wkv_a", (n, D, r + dr), D ** -0.5, 0.0, False),
                    ("kv_norm", (n, r), 0.05, 1.0, False),
                    ("wkv_b", (n, r, H * (dn + dv)), r ** -0.5, 0.0, False),
                    ("wo", (n, H * dv, D), (H * dv) ** -0.5, 0.0, False),
                    ("ffn_norm", (n, D), 0.05, 1.0, False)]

        dense = attn(n_dense) + [
            ("wg", (n_dense, D, F), D ** -0.5, 0.0, False),
            ("wu", (n_dense, D, F), D ** -0.5, 0.0, False),
            ("wd", (n_dense, F, D), F ** -0.5, 0.0, False)]
        moe = attn(n_moe) + [
            ("router", (n_moe, D, E), D ** -0.5, 0.0, True),
            ("router_bias", (n_moe, E),
             c["assumed"]["e_score_correction_bias_std"], 0.0, True),
            ("moe_wg", (n_moe, E, D, Fe), D ** -0.5, 0.0, False),
            ("moe_wu", (n_moe, E, D, Fe), D ** -0.5, 0.0, False),
            ("moe_wd", (n_moe, E, Fe, D), Fe ** -0.5, 0.0, False),
            ("shared_wg", (n_moe, D, Fs), D ** -0.5, 0.0, False),
            ("shared_wu", (n_moe, D, Fs), D ** -0.5, 0.0, False),
            ("shared_wd", (n_moe, Fs, D), Fs ** -0.5, 0.0, False)]
        return top, dense, moe

    def make_weights(self, gen: torch.Generator) -> dict:
        """Normal draws, one layer of one leaf at a time (the stacked expert
        leaves hold over 2**32 elements), in the served dtype but for the
        router and its selection bias (float32, as the program keeps them),
        scaled and shifted in place."""
        def leaf(shape, scale, shift, f32):
            t = torch.empty(shape, device=self.device,
                            dtype=torch.float32 if f32 else self.dtype)
            for part in (t if len(shape) > 2 else [t]):
                part.normal_(generator=gen).mul_(scale).add_(shift)
            return t

        top, dense, moe = self._shapes()
        w = {name: leaf(*spec) for name, *spec in top}
        w["dense"] = {name: leaf(*spec) for name, *spec in dense}
        w["moe"] = {name: leaf(*spec) for name, *spec in moe}
        return w

    # ------------------------------------------------------------ program
    def lm_config(self):
        from repro_torch.configs.mla import DeepSeekMoEConfig, MLAConfig

        c = self.cfg
        return MLAConfig(
            arch_id=c["arch_id"], n_layers=c["num_hidden_layers"],
            d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
            n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
            vocab=self.vocab,
            moe=DeepSeekMoEConfig(
                n_experts=c["n_routed_experts"],
                top_k=c["num_experts_per_tok"],
                capacity_factor=c["capacity_factor"],
                d_expert=c["moe_intermediate_size"],
                n_shared=c["n_shared_experts"],
                routed_scale=c["routed_scaling_factor"],
                norm_topk_prob=c["norm_topk_prob"]),
            rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
            dtype=c["dtype"], user_embed_dim=c["user_embed_dim"],
            attn_impl=c["attn_impl"], moe_group_size=c["moe_group_size"],
            kv_lora_rank=c["kv_lora_rank"],
            qk_nope_head_dim=c["qk_nope_head_dim"],
            qk_rope_head_dim=c["qk_rope_head_dim"],
            v_head_dim=c["v_head_dim"],
            first_k_dense=c["first_k_dense_replace"])

    def program_params(self, w: dict):
        """The program's tower over ``w``'s own tensors (bound, not
        copied: two copies of Moonlight's weights would be 64 GB)."""
        from repro_torch.models import transformer as tfm

        return tfm.mla_tower_from(self.lcfg, w)

    def tower_fn(self):
        from repro_torch.models import transformer as tfm

        lcfg, backend = self.lcfg, self.backend
        return lambda p, tokens: tfm.user_tower_step(p, tokens, lcfg,
                                                     backend=backend)

    @staticmethod
    def program_features(ids: torch.Tensor):
        return ids

    # ---------------------------------------------------------- reference
    def reference(self, w: dict, ids: torch.Tensor, mm, n_rows_call: int
                  ) -> torch.Tensor:
        return ref_mla.user_embedding(w, ids, self.cfg, n_rows_call, mm)

    def reference_tower_fn(self, w: dict, mm, n_rows_call: int):
        return lambda p, tokens: self.reference(w, tokens, mm, n_rows_call)

    # --------------------------------------------------------------- work
    def _widths(self):
        c = self.cfg
        return (c["num_attention_heads"],
                c["qk_nope_head_dim"] + c["qk_rope_head_dim"],
                c["v_head_dim"])

    def row_flops(self, history_len: int) -> int:
        """One row (2 operations a multiply-add): per token and layer the
        MLA projections (q, kv_a, kv_b, o), then the dense SwiGLU, or the
        router, the top-k routed experts' and the shared experts' three
        products each; per layer both causal attention products over the
        192-wide scores and 128-wide values; the user head once. Experts a
        token is not routed to do not count, nor do norms, RoPE, softmax,
        the dispatch or the gathers."""
        c = self.cfg
        D, r = c["hidden_size"], c["kv_lora_rank"]
        H, dqk, dv = self._widths()
        E, K, Fe = (c["n_routed_experts"], c["num_experts_per_tok"],
                    c["moe_intermediate_size"])
        proj = 2 * D * (H * dqk + r + c["qk_rope_head_dim"]) \
            + 2 * r * H * (c["qk_nope_head_dim"] + dv) + 2 * H * dv * D
        dense = 3 * 2 * D * c["intermediate_size"]
        moe = 2 * D * E + K * 3 * 2 * D * Fe \
            + 3 * 2 * D * c["n_shared_experts"] * Fe
        n_dense = c["first_k_dense_replace"]
        n_moe = c["num_hidden_layers"] - n_dense
        S = history_len
        attn = 2 * H * (dqk + dv) * (S * (S + 1) // 2)
        return (S * (c["num_hidden_layers"] * proj + n_dense * dense
                     + n_moe * moe)
                + c["num_hidden_layers"] * attn + 2 * D * c["user_embed_dim"])

    def bag(self):
        return None

    def attention(self, n_rows: int, history_len: int):
        """The flash kernel's launches a tower call (one a layer) and the
        (operations, bytes) of each: both causal products over the visible
        pairs, ``2 * rows * heads * (dqk + dv)`` operations a pair; q and k
        read at ``dqk`` and v read and the output written at ``dv`` a
        head, each once, as the program materialises them (k holds its
        shared RoPE part once a head). None where the program takes another
        path (the reference's dispatch: 2**20 query-key pairs or fewer run
        the plain product)."""
        c = self.cfg
        if c["attn_impl"] != "flash_kernel" or history_len ** 2 <= 1 << 20:
            return None
        H, dqk, dv = self._widths()
        S = history_len
        elem = torch.finfo(self.dtype).bits // 8
        ops = 2 * n_rows * H * (dqk + dv) * (S * (S + 1) // 2)
        io = n_rows * S * H * (2 * dqk + 2 * dv) * elem
        return c["num_hidden_layers"], ops, io
