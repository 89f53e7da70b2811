"""The decoder-LM family with sparse experts (Granite-MoE): weights made
from the seed, the program's tower (``repro_torch.models.transformer``
``user_tower_step`` over ``models/moe.py``), its plain reference and its
work a row."""
from __future__ import annotations

import torch

from bench import work
from bench.reference import lm_moe as ref_lm

_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# what the program runs whatever a file says, so a file must say it: GShard
# capacity routing and none of Granite's multipliers (attention scaled by
# hd ** -0.5, checked apart)
AS_RUN = {"routing": "capacity", "embedding_multiplier": 1.0,
          "residual_multiplier": 1.0, "logits_scaling": 1.0}


class Family:
    def __init__(self, cfg: dict, device, backend: str):
        self.cfg = cfg
        self.device = device
        self.backend = backend
        self.vocab = cfg["vocab"]
        self.value_dim = cfg["user_embed_dim"]
        self.dtype = _DT[cfg["dtype"]]
        self.peak = cfg["dtype"]
        hd = cfg["d_model"] // cfg["n_heads"]
        for key, v in dict(AS_RUN, attention_multiplier=hd ** -0.5).items():
            if cfg.get(key, v) != v:
                raise ValueError(f"{cfg['arch_id']}: {key} {cfg[key]!r}, but "
                                 f"the program runs {v!r}")

    # ------------------------------------------------------------ weights
    def _shapes(self):
        c = self.cfg
        D, F, E, L = c["d_model"], c["d_ff"], c["n_experts"], c["n_layers"]
        hd = D // c["n_heads"]
        q, kv = c["n_heads"] * hd, c["n_kv_heads"] * hd
        top = [("embed", (self.vocab, D), 0.02, 0.0),
               ("final_norm", (D,), 0.05, 1.0),
               ("user_head", (D, c["user_embed_dim"]), D ** -0.5, 0.0)]
        layers = [("attn_norm", (L, D), 0.05, 1.0),
                  ("wq", (L, D, q), D ** -0.5, 0.0),
                  ("wk", (L, D, kv), D ** -0.5, 0.0),
                  ("wv", (L, D, kv), D ** -0.5, 0.0),
                  ("wo", (L, q, D), q ** -0.5, 0.0),
                  ("ffn_norm", (L, D), 0.05, 1.0),
                  ("moe_wg", (L, E, D, F), D ** -0.5, 0.0),
                  ("moe_wu", (L, E, D, F), D ** -0.5, 0.0),
                  ("moe_wd", (L, E, F, D), F ** -0.5, 0.0)]
        return top, layers, ("router", (L, D, E), D ** -0.5)

    def make_weights(self, gen: torch.Generator) -> dict:
        """One normal draw in the served dtype for every leaf but the
        router (one float32 draw, as the program keeps it), scaled in
        place."""
        top, layers, (rname, rshape, rscale) = self._shapes()
        leaves = top + layers
        total = sum(torch.Size(s).numel() for _, s, _, _ in leaves)
        flat = torch.randn(total, generator=gen, device=self.device,
                           dtype=self.dtype)
        w, lw, pos = {}, {}, 0
        for i, (name, shape, scale, shift) in enumerate(leaves):
            n = torch.Size(shape).numel()
            v = flat[pos:pos + n].view(shape).mul_(scale).add_(shift)
            (w if i < len(top) else lw)[name] = v
            pos += n
        lw[rname] = torch.randn(rshape, generator=gen, device=self.device,
                                dtype=torch.float32).mul_(rscale)
        w["layers"] = lw
        return w

    # ------------------------------------------------------------ program
    def lm_config(self):
        from repro_torch.configs.base import LMConfig, MoEConfig

        c = self.cfg
        return LMConfig(
            arch_id=c["arch_id"], n_layers=c["n_layers"],
            d_model=c["d_model"], n_heads=c["n_heads"],
            n_kv_heads=c["n_kv_heads"], d_ff=c["d_ff"], vocab=self.vocab,
            moe=MoEConfig(n_experts=c["n_experts"], top_k=c["top_k"],
                          capacity_factor=c["capacity_factor"]),
            rope_theta=c["rope_theta"], norm_eps=c["norm_eps"],
            dtype=c["dtype"], user_embed_dim=c["user_embed_dim"],
            attn_impl=c["attn_impl"], moe_group_size=c["moe_group_size"])

    def program_params(self, w: dict):
        from repro_torch.models import transformer as tfm

        self.lcfg = self.lm_config()
        model = tfm.LMTower(self.lcfg, self.device)
        with torch.no_grad():
            for name in ("embed", "final_norm", "user_head"):
                getattr(model, name).copy_(w[name])
            for name, v in w["layers"].items():
                model.stack[name].copy_(v)
        return model

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
        return ref_lm.user_embedding(w, ids, self.cfg, n_rows_call, mm)

    def reference_tower_fn(self, w: dict, mm, n_rows_call: int):
        return lambda p, tokens: self.reference(w, tokens, mm, n_rows_call)

    # --------------------------------------------------------------- work
    def row_flops(self, history_len: int) -> int:
        c = self.cfg
        return work.lm_moe_row_flops(
            history_len, c["d_model"], c["n_heads"], c["n_kv_heads"],
            c["n_layers"], c["n_experts"], c["top_k"], c["d_ff"],
            c["user_embed_dim"])

    def bag(self):
        return None

    def attention(self, n_rows: int, history_len: int):
        """The flash kernel's launches a tower call (one a layer) and the
        (operations, bytes) of each; None where the program takes another
        path (the reference's dispatch: 2**20 query-key pairs or fewer run
        the plain product)."""
        c = self.cfg
        if c["attn_impl"] != "flash_kernel" or history_len ** 2 <= 1 << 20:
            return None
        elem = torch.finfo(self.dtype).bits // 8
        ops, io = work.flash_work(n_rows, history_len, c["n_heads"],
                                  c["n_kv_heads"], c["d_model"] // c["n_heads"],
                                  elem)
        return c["n_layers"], ops, io
