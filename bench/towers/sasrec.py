"""The SASRec family: weights made from the seed, the program's tower
(``repro_torch.models.recsys.SASRec`` behind ``tower_step``), its plain
reference and its work a row."""
from __future__ import annotations

import torch

from bench import work
from bench.reference import sasrec as ref_sasrec

KEYS = ("family", "arch_id", "embed_dim", "n_blocks", "n_heads", "seq_len",
        "vocab", "dtype")


class Family:
    peak = "float32"                   # TF32 off

    def __init__(self, cfg: dict, device, backend: str):
        self.cfg = cfg
        self.device = device
        self.backend = backend
        self.d = cfg["embed_dim"]
        self.vocab = cfg["vocab"]
        self.value_dim = self.d
        if cfg["dtype"] != "float32":
            raise ValueError("the SASRec cells run float32")

    # ------------------------------------------------------------ weights
    def _shapes(self):
        d, S = self.d, self.cfg["seq_len"]
        top = [("item_emb", (self.vocab, d), 0.01, 0.0),
               ("pos_emb", (S, d), 0.01, 0.0),
               ("ln_w", (d,), 0.05, 1.0), ("ln_b", (d,), 0.05, 0.0)]
        blk = [(n, (d, d), d ** -0.5, 0.0)
               for n in ("wq", "wk", "wv", "wo", "w1", "w2")]
        blk += [("b1", (d,), 0.02, 0.0), ("b2", (d,), 0.02, 0.0),
                ("ln1_w", (d,), 0.05, 1.0), ("ln1_b", (d,), 0.05, 0.0),
                ("ln2_w", (d,), 0.05, 1.0), ("ln2_b", (d,), 0.05, 0.0)]
        return top, blk

    def make_weights(self, gen: torch.Generator) -> dict:
        """Every leaf a view of ONE normal draw on the device, scaled (and
        shifted, for the norms' gains) in place."""
        top, blk = self._shapes()
        n_blocks = self.cfg["n_blocks"]
        leaves = top + blk * n_blocks
        total = sum(torch.Size(s).numel() for _, s, _, _ in leaves)
        flat = torch.randn(total, generator=gen, device=self.device,
                           dtype=torch.float32)
        views, pos = [], 0
        for _, shape, scale, shift in leaves:
            n = torch.Size(shape).numel()
            v = flat[pos:pos + n].view(shape).mul_(scale).add_(shift)
            views.append(v)
            pos += n
        w = {name: v for (name, *_), v in zip(top, views)}
        w["blocks"] = []
        it = iter(views[len(top):])
        for _ in range(n_blocks):
            w["blocks"].append({name: next(it) for name, *_ in blk})
        return w

    # ------------------------------------------------------------ program
    def program_params(self, w: dict):
        from repro_torch.configs.base import RecsysConfig
        from repro_torch.models import recsys as rec

        c = self.cfg
        self.rcfg = RecsysConfig(
            arch_id=c["arch_id"], interaction="self-attn-seq",
            embed_dim=self.d, n_blocks=c["n_blocks"], n_heads=c["n_heads"],
            seq_len=c["seq_len"], vocab=self.vocab)
        model = rec.SASRec.from_config(self.rcfg, self.device)
        with torch.no_grad():
            for name in ("item_emb", "pos_emb", "ln_w", "ln_b"):
                getattr(model, name).copy_(w[name])
            for blk, wb in zip(model.blocks, w["blocks"], strict=True):
                for name, v in wb.items():
                    getattr(blk, name).copy_(v)
        return model

    def tower_fn(self):
        from repro_torch.models import recsys as rec

        rcfg, impl = self.rcfg, ("cuda" if self.backend == "cuda"
                                 else "torch")
        return lambda p, feats: rec.tower_step(p, feats, rcfg, impl=impl)

    @staticmethod
    def program_features(ids: torch.Tensor):
        return {"seq": ids}

    # ---------------------------------------------------------- reference
    def reference(self, w: dict, ids: torch.Tensor, mm, n_rows_call: int
                  ) -> torch.Tensor:
        return ref_sasrec.user_embedding(w, ids, self.cfg["n_heads"], mm)

    def reference_tower_fn(self, w: dict, mm, n_rows_call: int):
        """The reference in the program's place (the control)."""
        return lambda p, feats: self.reference(w, feats["seq"], mm,
                                               n_rows_call)

    # --------------------------------------------------------------- work
    def row_flops(self, history_len: int) -> int:
        return work.sasrec_row_flops(history_len, self.d,
                                     self.cfg["n_blocks"])

    def bag(self):
        """(dim, element bytes) of the one embedding bag a tower call
        makes, one nnz-1 bag a position."""
        return self.d, 4

    def attention(self, n_rows: int, history_len: int):
        return None
