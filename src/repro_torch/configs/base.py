"""Config schema of the recsys towers and their input shapes.

Twin of the recsys part of ``repro/configs/base.py``: every arch file
exports ``CONFIG`` (the published configuration) and ``SMOKE`` (a reduced
same-family variant for CPU tests). The LM and GNN families are not part
of the port's serve path and join with their own slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class RecsysShape:
    name: str
    batch: int
    n_candidates: int = 0
    kind: str = "train"           # "train" | "serve" | "retrieval"


RECSYS_SHAPES: Dict[str, RecsysShape] = {
    "train_batch": RecsysShape("train_batch", 65_536, kind="train"),
    "serve_p99": RecsysShape("serve_p99", 512, kind="serve"),
    "serve_bulk": RecsysShape("serve_bulk", 262_144, kind="serve"),
    "retrieval_cand": RecsysShape("retrieval_cand", 1,
                                  n_candidates=1_000_000, kind="retrieval"),
}


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    arch_id: str
    interaction: str                  # concat | self-attn-seq | transformer-seq | multi-interest
    embed_dim: int
    n_sparse: int = 0                 # sparse fields (wide-deep)
    mlp: Tuple[int, ...] = ()
    seq_len: int = 0
    n_blocks: int = 0
    n_heads: int = 0
    n_interests: int = 0
    capsule_iters: int = 0
    vocab: int = 1_000_000            # rows per embedding table (items/users)
    nnz_per_field: int = 4            # multi-hot ids per sparse field
    dtype: str = "float32"
    family: str = "recsys"

    @property
    def user_embed_dim(self) -> int:
        if self.interaction == "multi-interest":
            return self.n_interests * self.embed_dim
        if self.interaction == "concat" and self.mlp:
            return self.mlp[-1]       # deep-tower top layer is the user repr
        return self.embed_dim
