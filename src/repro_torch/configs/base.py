"""Config schema of the recsys towers and their input shapes.

Twin of the LM and recsys parts of ``repro/configs/base.py``: every arch
file exports ``CONFIG`` (the published configuration) and ``SMOKE`` (a
reduced same-family variant for CPU tests). The GNN family joins with its
own slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


LM_SHAPES: Dict[str, LMShape] = {
    "train_4k": LMShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": LMShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": LMShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": LMShape("long_500k", 524_288, 1, "decode"),
}


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
class MoEConfig:
    """The expert block's knobs (a field type of :class:`LMConfig`; the MoE
    layers join with their slice)."""
    n_experts: int
    top_k: int
    dense_residual: bool = False  # arctic: MoE in parallel with a dense FFN
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class LMConfig:
    arch_id: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    moe: Optional[MoEConfig] = None
    head_dim: Optional[int] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    family: str = "lm"
    # ERCache integration: the cached user representation is the mean-pooled
    # final hidden state projected to this dim (paper ref [24] scale-up).
    user_embed_dim: int = 256
    # training-step knobs of the reference, kept so configs compare equal:
    microbatches: int = 1
    remat: bool = True
    attn_impl: str = "chunked"    # "naive" | "chunked" | "flash_kernel"
    kv_chunk: int = 1024          # KV chunk for chunked attention
    moe_aux_weight: float = 0.01
    moe_group_size: int = 512
    unroll_scans: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


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
