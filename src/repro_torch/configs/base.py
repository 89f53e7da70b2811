"""Config schema of the LMs, the GNN and the recsys towers, and their
input shapes.

Twin of ``repro/configs/base.py``: every arch file exports ``CONFIG`` (the
published configuration) and ``SMOKE`` (a reduced same-family variant for
CPU tests).
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
class GNNShape:
    name: str
    n_nodes: int
    n_edges: int
    d_feat: int = 0
    batch_nodes: int = 0          # sampled-training seeds
    fanout: Tuple[int, ...] = ()
    graphs_per_batch: int = 0     # batched-small-graphs
    kind: str = "full"            # "full" | "sampled" | "batched"


GNN_SHAPES: Dict[str, GNNShape] = {
    "full_graph_sm": GNNShape("full_graph_sm", 2_708, 10_556, d_feat=1_433,
                              kind="full"),
    "minibatch_lg": GNNShape("minibatch_lg", 232_965, 114_615_892,
                             d_feat=602, batch_nodes=1_024, fanout=(15, 10),
                             kind="sampled"),
    "ogb_products": GNNShape("ogb_products", 2_449_029, 61_859_140,
                             d_feat=100, kind="full"),
    "molecule": GNNShape("molecule", 30, 64, d_feat=16, graphs_per_batch=128,
                         kind="batched"),
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
    """The expert block's knobs (``models/moe.py``)."""
    n_experts: int
    top_k: int
    dense_residual: bool = False  # arctic: MoE in parallel with a dense FFN
    capacity_factor: float = 1.25

    def gate(self, logits, params):
        """Router logits (G, T, E) float32 -> (gates (G, T, k), expert ids
        (G, T, k), probabilities (G, T, E) for the load-balance loss): the
        softmax top-k (``models.moe.top_k_gating``)."""
        from repro_torch.models.moe import top_k_gating

        return top_k_gating(logits, self.top_k)

    def shared(self, x, params):
        """What every token of x (G, T, D) adds beside its routed experts'
        output: nothing here."""
        return None


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

    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        if self.moe is None:
            ffn = 3 * d * self.d_ff
        else:
            ffn = self.moe.n_experts * 3 * d * self.d_ff
            if self.moe.dense_residual:
                ffn += 3 * d * self.d_ff
            ffn += d * self.moe.n_experts           # router
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d

    def active_param_count(self) -> int:
        """Parameters a token runs through: top_k of the experts."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        full_ffn = self.moe.n_experts * 3 * d * self.d_ff
        active_ffn = self.moe.top_k * 3 * d * self.d_ff
        return self.param_count() - self.n_layers * (full_ffn - active_ffn)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    arch_id: str
    n_layers: int
    d_hidden: int
    aggregator: str = "sum"
    learnable_eps: bool = True
    n_classes: int = 64
    mlp_layers: int = 2
    norm_eps: float = 1e-5
    dtype: str = "float32"
    family: str = "gnn"
    user_embed_dim: int = 64
    # the dtype messages are gathered and aggregated in; the MLP runs in
    # float32
    message_dtype: str = "float32"

    def param_count(self, d_feat: int) -> int:
        per = 0
        d_in = d_feat
        for _ in range(self.n_layers):
            per += d_in * self.d_hidden + self.d_hidden * self.d_hidden \
                + 2 * self.d_hidden
            d_in = self.d_hidden
        return per + self.d_hidden * self.n_classes


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
    # under a model mesh: the row-sharded bag (False: the unsharded bag)
    sharded_bag: bool = True
    # serving layout: the bags' partial sums scattered over the batch and
    # the deep MLP batch-parallel (the same values as the summed form)
    serve_scatter: bool = False

    @property
    def user_embed_dim(self) -> int:
        if self.interaction == "multi-interest":
            return self.n_interests * self.embed_dim
        if self.interaction == "concat" and self.mlp:
            return self.mlp[-1]       # deep-tower top layer is the user repr
        return self.embed_dim
