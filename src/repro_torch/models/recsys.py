"""RecSys towers, the ERCache-native family: Wide&Deep, SASRec, BST, MIND.

Twin of ``repro/models/recsys.py``: the towers, the serve-side scores,
``retrieval_step``, the training losses and the train step, each with the
reference's ``mesh=`` (a ``launch.mesh.ModelMesh``): under a mesh with a
``"model"`` axis Wide&Deep's tables are row-sharded
(:func:`sharded_field_embedding_bag`, one bag launch a shard), the
retrieval of the non-MIND towers is candidate-sharded
(``collectives.sharded_topk_scores``), and the reference's sharding
constraints are checked (``sharding.constrain``), which changes no value.
The hot path is the sparse embedding lookup: on the card every
serving gather runs the hand-written ``embedding_bag`` kernel
(``kernels/embedding_bag.py``), the "TPU-target implementation" the
reference names for it, and Wide&Deep's F field bags are ONE launch
(:func:`field_embedding_bag`). The losses run the bag's plain version
(``impl="torch"``), which autograd differentiates, as the reference's
losses run its ``jnp`` bag under ``jax.grad``: the kernel has no
backward.

The ERCache tower contract is kept as a plain function:
    ``tower_step(params, inputs, cfg, impl, mesh) -> (B, cfg.user_embed_dim)``
where ``params`` is the tower's ``nn.Module`` (parameters frozen until a
train step makes them trainable). :func:`param_tree` gives the
reference's parameter pytree over a module's own Parameters.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.training.optimizer import leaf_grads, trainable

IMPLS = ("torch", "cuda")
_INT32_MAX = 2 ** 31 - 1


def _param(*shape, dtype=torch.float32, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _params(shapes, device) -> nn.ParameterList:
    return nn.ParameterList(_param(*s, device=device) for s in shapes)


# ---------------------------------------------------------------- embedding
def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mode: str = "sum",
                  impl: str = "cuda") -> torch.Tensor:
    """table (V, D); ids (..., nnz), -1 = padding -> (..., D).

    The leading dims of ``ids`` are flattened into bags before the call
    (the kernel takes 2-D ids). ``impl="cuda"`` launches the kernel and
    needs CUDA tensors; ``"torch"`` runs its plain version anywhere.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    lead, nnz = ids.shape[:-1], ids.shape[-1]
    flat = ids.reshape(-1, nnz).to(torch.int32).contiguous()
    if impl == "cuda":
        if not (flat.is_cuda and table.is_cuda):
            raise ValueError("impl='cuda' runs the CUDA kernel and needs "
                             "CUDA tensors; use impl='torch' on the CPU")
        from repro_torch.kernels import embedding_bag as bag_kernel

        out = bag_kernel.embedding_bag(table, flat, mode=mode)
    else:
        out = ref.embedding_bag_ref(table, flat, mode=mode)
    return out.reshape(*lead, table.shape[1])


def _field_rows(tables: torch.Tensor, ids: torch.Tensor):
    """The (F*V, D) view of field tables (F, V, D), and ids (B, F, nnz)
    as int32 with field f's ids offset by f*V. The view needs contiguous
    tables (never copied: a Wide&Deep table stack is 10 GB at the
    published widths)."""
    n_fields, vocab, dim = tables.shape
    if n_fields * vocab > _INT32_MAX:
        raise ValueError(f"{n_fields} x {vocab} rows overflow int32 ids")
    if not tables.is_contiguous():
        raise ValueError("the field bags need contiguous tables")
    ids = ids.to(torch.int32)
    offset = torch.arange(n_fields, dtype=torch.int32,
                          device=ids.device)[:, None] * vocab
    return tables.view(n_fields * vocab, dim), ids, ids + offset


def field_embedding_bag(tables: torch.Tensor, ids: torch.Tensor,
                        mode: str = "sum", impl: str = "cuda"
                        ) -> torch.Tensor:
    """tables (F, V, D); ids (B, F, nnz), -1 = padding -> (B, F, D): the
    per-field bags as ONE bag over the (F*V, D) view of the tables.

    Field f's ids are offset by f*V where they are >= 0 (pads stay -1),
    so each bag reads rows of its own field only and its sum is that
    field's."""
    flat, ids, rows = _field_rows(tables, ids)
    return embedding_bag(flat, torch.where(ids >= 0, rows, ids), mode, impl)


def sharded_field_embedding_bag(tables: torch.Tensor, ids: torch.Tensor,
                                mesh, rows_axis: str = "model",
                                batch_axes=("pod", "data"),
                                scatter_batch: bool = False,
                                impl: str = "cuda") -> torch.Tensor:
    """The per-field bags with tables (F, V, D) row-sharded over
    ``rows_axis``: shard s owns rows ``[s*Vl, (s+1)*Vl)`` of every field.
    ids (B, F, nnz), -1 = padding -> (B, F, D) in the table dtype.

    Shard s maps its owned ids to ``f*V + id`` in the (F*V, D) view of
    :func:`field_embedding_bag` and every other id to -1, then makes ONE
    bag launch that reads its rows only (the view is never copied). Its
    partial is in the table dtype, as the reference casts it, and the
    partials are summed in shard order, every shard added: as the
    reference's ``psum``, a bag that reads -0.0 gives +0.0 at two shards or
    more. ``scatter_batch`` (the reference's ``psum_scatter`` serving
    layout) gives the same values; ``batch_axes`` split rows only. The
    plain version (``impl="torch"``) is differentiable: a sharded train
    step runs it into the one tables tensor.

    Raises ``ValueError`` where the reference's ``shard_map`` does: a batch
    B that the batch axes present in the mesh do not divide, and with
    ``scatter_batch`` one that those axes times ``rows_axis`` do not
    divide (its tiled ``psum_scatter``)."""
    vocab, batch = tables.shape[1], ids.shape[0]
    n = mesh.shape[rows_axis]
    mesh.device()                       # refuses a mesh of distinct devices
    if vocab % n:
        raise ValueError(f"{vocab} rows do not split over {n} shards")
    vl = vocab // n
    baxes = tuple(a for a in batch_axes if a in mesh.axis_names)
    split = math.prod(mesh.shape[a] for a in baxes)
    if batch % split:
        raise ValueError(f"batch {batch} does not split over the {split} "
                         f"shards of {baxes}")
    if scatter_batch and batch % (split * n):
        raise ValueError(f"batch {batch} does not scatter over the "
                         f"{split * n} shards of {baxes + (rows_axis,)}")
    # the reference's psum (psum_scatter) of a device's (B, F, D) partials
    collectives.record(
        "reduce-scatter" if scatter_batch else "all-reduce",
        batch // split * ids.shape[1] * tables.shape[2]
        * tables.element_size(), n)
    flat, ids, rows = _field_rows(tables, ids)
    total = None
    for s in collectives.shard_range(n):
        owned = (ids >= s * vl) & (ids < (s + 1) * vl)
        part = embedding_bag(flat, torch.where(owned, rows, -1), impl=impl)
        total = part if total is None else total + part
    out_axes = baxes + (rows_axis,) if scatter_batch else baxes
    return collectives.placed(total, (out_axes or None, None, None))


def _shardable(cfg: RecsysConfig, table: torch.Tensor, mesh) -> bool:
    """The reference's rule for the row-sharded bag: a mesh with a model
    axis that divides the table's rows."""
    return (cfg.sharded_bag and mesh is not None
            and "model" in mesh.axis_names
            and table.shape[1] % mesh.shape["model"] == 0)


# ============================================================== wide & deep
class WideDeep(nn.Module):
    """Wide&Deep: F multi-hot field bags -> flatten -> float32 ReLU MLP
    (the deep tower, whose top layer is the user representation); the
    score adds a linear head and the wide part (one scalar per id)."""

    TREE_KEYS = frozenset({"tables", "wide", "mlp_w", "mlp_b", "head"})

    def __init__(self, n_sparse: int, vocab: int, d: int,
                 mlp: Sequence[int], dtype=torch.float32, device=None):
        super().__init__()
        self.tables = _param(n_sparse, vocab, d, dtype=dtype, device=device)
        self.wide = _param(n_sparse, vocab, dtype=dtype, device=device)
        dims = [n_sparse * d, *mlp]
        self.mlp_w = _params(zip(dims[:-1], dims[1:]), device)
        self.mlp_b = _params(((n,) for n in dims[1:]), device)
        self.head = _param(dims[-1], 1, device=device)

    @classmethod
    def from_config(cls, cfg: RecsysConfig, device) -> "WideDeep":
        return cls(cfg.n_sparse, cfg.vocab, cfg.embed_dim, cfg.mlp,
                   dtype=getattr(torch, cfg.dtype), device=device)

    @classmethod
    def from_tree(cls, tree: Dict, device) -> "WideDeep":
        n_sparse, vocab, d = np.shape(tree["tables"])
        dtype = (torch.bfloat16 if str(np.asarray(tree["tables"]).dtype)
                 == "bfloat16" else torch.float32)
        return cls(n_sparse, vocab, d,
                   [np.shape(w)[1] for w in tree["mlp_w"]], dtype=dtype,
                   device=device)

    def init_(self, gen: torch.Generator) -> None:
        self.tables.normal_(0.0, 0.01, generator=gen)
        self.wide.normal_(0.0, 0.01, generator=gen)
        for w in [*self.mlp_w, self.head]:
            w.copy_(L.dense_init(gen, tuple(w.shape)))
        for b in self.mlp_b:
            b.zero_()

    def _bags(self, table, ids, cfg: RecsysConfig, impl: str, mesh):
        """(bags, scatter): the field bags of ``table``, row-sharded under
        a mesh that allows it."""
        if not _shardable(cfg, table, mesh):
            return field_embedding_bag(table, ids, impl=impl), False
        scatter = cfg.serve_scatter and ids.shape[0] % mesh.size == 0
        return sharded_field_embedding_bag(table, ids, mesh,
                                           scatter_batch=scatter,
                                           impl=impl), scatter

    def tower(self, inputs, cfg: RecsysConfig, impl: str = "cuda",
              mesh=None):
        """sparse_ids (B, F, nnz) -> deep-tower top (B, mlp[-1])."""
        bags, scatter = self._bags(self.tables, inputs["sparse_ids"], cfg,
                                   impl, mesh)               # (B, F, D)
        x = bags.reshape(bags.shape[0], -1).to(torch.float32)
        if not scatter:
            x = constrain(x, ("batch", None), "recsys", mesh)
        for w, b in zip(self.mlp_w, self.mlp_b):
            x = F.relu(x @ w + b)
            if not scatter:  # scatter: batch-parallel, replicated weights
                x = constrain(x, ("batch", "ffn"), "recsys", mesh)
        return x

    def score(self, inputs, cfg: RecsysConfig, impl: str = "cuda",
              mesh=None):
        """(B,) logit: the deep head plus the wide part, whose per-field
        scalar bags are one more field bag (D = 1)."""
        deep = self.tower(inputs, cfg, impl, mesh) @ self.head
        wide_rows = self._bags(self.wide[..., None], inputs["sparse_ids"],
                               cfg, impl, mesh)[0][..., 0]    # (B, F)
        return deep[:, 0] + wide_rows.sum(dim=1).to(torch.float32)


# ==================================================================== sasrec
class SASRecBlock(nn.Module):
    """Pre-LN block: single-matrix MHA (causal or not) + pointwise FFN of
    width ``d_ff`` (default ``d``)."""

    def __init__(self, d: int, d_ff: Optional[int] = None,
                 causal: bool = True, device=None):
        super().__init__()
        d_ff = d_ff or d
        self.causal = causal
        p = lambda *s: _param(*s, device=device)
        self.wq, self.wk, self.wv, self.wo = p(d, d), p(d, d), p(d, d), \
            p(d, d)
        self.w1, self.b1, self.w2, self.b2 = p(d, d_ff), p(d_ff), \
            p(d_ff, d), p(d)
        self.ln1_w, self.ln1_b, self.ln2_w, self.ln2_b = p(d), p(d), p(d), \
            p(d)

    def init_(self, gen: torch.Generator) -> None:
        for name in ("wq", "wk", "wv", "wo", "w1", "w2"):
            w = getattr(self, name)
            w.copy_(L.dense_init(gen, tuple(w.shape)))
        for name in ("b1", "b2", "ln1_b", "ln2_b"):
            getattr(self, name).zero_()
        self.ln1_w.fill_(1.0)
        self.ln2_w.fill_(1.0)

    def forward(self, x: torch.Tensor, n_heads: int) -> torch.Tensor:
        B, S, D = x.shape
        hd = D // n_heads
        h = L.layer_norm(x, self.ln1_w, self.ln1_b)
        q = (h @ self.wq).reshape(B, S, n_heads, hd)
        k = (h @ self.wk).reshape(B, S, n_heads, hd)
        v = (h @ self.wv).reshape(B, S, n_heads, hd)
        o = L.attention(q, k, v, causal=self.causal, impl="naive")
        x = x + o.reshape(B, S, D) @ self.wo
        h2 = L.layer_norm(x, self.ln2_w, self.ln2_b)
        return x + F.relu(h2 @ self.w1 + self.b1) @ self.w2 + self.b2


class SASRec(nn.Module):
    """SASRec user tower: item + position embeddings, causal self-attention
    blocks, final layer norm; the last position is the user embedding."""

    TREE_KEYS = frozenset({"item_emb", "pos_emb", "blocks", "ln_w", "ln_b"})

    def __init__(self, vocab: int, seq_len: int, d: int, n_blocks: int,
                 device=None):
        super().__init__()
        self.item_emb = _param(vocab, d, device=device)
        self.pos_emb = _param(seq_len, d, device=device)
        self.blocks = nn.ModuleList(SASRecBlock(d, device=device)
                                    for _ in range(n_blocks))
        self.ln_w, self.ln_b = _param(d, device=device), _param(
            d, device=device)

    @classmethod
    def from_config(cls, cfg: RecsysConfig, device) -> "SASRec":
        return cls(cfg.vocab, cfg.seq_len, cfg.embed_dim, cfg.n_blocks,
                   device=device)

    @classmethod
    def from_tree(cls, tree: Dict, device) -> "SASRec":
        vocab, d = np.shape(tree["item_emb"])
        return cls(vocab, np.shape(tree["pos_emb"])[0], d,
                   len(tree["blocks"]), device=device)

    def init_(self, gen: torch.Generator) -> None:
        self.item_emb.normal_(0.0, 0.01, generator=gen)
        self.pos_emb.normal_(0.0, 0.01, generator=gen)
        for blk in self.blocks:
            blk.init_(gen)
        self.ln_w.fill_(1.0)
        self.ln_b.zero_()

    def forward(self, seq: torch.Tensor, cfg: RecsysConfig,
                impl: str = "cuda", mesh=None) -> torch.Tensor:
        """seq (B, S) item ids (-1 pad) -> (B, D)."""
        x = embedding_bag(self.item_emb, seq[..., None], impl=impl)
        x = x + self.pos_emb[None, :seq.shape[1]]
        x = torch.where((seq >= 0)[..., None], x, 0.0)
        x = constrain(x, ("batch", "seq", None), "recsys", mesh)
        for blk in self.blocks:
            x = blk(x, cfg.n_heads)
        x = L.layer_norm(x, self.ln_w, self.ln_b)
        return x[:, -1]

    def tower(self, inputs, cfg: RecsysConfig, impl: str = "cuda",
              mesh=None):
        return self(inputs["seq"], cfg, impl=impl, mesh=mesh)


# ======================================================================= bst
class BST(nn.Module):
    """Behavior Sequence Transformer: [behaviours ; target] through
    non-causal blocks (FFN width 4*D). The user tower mean-pools the
    behaviour positions with a padded target; the score runs a leaky-ReLU
    MLP over the flattened sequence."""

    TREE_KEYS = frozenset({"item_emb", "pos_emb", "blocks", "mlp_w", "mlp_b",
                           "head"})

    def __init__(self, vocab: int, seq_len: int, d: int, n_blocks: int,
                 mlp: Sequence[int], device=None):
        super().__init__()
        self.item_emb = _param(vocab, d, device=device)
        self.pos_emb = _param(seq_len + 1, d, device=device)
        self.blocks = nn.ModuleList(
            SASRecBlock(d, 4 * d, causal=False, device=device)
            for _ in range(n_blocks))
        dims = [(seq_len + 1) * d, *mlp]
        self.mlp_w = _params(zip(dims[:-1], dims[1:]), device)
        self.mlp_b = _params(((n,) for n in dims[1:]), device)
        self.head = _param(dims[-1], 1, device=device)

    @classmethod
    def from_config(cls, cfg: RecsysConfig, device) -> "BST":
        return cls(cfg.vocab, cfg.seq_len, cfg.embed_dim, cfg.n_blocks,
                   cfg.mlp, device=device)

    @classmethod
    def from_tree(cls, tree: Dict, device) -> "BST":
        vocab, d = np.shape(tree["item_emb"])
        return cls(vocab, np.shape(tree["pos_emb"])[0] - 1, d,
                   len(tree["blocks"]),
                   [np.shape(w)[1] for w in tree["mlp_w"]], device=device)

    def init_(self, gen: torch.Generator) -> None:
        self.item_emb.normal_(0.0, 0.01, generator=gen)
        self.pos_emb.normal_(0.0, 0.01, generator=gen)
        for blk in self.blocks:
            blk.init_(gen)
        for w in [*self.mlp_w, self.head]:
            w.copy_(L.dense_init(gen, tuple(w.shape)))
        for b in self.mlp_b:
            b.zero_()

    def encode(self, seq: torch.Tensor, target: torch.Tensor,
               cfg: RecsysConfig, impl: str = "cuda",
               mesh=None) -> torch.Tensor:
        """Transformer over [behaviours ; target] -> (B, S+1, D)."""
        full = torch.cat([seq, target[:, None].to(seq.dtype)], dim=1)
        x = embedding_bag(self.item_emb, full[..., None], impl=impl)
        x = x + self.pos_emb[None]
        x = torch.where((full >= 0)[..., None], x, 0.0)
        x = constrain(x, ("batch", "seq", None), "recsys", mesh)
        for blk in self.blocks:
            x = blk(x, cfg.n_heads)
        return x

    def tower(self, inputs, cfg: RecsysConfig, impl: str = "cuda",
              mesh=None):
        """Mean over all ``seq_len`` behaviour positions (pads included,
        as in the reference); the padded target is item 0, not -1, so it
        is gathered and attended to (target-independent: cacheable)."""
        seq = inputs["seq"]
        pad_target = torch.zeros(seq.shape[0], dtype=seq.dtype,
                                 device=seq.device)
        return self.encode(seq, pad_target, cfg, impl,
                           mesh)[:, :-1].mean(dim=1)

    def score(self, inputs, cfg: RecsysConfig, impl: str = "cuda",
              mesh=None):
        x = self.encode(inputs["seq"], inputs["target"], cfg, impl, mesh)
        flat = x.reshape(x.shape[0], -1)
        for w, b in zip(self.mlp_w, self.mlp_b):
            flat = F.leaky_relu(flat @ w + b)
            flat = constrain(flat, ("batch", "ffn"), "recsys", mesh)
        return (flat @ self.head)[:, 0]


# ====================================================================== mind
def _squash(z: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n2 = (z * z).sum(dim=dim, keepdim=True)
    return z * (n2 / (1.0 + n2)) / torch.sqrt(n2 + 1e-9)


class MIND(nn.Module):
    """Multi-Interest Network with Dynamic routing: K interest capsules
    routed from the behaviour sequence; the cached value is the flattened
    (B, K*D) interests."""

    TREE_KEYS = frozenset({"item_emb", "S", "b_init"})

    def __init__(self, vocab: int, d: int, n_interests: int, device=None):
        super().__init__()
        self.item_emb = _param(vocab, d, device=device)
        self.S = _param(d, d, device=device)      # shared bilinear map
        self.b_init = _param(n_interests, device=device)

    @classmethod
    def from_config(cls, cfg: RecsysConfig, device) -> "MIND":
        return cls(cfg.vocab, cfg.embed_dim, cfg.n_interests, device=device)

    @classmethod
    def from_tree(cls, tree: Dict, device) -> "MIND":
        vocab, d = np.shape(tree["item_emb"])
        return cls(vocab, d, np.shape(tree["b_init"])[0], device=device)

    def init_(self, gen: torch.Generator) -> None:
        self.item_emb.normal_(0.0, 0.01, generator=gen)
        self.S.copy_(L.dense_init(gen, tuple(self.S.shape)))
        self.b_init.normal_(0.0, 0.1, generator=gen)

    def interests(self, seq: torch.Tensor, cfg: RecsysConfig,
                  impl: str = "cuda", mesh=None) -> torch.Tensor:
        """Dynamic-routing capsules: seq (B, S) -> interests (B, K, D).
        The routing softmax runs over the K capsules and the padding
        mask applies after it. ``mesh`` is taken and unused, as in the
        reference."""
        B, S = seq.shape
        e = embedding_bag(self.item_emb, seq[..., None], impl=impl)
        mask = seq >= 0
        e = torch.where(mask[..., None], e, 0.0)
        low = torch.einsum("bsd,de->bse", e, self.S)        # mapped caps
        logits = self.b_init[None, :, None].expand(B, cfg.n_interests, S)
        for _ in range(cfg.capsule_iters):
            c = torch.softmax(logits, dim=1)                  # over K
            c = torch.where(mask[:, None, :], c, 0.0)
            u = _squash(torch.einsum("bks,bse->bke", c, low))
            logits = logits + torch.einsum("bke,bse->bks", u, low)
        return u

    def tower(self, inputs, cfg: RecsysConfig, impl: str = "cuda",
              mesh=None):
        ints = self.interests(inputs["seq"], cfg, impl, mesh)
        return ints.reshape(ints.shape[0], -1)


# ================================================================= retrieval
def retrieval_step(user_repr: torch.Tensor, candidates: torch.Tensor,
                   cfg: RecsysConfig, k_top: int = 100, mesh=None):
    """(B, D') queries vs the (N, D') candidate matrix -> (scores, ids
    int32), ``jax.lax.top_k`` of the float32 dot products (one batched
    product, no loop; ``collectives.top_k``: equal scores lower id first).
    MIND queries are (B, K*D): a candidate's score is its max over the K
    interests. Under a mesh the other towers score candidate-sharded
    (``collectives.sharded_topk_scores``), as the reference. Serving
    only: no gradient."""
    if cfg.interaction != "multi-interest" and mesh is not None:
        return collectives.sharded_topk_scores(user_repr, candidates, k_top,
                                               mesh)
    with torch.no_grad():
        cand = candidates.to(torch.float32)
        if cfg.interaction == "multi-interest":
            q = user_repr.reshape(user_repr.shape[0], cfg.n_interests,
                                  cfg.embed_dim).to(torch.float32)
            scores = torch.einsum("bkd,nd->bkn", q, cand).amax(dim=1)
        else:
            scores = user_repr.to(torch.float32) @ cand.T
        vals, ids = collectives.top_k(scores, k_top)
    return vals, ids.to(torch.int32)


# ================================================================== registry
TOWERS = {"wide-deep": WideDeep, "sasrec": SASRec, "bst": BST,
          "mind": MIND}


def get_arch_fns(arch_id: str):
    """The tower class of ``arch_id`` (SMOKE ids included)."""
    base = arch_id.replace("-smoke", "")
    if base not in TOWERS:
        raise ValueError(f"arch {arch_id!r} is not a recsys tower; towers: "
                         f"{list(TOWERS)}")
    return TOWERS[base]


def init_params(generator: torch.Generator, cfg: RecsysConfig,
                device="cuda") -> nn.Module:
    """Random weights with the reference's shapes and scales
    (``recsys.py:init_*``): embeddings N(0, 0.01^2) in ``cfg.dtype``,
    projections N(0, 1/fan_in), biases 0, norms (1, 0), MIND's routing
    init N(0, 0.1^2). Every tensor is drawn in place on ``device`` (a
    10 GB table stack is never staged), so the generator must live on
    ``device``."""
    from repro_torch.core.cache import resolve_device

    device = resolve_device(device)
    model = get_arch_fns(cfg.arch_id).from_config(cfg, device)
    with torch.no_grad():
        model.init_(generator)
    return model


def _copy_tree(module: nn.Module, tree: Dict, device) -> None:
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    for name, val in tree.items():
        dst = getattr(module, name)
        if isinstance(val, (list, tuple)):
            for sub, v in zip(dst, val, strict=True):
                if isinstance(v, dict):
                    _copy_tree(sub, v, device)
                else:
                    sub.copy_(t(v))
        else:
            dst.copy_(t(val))


def load_jax_params(np_tree: Dict, device="cuda") -> nn.Module:
    """The JAX package's parameter pytree of any tower (as numpy arrays)
    as the port's module, so both packages compute the same tower. The
    tree's keys name the tower; keys that are no tower's raise."""
    from repro_torch.core.cache import resolve_device

    device = resolve_device(device)
    keys = set(np_tree)
    found = [c for c in TOWERS.values() if c.TREE_KEYS == keys]
    if not found:
        raise ValueError(f"keys {sorted(keys)} name no recsys tower")
    model = found[0].from_tree(np_tree, device)
    with torch.no_grad():
        _copy_tree(model, np_tree, device)
    return model


def abstract_params(cfg: RecsysConfig) -> Dict:
    """The tower's parameter tree on the ``meta`` device: shapes and
    dtypes, nothing allocated (the reference's ``eval_shape``)."""
    return param_tree(get_arch_fns(cfg.arch_id).from_config(cfg, "meta"))


def tower_step(params: nn.Module, inputs: Dict[str, torch.Tensor],
               cfg: RecsysConfig, impl: str = "cuda",
               mesh=None) -> torch.Tensor:
    """The ERCache tower contract: ``inputs`` (``"sparse_ids"`` (B, F,
    nnz) for Wide&Deep, ``"seq"`` (B, S) otherwise) -> (B,
    cfg.user_embed_dim)."""
    with torch.no_grad():
        return params.tower(inputs, cfg, impl, mesh)


def wide_deep_score(params: WideDeep, inputs, cfg: RecsysConfig,
                    impl: str = "cuda", mesh=None) -> torch.Tensor:
    """Wide&Deep's serving score (B,): deep head plus the wide part."""
    with torch.no_grad():
        return params.score(inputs, cfg, impl, mesh)


def bst_score(params: BST, inputs, cfg: RecsysConfig,
              impl: str = "cuda", mesh=None) -> torch.Tensor:
    """BST's serving score (B,) of ``inputs["target"]`` (-1 masked)."""
    with torch.no_grad():
        return params.score(inputs, cfg, impl, mesh)


# ================================================================ training
def param_tree(model: nn.Module) -> Dict:
    """The reference's parameter pytree over the module's own Parameters
    (no copy): lists for the MLP stacks, a dict a block."""
    out = {}
    for key in sorted(model.TREE_KEYS):
        v = getattr(model, key)
        if isinstance(v, nn.ParameterList):
            out[key] = list(v)
        elif isinstance(v, nn.ModuleList):
            out[key] = [dict(b.named_parameters(recurse=False)) for b in v]
        else:
            out[key] = v
    return out


def bind_tree(model: nn.Module, tree: Dict) -> nn.Module:
    """Make the module's Parameters the tree's (which must be
    Parameters): the module then computes with the tree's tensors."""
    for key, val in tree.items():
        dst = getattr(model, key)
        if isinstance(dst, nn.ParameterList):
            for i, p in enumerate(val):
                dst[i] = p
        elif isinstance(dst, nn.ModuleList):
            for blk, ps in zip(dst, val, strict=True):
                for name, p in ps.items():
                    setattr(blk, name, p)
        else:
            setattr(model, key, val)
    return model


def _bce(logits, labels):
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def _sampled_softmax(user_vec, item_table, pos_ids, neg_ids):
    """Mean of log-softmax over {pos} U negs item embeddings."""
    pos_e = item_table[pos_ids.long()]                        # (B, D)
    neg_e = item_table[neg_ids.long()]                        # (B, K, D)
    pos_s = torch.einsum("bd,bd->b", user_vec, pos_e)
    neg_s = torch.einsum("bd,bkd->bk", user_vec, neg_e)
    all_s = torch.cat([pos_s[:, None], neg_s], dim=1).to(torch.float32)
    return torch.mean(torch.logsumexp(all_s, dim=1) - all_s[:, 0])


def wide_deep_loss(params: WideDeep, batch, cfg: RecsysConfig,
                   impl: str = "torch", mesh=None):
    return _bce(params.score(batch, cfg, impl, mesh), batch["labels"])


def sasrec_loss(params: SASRec, batch, cfg: RecsysConfig,
                impl: str = "torch", mesh=None):
    """Standard SASRec BCE: positive next item vs one sampled negative."""
    h = params.tower(batch, cfg, impl, mesh)                  # (B, D)
    pos = params.item_emb[batch["pos"].long()]
    neg = params.item_emb[batch["neg"].long()]
    s_pos = torch.einsum("bd,bd->b", h, pos)
    s_neg = torch.einsum("bd,bd->b", h, neg)
    ones = torch.ones_like(s_pos)
    return _bce(s_pos, ones) + _bce(s_neg, 1.0 - ones)


def bst_loss(params: BST, batch, cfg: RecsysConfig, impl: str = "torch",
             mesh=None):
    return _bce(params.score(batch, cfg, impl, mesh), batch["labels"])


def mind_loss(params: MIND, batch, cfg: RecsysConfig, impl: str = "torch",
              mesh=None, pow_p: float = 2.0):
    """Label-aware attention over interests + sampled softmax."""
    ints = params.interests(batch["seq"], cfg, impl, mesh)    # (B, K, D)
    tgt = params.item_emb[batch["target"].long()]
    att = torch.softmax(torch.einsum("bkd,bd->bk", ints, tgt) * pow_p,
                        dim=1)
    user = torch.einsum("bk,bkd->bd", att, ints)
    return _sampled_softmax(user, params.item_emb, batch["target"],
                            batch["neg"])


LOSSES = {"wide-deep": wide_deep_loss, "sasrec": sasrec_loss,
          "bst": bst_loss, "mind": mind_loss}


def loss_fn(params: nn.Module, batch, cfg: RecsysConfig,
            impl: str = "torch", mesh=None) -> torch.Tensor:
    """The tower's training loss (a float32 scalar). The default
    ``impl="torch"`` gathers with the bag's plain version, which autograd
    differentiates; the kernel refuses inputs that need a gradient."""
    get_arch_fns(cfg.arch_id)                  # raises on a non-tower arch
    return LOSSES[cfg.arch_id.replace("-smoke", "")](params, batch, cfg,
                                                     impl, mesh)


def make_train_step(cfg: RecsysConfig, optimizer, mesh=None):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    {"loss"})``: one gradient of :func:`loss_fn` and one optimizer
    application. ``params`` is the reference's pytree
    (:func:`param_tree`); the step updates it and the optimizer state IN
    PLACE and returns them, every leaf a Parameter that requires grad."""
    skeleton = get_arch_fns(cfg.arch_id).from_config(cfg, "meta")

    def step(params, opt_state, batch):
        params = trainable(params)
        loss = loss_fn(bind_tree(skeleton, params), batch, cfg, mesh=mesh)
        grads = leaf_grads(loss, params)
        opt_state = optimizer.apply(grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach()}

    return step
