"""GIN (Graph Isomorphism Network, arXiv:1810.00826) in plain torch.

Twin of ``repro/models/gnn.py``. Message passing runs over an edge list:
the sum aggregation is ``index_add`` (the reference's ``segment_sum``; on
the card its float atomics add in no fixed order), the max aggregation a
``scatter_reduce("amax")`` into a -inf buffer. Three regimes, one per
shape kind of ``configs.GNN_SHAPES``:

  * full-batch (``full_graph_sm``, ``ogb_products``): the whole graph a
    step, or edge-cut partitioned over the node shards of a model mesh
    (:func:`forward_partitioned`);
  * sampled (``minibatch_lg``): a fanout-sampled, padded static subgraph
    from ``models/sampler.py``;
  * batched (``molecule``): a disjoint union of small graphs with a
    ``graph_ids`` sum readout.

GIN update: h' = MLP((1 + eps) * h + sum over neighbours u of h_u), eps
learnable (None when it is not). The model is a :class:`GIN` module whose
parameters are frozen until a train step makes them trainable;
:func:`param_tree` gives the reference's pytree (``{"head", "layers":
[{"w1", "b1", "w2", "b2", "eps"}, ...]}``) over its own Parameters, so
checkpoints carry the reference's leaf names. The ERCache tower contract:
node (or graph) embeddings are the cached user representation.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.distributed.collectives import _axes_size, record
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.training.optimizer import leaf_grads, trainable

AGGREGATORS = ("sum", "max")


class Graph(NamedTuple):
    """Edge-list graph. ``senders`` / ``receivers`` (E,) int; node rows
    past the valid ones and padding edges (sender == -1) are inert."""

    node_feats: torch.Tensor                   # (N, F)
    senders: torch.Tensor                      # (E,), -1 = padding
    receivers: torch.Tensor                    # (E,)
    graph_ids: Optional[torch.Tensor] = None   # (N,) for batched graphs


# ------------------------------------------------------------------- params
def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


class GINLayer(nn.Module):
    """One GIN update's MLP (two dense layers) and its eps."""

    def __init__(self, d_in: int, d_hidden: int, learnable_eps: bool,
                 device=None):
        super().__init__()
        self.w1, self.b1 = _param(d_in, d_hidden, device=device), _param(
            d_hidden, device=device)
        self.w2, self.b2 = _param(d_hidden, d_hidden, device=device), \
            _param(d_hidden, device=device)
        self.register_parameter(
            "eps", _param(device=device) if learnable_eps else None)


class GIN(nn.Module):
    """``n_layers`` GIN updates and the classification head."""

    def __init__(self, d_feat: int, d_hidden: int, n_layers: int,
                 n_classes: int, learnable_eps: bool = True, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            GINLayer(d_feat if i == 0 else d_hidden, d_hidden,
                     learnable_eps, device) for i in range(n_layers))
        self.head = _param(d_hidden, n_classes, device=device)

    @classmethod
    def from_config(cls, cfg: GNNConfig, d_feat: int, device) -> "GIN":
        return cls(d_feat, cfg.d_hidden, cfg.n_layers, cfg.n_classes,
                   cfg.learnable_eps, device)

    @classmethod
    def from_tree(cls, tree: Dict, device) -> "GIN":
        d_feat, d_hidden = np.shape(tree["layers"][0]["w1"])
        return cls(d_feat, d_hidden, len(tree["layers"]),
                   np.shape(tree["head"])[1],
                   tree["layers"][0]["eps"] is not None, device)


def param_tree(model: GIN) -> Dict:
    """The reference's parameter pytree over the module's own Parameters
    (no copy); ``eps`` is None when it is not learnable."""
    return {"head": model.head,
            "layers": [{n: getattr(lp, n) for n in
                        ("w1", "b1", "w2", "b2", "eps")}
                       for lp in model.layers]}


def bind_tree(model: GIN, tree: Dict) -> GIN:
    """Make the module's Parameters the tree's (which must be
    Parameters): the module then computes with the tree's tensors."""
    model.head = tree["head"]
    for lp, leaves in zip(model.layers, tree["layers"], strict=True):
        for name, p in leaves.items():
            setattr(lp, name, p)
    return model


def init_params(generator: torch.Generator, cfg: GNNConfig, d_feat: int,
                device="cuda") -> GIN:
    """Random weights with the reference's shapes and scales
    (``gnn.py:init_params``): w1, w2 and the head N(0, 1/fan_in), biases
    and eps 0; drawn on the generator's device, layer by layer (w1, w2),
    the head last, and copied to ``device``."""
    from repro_torch.core.cache import resolve_device

    device = resolve_device(device)
    model = GIN.from_config(cfg, d_feat, device)
    with torch.no_grad():
        for lp in model.layers:
            for w in (lp.w1, lp.w2):
                w.copy_(L.dense_init(generator, tuple(w.shape)))
            lp.b1.zero_()
            lp.b2.zero_()
            if lp.eps is not None:
                lp.eps.zero_()
        model.head.copy_(L.dense_init(generator, tuple(model.head.shape)))
    return model


def load_jax_params(np_tree: Dict, device="cuda") -> GIN:
    """The reference's parameter pytree (numpy leaves) as the port's
    module, so both packages compute the same GIN."""
    from repro_torch.core.cache import resolve_device

    device = resolve_device(device)
    model = GIN.from_tree(np_tree, device)
    put = lambda p, a: p.copy_(torch.tensor(np.asarray(a, np.float32)))
    with torch.no_grad():
        put(model.head, np_tree["head"])
        for lp, leaves in zip(model.layers, np_tree["layers"], strict=True):
            for name, val in leaves.items():
                if val is not None:
                    put(getattr(lp, name), val)
    return model


def abstract_params(cfg: GNNConfig, d_feat: int) -> Dict:
    """The parameter tree on the ``meta`` device: shapes and dtypes,
    nothing allocated."""
    return param_tree(GIN.from_config(cfg, d_feat, "meta"))


# ------------------------------------------------------------------ forward
def _aggregate(h: torch.Tensor, senders: torch.Tensor,
               receivers: torch.Tensor, n_nodes: int, aggregator: str,
               mesh=None, message_dtype=torch.float32) -> torch.Tensor:
    """Sum (or max) of the neighbours' features per node, in
    ``message_dtype``, returned in float32. Padding edges (-1) are routed
    to a scratch row ``n_nodes`` and dropped; under max, a node without
    messages gets 0."""
    if aggregator not in AGGREGATORS:
        raise ValueError(f"aggregator must be one of {AGGREGATORS}, got "
                         f"{aggregator!r}")
    dst = torch.where(senders < 0, n_nodes, receivers).long()
    msgs = h.to(message_dtype)[senders.clamp(min=0).long()]
    msgs = constrain(msgs, ("edges", None), "gnn", mesh)
    shape = (n_nodes + 1, h.shape[1])
    if aggregator == "max":
        agg = torch.full(shape, float("-inf"), dtype=message_dtype,
                         device=h.device).scatter_reduce(
            0, dst[:, None].expand_as(msgs), msgs, "amax",
            include_self=False)
        agg = torch.where(torch.isfinite(agg), agg, 0.0)
    else:
        agg = torch.zeros(shape, dtype=message_dtype,
                          device=h.device).index_add(0, dst, msgs)
    out = constrain(agg[:n_nodes], (None, None), "gnn", mesh)
    return out.to(torch.float32)


def _update(lp: GINLayer, h: torch.Tensor, agg: torch.Tensor
            ) -> torch.Tensor:
    eps = lp.eps if lp.eps is not None else 0.0
    z = F.relu(((1.0 + eps) * h + agg) @ lp.w1 + lp.b1)
    return F.relu(z @ lp.w2 + lp.b2)


def forward(params: GIN, g: Graph, cfg: GNNConfig, mesh=None
            ) -> torch.Tensor:
    """Node embeddings (N, d_hidden) after ``n_layers`` GIN updates."""
    h = g.node_feats.to(torch.float32)
    mdt = getattr(torch, cfg.message_dtype)
    for lp in params.layers:
        agg = _aggregate(h, g.senders, g.receivers, h.shape[0],
                         cfg.aggregator, mesh, message_dtype=mdt)
        h = constrain(_update(lp, h, agg), ("nodes", None), "gnn", mesh)
    return h


# ------------------------------------------- partitioned (edge-cut) forward
def partition_edges(senders, receivers, n_nodes: int, n_shards: int):
    """Host-side edge-cut partitioning (the launcher's contract for
    :func:`forward_partitioned`): bucket edges by the RECEIVER's owner
    shard (owner s holds nodes [s*Np, (s+1)*Np)), pad each bucket to the
    largest bucket's size rounded up to 512 with inert (-1) edges, and
    return (senders', receivers') of shape (n_shards * Eb,), bucket-major.
    numpy in and out, as the reference."""
    n_p = n_nodes // n_shards
    owner = np.minimum(receivers // n_p, n_shards - 1)
    buckets_s = [senders[owner == s] for s in range(n_shards)]
    buckets_r = [receivers[owner == s] for s in range(n_shards)]
    eb = max(int(b.shape[0]) for b in buckets_s)
    eb = ((eb + 511) // 512) * 512
    out_s = np.full((n_shards, eb), -1, np.int32)
    out_r = np.zeros((n_shards, eb), np.int32)
    for s in range(n_shards):
        k = buckets_s[s].shape[0]
        out_s[s, :k] = buckets_s[s]
        out_r[s, :k] = buckets_r[s]
    return out_s.reshape(-1), out_r.reshape(-1)


def forward_partitioned(params: GIN, g: Graph, cfg: GNNConfig, mesh,
                        node_axes=("pod", "data")) -> torch.Tensor:
    """Edge-cut partitioned GIN forward over the node shards of ``mesh``
    (its ``node_axes``; s is the row-major combined index, the
    reference's ``_combined_axis_index``): shard s owns nodes ``[s*Np,
    (s+1)*Np)`` and the s-th bucket of :func:`partition_edges`' layout.
    Each layer concatenates every shard's own node states in
    ``message_dtype`` in shard order (the reference's tiled
    ``all_gather``) and each shard sums the messages of its own receivers
    (``index_add``, whatever ``cfg.aggregator``, as the reference). One
    controller runs the shards in turn on the mesh's one device. Returns
    the (N, d_hidden) node states, shard blocks in order."""
    axes = tuple(a for a in node_axes if a in mesh.axis_names)
    mesh.device()                       # refuses a mesh of distinct devices
    n_shards = _axes_size(mesh, axes)
    N = g.node_feats.shape[0]
    assert N % n_shards == 0, (N, n_shards)
    n_p = N // n_shards
    eb = g.senders.shape[0] // n_shards
    mdt = getattr(torch, cfg.message_dtype)
    h_own = [g.node_feats[s * n_p:(s + 1) * n_p].to(torch.float32)
             for s in range(n_shards)]
    for lp in params.layers:
        # the reference's tiled all_gather of every shard's own states
        record("all-gather", n_p * h_own[0].shape[1] * mdt.itemsize,
               n_shards)
        h_full = torch.cat([h.to(mdt) for h in h_own])   # (N, F) in mdt
        for s in range(n_shards):
            snd = g.senders[s * eb:(s + 1) * eb]
            dst = torch.where(snd < 0, n_p,
                              g.receivers[s * eb:(s + 1) * eb] - s * n_p)
            msgs = h_full[snd.clamp(min=0).long()]
            agg = torch.zeros((n_p + 1, h_full.shape[1]), dtype=mdt,
                              device=h_full.device).index_add(
                0, dst.long(), msgs)
            h_own[s] = _update(lp, h_own[s], agg[:n_p].to(torch.float32))
    return torch.cat(h_own)


def node_logits(params: GIN, g: Graph, cfg: GNNConfig, mesh=None,
                partitioned: bool = False) -> torch.Tensor:
    if partitioned and mesh is not None:
        h = forward_partitioned(params, g, cfg, mesh)
    else:
        h = forward(params, g, cfg, mesh)
    return h @ params.head


def graph_embeddings(params: GIN, g: Graph, cfg: GNNConfig, n_graphs: int,
                     mesh=None) -> torch.Tensor:
    """Sum readout per graph (the batched-small-graphs regime)."""
    h = forward(params, g, cfg, mesh)
    return torch.zeros((n_graphs, h.shape[1]), dtype=h.dtype,
                       device=h.device).index_add(0, g.graph_ids.long(), h)


def user_tower_step(params: GIN, g: Graph, cfg: GNNConfig, mesh=None
                    ) -> torch.Tensor:
    """ERCache tower contract: per-node user embeddings (N, d_hidden)."""
    with torch.no_grad():
        return forward(params, g, cfg, mesh)


# -------------------------------------------------------------------- train
def _ce(logits, labels, mask):
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[:, None])[:, 0]
    return torch.sum((lse - gold) * mask) / mask.sum().clamp(min=1.0)


def node_loss(params: GIN, g: Graph, labels, mask, cfg: GNNConfig,
              mesh=None, partitioned: bool = False) -> torch.Tensor:
    """Node-classification CE over the ``mask``-selected nodes (the
    train split or the seeds): the full-batch and sampled regimes."""
    return _ce(node_logits(params, g, cfg, mesh, partitioned), labels,
               mask.to(torch.float32))


def graph_loss(params: GIN, g: Graph, labels, n_graphs: int,
               cfg: GNNConfig, mesh=None) -> torch.Tensor:
    logits = graph_embeddings(params, g, cfg, n_graphs, mesh) @ params.head
    ones = torch.ones((n_graphs,), dtype=torch.float32, device=logits.device)
    return _ce(logits, labels, ones)


def make_train_step(cfg: GNNConfig, optimizer, kind: str = "node",
                    mesh=None, partitioned: bool = False):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    {"loss"})``. ``kind``: ``"node"`` (full or sampled: ``batch`` holds
    node_feats, senders, receivers, labels, mask) or ``"graph"``
    (molecules: graph_ids, labels, n_graphs); ``partitioned`` routes the
    node kind through :func:`forward_partitioned`. ``params`` is the
    reference's pytree (:func:`param_tree`); the step updates it and the
    optimizer state IN PLACE and returns them."""
    if kind not in ("node", "graph"):
        raise ValueError(f"kind must be 'node' or 'graph', got {kind!r}")

    def step(params, opt_state, batch):
        params = trainable(params)
        model = bind_tree(GIN.from_tree(params, "meta"), params)
        g = Graph(batch["node_feats"], batch["senders"], batch["receivers"],
                  graph_ids=batch.get("graph_ids"))
        if kind == "graph":
            loss = graph_loss(model, g, batch["labels"], batch["n_graphs"],
                              cfg, mesh)
        else:
            loss = node_loss(model, g, batch["labels"], batch["mask"], cfg,
                             mesh, partitioned)
        grads = leaf_grads(loss, params)
        opt_state = optimizer.apply(grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach()}

    return step
