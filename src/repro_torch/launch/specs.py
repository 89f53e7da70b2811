"""Per-(arch x shape) planning cells: step fn + abstract inputs + partition
specs for the production mesh.

Twin of ``repro/launch/specs.py``. ``build_cell(arch, shape_name, mesh)``
returns everything ``launch/dryrun.py`` needs to trace a cell without
allocating a byte of model state: the abstract inputs are tensors on the
``meta`` device (the reference's ``ShapeDtypeStruct``), the parameters
come from the models' own ``abstract_params``, and the step functions are
the port's (``make_train_step``, ``prefill_step``, ``decode_step``, the
recsys scores, ``retrieval_step``, GIN's ``make_train_step``), built on
the plain versions (``backend="torch"``) and the cell's
:class:`~repro_torch.launch.mesh.ModelMesh`. The specs are
``sharding.Spec`` trees in the reference's layout, leaf for leaf.

Conventions (the reference's):
  * Sharded-dim divisibility: GNN node/edge arrays are padded up to the
    next multiple of 512 (padding edges carry sender == -1 and are inert
    by the aggregation contract).
  * Optimizer-state specs are derived from the matching parameter's spec
    by shape (exact -> same spec; rank-reduced Adafactor factors -> the
    spec with the corresponding axis dropped).
  * ``model_flops`` (the useful-compute numerator of the roofline) is
    estimated per cell: 6 N_active tokens for training, 2 N_active tokens
    for inference, plus the attention term; analogous counts for the GNN
    and the recsys towers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import base as cfg_base
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import Spec as P
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tfm
from repro_torch.training import optimizer as opt_lib

F32 = torch.float32
I32 = torch.int32
BACKEND = "torch"                  # the planner traces the plain versions


@dataclasses.dataclass
class Cell:
    arch: str
    shape_name: str
    fn: Callable
    args: Tuple[Any, ...]                 # abstract (meta tensor) trees
    in_specs: Tuple[Any, ...]             # matching Spec trees
    out_specs: Any = None                 # None = not planned
    donate_argnums: Tuple[int, ...] = ()
    static_argnums: Tuple[int, ...] = ()
    model_flops: float = 0.0              # useful-FLOPs numerator
    note: str = ""


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _pad_to(n: int, mult: int = 512) -> int:
    return ((n + mult - 1) // mult) * mult


def _leaf_spec(logical, shape, family, mesh) -> P:
    spec = shd.logical_to_spec(logical, shd.RULES_BY_FAMILY[family],
                               mesh.axis_names)
    return shd.divisible_or_replicate(spec, shape, mesh)


def _tree_specs(logical_tree, abs_tree, family, mesh):
    """Zip logical axes with abstract shapes -> divisibility-checked
    specs, in the logical tree's structure."""
    if shd._is_logical(logical_tree):
        return _leaf_spec(logical_tree, abs_tree.shape, family, mesh)
    if isinstance(logical_tree, dict):
        return {k: _tree_specs(v, abs_tree[k], family, mesh)
                for k, v in logical_tree.items()}
    if isinstance(logical_tree, tuple) and hasattr(logical_tree, "_fields"):
        return type(logical_tree)(*(
            _tree_specs(v, a, family, mesh)
            for v, a in zip(logical_tree, abs_tree)))
    return type(logical_tree)(_tree_specs(v, a, family, mesh)
                              for v, a in zip(logical_tree, abs_tree))


def _spec_leaves(tree):
    """The Specs of a spec tree in JAX's flattening order (dict keys
    sorted, None an empty subtree)."""
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _spec_leaves(v)]
    return []


def _opt_state_specs(opt_state_abs, params_abs, param_specs):
    """Shape-match optimizer-state leaves to parameter specs (the first
    parameter of a shape, in leaf order, gives it its spec)."""
    by_shape: Dict[Tuple[int, ...], P] = {}
    for p, s in zip(opt_lib.tree_leaves(params_abs),
                    _spec_leaves(param_specs)):
        by_shape.setdefault(tuple(p.shape), s)

    def spec_of(leaf):
        shp = tuple(leaf.shape)
        if shp in by_shape:
            return by_shape[shp]
        for pshape, spec in by_shape.items():
            entries = tuple(spec) + (None,) * (len(pshape) - len(spec))
            if shp == pshape[:-1]:                    # adafactor row factor
                return P(*entries[:-1])
            if len(pshape) >= 2 and shp == pshape[:-2] + pshape[-1:]:
                return P(*(entries[:-2] + entries[-1:]))  # col factor
        return P()
    return opt_lib.tree_map(spec_of, opt_state_abs)


def _batch_spec(mesh) -> Any:
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _bsize(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n


def _replicated(tree):
    return opt_lib.tree_map(lambda _: P(), tree)


# ======================================================================== LM
# microbatch counts for train_4k, the reference's: live rematerialized
# activations (L x tokens/device/micro x D x 2B) stay ~2 GB a device
TRAIN_MICRO = {
    "yi-6b": 8, "llama3-8b": 8, "tinyllama-1.1b": 4,
    "arctic-480b": 16, "granite-moe-1b-a400m": 2,
}


def _lm_flops(cfg, tokens: int, train: bool, attn_s: int) -> float:
    n_active = cfg.active_param_count()
    mult = 6.0 if train else 2.0
    param_f = mult * n_active * tokens
    # causal attention matmuls: 2 (qk+pv) x 2 flops/MAC x S/2 avg context
    attn_f = (3.0 if train else 1.0) * cfg.n_layers * tokens \
        * 4.0 * cfg.n_heads * cfg.hd * attn_s
    return param_f + attn_f


def _decode_flops(cfg, batch: int, s: int) -> float:
    n_active = cfg.active_param_count()
    return 2.0 * n_active * batch \
        + cfg.n_layers * batch * 4.0 * cfg.n_heads * cfg.hd * s


def _lm_module(cfg, params):
    """The LM module computing with the parameter tree's tensors."""
    return tfm.bind_tree(tfm.LMTower(cfg, device="meta"), params)


def _build_lm_cell(arch: str, shape: cfg_base.LMShape, mesh,
                   overrides: Optional[dict] = None) -> Cell:
    cfg = get_config(arch)
    overrides = dict(overrides or {})
    global_batch = overrides.pop("global_batch", shape.global_batch)
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, microbatches=TRAIN_MICRO[arch])
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = dataclasses.replace(shape, global_batch=global_batch)
    bspec = _batch_spec(mesh)
    params_abs = tfm.abstract_params(cfg)
    param_specs = _tree_specs(tfm.param_logical_axes(cfg), params_abs,
                              "lm", mesh)
    B, S = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        opt = opt_lib.for_config(cfg)
        opt_abs = opt.init(params_abs)
        opt_specs = _opt_state_specs(opt_abs, params_abs, param_specs)
        state_abs = tfm.TrainState(params=params_abs, opt_state=opt_abs,
                                   step=_sds((), I32))
        state_specs = tfm.TrainState(params=param_specs,
                                     opt_state=opt_specs, step=P())
        batch_abs = {"tokens": _sds((B, S), I32),
                     "labels": _sds((B, S), I32)}
        batch_specs = {"tokens": P(bspec, None), "labels": P(bspec, None)}
        step = tfm.make_train_step(cfg, opt, backend=BACKEND, mesh=mesh)
        return Cell(
            arch=arch, shape_name=shape.name, fn=step,
            args=(state_abs, batch_abs),
            in_specs=(state_specs, batch_specs),
            out_specs=(state_specs, None),
            donate_argnums=(0,),
            model_flops=_lm_flops(cfg, B * S, True, S // 2),
            note=f"microbatches={cfg.microbatches}")

    if shape.kind == "prefill":
        def fn(params, tokens):
            return tfm.prefill_step(_lm_module(cfg, params), tokens, cfg,
                                    backend=BACKEND, mesh=mesh)
        cache_axes = tfm.kv_cache_logical_axes()
        kv_spec = _leaf_spec(cache_axes.k,
                             (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd),
                             "lm", mesh)
        return Cell(
            arch=arch, shape_name=shape.name, fn=fn,
            args=(params_abs, _sds((B, S), I32)),
            in_specs=(param_specs, P(bspec, None)),
            out_specs=(None, tfm.KVCache(k=kv_spec, v=kv_spec,
                                         length=P(bspec))),
            model_flops=_lm_flops(cfg, B * S, False, S // 2))

    # decode: one token against a KV cache of S entries
    seq_axes = ("model",) if B % _bsize(mesh) == 0 else ("data", "model")
    cache_abs = tfm.init_kv_cache(cfg, B, S, device="meta")
    bspec_kv = bspec if B % _bsize(mesh) == 0 else None
    kv_spec = P(None, bspec_kv, seq_axes if len(seq_axes) > 1 else "model",
                None, None)
    cache_specs = tfm.KVCache(k=kv_spec, v=kv_spec, length=P(bspec_kv))

    def fn(params, cache, tokens):
        return tfm.decode_step(_lm_module(cfg, params), cache, tokens, cfg,
                               backend=BACKEND, mesh=mesh, seq_axes=seq_axes)

    return Cell(
        arch=arch, shape_name=shape.name, fn=fn,
        args=(params_abs, cache_abs, _sds((B,), I32)),
        in_specs=(param_specs, cache_specs, P(bspec_kv)),
        out_specs=(None, cache_specs),
        donate_argnums=(1,),
        model_flops=_decode_flops(cfg, B, S),
        note=f"seq_axes={seq_axes}")


# ======================================================================= GNN
def _gnn_flops(cfg, n_nodes: int, n_edges: int, d_feat: int,
               train: bool) -> float:
    total = 0.0
    d_in = d_feat
    for _ in range(cfg.n_layers):
        total += n_edges * d_in                      # aggregate adds
        total += 2.0 * n_nodes * d_in * cfg.d_hidden
        total += 2.0 * n_nodes * cfg.d_hidden ** 2
        d_in = cfg.d_hidden
    total += 2.0 * n_nodes * cfg.d_hidden * cfg.n_classes
    return (3.0 if train else 1.0) * total


def _sampler_caps(shape: cfg_base.GNNShape) -> Tuple[int, int]:
    nodes = shape.batch_nodes
    edges = 0
    frontier = shape.batch_nodes
    for f in shape.fanout:
        edges += frontier * f
        frontier *= f
        nodes += frontier
    return _pad_to(nodes), _pad_to(edges)


def _build_gnn_cell(arch: str, shape: cfg_base.GNNShape, mesh,
                    overrides: Optional[dict] = None) -> Cell:
    cfg = get_config(arch)
    overrides = dict(overrides or {})
    partitioned = overrides.pop("partitioned", False)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    bspec = _batch_spec(mesh)
    opt = opt_lib.for_config(cfg)

    if shape.kind == "sampled":
        N, E = _sampler_caps(shape)
        d_feat = shape.d_feat
        kind = "node"
    elif shape.kind == "batched":
        G = shape.graphs_per_batch
        N = _pad_to(G * shape.n_nodes)
        E = _pad_to(G * shape.n_edges)
        d_feat = shape.d_feat or 16
        kind = "graph"
    else:
        N = _pad_to(shape.n_nodes)
        E = _pad_to(shape.n_edges)
        d_feat = shape.d_feat
        kind = "node"

    params_abs = gnn_lib.abstract_params(cfg, d_feat)
    param_specs = _replicated(params_abs)
    opt_abs = opt.init(params_abs)
    opt_specs = _replicated(opt_abs)

    feats, snd, rcv = (_sds((N, d_feat), F32), _sds((E,), I32),
                       _sds((E,), I32))
    feat_specs = (P(bspec, None), P(bspec), P(bspec))
    inner = gnn_lib.make_train_step(cfg, opt, kind=kind, mesh=mesh,
                                    partitioned=partitioned)

    if kind == "graph":
        n_graphs = shape.graphs_per_batch

        def fn(params, opt_state, feats, snd, rcv, gids, labels):
            batch = {"node_feats": feats, "senders": snd, "receivers": rcv,
                     "graph_ids": gids, "labels": labels,
                     "n_graphs": n_graphs}
            return inner(params, opt_state, batch)
        tail = (_sds((N,), I32), _sds((n_graphs,), I32))
        tail_specs = (P(bspec), P())
    else:
        def fn(params, opt_state, feats, snd, rcv, labels, mask):
            batch = {"node_feats": feats, "senders": snd, "receivers": rcv,
                     "labels": labels, "mask": mask}
            return inner(params, opt_state, batch)
        tail = (_sds((N,), I32), _sds((N,), torch.bool))
        tail_specs = (P(bspec), P(bspec))

    return Cell(
        arch=arch, shape_name=shape.name, fn=fn,
        args=(params_abs, opt_abs, feats, snd, rcv) + tail,
        in_specs=(param_specs, opt_specs) + feat_specs + tail_specs,
        donate_argnums=(0, 1),
        model_flops=_gnn_flops(cfg, N, E, d_feat, True),
        note=f"kind={kind} padded N={N} E={E}")


# ==================================================================== recsys
def _recsys_param_specs(cfg, params_abs, mesh):
    """Megatron-style specs for the recsys towers: each leaf's spec by the
    last dict key on its path."""
    def spec(key: str, leaf):
        shp = leaf.shape
        if key == "tables":                       # (F, V, D) row-sharded
            return shd.divisible_or_replicate(P(None, "model", None),
                                              shp, mesh)
        if key == "wide":
            return shd.divisible_or_replicate(P(None, "model"), shp, mesh)
        if key == "item_emb":
            return shd.divisible_or_replicate(P("model", None), shp, mesh)
        return P()

    def walk(tree, key):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, key) for v in tree)
        return spec(key, tree)

    specs = walk(params_abs, "")
    # Megatron column/row alternation over the deep MLP (replicated in
    # serve_scatter mode: the batch is sharded over every axis instead)
    if getattr(cfg, "serve_scatter", False) and "mlp_w" in params_abs:
        specs["mlp_w"] = [P() for _ in params_abs["mlp_w"]]
        specs["mlp_b"] = [P() for _ in params_abs["mlp_b"]]
    elif "mlp_w" in params_abs:
        ws, bs = [], []
        for i, w in enumerate(params_abs["mlp_w"]):
            col = (i % 2 == 0)
            wspec = P(None, "model") if col else P("model", None)
            bspec_ = P("model") if col else P()
            ws.append(shd.divisible_or_replicate(wspec, w.shape, mesh))
            bs.append(shd.divisible_or_replicate(
                bspec_, params_abs["mlp_b"][i].shape, mesh))
        specs["mlp_w"], specs["mlp_b"] = ws, bs
    return specs


def _recsys_inputs(cfg, B: int) -> Dict[str, torch.Tensor]:
    if cfg.arch_id.startswith("wide-deep"):
        return {"sparse_ids": _sds((B, cfg.n_sparse, cfg.nnz_per_field),
                                   I32)}
    abs_ = {"seq": _sds((B, cfg.seq_len), I32)}
    if cfg.arch_id.startswith("sasrec"):
        abs_.update(pos=_sds((B,), I32), neg=_sds((B,), I32))
    elif cfg.arch_id.startswith("bst"):
        abs_.update(target=_sds((B,), I32))
    elif cfg.arch_id.startswith("mind"):
        abs_.update(target=_sds((B,), I32), neg=_sds((B, 16), I32))
    return abs_


def _recsys_flops(cfg, B: int, train: bool) -> float:
    total = 0.0
    if cfg.arch_id.startswith("wide-deep"):
        d_in = cfg.n_sparse * cfg.embed_dim
        total += B * cfg.n_sparse * cfg.nnz_per_field * cfg.embed_dim
        for d_out in cfg.mlp:
            total += 2.0 * B * d_in * d_out
            d_in = d_out
        total += 2.0 * B * d_in
    else:
        S, D = max(cfg.seq_len, 1), cfg.embed_dim
        total += B * S * D                                 # gathers
        blocks = max(cfg.n_blocks, 1)
        total += blocks * (8.0 * B * S * D * D + 4.0 * B * S * S * D)
        if cfg.interaction == "multi-interest":
            total += cfg.capsule_iters * 4.0 * B * cfg.n_interests * S * D
        if cfg.mlp:
            d_in = (S + 1) * D
            for d_out in cfg.mlp:
                total += 2.0 * B * d_in * d_out
                d_in = d_out
    return (3.0 if train else 1.0) * total


def _rec_module(cfg, params):
    """The tower module computing with the parameter tree's tensors."""
    return rec_lib.bind_tree(
        rec_lib.get_arch_fns(cfg.arch_id).from_config(cfg, "meta"), params)


def _build_recsys_cell(arch: str, shape: cfg_base.RecsysShape, mesh,
                       overrides: Optional[dict] = None) -> Cell:
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    bspec = _batch_spec(mesh)
    params_abs = rec_lib.abstract_params(cfg)
    param_specs = _recsys_param_specs(cfg, params_abs, mesh)
    B = shape.batch

    def batch_specs(abs_):
        return {k: P(bspec, *([None] * (v.dim() - 1)))
                for k, v in abs_.items()}

    if shape.kind == "train":
        opt = opt_lib.for_config(cfg)
        opt_abs = opt.init(params_abs)
        opt_specs = _opt_state_specs(opt_abs, params_abs, param_specs)
        batch_abs = _recsys_inputs(cfg, B)
        batch_abs["labels"] = _sds((B,), F32)
        return Cell(
            arch=arch, shape_name=shape.name,
            fn=rec_lib.make_train_step(cfg, opt, mesh),
            args=(params_abs, opt_abs, batch_abs),
            in_specs=(param_specs, opt_specs, batch_specs(batch_abs)),
            donate_argnums=(0, 1),
            model_flops=_recsys_flops(cfg, B, True))

    if shape.kind == "serve":
        inputs_abs = _recsys_inputs(cfg, B)
        score = {"wide-deep": rec_lib.wide_deep_score,
                 "bst": rec_lib.bst_score}.get(
            cfg.arch_id.replace("-smoke", ""), rec_lib.tower_step)

        def fn(params, inputs):
            return score(_rec_module(cfg, params), inputs, cfg, BACKEND,
                         mesh)
        return Cell(
            arch=arch, shape_name=shape.name, fn=fn,
            args=(params_abs, inputs_abs),
            in_specs=(param_specs, batch_specs(inputs_abs)),
            model_flops=_recsys_flops(cfg, B, False))

    # retrieval: one user query vs n_candidates (padded to a shardable
    # multiple; padding rows are zero vectors whose ids the serving tier
    # drops from the returned top-k)
    N = _pad_to(shape.n_candidates)
    d_cand = (cfg.embed_dim if cfg.interaction == "multi-interest"
              else cfg.user_embed_dim)
    inputs_abs = _recsys_inputs(cfg, B)
    cands_abs = _sds((N, d_cand), F32)
    cand_axes = tuple(a for a in ("data", "model") if a in mesh.axis_names)
    cand_spec = P(cand_axes if len(cand_axes) > 1 else cand_axes[0], None)

    def fn(params, inputs, candidates):
        repr_ = rec_lib.tower_step(_rec_module(cfg, params), inputs, cfg,
                                   BACKEND, mesh)
        return rec_lib.retrieval_step(repr_, candidates, cfg, mesh=mesh)

    in_specs = {k: P(*([None] * v.dim())) for k, v in inputs_abs.items()}
    return Cell(
        arch=arch, shape_name=shape.name, fn=fn,
        args=(params_abs, inputs_abs, cands_abs),
        in_specs=(param_specs, in_specs, cand_spec),
        model_flops=_recsys_flops(cfg, B, False) + 2.0 * B * N * d_cand)


# ================================================================ cache tier
def cache_tier_specs(state) -> Any:
    """Spec tree for a ServerState / MultiServerState on the cache tier's
    1-D ``("shard",)`` mesh: every table leaf split along its bucket axis
    (``collectives.bucket_axis``: 0 of a CacheState leaf, 1 of a
    MultiCacheState leaf), the rings and the admission budget replicated.
    A table already split (``ShardedCacheState``) gets the specs of its
    unsharded type. Feed through :func:`to_shardings` for placements."""
    from repro_torch.distributed import collectives as coll

    def table(tier):
        if isinstance(tier, shd.ShardedCacheState):
            tier = tier.shards[0]
        spec = P(*([None] * coll.bucket_axis(tier)), coll.SHARD_AXIS)
        return type(tier)(*(spec for _ in tier))

    def rep(tree):
        return type(tree)(*(P() for _ in tree))

    return state._replace(direct=table(state.direct),
                          failover=table(state.failover),
                          writebuf=rep(state.writebuf),
                          touchbuf=rep(state.touchbuf),
                          budget=rep(state.budget))


# ==================================================================== public
def build_cell(arch: str, shape_name: str, mesh,
               overrides: Optional[dict] = None) -> Cell:
    """``overrides``: config field overrides plus the pseudo-field
    ``global_batch`` (LM) or ``partitioned`` (GNN), as the dry-run's
    accounting variants use them."""
    cfg = get_config(arch)
    shapes = cfg_base.LM_SHAPES if cfg.family == "lm" else (
        cfg_base.GNN_SHAPES if cfg.family == "gnn"
        else cfg_base.RECSYS_SHAPES)
    shape = shapes[shape_name]
    if cfg.family == "lm":
        return _build_lm_cell(arch, shape, mesh, overrides)
    if cfg.family == "gnn":
        return _build_gnn_cell(arch, shape, mesh, overrides)
    return _build_recsys_cell(arch, shape, mesh, overrides)


def _map_specs(fn, tree):
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    return tree


def to_shardings(mesh, tree):
    """A spec tree with every Spec placed on ``mesh``
    (``sharding.Placement``, the reference's ``NamedSharding``)."""
    return _map_specs(lambda s: shd.Placement(mesh, s), tree)


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The per-device shard shape of a tensor of ``shape`` laid out by
    ``spec`` on ``mesh``: each dim divided by the product of its axes."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"over {n} shards ({spec})")
        out.append(dim // n)
    return tuple(out)
