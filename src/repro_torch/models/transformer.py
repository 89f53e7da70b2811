"""LLaMA-family decoder LM (dense + MoE): an ERCache user tower, its
prefill/decode, and its training step.

Twin of ``repro/models/transformer.py``: token embedding, ``n_layers``
pre-norm decoder layers (RMSNorm, GQA attention with RoPE, a SwiGLU FFN
and/or the MoE block of ``models/moe.py``), a final RMSNorm, then either
the mean-pooled hidden state through a projection head (the (B,
user_embed_dim) representation ERCache stores; paper ref [24], Scaling
User Modeling) or the unembedding to next-token logits (generation:
:func:`prefill_step` fills a :class:`KVCache`, :func:`decode_step` appends
one token per call; training: :func:`lm_loss`, :func:`make_train_step`).

Layer parameters are held stacked ``(L, ...)`` as in the reference's
pytree (``LMTower.stack``), and layer i reads the views ``[i]`` of one
``torch.unbind`` a forward, so the optimizer sees the reference's leaves
and shapes (Adafactor's update clipping takes one RMS over a stacked
leaf) and checkpoints carry the reference's leaf names. The ``lax.scan``
over layers becomes a Python loop; ``cfg.remat`` is
``torch.utils.checkpoint`` around each layer while autograd records.
Weights keep the reference's (in, out) layout, so every projection is
``x @ w``. Attention follows ``cfg.attn_impl`` through
``layers.attention``: with ``"flash_kernel"`` and more than 2**20
query-key pairs it runs the hand-written ``flash_attention`` kernel
(``backend="cuda"``) or its plain version (``backend="torch"``). A decode
step attends through the hand-written ``decode_attention`` kernel
(``backend="cuda"``) or the reference's
``collectives.decode_attention_local`` (``backend="torch"``). Training
runs the plain versions (``backend="torch"``): the hand kernels have no
backward.

A :class:`~repro_torch.configs.mla.MLAConfig` (the port's DeepSeek-V3
block, no counterpart in the reference; Moonlight-16B-A3B) is an
:class:`MLATower` whose leading dense layers and MoE layers are two stacks
with their own leaves: each layer attends with multi-head latent attention
(:func:`_mla_attention`: the two-stage kv projection, the latent norm,
interleaved RoPE on a 64-wide part of q and one shared key, 192-wide
scores over 128-wide values through ``layers.attention``), then a dense
SwiGLU or ``moe.moe_ffn``'s sigmoid-routed experts with shared ones. It
runs as a user tower only (:func:`user_tower_step`, no mesh):
:func:`prefill_step`, :func:`decode_step` and :func:`lm_loss` refuse it.

Each entry point takes the reference's ``mesh=`` (a
``launch.mesh.ModelMesh``): the logical-axis constraints are checked at
the reference's points (``sharding.constrain``, which changes no value),
and ``decode_step`` attends through
``collectives.seq_sharded_decode_attention`` over ``seq_axes`` (cuda: one
``decode_attention_partials`` launch a sequence shard and layer).
:func:`param_logical_axes` and :func:`kv_cache_logical_axes` name every
leaf's logical axes; :func:`abstract_params` is the parameter tree on the
``meta`` device.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.configs.mla import MLAConfig
from repro_torch.core import trace
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.training.optimizer import (global_norm, leaf_grads,
                                            trainable, tree_leaves)

BACKENDS = ("torch", "cuda")
TOP_KEYS = ("embed", "final_norm", "unembed", "user_head")


def _dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ------------------------------------------------------------------- params
def layer_param_shapes(cfg: LMConfig) -> Dict[str, Tuple[tuple, str]]:
    """name -> (shape without the layer axis, init kind): the reference's
    layer leaves, in its order."""
    D, F = cfg.d_model, cfg.d_ff
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    shapes = {
        "attn_norm": ((D,), "ones"),
        "wq": ((D, Hq * hd), "fan_in"),
        "wk": ((D, Hkv * hd), "fan_in"),
        "wv": ((D, Hkv * hd), "fan_in"),
        "wo": ((Hq * hd, D), "fan_in"),
        "ffn_norm": ((D,), "ones"),
    }
    if cfg.moe is None or cfg.moe.dense_residual:
        shapes.update({"wg": ((D, F), "fan_in"), "wu": ((D, F), "fan_in"),
                       "wd": ((F, D), "fan_in")})
    if cfg.moe is not None:
        E = cfg.moe.n_experts
        shapes.update({"router": ((D, E), "fan_in_f32"),
                       "moe_wg": ((E, D, F), "fan_in"),
                       "moe_wu": ((E, D, F), "fan_in"),
                       "moe_wd": ((E, F, D), "fan_in")})
    return shapes


LAYER_LOGICAL = {
    "attn_norm": ("layers", "embed"),
    "wq": ("layers", "embed", "heads"),
    "wk": ("layers", "embed", "kv_heads"),
    "wv": ("layers", "embed", "kv_heads"),
    "wo": ("layers", "heads", "embed"),
    "ffn_norm": ("layers", "embed"),
    "wg": ("layers", "embed", "ffn"),
    "wu": ("layers", "embed", "ffn"),
    "wd": ("layers", "ffn", "embed"),
    "router": ("layers", "embed", None),
    # expert weights: experts on model, d_model on data (a 2nd shard)
    "moe_wg": ("layers", "expert", "expert_ffn", None),
    "moe_wu": ("layers", "expert", "expert_ffn", None),
    "moe_wd": ("layers", "expert", None, "expert_ffn"),
}

TOP_LOGICAL = {
    "embed": ("vocab", "embed"),
    "unembed": ("embed", "vocab"),
    "final_norm": ("embed",),
    "user_head": ("embed", None),
}


def param_logical_axes(cfg: LMConfig) -> Dict:
    """The logical axes of every leaf of :func:`param_tree`'s tree."""
    layer_axes = {k: LAYER_LOGICAL[k] for k in layer_param_shapes(cfg)}
    return {**TOP_LOGICAL, "layers": layer_axes}


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class LayerView:
    """Layer i of a tower: each attribute is the view ``[i]`` of the
    stacked (L, ...) parameter of that name."""

    def __init__(self, stack, i: int):
        self._stack, self._i = stack, i

    def __getattr__(self, name):
        if name.startswith("_") or name not in self._stack:
            raise AttributeError(name)
        return self._stack[name][self._i]


class LMTower(nn.Module):
    """Embedding, the stacked decoder layers (``stack``: the reference's
    ``params["layers"]``), final norm, user head and unembedding.
    Parameters are frozen (serving) until a train step makes them
    trainable."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        dt = _dtype(cfg)
        self.n_layers = cfg.n_layers
        self.embed = _param((cfg.vocab, cfg.d_model), dt, device)
        self.stack = nn.ParameterDict({
            name: _param((cfg.n_layers,) + shape,
                         torch.float32 if kind == "fan_in_f32" else dt,
                         device)
            for name, (shape, kind) in layer_param_shapes(cfg).items()})
        self.final_norm = _param((cfg.d_model,), dt, device)
        self.user_head = _param((cfg.d_model, cfg.user_embed_dim), dt, device)
        self.unembed = _param((cfg.d_model, cfg.vocab), dt, device)

    @property
    def layers(self) -> List[LayerView]:
        return [LayerView(self.stack, i) for i in range(self.n_layers)]


# ---------------------------------------------------- MLA tower (port's)
MLA_TOP_KEYS = ("embed", "final_norm", "user_head")


def mla_layer_shapes(cfg: MLAConfig, moe: bool
                     ) -> Dict[str, Tuple[tuple, bool]]:
    """name -> (shape without the layer axis, held in float32) of a dense
    (``moe=False``) or an MoE layer of an :class:`MLAConfig`; every other
    leaf is in ``cfg.dtype``."""
    D, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    shapes = {
        "attn_norm": ((D,), False),
        "wq": ((D, H * cfg.qk_head_dim), False),
        "wkv_a": ((D, r + cfg.qk_rope_head_dim), False),
        "kv_norm": ((r,), False),
        "wkv_b": ((r, H * (cfg.qk_nope_head_dim + cfg.v_head_dim)), False),
        "wo": ((H * cfg.v_head_dim, D), False),
        "ffn_norm": ((D,), False),
    }
    if not moe:
        F = cfg.d_ff
        shapes.update({"wg": ((D, F), False), "wu": ((D, F), False),
                       "wd": ((F, D), False)})
        return shapes
    m = cfg.moe
    E, Fe, Fs = m.n_experts, m.d_expert, m.d_shared
    shapes.update({"router": ((D, E), True),
                   "router_bias": ((E,), True),
                   "moe_wg": ((E, D, Fe), False),
                   "moe_wu": ((E, D, Fe), False),
                   "moe_wd": ((E, Fe, D), False),
                   "shared_wg": ((D, Fs), False),
                   "shared_wu": ((D, Fs), False),
                   "shared_wd": ((Fs, D), False)})
    return shapes


class MLATower(nn.Module):
    """Embedding, the leading dense layers (``dense_stack``,
    ``first_k_dense`` of them), the MoE layers (``moe_stack``), final norm
    and user head of an :class:`MLAConfig`: a user tower, with no
    unembedding. Frozen."""

    def __init__(self, cfg: MLAConfig, device=None):
        super().__init__()
        dt = _dtype(cfg)
        self.n_dense, self.n_moe = cfg.first_k_dense, cfg.n_moe_layers
        self.embed = _param((cfg.vocab, cfg.d_model), dt, device)

        def stack(n, moe):
            return nn.ParameterDict({
                name: _param((n,) + shape, torch.float32 if f32 else dt,
                             device)
                for name, (shape, f32) in mla_layer_shapes(cfg,
                                                           moe).items()})

        self.dense_stack = stack(self.n_dense, False)
        self.moe_stack = stack(self.n_moe, True)
        self.final_norm = _param((cfg.d_model,), dt, device)
        self.user_head = _param((cfg.d_model, cfg.user_embed_dim), dt, device)


def mla_tower_from(cfg: MLAConfig, tree: Dict) -> MLATower:
    """The tower over the tensors of ``tree`` (``MLA_TOP_KEYS`` and
    ``"dense"`` / ``"moe"``: stacked layer leaves), bound as frozen
    Parameters with no copy; each must have the leaf's shape and dtype."""
    model = MLATower(cfg, device="meta")

    def bind(owner, name, t):
        want = owner[name] if isinstance(owner, nn.ParameterDict) \
            else getattr(owner, name)
        if t.shape != want.shape or t.dtype != want.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, the tower "
                             f"holds {tuple(want.shape)} {want.dtype}")
        p = nn.Parameter(t, requires_grad=False)
        if isinstance(owner, nn.ParameterDict):
            owner[name] = p
        else:
            setattr(owner, name, p)

    for name in MLA_TOP_KEYS:
        bind(model, name, tree[name])
    for key, stack in (("dense", model.dense_stack), ("moe", model.moe_stack)):
        if set(tree[key]) != set(stack):
            raise ValueError(f"{key} leaves {sorted(tree[key])}, the tower "
                             f"holds {sorted(stack)}")
        for name, t in tree[key].items():
            bind(stack, name, t)
    return model


def param_tree(model: LMTower) -> Dict:
    """The reference's parameter pytree over the module's own Parameters
    (no copy): top-level leaves and ``"layers"``, the stacked ones."""
    return {**{k: getattr(model, k) for k in TOP_KEYS},
            "layers": dict(model.stack.items())}


def abstract_params(cfg: LMConfig) -> Dict:
    """The parameter tree on the ``meta`` device: shapes and dtypes,
    nothing allocated (the reference's ``eval_shape``)."""
    return param_tree(LMTower(cfg, device="meta"))


def _param_shardings(cfg: LMConfig, params_like: Dict, mesh) -> Dict:
    """Each leaf's placement from the logical-axis rules, a dim its axes
    do not divide replicated (the reference pins the gradient sums to
    them; on the port's one-device mesh they are a checked plan)."""
    def place(logical, p):
        spec = sharding.logical_to_spec(logical, sharding.LM_RULES,
                                        mesh.axis_names)
        return sharding.Placement(
            mesh, sharding.divisible_or_replicate(spec, p.shape, mesh))

    logical = param_logical_axes(cfg)
    return {**{k: place(logical[k], params_like[k]) for k in TOP_LOGICAL},
            "layers": {k: place(lg, params_like["layers"][k])
                       for k, lg in logical["layers"].items()}}


def bind_tree(model: LMTower, tree: Dict) -> LMTower:
    """Make the module's Parameters the tree's (which must be
    Parameters): the module then computes with the tree's tensors."""
    for k in TOP_KEYS:
        setattr(model, k, tree[k])
    for name, p in tree["layers"].items():
        model.stack[name] = p
    return model


def init_params(generator: torch.Generator, cfg: LMConfig,
                device="cuda") -> LMTower:
    """Random weights with the reference's shapes and scales
    (``transformer.py:init_params``): embedding N(0, 0.02^2), projections
    N(0, 1/fan_in) (``shape[-2]`` for a 3-D expert weight), the MoE router
    in float32, user head and unembedding N(0, 1/d_model), norms 1; drawn
    in float32 on the generator's device layer by layer, cast to
    ``cfg.dtype`` on ``device``. The unembedding is drawn last, so the
    tower's weights are those of a generator that draws no unembedding."""
    from repro_torch.core.cache import resolve_device

    device = resolve_device(device)
    model = LMTower(cfg, device)
    gdev = generator.device

    def fill(p, scale):
        p.copy_((torch.randn(p.shape, generator=generator, device=gdev)
                 * scale).to(device=device, dtype=p.dtype))

    with torch.no_grad():
        fill(model.embed, 0.02)
        fill(model.user_head, cfg.d_model ** -0.5)
        model.final_norm.fill_(1.0)
        for i in range(cfg.n_layers):
            for name, (shape, kind) in layer_param_shapes(cfg).items():
                p = model.stack[name][i]
                if kind == "ones":
                    p.fill_(1.0)
                else:
                    fill(p, shape[0] ** -0.5 if len(shape) == 2
                         else shape[-2] ** -0.5)
        fill(model.unembed, cfg.d_model ** -0.5)
    return model


def load_jax_params(np_tree: Dict, cfg: LMConfig, device="cuda") -> LMTower:
    """The reference's parameter pytree (numpy leaves, stacked ``(L, ...)``
    layers) as the port's module, so both packages compute the same tower.
    Leaves go through float32 (numpy has no bfloat16), which is lossless
    for bfloat16 weights."""
    from repro_torch.core.cache import resolve_device

    device = resolve_device(device)
    model = LMTower(cfg, device)

    def put(p, arr):
        p.copy_(torch.tensor(np.asarray(arr, np.float32)).to(
            device=device, dtype=p.dtype))

    with torch.no_grad():
        for name in TOP_KEYS:
            put(getattr(model, name), np_tree[name])
        for name in layer_param_shapes(cfg):
            put(model.stack[name], np_tree["layers"][name])
    return model


# ------------------------------------------------------------------ forward
def _ffn_apply(lp, h, cfg: LMConfig, mesh=None):
    """Dense SwiGLU and/or the MoE block -> (out, aux loss or None). MoE
    first, then ``+ swiglu`` with ``dense_residual`` (Arctic)."""
    if cfg.moe is None:
        return L.swiglu(h, lp["wg"], lp["wu"], lp["wd"]), None
    y, aux = moe_lib.moe_ffn(
        h, {"router": lp["router"], "wg": lp["moe_wg"], "wu": lp["moe_wu"],
            "wd": lp["moe_wd"]}, cfg.moe, group_size=cfg.moe_group_size,
        mesh=mesh)
    if cfg.moe.dense_residual:
        y = y + L.swiglu(h, lp["wg"], lp["wu"], lp["wd"])
    return y, aux


def _layer_apply(lp, x, cos, sin, cfg: LMConfig, backend: str,
                 kv_out=None, mesh=None):
    """One pre-norm layer over x (B, T, D): x + attn(norm(x)), then + the
    FFN of norm(x). Returns (x, aux or None). With ``kv_out`` = (k, v)
    buffers of shape (B, >= T, Hkv, hd), the post-RoPE k and the v of the
    T positions are written into their first T rows."""
    B, T, _ = x.shape
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = L.apply_rope((h @ lp["wq"]).reshape(B, T, Hq, hd), cos, sin)
    q = constrain(q, ("batch", "seq", "heads", None), "lm", mesh)
    k = L.apply_rope((h @ lp["wk"]).reshape(B, T, Hkv, hd), cos, sin)
    v = (h @ lp["wv"]).reshape(B, T, Hkv, hd)
    if kv_out is not None and mesh is not None \
            and Hq % mesh.shape.get(sharding.LM_RULES["heads"], 1):
        # the heads leave the model axis free (Arctic's 56 on 16): GSPMD
        # splits the queries' sequence over it, as the cache's (the
        # reference's scores are f32[2,56,2048,1024])
        q = constrain(q, (sharding.UNCONSTRAINED, "kv_seq", None, None),
                      "lm", mesh)
    if kv_out is not None:
        kv_out[0][:, :T] = k
        kv_out[1][:, :T] = v
    o = L.attention(q, k, v, causal=True, impl=cfg.attn_impl,
                    kv_chunk=cfg.kv_chunk, backend=backend)
    x = x + o.reshape(B, T, Hq * hd) @ lp["wo"]
    f, aux = _ffn_apply(lp, L.rms_norm(x, lp["ffn_norm"], cfg.norm_eps),
                        cfg, mesh)
    return constrain(x + f, ("batch", "seq", "embed"), "lm", mesh), aux


def _stack_views(stack, n: int) -> List[Dict[str, torch.Tensor]]:
    """Per layer, ``{name: stacked[name][i]}`` from one ``unbind`` a
    leaf (its backward stacks the L grads in one go)."""
    views = {name: torch.unbind(p) for name, p in stack.items()}
    return [{name: v[i] for name, v in views.items()} for i in range(n)]


def _layer_views(params) -> List[Dict[str, torch.Tensor]]:
    return _stack_views(params.stack, params.n_layers)


def _mla_attention(lp, x, cos, sin, cfg: MLAConfig, backend: str):
    """x + MLA(norm(x)) over x (B, T, D) (module docstring; the
    ``mla.project`` phase brackets the projections, the latent norm, RoPE
    and the concatenation). q = [q_nope, RoPE(q_pe)] and k = [k_nope,
    RoPE(k_pe) broadcast over the heads] are ``qk_head_dim`` wide, v
    ``v_head_dim``; RoPE rotates DeepSeek's interleaved pairs."""
    B, T, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dv, r = cfg.v_head_dim, cfg.kv_lora_rank
    if trace.on:
        trace.begin("mla.project", x.device)
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).view(B, T, H, dn + dr)
    c, k_pe = (h @ lp["wkv_a"]).split([r, dr], dim=-1)
    kv = (L.rms_norm(c, lp["kv_norm"], cfg.norm_eps) @ lp["wkv_b"]).view(
        B, T, H, dn + dv)
    k_nope, v = kv.split([dn, dv], dim=-1)
    q_pe = L.apply_rope(L.deinterleave(q[..., dn:]), cos, sin)
    k_pe = L.apply_rope(L.deinterleave(k_pe.view(B, T, 1, dr)), cos, sin)
    q = torch.cat([q[..., :dn], q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(B, T, H, dr)], dim=-1)
    v = v.contiguous()
    if trace.on:
        trace.end("mla.project")
    o = L.attention(q, k, v, causal=True, impl=cfg.attn_impl,
                    kv_chunk=cfg.kv_chunk, backend=backend)
    return x + o.reshape(B, T, H * dv) @ lp["wo"]


def _mla_ffn(lp, x, cfg: MLAConfig, moe: bool):
    """x + FFN(norm(x)): the dense SwiGLU, or the sigmoid-routed experts
    with the shared ones (``moe.moe_ffn``)."""
    h = L.rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    if not moe:
        return x + L.swiglu(h, lp["wg"], lp["wu"], lp["wd"])
    f, _ = moe_lib.moe_ffn(
        h, {"router": lp["router"], "bias": lp["router_bias"],
            "wg": lp["moe_wg"], "wu": lp["moe_wu"], "wd": lp["moe_wd"],
            "shared_wg": lp["shared_wg"], "shared_wu": lp["shared_wu"],
            "shared_wd": lp["shared_wd"]},
        cfg.moe, group_size=cfg.moe_group_size)
    return x + f


def _forward_mla(params: MLATower, tokens: torch.Tensor, cfg: MLAConfig,
                 backend: str) -> torch.Tensor:
    """The dense layers, then the MoE layers, over tokens (B, S) -> the
    final hidden (B, S, D)."""
    x = _embed_tokens(params, tokens)
    cos, sin = L.rope_tables(torch.arange(tokens.shape[1],
                                          device=tokens.device),
                             cfg.qk_rope_head_dim, cfg.rope_theta)
    for stack, n, moe in ((params.dense_stack, params.n_dense, False),
                          (params.moe_stack, params.n_moe, True)):
        for lp in _stack_views(stack, n):
            x = _mla_attention(lp, x, cos, sin, cfg, backend)
            x = _mla_ffn(lp, x, cfg, moe)
    return L.rms_norm(x, params.final_norm, cfg.norm_eps)


def _refuse_mla(cfg: LMConfig, what: str) -> None:
    if isinstance(cfg, MLAConfig):
        raise ValueError(
            f"{what}: {cfg.arch_id} attends with multi-head latent attention "
            "(MLA), which the port runs as a user tower only "
            "(user_tower_step): it has no latent KV cache and no logits")


def _embed_tokens(params: LMTower, tokens: torch.Tensor) -> torch.Tensor:
    """The token embedding, a row gather with or without a mesh. Under a
    mesh the reference takes a one-hot matmul against the vocab-sharded
    table (``transformer.py:182``), which at 245,760 tokens x 32,000 would
    be a 15.7 GB bf16 operand here; it gives the same values but for a
    stored -0.0 element, which its sum over the vocabulary reads back as
    +0.0 (the gather keeps the sign)."""
    return params.embed[tokens.long()]


def _forward(params: LMTower, tokens: torch.Tensor, cfg: LMConfig,
             backend: str, kv_out=None, mesh=None):
    """The layers over tokens (B, S) -> (final hidden, float32 aux loss
    summed over layers). With ``kv_out`` = (k, v) stacked (L, B, >= S,
    Hkv, hd) buffers, layer i writes its k and v into
    ``kv_out[.][i, :, :S]`` (no second copy of the cache)."""
    S = tokens.shape[1]
    x = constrain(_embed_tokens(params, tokens), ("batch", "seq", "embed"),
                  "lm", mesh)
    cos, sin = L.rope_tables(torch.arange(S, device=tokens.device), cfg.hd,
                             cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, lp in enumerate(_layer_views(params)):
        kv = None if kv_out is None else (kv_out[0][i], kv_out[1][i])
        if remat:
            x, a = checkpoint(_layer_apply, lp, x, cos, sin, cfg, backend,
                              kv, mesh, use_reentrant=False)
        else:
            x, a = _layer_apply(lp, x, cos, sin, cfg, backend, kv, mesh)
        if a is not None:
            aux = aux + a
    return L.rms_norm(x, params.final_norm, cfg.norm_eps), aux


def forward_hidden(params: LMTower, tokens: torch.Tensor, cfg: LMConfig,
                   backend: str = "cuda", collect_kv: bool = False,
                   mesh=None):
    """tokens (B, S) -> final hidden (B, S, D): a plain embedding take, the
    layers in order, the final RMSNorm. With ``collect_kv`` returns
    ``(x, (k, v))``, k and v the stacked (L, B, S, Hkv, hd) post-RoPE keys
    and values (the reference returns them beside its MoE aux loss, which
    :func:`lm_loss` reads)."""
    if isinstance(cfg, MLAConfig):
        if collect_kv or mesh is not None:
            raise ValueError(f"{cfg.arch_id}: an MLA tower runs without a "
                             "mesh and collects no KV")
        return _forward_mla(params, tokens, cfg, backend)
    if not collect_kv:
        return _forward(params, tokens, cfg, backend, mesh=mesh)[0]
    kv = _kv_buffers(cfg, tokens.shape[0], tokens.shape[1], tokens.device,
                     torch.empty)
    return _forward(params, tokens, cfg, backend, kv, mesh)[0], kv


def logits_from_hidden(params: LMTower, x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> next-token logits (..., vocab) in the weights' dtype."""
    return x @ params.unembed


def user_embedding_from_hidden(params: LMTower, x: torch.Tensor
                               ) -> torch.Tensor:
    """Mean-pool over the sequence (reduced in float32, as XLA reduces a
    bfloat16 mean) -> user head: the ERCache-cached representation."""
    pooled = x.to(torch.float32).mean(dim=1).to(x.dtype)
    return pooled @ params.user_head


def user_tower_step(params: LMTower, tokens: torch.Tensor, cfg: LMConfig,
                    backend: str = "cuda", mesh=None) -> torch.Tensor:
    """The LM as an ERCache user tower: tokens (B, S) -> (B,
    user_embed_dim). ``backend="cuda"`` runs the flash kernel and needs
    CUDA tensors; ``"torch"`` runs its plain version on any device."""
    _check_backend(backend, tokens, params.embed)
    with torch.no_grad():
        return user_embedding_from_hidden(
            params, forward_hidden(params, tokens, cfg, backend, mesh=mesh))


def _check_backend(backend: str, *tensors) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "cuda" and not all(t.is_cuda for t in tensors):
        raise ValueError("backend='cuda' runs the CUDA kernels and needs "
                         "CUDA tensors; use backend='torch' on the CPU")


# --------------------------------------------------------------------- loss
def lm_loss(params: LMTower, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: LMConfig, backend: str = "torch", mesh=None):
    """Mean next-token CE (float32 reduction) + the weighted MoE aux loss;
    labels -1 are masked. Returns (loss, {"ce", "aux"}). The default
    ``backend="torch"`` runs the plain attention, which autograd
    differentiates."""
    _refuse_mla(cfg, "lm_loss")
    x, aux = _forward(params, tokens, cfg, backend, mesh=mesh)
    logits = logits_from_hidden(params, x).to(torch.float32)
    mask = (labels >= 0).to(torch.float32)
    lab = labels.clamp(min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lab[..., None])[..., 0]
    ce = torch.sum((lse - gold) * mask) / mask.sum().clamp(min=1.0)
    return ce + cfg.moe_aux_weight * aux, {"ce": ce, "aux": aux}


# --------------------------------------------------------------- train step
class TrainState(NamedTuple):
    params: Dict                # the reference's pytree (param_tree)
    opt_state: Dict
    step: torch.Tensor          # () int32


def optimizer_grad_norm(grads) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf."""
    return global_norm(grads)


def _add_into(acc_tree, tree) -> None:
    """``acc_tree += tree`` leaf by leaf, in place (a function, so that no
    loop variable keeps a leaf of ``tree`` alive after it)."""
    for acc, g in zip(tree_leaves(acc_tree), tree_leaves(tree)):
        acc.add_(g)


def make_train_step(cfg: LMConfig, optimizer, backend: str = "torch",
                    mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)``: the batch
    (``{"tokens": (B, S) int32, "labels": (B, S)}``) split
    row-contiguously into ``cfg.microbatches`` chunks, the gradients
    summed chunk by chunk in the parameter dtype and divided by their
    count, the optimizer applied once. Metrics: ``loss`` and ``ce`` (means
    over the chunks) and ``grad_norm`` (before the optimizer clips).

    The step updates ``state.params`` and the optimizer state IN PLACE
    and returns them (as a donated JAX state); every leaf becomes a
    Parameter that requires grad (``optimizer.trainable``). Under a mesh
    the gradient placements are planned once (:func:`_param_shardings`)."""
    n_micro = max(cfg.microbatches, 1)
    skeleton = LMTower(cfg, device="meta")
    if mesh is not None:
        _param_shardings(cfg, param_tree(skeleton), mesh)

    def step(state: TrainState, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        B = tokens.shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             "microbatches")
        bm = B // n_micro
        tree = trainable(state.params)
        model = bind_tree(skeleton, tree)
        gsum, losses, ces = None, [], []
        for c in range(n_micro):
            rows = slice(c * bm, (c + 1) * bm)
            loss, metrics = lm_loss(model, tokens[rows], labels[rows], cfg,
                                    backend, mesh)
            grads = leaf_grads(loss, tree)
            if gsum is None:
                gsum = grads
            else:
                _add_into(gsum, grads)
            del grads          # freed before the next microbatch's backward
            losses.append(loss.detach())
            ces.append(metrics["ce"].detach())
        grads = gsum
        if n_micro > 1:
            for g in tree_leaves(grads):
                g.div_(n_micro)
        grad_norm = optimizer_grad_norm(grads)
        new_opt = optimizer.apply(grads, state.opt_state, tree)
        metrics = {"loss": torch.stack(losses).sum() / n_micro,
                   "ce": torch.stack(ces).mean(), "grad_norm": grad_norm}
        return TrainState(tree, new_opt, state.step + 1), metrics

    return step


# ------------------------------------------------------------------- decode
class KVCache(NamedTuple):
    k: torch.Tensor        # (L, B, S, Hkv, hd)
    v: torch.Tensor        # (L, B, S, Hkv, hd)
    length: torch.Tensor   # (B,) int32: valid prefix length


def _kv_buffers(cfg: LMConfig, batch: int, max_seq: int, device, alloc
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return (alloc(shape, dtype=_dtype(cfg), device=device),
            alloc(shape, dtype=_dtype(cfg), device=device))


def kv_cache_logical_axes() -> KVCache:
    """The cache's logical axes: the sequence on ``kv_seq``."""
    ax = ("layers", "batch", "kv_seq", None, None)
    return KVCache(k=ax, v=ax, length=("batch",))


def init_kv_cache(cfg: LMConfig, batch: int, max_seq: int,
                  device="cuda") -> KVCache:
    """An empty cache of ``max_seq`` positions: zeros, length 0."""
    from repro_torch.core.cache import resolve_device

    device = resolve_device(device)
    k, v = _kv_buffers(cfg, batch, max_seq, device, torch.zeros)
    return KVCache(k, v, torch.zeros((batch,), dtype=torch.int32,
                                     device=device))


def prefill_step(params: LMTower, tokens: torch.Tensor, cfg: LMConfig,
                 backend: str = "cuda", max_seq: Optional[int] = None,
                 mesh=None) -> Tuple[torch.Tensor, KVCache]:
    """tokens (B, S) -> (last-position logits (B, vocab), the filled
    KVCache of length S). The cache holds ``max_seq`` positions (default
    S; the rest zeros, as the reference's padded cache), written layer by
    layer during the forward."""
    _refuse_mla(cfg, "prefill_step")
    _check_backend(backend, tokens, params.embed)
    B, S = tokens.shape
    max_seq = S if max_seq is None else max_seq
    if max_seq < S:
        raise ValueError(f"max_seq={max_seq} is shorter than the prompt {S}")
    with torch.no_grad():
        k, v = _kv_buffers(cfg, B, max_seq, tokens.device,
                           torch.zeros if max_seq > S else torch.empty)
        if mesh is not None:          # the reference's out_specs of the cache
            ax = kv_cache_logical_axes()
            k, v = (constrain(k, ax.k, "lm", mesh),
                    constrain(v, ax.v, "lm", mesh))
        x = _forward(params, tokens, cfg, backend, (k, v), mesh)[0]
        logits = logits_from_hidden(params, x[:, -1])
    return logits, KVCache(k, v, torch.full((B,), S, dtype=torch.int32,
                                            device=tokens.device))


def decode_step(params: LMTower, cache: KVCache, tokens: torch.Tensor,
                cfg: LMConfig, backend: str = "cuda", mesh=None,
                seq_axes=("model",)) -> Tuple[torch.Tensor, KVCache]:
    """One decode step: tokens (B,) at positions ``cache.length`` ->
    (logits (B, vocab), the cache with length + 1).

    Each layer writes its new k and v at row ``length[b]`` of the cache IN
    PLACE (the returned cache shares the given one's tensors; clone first
    to keep a before-image) and attends with ``valid = length + 1``. A row
    whose position is past the cache (``length >= S``) writes nothing, as
    JAX drops an out-of-range ``.at[].set``; it still attends to all S
    positions. ``backend="cuda"`` attends with the hand-written
    ``decode_attention`` kernel and needs CUDA tensors; ``"torch"`` with
    ``collectives.decode_attention_local`` on any device. Under a mesh the
    cache is sequence-sharded over ``seq_axes``
    (``collectives.seq_sharded_decode_attention``: one
    ``decode_attention_partials`` launch a shard on the cuda backend)."""
    from repro_torch.kernels.decode_attention import decode_attention

    _refuse_mla(cfg, "decode_step")
    _check_backend(backend, tokens, params.embed, cache.k, cache.v,
                   cache.length)
    B = tokens.shape[0]
    S = cache.k.shape[2]
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pos = cache.length
    valid = pos + 1
    # rows past the cache rewrite row S-1 with its own old value (no sync)
    rows = torch.arange(B, device=pos.device)
    at = pos.clamp(max=S - 1).long()
    keep = (pos < S)[:, None, None]
    with torch.no_grad():
        x = _embed_tokens(params, tokens)                       # (B, D)
        # (B, hd/2) tables: apply_rope on (B, H, hd) is the reference's
        # _rope_single (one position per row, broadcast over heads)
        cos, sin = L.rope_tables(pos, hd, cfg.rope_theta)
        for i, lp in enumerate(_layer_views(params)):
            h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            q = L.apply_rope((h @ lp["wq"]).reshape(B, Hq, hd), cos, sin)
            k = L.apply_rope((h @ lp["wk"]).reshape(B, Hkv, hd), cos, sin)
            v = (h @ lp["wv"]).reshape(B, Hkv, hd)
            kc, vc = cache.k[i], cache.v[i]
            kc[rows, at] = torch.where(keep, k.to(kc.dtype), kc[rows, at])
            vc[rows, at] = torch.where(keep, v.to(vc.dtype), vc[rows, at])
            if mesh is not None:
                o = collectives.seq_sharded_decode_attention(
                    q, kc, vc, mesh, seq_axes=seq_axes, kv_valid_len=valid,
                    backend=backend)
            elif backend == "cuda":
                # one block of S: the reference's decode path takes any S
                o = decode_attention(q, kc, vc, valid, bs=S)
            else:
                o = collectives.decode_attention_local(q, kc, vc,
                                                       kv_valid_len=valid)
            x = x + o.reshape(B, Hq * hd) @ lp["wo"]
            h2 = L.rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
            if cfg.moe is None:
                x = x + L.swiglu(h2, lp["wg"], lp["wu"], lp["wd"])
            else:
                # B tokens route as one group of B: dropless up to 64
                x = x + _ffn_apply(lp, h2[:, None, :], cfg,
                                   mesh)[0][:, 0, :]
        x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
        logits = logits_from_hidden(params, x)
    return logits, KVCache(cache.k, cache.v, cache.length + 1)
