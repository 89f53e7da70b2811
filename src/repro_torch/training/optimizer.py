"""Optimizers in plain torch: AdamW, Adafactor, SGD + schedules.

Twin of ``repro/training/optimizer.py``, in its float32 arithmetic: the
step counter is int32, the bias corrections are ``1 - b ** float32(step)``,
every update is computed in float32 and cast to the parameter dtype, then
added in that dtype. Adafactor (factored second moments) is the default
for the MoE LMs: its state for an (..., R, C) weight is R + C floats
instead of R*C, and its update clipping takes one RMS over a whole leaf
(a stacked (L, ...) layer leaf clips as one).

An :class:`Optimizer` has the reference's ``init(params)`` and
``update(grads, state, params) -> (updates, new_state)`` (nothing given is
modified), plus ``apply(grads, state, params) -> new_state``, which adds
each leaf's update to the parameter IN PLACE as soon as it is made and
updates the state IN PLACE (the grads may be overwritten): the train
steps use it, so that no second copy of the parameters or of the state
exists (Wide&Deep's tables are 10 GB). AdamW and SGD work on a large
leaf a block of rows at a time (element-wise arithmetic: the same numbers,
a bounded scratch; the global norm sums such a leaf block by block).

A tree is a dict (keys in sorted order, as JAX flattens), list or tuple of
tensors; None is an empty subtree (GIN's eps when it is not learnable).
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

PyTree = Any
CHUNK_ELEMS = 1 << 26          # 256 MB of float32 scratch at most a block


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], Tuple[PyTree, PyTree]]
    apply: Callable[[PyTree, PyTree, PyTree], PyTree]


# ------------------------------------------------------------------ trees
def tree_leaves(tree: PyTree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``
    (a leaf of ``tree`` may stand for a subtree of ``rest``, as
    ``flatten_up_to``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:               # an empty subtree, as in JAX
        return None
    return fn(tree, *rest)


def trainable(tree: PyTree) -> PyTree:
    """The tree with every leaf a Parameter that requires grad: a
    Parameter is switched over in place, any other tensor wrapped (its
    storage shared, no copy)."""
    def one(t):
        if isinstance(t, torch.nn.Parameter):
            return t.requires_grad_(True)
        return torch.nn.Parameter(t, requires_grad=True)
    return tree_map(one, tree)


def leaf_grads(loss: torch.Tensor, tree: PyTree) -> PyTree:
    """d loss / d every leaf of ``tree``, as a tree of the same shape; a
    leaf the loss does not reach gets zeros (as ``jax.grad`` gives)."""
    leaves = tree_leaves(tree)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for g, p in zip(grads, leaves))
    return tree_map(lambda _: next(it), tree)


def _clone(tree: PyTree) -> PyTree:
    return tree_map(lambda t: t.clone(), tree)


def _rows(t: torch.Tensor):
    """Index expressions covering ``t`` in blocks of whole leading rows of
    at most CHUNK_ELEMS elements (``...``, the whole leaf, when small)."""
    if t.dim() == 0 or t.numel() <= CHUNK_ELEMS:
        yield ...
        return
    per = max(1, CHUNK_ELEMS // max(t[0].numel(), 1))
    for lo in range(0, t.shape[0], per):
        yield slice(lo, lo + per)


def _f32(x) -> torch.Tensor:
    return x.to(torch.float32)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# ------------------------------------------------------------------ common
def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        for r in _rows(x):
            total = total + torch.sum(torch.square(_f32(x[r])))
    return torch.sqrt(total)


def _clip_scale(tree: PyTree, max_norm: float) -> torch.Tensor:
    norm = global_norm(tree)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: PyTree, max_norm: float) -> PyTree:
    """Every leaf scaled by ``min(1, max_norm / max(norm, 1e-9))`` in
    float32, back in its dtype."""
    scale = _clip_scale(tree, max_norm)
    return tree_map(lambda g: (_f32(g) * scale).to(g.dtype), tree)


# --------------------------------------------------------------- schedules
def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    to 0 at ``total``; float32 in and out."""
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant_schedule(base_lr: float):
    return lambda step: _scalar(base_lr, step)


def _step0(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _zeros32(p) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _make(init, prepare, leaf, state_keys, whole: bool = False):
    """An Optimizer from ``prepare(grads, state) -> ctx`` (the step's
    scalars; ``ctx["step"]`` is the new counter) and ``leaf(g, p, ss, ctx,
    r) -> update`` of rows ``r`` of one leaf, which writes the leaf's new
    state into ``ss`` (its entries of the ``state_keys`` trees: tensors,
    or Adafactor's per-leaf dicts) in place. ``whole`` leaves are not cut
    into row blocks."""
    def run(grads, state, params, add: bool):
        ctx = prepare(grads, state)

        def visit(g, p, *ss):
            u = None if add else torch.empty_like(p)
            for r in ([...] if whole else _rows(p)):
                ur = leaf(g, p, ss, ctx, r)
                if add:
                    p[r].add_(ur)
                else:
                    u[r] = ur
            return u

        ups = tree_map(visit, grads, params, *(state[k] for k in state_keys))
        return ups, {"step": ctx["step"],
                     **{k: state[k] for k in state_keys}}

    def update(grads, state, params):
        with torch.no_grad():
            state = {k: v if k == "step" else _clone(v)
                     for k, v in state.items()}
            return run(grads, state, params, add=False)

    def apply(grads, state, params):
        with torch.no_grad():
            return run(grads, state, params, add=True)[1]

    return Optimizer(init, update, apply)


# -------------------------------------------------------------------- sgd
def sgd(lr: float = 1e-2, momentum: float = 0.0) -> Optimizer:
    keys = () if momentum == 0.0 else ("mom",)

    def init(params):
        if momentum == 0.0:
            return {"step": _step0(params)}
        return {"step": _step0(params), "mom": tree_map(_zeros32, params)}

    def prepare(grads, state):
        return {"step": state["step"] + 1}

    def leaf(g, p, ss, ctx, r):
        if momentum == 0.0:
            return (-lr * _f32(g[r])).to(p.dtype)
        mom = ss[0]
        m = momentum * mom[r] + _f32(g[r])
        mom[r] = m
        return (-lr * m).to(p.dtype)

    return _make(init, prepare, leaf, keys)


# ------------------------------------------------------------------- adamw
def adamw(lr: Any = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: Optional[float] = 1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        return {"step": _step0(params), "m": tree_map(_zeros32, params),
                "v": tree_map(_zeros32, params)}

    def prepare(grads, state):
        step = state["step"] + 1
        t = _f32(step)
        return {"step": step, "lr": lr_fn(step),
                "bc1": 1.0 - torch.pow(_scalar(b1, t), t),
                "bc2": 1.0 - torch.pow(_scalar(b2, t), t),
                "scale": (None if clip_norm is None
                          else _clip_scale(grads, clip_norm))}

    def leaf(g, p, ss, ctx, r):
        m_s, v_s = ss
        g = g[r]
        if ctx["scale"] is not None:         # clip_by_global_norm
            g = (_f32(g) * ctx["scale"]).to(g.dtype)
        g = _f32(g)
        m = b1 * m_s[r] + (1 - b1) * g
        v = b2 * v_s[r] + (1 - b2) * torch.square(g)
        m_s[r], v_s[r] = m, v
        lr_t = ctx["lr"]
        u = -(lr_t * (m / ctx["bc1"]) / (torch.sqrt(v / ctx["bc2"]) + eps))
        if weight_decay:
            u = u - lr_t * weight_decay * _f32(p[r])
        return u.to(p.dtype)

    return _make(init, prepare, leaf, ("m", "v"))


# --------------------------------------------------------------- adafactor
def adafactor(lr: Any = 1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, min_dim_factored: int = 128
              ) -> Optimizer:
    """Factored AdaFactor (Shazeer & Stern 2018): tensors with >=2 trailing
    dims >= min_dim_factored keep row/col second-moment vectors only."""
    lr_fn = lr if callable(lr) else constant_schedule(lr)

    def factored(p) -> bool:
        return (p.dim() >= 2 and p.shape[-1] >= min_dim_factored
                and p.shape[-2] >= min_dim_factored)

    def init(params):
        def state_of(p):
            if factored(p):
                return {"vr": _zeros32(p[..., 0]),
                        "vc": _zeros32(p[..., 0, :])}
            return {"v": _zeros32(p)}
        return {"step": _step0(params), "v": tree_map(state_of, params)}

    def prepare(grads, state):
        step = state["step"] + 1
        t = _f32(step)
        return {"step": step, "lr": lr_fn(step),
                "beta": 1.0 - t ** (-decay)}

    def leaf(g, p, ss, ctx, r):
        s, beta = ss[0], ctx["beta"]
        g = _f32(g)
        g2 = torch.square(g) + eps
        if factored(p):
            vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
            vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
            r_factor = (vr / torch.clamp(vr.mean(dim=-1, keepdim=True),
                                         min=eps))[..., None]
            u = g * torch.rsqrt(r_factor * vc[..., None, :] + eps)
            s["vr"].copy_(vr)
            s["vc"].copy_(vc)
        else:
            v = beta * s["v"] + (1 - beta) * g2
            u = g * torch.rsqrt(v + eps)
            s["v"].copy_(v)
        # update clipping (RMS <= clip_threshold), one RMS a whole leaf
        rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        return (-ctx["lr"] * u).to(p.dtype)

    return _make(init, prepare, leaf, ("v",), whole=True)


def for_config(cfg, total_steps: int = 10_000) -> Optimizer:
    """Default optimizer per family/size: Adafactor for the MoE LMs, AdamW
    with weight decay for the dense LMs, plain AdamW for recsys."""
    family = getattr(cfg, "family", "lm")
    if family == "lm" and getattr(cfg, "moe", None) is not None:
        return adafactor(lr=cosine_schedule(1e-2, 100, total_steps))
    if family == "lm":
        return adamw(lr=cosine_schedule(3e-4, 100, total_steps),
                     weight_decay=0.1)
    return adamw(lr=1e-3)
