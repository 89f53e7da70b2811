"""Per-device placement of the planner's traced tensors: the SPMD view of
a cell traced on ``meta`` tensors.

The reference plans a cell by compiling it for one device of the mesh:
GSPMD propagates each argument's sharding through the program, derives
the collectives that the sharding constraints ask for, and its cost
analysis counts the work and bytes of that one device. The port runs its
models as plain PyTorch on one device, so :class:`LayoutCounter` redoes
the propagation over the aten ops of the trace. Every live tensor carries
a :class:`Layout`: for each dimension the mesh axes it is split over, and
the axes over which it holds a partial sum. Arguments start from the
cell's specs; every op derives its outputs' layouts from its inputs':

* products (``mm``, ``bmm``, ``addmm``; ``einsum`` and ``linear`` lower to
  them): a contracted dimension split over an axis gives a partial sum
  over it; a contracted dimension split over an axis that the output is
  also split over is all-gathered first (GSPMD's dot partitioning); a
  contraction split on one operand only is all-gathered instead where
  that moves less than all-reducing the output (a small operand of a
  large product); an operand's partial sum is all-reduced first where the
  output splits over its axes, or where the product would grow it (GSPMD
  reduces a partial dot output at the dot); where both operands split
  their free dims over one axis, the smaller is gathered;
* element-wise ops: operands are aligned (a replicated operand is sliced
  for free); an operand split over an axis that the output splits another
  of its dims over moves it there in one all-to-all (GSPMD's reshard of
  an axis between dims); a partial sum passes only a linear op (a sum, a
  difference, a product or quotient by a non-partial operand, a cast),
  any other op all-reduces it first, and every view of the reduced value
  reads it reduced;
* sums and means over a split dimension give a partial sum; other
  reductions all-reduce their output; softmax, sorts, top-k and scans
  all-gather a split dimension first;
* views keep or regroup each dimension's axes; where dims merge with a
  split on a minor one (an einsum's merged batch or contraction, separate
  dims to GSPMD), the merge is remembered on the merged tensor's storage
  and carried by products to their output's dims, and splitting that dim
  back puts each axis on the dim it came from; a dim cut into parts
  (``split``, ``chunk``: RoPE's halves) costs a collective-permute a part,
  each lying on some of the dim's devices, and joining parts split alike
  along the joined dim (``cat``) one all-to-all a part; a gather from a table
  split along the gathered dimension gives a partial sum (the masked
  local gather GSPMD emits), or all-gathers the table where the indices
  are split over the same axes; scatters and index-adds of split sources
  give partial sums;
* operands whose layouts conflict (one dimension split over different
  axes, an axis used twice), and ops with no rule, are all-gathered to
  replicated, as GSPMD's "involuntary full rematerialization" does; each
  such event counts in ``involuntary``;
* a copy that repeats its source (the broadcast dims of GQA's repeated KV)
  or widens it (a cast to float32) is all-gathered at its source's bytes:
  XLA gathers before the broadcast and the cast, and the reference gathers
  its KV chunks before its repeat.

:func:`~repro_torch.distributed.sharding.constrain` resolves a tensor to
its constraint's spec under this counter (``resolve``): a partial sum over
an axis becomes an all-reduce, or a reduce-scatter where the target
splits a dimension over that axis; a dimension split over an axis that
the target leaves whole is all-gathered, or moved in one all-to-all where
the target splits another dimension over it; a whole dimension that the
target splits costs nothing; an ``UNCONSTRAINED`` entry keeps the
tensor's axes on its dimension, less those the spec puts elsewhere
(``jax.sharding.PartitionSpec.UNCONSTRAINED``). Where the tensor gathered
is a product's
output, GSPMD carries the constraint back to the product, which then runs
with that dimension whole: its operand is gathered and its FLOPs counted
for the whole dimension (the replicated node gradients of GIN's
backward). A dimension that the spec's axes do not
divide keeps the minor ones that do, where the reference's
``divisible_or_replicate`` leaves it whole: GSPMD keeps the split the
inputs carry. It does so as an autograd function whose backward
resolves the gradient to the same spec (the transposed collective), and
which runs again where a checkpointed layer recomputes its forward.
Gradients are resolved to their parameters' layouts where the backward
makes them (the reference's ``constrain_grads``): a tensor hook on each
parameter, and for a stacked parameter's layer slices a node that
:class:`_LayerSlices` puts in the graph. Each collective goes to
``traffic`` with its operand's bytes on one device and its group size.

Counts are per device: an op's FLOPs and bytes, and a storage's bytes,
are the global figures over the product of the axes its output is split
over (and, for a product, its contraction). FLOPs are counted as XLA's
cost analysis does: ``2 M N K`` a product, one a output element of an
element-wise op (none for a transcendental, a copy or a view), one an
input element of a reduction. The attention the port computes is counted
whole: the reference counts the body of its KV-chunk scan once.

Under this counter a model-axis shard loop (``collectives.shard_range``)
runs its first shard only: the one device's share, whose slices of a
split dimension are that device's local block. GSPMD also lays tensors
out by their users, which a forward count cannot see; where that matters
the model code states the layout by a constraint (``sharding.constrain``:
the MoE dispatch's experts on the expert axis; a prefill's queries'
sequence on the cache's axis where the heads leave it free).
"""
from __future__ import annotations

import contextlib
import math
import weakref
from typing import Dict, FrozenSet, List, NamedTuple, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.distributed.collectives import UNCONSTRAINED

aten = torch.ops.aten
Axes = Tuple[str, ...]


class Layout(NamedTuple):
    """Per dimension the mesh axes it is split over (major first), and
    the axes over which the tensor holds a partial sum."""

    dims: Tuple[Axes, ...]
    partial: FrozenSet[str] = frozenset()


def _entry_axes(entry) -> Axes:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_layout(spec, ndim: int) -> Layout:
    """The layout of a spec (a ``Spec`` or a tuple of entries) over a
    tensor of ``ndim`` dimensions."""
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return Layout(tuple(_entry_axes(e) for e in entries[:ndim]))


def replicated(ndim: int) -> Layout:
    return Layout(((),) * ndim)


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """Bytes a read of ``t`` touches: its elements, or its storage when a
    broadcast view repeats them."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _dim(d: int, n: int) -> int:
    return d + n if d < 0 else d


def _finer(x: Axes, y: Axes) -> Optional[Axes]:
    """The finer of two tilings of one dim where one refines the other
    (a prefix of its axes: the coarser operand slices locally), else
    None."""
    if x[:len(y)] == y:
        return x
    if y[:len(x)] == x:
        return y
    return None


# ------------------------------------------------------------- op classes
_FACTORIES = {aten.empty, aten.empty_strided, aten.zeros, aten.ones,
              aten.full, aten.arange, aten.scalar_tensor, aten.new_zeros,
              aten.new_empty, aten.new_ones, aten.new_full,
              aten.new_empty_strided, aten.zeros_like, aten.ones_like,
              aten.empty_like, aten.full_like, aten.rand, aten.randn,
              aten.randint, aten.rand_like, aten.randn_like,
              aten.lift_fresh, aten.eye}
_LIKE = {aten.zeros_like, aten.ones_like, aten.empty_like, aten.full_like,
         aten.rand_like, aten.randn_like}
_NEW = {aten.new_zeros, aten.new_empty, aten.new_ones, aten.new_full,
        aten.new_empty_strided}
# element-wise ops XLA counts as transcendentals, not FLOPs
_TRANSCENDENTAL = {aten.exp, aten.log, aten.log1p, aten.expm1, aten.rsqrt,
                   aten.sqrt, aten.pow, aten.sin, aten.cos, aten.tanh,
                   aten.sigmoid, aten.erf, aten.log2, aten.exp2,
                   aten.silu, aten.silu_backward,
                   aten.tan, aten.atan2, aten.gelu}
# element-wise ops that move data and compute nothing
_COPIES = {aten.clone, aten.copy_, aten.copy, aten.fill_, aten.zero_,
           aten.masked_fill_, aten.fill}
_POINTWISE = {
    aten.add, aten.add_, aten.sub, aten.sub_, aten.rsub, aten.mul,
    aten.mul_, aten.div, aten.div_, aten.neg, aten.where, aten.eq, aten.ne,
    aten.lt, aten.le, aten.gt, aten.ge, aten.maximum, aten.minimum,
    aten.clamp, aten.clamp_, aten.clamp_min, aten.clamp_max, aten.abs,
    aten.sgn, aten.sign, aten.relu, aten.relu_, aten.leaky_relu,
    aten.leaky_relu_backward, aten.threshold_backward, aten.bitwise_and,
    aten.bitwise_or, aten.bitwise_not, aten.bitwise_xor, aten.logical_and,
    aten.logical_or, aten.logical_not, aten.masked_fill, aten.isfinite,
    aten.isinf, aten.isnan, aten.floor, aten.ceil, aten.round, aten.trunc,
    aten.remainder, aten.fmod, aten.floor_divide, aten.lerp, aten.addcmul,
    aten.addcdiv, aten.addcmul_, aten.addcdiv_, aten.lerp_, aten._to_copy,
    aten.sigmoid_backward, aten.tanh_backward, aten.gelu_backward,
    aten.bitwise_left_shift, aten.bitwise_right_shift, aten.__and__,
    aten.__or__, aten.__xor__, aten.mul_, aten.pow_, aten.neg_,
    aten.maximum, aten.exp_, aten.sqrt_, aten.rsqrt_} \
    | _TRANSCENDENTAL | _COPIES
# linear in their tensor operands: a partial sum passes through
_LINEAR_ALL = {aten.add, aten.add_, aten.sub, aten.sub_, aten.neg,
               aten.neg_, aten._to_copy, aten.clone, aten.copy_,
               aten.copy, aten.rsub}
_LINEAR_ONE = {aten.mul, aten.mul_, aten.div, aten.div_}
_SUMS = {aten.sum, aten.mean}
_REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max,
               aten.min, aten.argmax, aten.argmin, aten.logsumexp,
               aten.prod, aten.any, aten.all, aten.linalg_vector_norm,
               aten.norm, aten.var, aten.std, aten.var_mean}
# ops that need their dimension whole: (dim argument index, FLOPs per
# element)
_DIM_OPS = {aten._softmax: (1, 4), aten._log_softmax: (1, 4),
            aten._softmax_backward_data: (2, 3),
            aten._log_softmax_backward_data: (2, 3),
            aten.cumsum: (1, 1), aten.cumprod: (1, 1), aten.sort: (1, 1),
            aten.argsort: (1, 1), aten.topk: (2, 1)}
_PRODUCTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm}
_INDEX = {aten.index, aten._unsafe_index, aten.index_select,
          aten.embedding, aten.gather}
_SCATTER_SUMS = {aten.index_add, aten.index_add_, aten.scatter_add,
                 aten.scatter_add_, aten.scatter_reduce,
                 aten.scatter_reduce_, aten.index_reduce}
_WRITES = {aten.index_put, aten.index_put_, aten._index_put_impl_,
           aten.scatter, aten.scatter_}
# row reads and row writes of :func:`op_bytes`
_GATHERS = {aten.index, aten.gather, aten.index_select}
_SCATTERS = {aten.index_put_, aten.index_put, aten.index_add,
             aten.scatter_add, aten.scatter_reduce}
# copies of one tensor that may repeat or widen it (``_widened``)
_WIDENING = {aten.clone, aten._to_copy, aten.copy, aten.expand_copy}
_FREE = {aten._unsafe_view, aten.detach, aten.alias, aten.empty,
         aten.empty_like, aten.empty_strided, aten.new_empty}


def _written(packet, args) -> int:
    """Elements a row-writing op writes into its first argument."""
    if packet is aten.index_add:
        return args[3].numel()                      # the source rows
    if packet in (aten.scatter_add, aten.scatter_reduce):
        return args[2].numel()                      # the index
    self, idx = args[0], args[1]                    # index_put(_)
    n = 1
    for d in torch.broadcast_shapes(*(i.shape for i in idx if i is not None)):
        n *= d
    for d in range(self.dim()):
        if d >= len(idx) or idx[d] is None:
            n *= self.shape[d]
    return n


def op_bytes(func, args, kwargs, out, nb=_nbytes, rows=1.0) -> float:
    """Bytes one aten op reads and writes: each input read once, each
    output written once; views and allocations none; a gather the rows it
    reads, a scatter the rows it writes (read too where it accumulates)
    beside its index and source, an out-of-place one also copying its
    first argument. ``nb`` gives a tensor's bytes (one device's share
    under a :class:`LayoutCounter`); ``rows`` divides a scatter's
    written rows."""
    packet = func.overloadpacket
    if packet in _FREE or func.is_view:
        return 0.0
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    if packet in _GATHERS:
        return 2.0 * sum(nb(t) for t in outs) + sum(nb(t) for t in ins[1:])
    if packet in _SCATTERS:
        accumulate = True
        if packet in (aten.index_put_, aten.index_put):
            accumulate = bool(args[3] if len(args) > 3
                              else kwargs.get("accumulate", False))
        moved = ((2.0 if accumulate else 1.0)
                 * _written(packet, args) * args[0].element_size() / rows
                 + sum(nb(t) for t in ins[1:]))
        if packet is not aten.index_put_:   # the copy of the first argument
            moved += nb(args[0]) + sum(nb(t) for t in outs)
        return moved
    if packet is aten.copy_:                # writes its first argument only
        return float(sum(nb(t) for t in ins[1:]) + sum(nb(t) for t in outs))
    return float(sum(nb(t) for t in ins) + sum(nb(t) for t in outs))


# ----------------------------------------------------------- the counter
class LayoutCounter(TorchDispatchMode):
    """Counts one device's FLOPs, bytes and peak over every aten op of a
    trace, propagating each tensor's :class:`Layout` and recording the
    collectives the layouts ask for (module docstring) in ``traffic``, as
    ``(kind, operand bytes a device, group size)``. ``placed`` gives
    (tensor, spec) pairs for the arguments; a tensor without a layout is
    replicated. The model code reaches it through ``collectives.TRACER``
    (``record``, ``shard_range``, ``placed``, ``reshard``).

    With ``tally`` it also keeps the diagnosis view of
    ``scripts/plan_parity.py --ops``: ``flops_by_op`` (aten op -> FLOPs),
    ``records`` (each collective as ``(kind, operand bytes, group, the op
    that made it, involuntary, the global shape)``) and ``at_peak`` (each
    storage live at the peak as ``(bytes a device, shape, dtype, the op
    that made it)``)."""

    def __init__(self, mesh_shape: Dict[str, int], placed=(),
                 tally: bool = False):
        super().__init__()
        self.tally = tally
        self.op = ""                     # what is resolving or dispatching
        self.flops_by_op: Dict[str, float] = {}
        self.records: List[Tuple[str, float, int, str, bool, tuple]] = []
        self.at_peak: List[Tuple[float, Tuple[int, ...], str, str]] = []
        self._made: Dict[int, Tuple[Tuple[int, ...], str, str]] = {}
        self.sizes = dict(mesh_shape)
        self.layouts = WeakTensorKeyDictionary()
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0.0
        self.peak = 0.0
        self.involuntary = 0
        self.traffic: List[Tuple[str, float, int]] = []
        self.loop = 0                    # depth of shard_range loops
        self._hooked = WeakTensorKeyDictionary()   # parameter -> handle
        self.read = set()                # storages an op has read
        self._seen = set()
        self._store: Dict[int, float] = {}   # storage -> counted bytes
        self._fresh: Dict[int, Layout] = {}   # factory storages unread
        # an argument's shape (or its view's) -> its layout: a buffer of
        # that shape made in the trace (a gradient) is laid out like it
        self._shapes: Dict[Tuple[int, ...], Layout] = {}
        for t, spec in placed:
            self._seen.add(_key(t))
            self.layouts[t] = self._valid(spec_layout(spec, t.dim()), t)
            self._shapes.setdefault(tuple(t.shape), self.layouts[t])
        self._args = {_key(t) for t, _ in placed}
        # the last split layout an op gave each shape: a buffer of that
        # shape made later (a gradient's zeros) is laid out like it
        self._recent: Dict[Tuple[int, ...], Layout] = {}
        # a product's output storage -> (its shape, its FLOPs a device, its
        # operands' bytes a device)
        self._dots: Dict[int, Tuple[Tuple[int, ...], float,
                                    Tuple[float, float]]] = {}
        # storage -> {the size of a dim merged with a split on a minor
        # part: the parts' sizes and axes}; products carry it to their
        # output's dims
        self._merges: Dict[int, Dict[int, Tuple[Tuple[int, ...],
                                                List[Axes]]]] = {}
        # storage -> the partial axes all-reduced on it (its views' too)
        self._reduced: Dict[int, FrozenSet[str]] = {}
        # storage -> its source's bytes over its own, where it is a local
        # copy that repeats or widens its source (GQA's repeated KV, cast
        # to float32): gathered, it costs its source's bytes
        self._narrow: Dict[int, float] = {}

    # ---------------------------------------------------------- helpers
    def n(self, axes) -> int:
        return math.prod(self.sizes.get(a, 1) for a in axes)

    def _valid(self, lay: Layout, t: torch.Tensor) -> Layout:
        """Drops axes the mesh lacks, and a dimension's major axes until
        the rest divide it (a microbatch of a batch split over (pod, data)
        stays split over data, as the reference's reshape leaves it)."""
        dims = []
        for size, axes in zip(t.shape, lay.dims):
            axes = tuple(a for a in axes if a in self.sizes)
            while size % self.n(axes):
                axes = axes[1:]
            dims.append(axes)
        return Layout(tuple(dims), frozenset(a for a in lay.partial
                                             if a in self.sizes))

    def layout(self, t: torch.Tensor) -> Layout:
        lay = self.layouts.get(t)
        if lay is None or len(lay.dims) != t.dim():
            return replicated(t.dim())
        done = self._reduced.get(_key(t))
        if done and lay.partial & done:   # a view of a value reduced since
            lay = lay._replace(partial=lay.partial - done)
        return lay

    def split(self, lay: Layout) -> int:
        """How many devices share a tensor's elements."""
        return self.n(a for axes in lay.dims for a in axes)

    def local(self, t: torch.Tensor, lay: Optional[Layout] = None) -> float:
        return _nbytes(t) / self.split(lay or self.layout(t))

    def _record(self, kind: str, operand: float, axes,
                involuntary: bool = False, t=None) -> None:
        self.explicit(kind, operand, self.n(axes), involuntary, t)

    def explicit(self, kind: str, operand: float, group: int,
                 involuntary: bool = False, t=None) -> None:
        """Count one collective: ``kind``, its operand's bytes a device,
        its group's size (the model code's explicit combines come here
        through ``collectives.record``)."""
        if group > 1:
            self.traffic.append((kind, float(operand), group))
            self.involuntary += involuntary
            if self.tally:
                self.records.append((kind, float(operand), group, self.op,
                                     bool(involuntary),
                                     () if t is None else tuple(t.shape)))

    # ------------------------------------------------------- resharding
    def _all_reduce(self, t, lay: Layout) -> Layout:
        """All-reduce ``t``'s partial sums; every later use of ``t``
        reads the reduced value."""
        held = self.layout(t).partial
        if lay.partial and held:        # not yet reduced for another use
            self._record("all-reduce", self.local(t, lay), sorted(lay.partial),
                         t=t)
            self.layouts[t] = self.layout(t)._replace(partial=frozenset())
            k = _key(t)                 # and none of its views
            self._reduced[k] = self._reduced.get(k, frozenset()) | held
        return lay._replace(partial=frozenset())

    def gathered(self, t: torch.Tensor, lay: Layout) -> float:
        """The bytes a device all-gathers of ``t`` laid out by ``lay``: a
        local copy that repeats or widens its source (GQA's repeated KV
        chunks, cast to float32) is gathered as its source, before the
        repeat and the cast, as the reference gathers its KV chunks."""
        return self.local(t, lay) * self._narrow.get(_key(t), 1.0)

    def _gather(self, t, lay: Layout, dims, involuntary=False) -> Layout:
        """All-gather ``dims`` of ``t`` to whole."""
        new = list(lay.dims)
        for d in dims:
            if new[d]:
                self._record("all-gather", self.gathered(t, lay), new[d],
                             involuntary, t)
                new[d] = ()
                lay = lay._replace(dims=tuple(new))
        return lay

    def resolve(self, t: torch.Tensor, target: Layout) -> Layout:
        """Reshard ``t`` to ``target`` (the rule of ``constrain``):
        partial sums all-reduced, or reduce-scattered along a dimension the
        target splits over their axis; dimensions split over axes the
        target leaves whole all-gathered; new splits free."""
        lay = self.layout(t)
        target = self._valid(target, t)
        partial = lay.partial - target.partial
        scatter = [a for a in sorted(partial)
                   if any(a in ax and a not in cur for ax, cur
                          in zip(target.dims, lay.dims))]
        reduce = sorted(partial - set(scatter))
        if reduce:
            self._record("all-reduce", self.local(t, lay), reduce, t=t)
        if scatter:
            self._record("reduce-scatter", self.local(t, lay), scatter,
                         t=t)
            dims = list(lay.dims)
            for a in scatter:
                d = next(i for i, ax in enumerate(target.dims) if a in ax)
                dims[d] = dims[d] + (a,)
            lay = lay._replace(dims=tuple(dims))
        lay = lay._replace(partial=lay.partial & target.partial)
        for d, (cur, want) in enumerate(zip(lay.dims, target.dims)):
            drop = tuple(a for a in cur if a not in want)
            if drop:
                # an axis the target splits another dimension over, which
                # that dimension does not hold yet, moves there: one
                # all-to-all over it; the rest is all-gathered
                moved = tuple(a for a in drop if any(
                    a in w and a not in c for k, (c, w) in enumerate(
                        zip(lay.dims, target.dims)) if k != d))
                gathered = tuple(a for a in drop if a not in moved)
                if moved:
                    self._record("all-to-all", self.local(t, lay), moved,
                                 t=t)
                if gathered:
                    self._record("all-gather", self._regather(t, lay, d,
                                                              gathered),
                                 gathered, t=t)
                dims = list(lay.dims)
                dims[d] = tuple(a for a in cur if a in want)
                for a in moved:
                    k = next(k for k, w in enumerate(target.dims)
                             if a in w and k != d)
                    dims[k] = dims[k] + (a,)
                lay = lay._replace(dims=tuple(dims))
        return target

    def _regather(self, t, lay: Layout, d: int, axes) -> float:
        """The bytes a device all-gathers to make ``t``'s dim ``d`` whole
        over ``axes``. Where ``t`` is a product's output, GSPMD carries the
        constraint back to the product, which then runs with that dim
        whole: its operand gathered (rows of the first, columns of the
        second) and its FLOPs counted for the whole dim."""
        dot = self._dots.get(_key(t))
        if dot is None or dot[0] != tuple(t.shape):
            return self.gathered(t, lay)
        self._dots.pop(_key(t))
        self.flops += dot[1] * (self.n(axes) - 1)
        return dot[2][1] if d == t.dim() - 1 else dot[2][0]

    def set_layout(self, t: torch.Tensor, lay: Layout) -> None:
        """Give ``t`` a layout. A storage that ``t`` covers whole is counted
        at its new share from here on; one that a factory made and no op
        has read yet is counted at it when first read (GSPMD lays a buffer
        out by its users and never makes it whole)."""
        lay = self._valid(lay, t)
        self.layouts[t] = lay
        k = _key(t)
        nbytes = t.untyped_storage().nbytes()
        if t.numel() * t.element_size() != nbytes:
            return
        if k in self._fresh:
            self._fresh[k] = lay
        elif k in self._store:          # resharded whole: its new share
            now = nbytes / self.split(lay)
            self.live += now - self._store[k]
            self._store[k] = now

    # ----------------------------------------- the model code's hooks
    @contextlib.contextmanager
    def shard_loop(self):
        """Inside a shard loop slices of a split dimension are a device's
        local block."""
        self.loop += 1
        try:
            yield
        finally:
            self.loop -= 1

    def place(self, t: torch.Tensor, spec) -> None:
        """Lay ``t`` out by ``spec`` (a ``Spec`` or a tuple of entries)."""
        self.set_layout(t, spec_layout(spec, t.dim()))

    def reshard(self, src: torch.Tensor, out: torch.Tensor, spec) -> None:
        """Resolve ``src`` to ``spec`` (recording what that takes) and lay
        ``out``, a view of it, out so. An ``UNCONSTRAINED`` entry keeps
        ``src``'s axes on its dim, less those the spec puts elsewhere."""
        self.op = "constrain"
        entries = tuple(spec) + (None,) * (src.dim() - len(tuple(spec)))
        free = [e == UNCONSTRAINED for e in entries]
        target = spec_layout(tuple(None if f else e for e, f
                                   in zip(entries, free)), src.dim())
        used = {a for ax in target.dims for a in ax}
        target = target._replace(dims=tuple(
            tuple(a for a in cur if a not in used) if f else want
            for f, cur, want in zip(free, self.layout(src).dims,
                                    target.dims)))
        self.set_layout(out, self.resolve(src, target))

    def _hook_grads(self, ins) -> None:
        """The first time an op reads a parameter (an argument that
        requires grad by then: a train step makes its leaves trainable),
        hook its gradient: resolved to its layout where the backward makes
        it, the reference's ``constrain_grads`` (partial sums over the
        batch axes all-reduced, or reduce-scattered for a parameter split
        over one)."""
        for t in ins:
            if t.requires_grad and t.is_leaf and t not in self._hooked \
                    and _key(t) in self._args:
                self._hooked[t] = t.register_hook(
                    self._resolver(self.layout(t)))

    def _resolver(self, lay: Layout):
        def hook(grad):
            self.op = "gradient constraint"
            self.set_layout(grad, self.resolve(grad, lay))
        return hook

    def remove_hooks(self) -> None:
        for handle in self._hooked.values():
            handle.remove()

    def layer_slices(self) -> "_LayerSlices":
        """The mode that resolves a stacked parameter's gradient per
        layer (:class:`_LayerSlices`); entered beside this counter."""
        return _LayerSlices(self)

    def _adopt(self, t: torch.Tensor, dims) -> None:
        """A fresh replicated buffer first read beside tensors of its shape
        laid out by ``dims`` is laid out so itself."""
        if _key(t) in self._fresh and not any(self.layout(t).dims):
            self.set_layout(t, Layout(tuple(dims)))

    # --------------------------------------------------------- dispatch
    def _count(self, k: int, nbytes: int, lay: Layout) -> None:
        self._store[k] = nbytes / self.split(lay)
        self.live += self._store[k]

    def _dead(self, key: int) -> None:
        self.live -= self._store.pop(key, 0.0)
        self._dots.pop(key, None)
        self._reduced.pop(key, None)
        self._narrow.pop(key, None)
        self._merges.pop(key, None)
        self._seen.discard(key)          # a new storage may reuse the address
        self._fresh.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        self.op = f"aten.{packet.__name__}"
        ins = _tensors((args, kwargs))
        self._hook_grads(ins)
        outs_lay, flops = self._rule(func, packet)(func, args, kwargs)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if callable(outs_lay):
            outs_lay = outs_lay(outs)
        if isinstance(outs_lay, Layout) or outs_lay is None:
            outs_lay = [outs_lay] * len(outs)
        owned = {_key(t) for t in ins}
        for t, lay in zip(outs, outs_lay):
            lay = replicated(t.dim()) if lay is None or \
                len(lay.dims) != t.dim() else self._valid(lay, t)
            self.layouts[t] = lay
            if lay.partial and not func.is_view:    # a new partial value
                self._reduced.pop(_key(t), None)
            if any(lay.dims) and not func.is_view:
                self._recent[tuple(t.shape)] = lay
        self.flops += flops
        rows = max([self.split(self.layout(t)) for t in ins[:3]] or [1])
        self.bytes += op_bytes(func, args, kwargs, out,
                               lambda t: self.local(t), rows)
        if func.is_view:
            return out
        self.read.update(_key(t) for t in ins)
        for t in ins:                         # fresh buffers read: counted
            k = _key(t)
            if k in self._fresh:
                self._count(k, t.untyped_storage().nbytes(),
                            self._fresh.pop(k))
        if packet in _WIDENING and len(ins) == 1 and len(outs) == 1:
            self._widened(ins[0], outs[0])
        factory = packet in _FACTORIES
        for t in outs:
            st = t.untyped_storage()
            k = st._cdata
            if k in self._seen or k in owned:  # an argument's storage
                continue
            self._seen.add(k)
            if self.tally:
                self._made[k] = (tuple(t.shape),
                                 str(t.dtype).replace("torch.", ""), self.op)
            if factory:
                self._fresh[k] = self.layout(t)
            else:
                self._count(k, st.nbytes(), self.layout(t))
            weakref.finalize(st, self._dead, k)
        if self.tally:
            self.flops_by_op[self.op] = self.flops_by_op.get(self.op, 0.0) \
                + flops
        if not factory and self.live > self.peak:
            self.peak = self.live
            if self.tally:
                self.at_peak = [(n,) + self._made.get(k, ((), "?", "?"))
                                for k, n in self._store.items()]
        return out

    def _carry_merges(self, a, b, out) -> None:
        """A product's output dims (batch, rows of ``a``, columns of
        ``b``) keep the merges their operands' dims remember."""
        got = {}
        for t, dims in ((a, (0, -2) if a.dim() == 3 else (-2,)),
                        (b, (-1,))):
            held = self._merges.get(_key(t), {})
            for d in dims:
                if t.shape[d] in held:
                    got[t.shape[d]] = held[t.shape[d]]
        if got:
            self._merges.setdefault(_key(out), {}).update(got)

    def _widened(self, src: torch.Tensor, out: torch.Tensor) -> None:
        """Remember what of ``out``, a copy of ``src``, repeats (``src``'s
        broadcast dims, stride 0) or widens (a cast to more bytes) it."""
        ratio = self._narrow.get(_key(src), 1.0) * src.element_size() \
            / out.element_size()
        for size, stride in zip(src.shape, src.stride()):
            if stride == 0 and size > 1:
                ratio /= size
        if ratio < 1.0:
            self._narrow[_key(out)] = ratio
        else:
            self._narrow.pop(_key(out), None)

    def _rule(self, func, packet):
        if func.is_view or packet in (aten._unsafe_view, aten.view,
                                      aten.reshape, aten.alias,
                                      aten.detach, aten.lift_fresh):
            return self._view
        if packet in _FACTORIES:
            return self._factory
        if packet in _PRODUCTS:
            return self._product
        if packet in _POINTWISE:
            return self._pointwise
        if packet in _REDUCTIONS:
            return self._reduction
        if packet in _DIM_OPS:
            return self._dim_op
        if packet in _INDEX:
            return self._index
        if packet in _SCATTER_SUMS:
            return self._scatter_sum
        if packet in _WRITES:
            return self._write
        if packet in (aten.cat, aten.stack):
            return self._cat
        if packet in (aten.slice_backward, aten.select_backward):
            return self._slice_backward
        return self._fallback

    # ------------------------------------------------------------- rules
    # Each rule returns (output layouts, or a function of the outputs
    # giving them, and one device's FLOPs) and records the collectives its
    # inputs need.
    def _fallback(self, func, args, kwargs):
        """No rule: every input gathered to replicated."""
        for t in _tensors((args, kwargs)):
            lay = self._all_reduce(t, self.layout(t))
            self._gather(t, lay, range(t.dim()), involuntary=True)
        return None, 0.0

    def _factory(self, func, args, kwargs):
        packet = func.overloadpacket
        if packet in _LIKE:
            src = args[0]
            return Layout(self.layout(src).dims), 0.0

        def like(outs):
            shape = tuple(outs[0].shape)
            if packet in _NEW and shape == tuple(args[0].shape):
                return Layout(self.layout(args[0]).dims)
            lay = self._shapes.get(shape) or self._recent.get(shape)
            return None if lay is None else Layout(lay.dims)
        return like, 0.0

    def _view(self, func, args, kwargs):
        src = args[0]
        lay = self.layout(src)
        packet = func.overloadpacket
        shape = tuple(src.shape)
        nd = len(shape)
        if packet in (aten.alias, aten.detach, aten.lift_fresh):
            return lay, 0.0
        if packet in (aten.permute,):
            perm = [_dim(d, nd) for d in args[1]]
            return lay._replace(dims=tuple(lay.dims[d] for d in perm)), \
                0.0
        if packet in (aten.transpose,):
            d0, d1 = _dim(args[1], nd), _dim(args[2], nd)
            dims = list(lay.dims)
            dims[d0], dims[d1] = dims[d1], dims[d0]
            return lay._replace(dims=tuple(dims)), 0.0
        if packet is aten.t:
            return lay._replace(dims=tuple(reversed(lay.dims))), 0.0
        if packet is aten.unsqueeze:
            d = _dim(args[1], nd + 1)
            dims = list(lay.dims)
            dims.insert(d, ())
            return lay._replace(dims=tuple(dims)), 0.0
        if packet in (aten.slice, aten.narrow, aten.select, aten.unbind,
                      aten.split, aten.split_with_sizes, aten.chunk,
                      aten.unsafe_split):
            return self._slicing(func, args, kwargs, lay), 0.0
        if packet is aten.expand:
            sizes = list(args[1])
            off = len(sizes) - nd
            dims = [()] * off + [
                () if shape[i] == 1 and sizes[off + i] != 1 else lay.dims[i]
                for i in range(nd)]
            return lay._replace(dims=tuple(dims)), 0.0
        if packet is aten.as_strided:
            return None, 0.0

        def reshape(outs):                  # view, squeeze, _unsafe_view...
            out = self._reshape(src, lay, tuple(outs[0].shape), outs[0])
            if _key(src) in self._args:
                self._shapes.setdefault(tuple(outs[0].shape), out)
            return out
        return reshape, 0.0

    def _reshape(self, src, lay: Layout, oshape, dst) -> Layout:
        """Regroup the axes of ``src``'s dims onto ``oshape`` (``dst``'s
        shape): dims that merge or split together pool their axes, which
        the output dims take major first while they divide them (GSPMD's
        contiguous tiles). A merge whose split sits on a minor part (an
        einsum's merged batch or contraction, separate dims to GSPMD) is
        remembered on ``dst``'s storage, and splitting that dim back puts
        each axis on the part it came from."""
        ishape = tuple(src.shape)
        merged = self._merges.get(_key(src), {})
        out: List[Axes] = [()] * len(oshape)
        i = j = 0
        lost: List[str] = []
        while i < len(ishape) or j < len(oshape):
            if i < len(ishape) and ishape[i] == 1 and not lay.dims[i]:
                i += 1
                continue
            if j < len(oshape) and oshape[j] == 1:
                j += 1
                continue
            if i >= len(ishape) or j >= len(oshape):
                break
            ii, jj = [i], [j]
            pi, pj = ishape[i], oshape[j]
            while pi != pj:
                if pi < pj and i + 1 < len(ishape):
                    i += 1
                    pi *= ishape[i]
                    ii.append(i)
                elif j + 1 < len(oshape):
                    j += 1
                    pj *= oshape[j]
                    jj.append(j)
                else:
                    break
            pool = [a for d in ii for a in lay.dims[d]]
            if len(jj) == 1 and any(lay.dims[d] for d in ii[1:]):
                self._merges.setdefault(_key(dst), {})[oshape[jj[0]]] = (
                    tuple(ishape[d] for d in ii), [lay.dims[d] for d in ii])
            back = merged.get(ishape[ii[0]]) if len(ii) == 1 else None
            if back is not None and back[0] == tuple(oshape[d] for d in jj) \
                    and sorted(a for ax in back[1] for a in ax) \
                    == sorted(pool):
                for d, ax in zip(jj, back[1]):
                    out[d] = ax
                pool = []
            else:
                for d in jj:              # contiguous tiles: major first
                    rem, take = oshape[d], []
                    while pool and rem % self.sizes.get(pool[0], 1) == 0:
                        rem //= self.sizes.get(pool[0], 1)
                        take.append(pool.pop(0))
                    out[d] = tuple(take)
            lost += pool
            i += 1
            j += 1
        if lost:                          # axes no output dim could take
            self._record("all-gather", self.gathered(src, lay), lost, True,
                         src)
        return Layout(tuple(out), lay.partial)

    def _slicing(self, func, args, kwargs, lay: Layout):
        packet = func.overloadpacket
        src = args[0]
        nd = src.dim()
        if packet in (aten.unbind,):
            d = _dim(args[1] if len(args) > 1 else kwargs.get("dim", 0), nd)
        elif packet in (aten.split, aten.split_with_sizes, aten.chunk,
                        aten.unsafe_split):
            d = _dim(args[2] if len(args) > 2 else kwargs.get("dim", 0), nd)
        else:
            d = _dim(args[1] if len(args) > 1 else kwargs.get("dim", 0), nd)
        axes = lay.dims[d]
        full = src.shape[d]
        drop = packet in (aten.select, aten.unbind)
        cut = packet in (aten.split, aten.split_with_sizes, aten.chunk,
                         aten.unsafe_split)

        def each(outs):
            res = []
            for o in outs:
                dims = list(lay.dims)
                if drop:
                    del dims[d]
                elif axes and self.loop and \
                        o.shape[d] * self.n(axes) == full:
                    dims[d] = ()            # a shard's local block
                elif cut and axes and not self.loop and o.shape[d] != full \
                        and o.shape[d] % self.n(axes) == 0:
                    # a part of a dim cut into parts (RoPE's halves) lies
                    # on some of its devices: GSPMD spreads it over all of
                    # them again (a row slice, as a microbatch, is counted
                    # spread already)
                    self._record("collective-permute",
                                 _nbytes(o) / self.split(lay), axes, t=o)
                res.append(lay._replace(dims=tuple(dims)))
            return res
        return each

    def _slice_backward(self, func, args, kwargs):
        grad = args[0]
        lay = self.layout(grad)
        if func.overloadpacket is aten.select_backward:
            d = _dim(args[2], len(args[1]))
            dims = list(lay.dims)
            dims.insert(d, ())
            return lay._replace(dims=tuple(dims)), 0.0
        return lay, 0.0

    # ..................................................... element-wise
    def _align(self, out_shape, ins, keep=None) -> Tuple[Axes, ...]:
        """The output dims of an element-wise op over ``ins`` ((tensor,
        layout) pairs), gathering the operands that conflict. ``keep``
        (an in-place op's destination) decides where it is given."""
        nd = len(out_shape)
        dims: List[Optional[Axes]] = [None] * nd
        order = sorted(ins, key=lambda p: (p[0] is not keep,
                                           -p[0].numel()))
        for t, lay in order:
            off = nd - t.dim()
            gather = []
            for i, axes in enumerate(lay.dims):
                d = off + i
                if not axes or t.shape[i] != out_shape[d]:
                    continue
                used = {a for k, ax in enumerate(dims) if k != d and ax
                        for a in ax}
                finer = _finer(dims[d] or (), axes)
                if finer is not None and not used & set(finer):
                    dims[d] = finer        # the coarser operand slices
                else:
                    gather.append(i)
            if gather:
                self._realign(t, lay, gather, dims, off, out_shape)
        return tuple(ax or () for ax in dims)

    def _realign(self, t, lay: Layout, gather, dims, off, out_shape) -> None:
        """Reshard ``t``'s dims ``gather``, whose axes conflict with the
        output ``dims`` of an element-wise op: where the output splits
        another dimension of ``t`` (held whole) over exactly such an axis
        set, the axes move there in one all-to-all (GSPMD's reshard of a
        mesh axis from one dimension to another); the rest are gathered,
        GSPMD's involuntary rematerialization."""
        rest = []
        for i in gather:
            axes = lay.dims[i]
            to = [k - off for k, ax in enumerate(dims)
                  if ax == axes and k - off != i and 0 <= k - off < t.dim()
                  and t.shape[k - off] == out_shape[k]
                  and not lay.dims[k - off]]
            if to:
                self._record("all-to-all", self.local(t, lay), axes, t=t)
                new = list(lay.dims)
                new[i], new[to[0]] = (), axes
                lay = lay._replace(dims=tuple(new))
            else:
                rest.append(i)
        if rest:
            self._gather(t, lay, rest, involuntary=True)

    def _pointwise(self, func, args, kwargs):
        packet = func.overloadpacket
        tens = _tensors((args, kwargs))
        if not tens:
            return None, 0.0
        inplace = packet.__name__.endswith("_") and isinstance(
            args[0], torch.Tensor)
        dest = args[0] if inplace else None
        lays = [(t, self.layout(t)) for t in tens]
        shape = tuple(torch.broadcast_shapes(*(t.shape for t in tens)))
        partial = self._partial_through(packet, args, lays)
        if partial is None:
            lays = [(t, self._all_reduce(t, lay)) for t, lay in lays]
            partial = frozenset()
        dims = self._align(shape, lays, dest)
        if inplace:
            dims = self.layout(dest).dims
        for t in tens:
            if tuple(t.shape) == shape:
                self._adopt(t, dims)
        lay = Layout(dims, partial)
        convert = packet is aten._to_copy and kwargs.get(
            "dtype", args[0].dtype) != args[0].dtype
        flops = 0.0
        if packet not in _TRANSCENDENTAL and packet not in _COPIES and (
                packet is not aten._to_copy or convert):
            flops = math.prod(shape) / self.split(lay)
        return lay, flops

    @staticmethod
    def _partial_through(packet, args, lays):
        """The partial axes of an element-wise op's output, or None where
        its operands' partial sums must be all-reduced first."""
        parts = [lay.partial for _, lay in lays]
        if not any(parts):
            return frozenset()
        scalars = any(isinstance(a, (int, float, bool)) for a in args[:2])
        if packet in _LINEAR_ALL:
            if scalars or any(p != parts[0] for p in parts):
                return None
            return parts[0]
        if packet in _LINEAR_ONE:
            held = [(t, p) for (t, _), p in zip(lays, parts) if p]
            if len(held) != 1:
                return None
            t, p = held[0]
            if packet in (aten.div, aten.div_) and t is not args[0]:
                return None
            others = {a for u, lay in lays if u is not t
                      for ax in lay.dims for a in ax}
            return None if others & p else p
        return None

    # ....................................................... reductions
    def _reduce_dims(self, func, args, kwargs, nd):
        packet = func.overloadpacket
        if packet in (aten.max, aten.min, aten.argmax, aten.argmin) and \
                len(args) > 1 and isinstance(args[1], int):
            dims, keep = [args[1]], (args[2] if len(args) > 2
                                     else kwargs.get("keepdim", False))
        elif len(args) > 1 and args[1] is not None and not isinstance(
                args[1], torch.dtype):
            dims = [args[1]] if isinstance(args[1], int) else list(args[1])
            keep = args[2] if len(args) > 2 and isinstance(args[2], bool) \
                else kwargs.get("keepdim", False)
        else:
            d = kwargs.get("dim")
            dims = [d] if isinstance(d, int) else (list(d) if d else [])
            keep = kwargs.get("keepdim", False)
        if not dims:
            dims = list(range(nd))
        return sorted({_dim(d, nd) for d in dims}), bool(keep)

    def _reduction(self, func, args, kwargs):
        packet = func.overloadpacket
        src = args[0]
        lay = self.layout(src)
        if packet not in _SUMS:
            lay = self._all_reduce(src, lay)
        dims, keep = self._reduce_dims(func, args, kwargs, src.dim())
        red = [a for d in dims for a in lay.dims[d]]
        out_dims = [() if d in dims else ax for d, ax in enumerate(lay.dims)]
        if not keep:
            out_dims = [ax for d, ax in enumerate(out_dims) if d not in dims]
        flops = (3.0 if packet is aten.logsumexp else 1.0) \
            * src.numel() / self.split(lay)
        if packet in _SUMS:
            return Layout(tuple(out_dims), lay.partial | set(red)), flops

        def out(outs):                    # a local reduce, then all-reduce
            if red:
                self._record("all-reduce",
                             sum(_nbytes(o) for o in outs)
                             / self.n(a for ax in out_dims for a in ax), red)
            return [Layout(tuple(out_dims))] * len(outs)
        return out, flops

    def _dim_op(self, func, args, kwargs):
        packet = func.overloadpacket
        idx, per = _DIM_OPS[packet]
        src = args[0]
        nd = src.dim()
        if packet in (aten.sort, aten.argsort):
            d = args[1] if len(args) > 1 and isinstance(args[1], int) \
                else kwargs.get("dim", -1)
        elif packet is aten.topk:
            d = args[2] if len(args) > 2 else kwargs.get("dim", -1)
        else:
            d = args[idx] if len(args) > idx else kwargs.get("dim", -1)
        d = _dim(d, nd)
        lays = []
        for t in _tensors((args, kwargs)):
            lay = self._all_reduce(t, self.layout(t))
            if t.dim() == nd:
                lay = self._gather(t, lay, [d])
            lays.append(lay)
        lay = lays[0]
        flops = per * src.numel() / self.split(lay)
        if packet is aten.sort:
            flops *= max(1.0, math.log2(max(src.shape[d], 2)))
        return lay, flops

    # ......................................................... products
    def _product(self, func, args, kwargs):
        packet = func.overloadpacket
        bias = None
        if packet in (aten.addmm, aten.baddbmm):
            bias, a, b = args[0], args[1], args[2]
        else:
            a, b = args[0], args[1]
        la, lb = self.layout(a), self.layout(b)
        if la.partial and lb.partial:
            lb = self._all_reduce(b, lb)
        batched = a.dim() == 3
        bdim = ()
        if batched:
            bdim = _finer(la.dims[0], lb.dims[0])
            if bdim is None:
                lb = self._gather(b, lb, [0], involuntary=True)
                bdim = la.dims[0]
        m, ka = la.dims[-2], la.dims[-1]
        kb, n = lb.dims[-2], lb.dims[-1]
        if set(bdim) & (set(m) | set(n)) or (
                set(m) & set(n) and self.local(b, lb) < self.local(a, la)):
            lb = self._gather(b, lb, [b.dim() - 1], involuntary=True)
            n = ()
        elif set(m) & set(n):           # the smaller operand is gathered
            la = self._gather(a, la, [a.dim() - 2], involuntary=True)
            m = ()
        # a partial sum over an axis that the output splits over (the
        # other operand's free or batch dims) is all-reduced first, as is
        # one the product would grow (GSPMD reduces a partial dot output
        # at the dot, where it is smaller)
        grown = math.prod(a.shape[:-1]) * b.shape[-1] * a.element_size() \
            / self.n({x for y in (bdim, m, n) for x in y})
        if la.partial & (set(n) | set(bdim)) or (
                la.partial and self.local(a, la) < grown):
            la = self._all_reduce(a, la)
        if lb.partial & (set(m) | set(bdim)) or (
                lb.partial and self.local(b, lb) < grown):
            lb = self._all_reduce(b, lb)
        if bool(ka) != bool(kb):
            # a contraction split on one operand only: slice the other
            # (the output a partial sum, all-reduced later) or gather it,
            # whichever moves less (GSPMD gathers a small operand of a
            # large product, as the unembedding's hidden state)
            t, lt, d, ax = (a, la, a.dim() - 1, ka) if ka else \
                (b, lb, b.dim() - 2, kb)
            reduce = 2.0 * math.prod(a.shape[:-1]) * b.shape[-1] \
                * a.element_size() / self.n(
                    {x for y in (bdim, m, n) for x in y} | set(ax))
            if (self.n(ax) - 1) * self.local(t, lt) < reduce \
                    and not lt.partial:
                if t is a:
                    la, ka = self._gather(a, la, [d]), ()
                else:
                    lb, kb = self._gather(b, lb, [d]), ()
        if ka == kb or not kb:
            kc = ka
        elif not ka:
            kc = kb
        else:
            lb = self._gather(b, lb, [b.dim() - 2], involuntary=True)
            kc = ka
        for t, lt, other, k_other in ((a, la, b, kb), (b, lb, a, ka)):
            held = lt.partial & set(kc)
            # a partial operand against a contraction split over the same
            # axes: all-reduce it, where that moves less than gathering the
            # other operand's contraction
            if held and 2.0 * self.local(t, lt) < (self.n(held) - 1) \
                    * (self.local(other) if set(k_other) & held else 0):
                if t is a:
                    la = self._all_reduce(a, la)
                else:
                    lb = self._all_reduce(b, lb)
        clash = set(kc) & (set(m) | set(n) | set(bdim) | la.partial
                           | lb.partial)
        if clash:
            # gather the contraction where the clashing axes split it, or
            # the output dims they split (leaving a partial sum to reduce
            # later), whichever moves less
            g = self.n(clash) - 1
            by_k = g * ((self.local(a, la) if set(ka) & clash else 0)
                        + (self.local(b, lb) if set(kb) & clash else 0))
            outs = []
            if set(m) & clash or set(bdim) & clash:
                outs.append((a, la, [d for d in range(a.dim() - 1)
                                     if set(la.dims[d]) & clash]))
            if set(n) & clash or set(bdim) & clash:
                outs.append((b, lb, [d for d in range(b.dim())
                                     if d != b.dim() - 2
                                     and set(lb.dims[d]) & clash]))
            keep = {x for ax in ((bdim,) + (m, n)) for x in ax} - clash
            by_out = g * sum(self.local(t, lt) for t, lt, _ in outs) \
                + 2.0 * math.prod(a.shape[:-1]) * b.shape[-1] \
                * a.element_size() / self.n(keep)
            if clash & (la.partial | lb.partial) or by_k <= by_out:
                if set(ka) & clash:
                    la = self._gather(a, la, [a.dim() - 1])
                if set(kb) & clash:
                    lb = self._gather(b, lb, [b.dim() - 2])
                kc = ()
            else:
                for t, lt, ds in outs:
                    self._gather(t, lt, ds)
                strip = lambda ax: tuple(x for x in ax if x not in clash)
                bdim, m, n = strip(bdim), strip(m), strip(n)
        dims = ((bdim,) if batched else ()) + (m, n)
        partial = la.partial | lb.partial | set(kc)
        lay = Layout(dims, frozenset(partial))
        flops = 2.0 * math.prod(a.shape) * b.shape[-1] \
            / (self.split(lay) * self.n(kc))
        if bias is not None:
            if lay.partial:
                def out(outs):
                    self._record("all-reduce", self.local(outs[0], lay),
                                 sorted(lay.partial))
                    return [lay._replace(partial=frozenset())]
                return out, flops + math.prod(
                    (a.shape[0], b.shape[-1])) / self.split(lay)
            flops += math.prod(a.shape[:-1]) * b.shape[-1] / self.split(lay)
        operands = (self.local(a, la), self.local(b, lb))

        def made(outs):                   # remembered for ``resolve``
            self._dots[_key(outs[0])] = (tuple(outs[0].shape), flops,
                                         operands)
            self._carry_merges(a, b, outs[0])
            return lay
        return made, flops

    # ............................................................ index
    def _index(self, func, args, kwargs):
        packet = func.overloadpacket
        src = args[0]
        lay = self.layout(src)
        nd = src.dim()
        if packet is aten.embedding:
            src, idx = args[0], args[1]
            lay = self.layout(src)
            return self._take(src, lay, [0], [idx]), 0.0
        if packet is aten.index_select:
            d = _dim(args[1], nd)
            return self._take(src, lay, [d], [args[2]]), 0.0
        if packet is aten.gather:
            d = _dim(args[1], nd)
            idx = args[2]
            il = self.layout(idx)
            dims = list(il.dims)
            for k in range(nd):
                if k != d and not dims[k] and idx.shape[k] == src.shape[k]:
                    dims[k] = lay.dims[k]
            partial = set(lay.partial)
            if lay.dims[d] and not self.loop:
                if set(lay.dims[d]) & {a for ax in dims for a in ax}:
                    lay = self._gather(src, lay, [d])
                else:
                    partial |= set(lay.dims[d])
            return Layout(tuple(dims), frozenset(partial)), 0.0
        # aten.index(self, indices): consecutive index tensors
        indices = list(args[1])
        pos = [k for k, i in enumerate(indices) if i is not None]
        if not pos:
            return lay, 0.0
        idxs = [indices[k] for k in pos]
        if pos != list(range(pos[0], pos[-1] + 1)):
            self._gather(src, lay, range(nd), involuntary=True)
            return None, 0.0
        return self._take(src, lay, pos, idxs), 0.0

    def _take(self, src, lay: Layout, pos, idxs):
        """Output layout of gathering ``src``'s consecutive dims ``pos``
        by ``idxs``, whose dims take their place."""
        shape = torch.broadcast_shapes(*(i.shape for i in idxs))
        ilays = [(i, self.layout(i)) for i in idxs]
        partial = set(lay.partial)
        for i, il in ilays:
            if il.partial:
                self._all_reduce(i, il)
        idims = self._align(tuple(shape), ilays)
        rest = [lay.dims[k] for k in range(src.dim()) if k not in pos]
        used = {a for ax in idims for a in ax}
        if used & {a for ax in rest for a in ax}:
            lay = self._gather(src, lay, [k for k in range(src.dim())
                                          if k not in pos and lay.dims[k]],
                               involuntary=True)
            rest = [lay.dims[k] for k in range(src.dim()) if k not in pos]
        taken = {a for k in pos for a in lay.dims[k]}
        if taken and not self.loop:      # in a shard loop: the local block
            clash = taken & used
            # gather the indices (the output then holds a partial sum of
            # its rows, reduced later) or the table, whichever moves less
            row = math.prod(src.shape[k] for k in range(src.dim())
                            if k not in pos) * src.element_size()
            keep = {a for ax in idims for a in ax} - clash
            by_index = sum(self.local(i, il) for i, il in ilays) \
                * (self.n(clash) - 1) + math.prod(shape) * row / self.n(keep)
            if clash and by_index < self.local(src, lay) * (self.n(clash) - 1):
                for i, il in ilays:
                    self._gather(i, il, [k for k, ax in enumerate(il.dims)
                                         if set(ax) & clash])
                idims = tuple(tuple(a for a in ax if a not in clash)
                              for ax in idims)
                used -= clash
            if taken & (used | {a for ax in rest for a in ax}):
                lay = self._gather(src, lay, pos)
            else:
                partial |= taken
        before = [lay.dims[k] for k in range(pos[0])]
        after = [lay.dims[k] for k in range(pos[-1] + 1, src.dim())]
        return Layout(tuple(before) + tuple(idims) + tuple(after),
                      frozenset(partial))

    def _scatter_sum(self, func, args, kwargs):
        """index_add / scatter_add / scatter_reduce: the destination's
        layout, partial over the axes that split its index or its sources
        along the scattered dim (each device adds the rows it holds)."""
        packet = func.overloadpacket
        dest = args[0]
        nd = dest.dim()
        d = _dim(args[1], nd)
        idx, src = args[2], args[3]
        dl, sl, il = self.layout(dest), self.layout(src), self.layout(idx)
        if sl.partial and packet in (aten.scatter_reduce,
                                     aten.scatter_reduce_, aten.index_reduce):
            sl = self._all_reduce(src, sl)
        along = set(sl.dims[d] if src.dim() == nd else ()) | {
            a for ax in il.dims for a in ax}
        along -= {a for ax in dl.dims for a in ax}
        lay = Layout(dl.dims, frozenset(dl.partial | sl.partial | along))
        return lay, src.numel() / self.split(sl)

    def _write(self, func, args, kwargs):
        """index_put / scatter: the destination's layout; an accumulating
        index_put (a gather's backward) adds its split sources into a
        partial sum, as an index-add."""
        dest = args[0]
        dl = self.layout(dest)
        vals = _tensors((args[1:], kwargs))
        accumulate = func.overloadpacket in (
            aten.index_put, aten.index_put_, aten._index_put_impl_) and bool(
            args[3] if len(args) > 3 else kwargs.get("accumulate", False))
        if accumulate:
            held = {a for ax in dl.dims for a in ax}
            along = {a for t in vals for ax in self.layout(t).dims
                     for a in ax} - held
            partial = set(dl.partial) | along
            for t in vals:
                partial |= self.layout(t).partial
            return Layout(dl.dims, frozenset(partial)), \
                args[2].numel() / self.split(self.layout(args[2]))
        for t in vals:
            lay = self.layout(t)
            if lay.partial and not dl.partial:
                self._all_reduce(t, lay)
        return Layout(dl.dims, dl.partial), 0.0

    def _cat(self, func, args, kwargs):
        tens = list(args[0])
        d = args[1] if len(args) > 1 else kwargs.get("dim", 0)
        stack = func.overloadpacket is aten.stack
        nd = tens[0].dim()
        d = _dim(d, nd + 1 if stack else nd)
        lays = []
        cut = () if stack else self.layout(tens[0]).dims[d]
        if cut and all(self.layout(t).dims[d] == cut for t in tens):
            # parts split alike along the joined dim: GSPMD re-tiles
            # them, one all-to-all a part, and the result keeps the split
            for t in tens:
                self._record("all-to-all", self.local(t), cut, t=t)
        else:
            cut = ()
        for t in tens:
            lay = self.layout(t)
            if not stack and lay.dims[d] and not cut:
                lay = self._gather(t, lay, [d])
            lays.append((t, lay))
        parts = {lay.partial for _, lay in lays}
        if len(parts) > 1:
            lays = [(t, self._all_reduce(t, lay)) for t, lay in lays]
            partial = frozenset()
        else:
            partial = parts.pop()
        # align the other dims as an element-wise op would
        dims = [None] * nd
        for t, lay in lays:
            for k, ax in enumerate(lay.dims):
                if ax and (stack or k != d):
                    if dims[k] is None:
                        dims[k] = ax
                    elif dims[k] != ax:
                        self._gather(t, lay, [k], involuntary=True)
        dims = [ax or () for ax in dims]
        if stack:
            dims.insert(d, ())
        elif cut:
            dims[d] = cut
        return Layout(tuple(dims), partial), 0.0


class _GradTo(torch.autograd.Function):
    """A view of ``x`` whose gradient ``counter`` resolves to ``lay`` as
    the backward passes it."""

    @staticmethod
    def forward(ctx, x, counter, lay):
        ctx.counter, ctx.lay = counter, lay
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.counter.op = "gradient constraint"
        ctx.counter.set_layout(grad, ctx.counter.resolve(grad, ctx.lay))
        return grad, None, None


class _LayerSlices(TorchFunctionMode):
    """Resolves each layer's slice of a stacked parameter's gradient as
    soon as that layer's backward ends: the reference's gradient
    constraint reaches into its layer scan, so no more than a layer's
    partial gradient is ever whole. The slice that ``unbind`` gives is
    replaced, from its first use on, by a view through :class:`_GradTo`,
    made at that first use: the autograd engine runs a ready node after
    every node made later, so a node made when the layer is reached runs
    right after the layer's backward. (A hook on the slice would wait for
    ``unbind``'s backward, once every layer's gradient has come.)"""

    def __init__(self, counter: LayoutCounter):
        super().__init__()
        self.counter = counter
        # id of a slice -> (the slice, its view or None until first used);
        # the trace holds every slice, so an id is not reused meanwhile
        self.slices: Dict[int, list] = {}

    def _use(self, t):
        entry = self.slices.get(id(t))
        if entry is None or entry[0] is not t:
            return t
        if entry[1] is None:
            entry[1] = _GradTo.apply(t, self.counter, self.counter.layout(t))
        return entry[1]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.slices:
            args = tuple(self._use(a) for a in args)
            kwargs = {k: self._use(v) for k, v in kwargs.items()}
        out = func(*args, **kwargs)
        if func in (torch.unbind, torch.Tensor.unbind) \
                and args[0].requires_grad \
                and _key(args[0]) in self.counter._args:
            for t in out:
                self.slices[id(t)] = [t, None]
        return out
