"""Compiled entry points: ``jax.jit``'s counterpart, as CUDA graphs.

The reference compiles a server's step, its S-step scan and its flush
with ``jax.jit``, donating the state. :class:`Compiled` wraps one plain
function of tensors, ``fn(*inplace, *inputs, **kwargs)``, whose leading
``inplace`` arguments (the tower's parameters, the server state) it reads
and writes in place and whose other arguments are the call's inputs:

* On a CPU state it calls ``fn``.
* On a CUDA state it keeps one ``torch.cuda.CUDAGraph`` per static key:
  what ``jax.jit``'s cache keys on (the inputs' structure, shapes and
  dtypes, the static arguments' values) plus the address, shape, strides
  and dtype of every in-place tensor, which the graph bakes in. The first
  call of a key runs ``fn`` eagerly on a side stream: that is the call's
  real execution, its result is what the call returns, and it does the
  lazy work (kernel builds, cuBLAS handles, shared-memory attributes).
  Then it captures ``fn``, which records without executing. Later calls
  copy their inputs into the graph's static buffers and replay.

A host int (``now_ms``) is staged into a device tensor outside the
graph with ``fill_``, so the captured body only sees device tensors.
Outputs are cloned out of the graph's memory pool, so the next replay
cannot overwrite them. The kernel launches recorded while
capturing are added to the ``kernels.ops`` counts on every replay.

A bucket-sharded state (``distributed.sharding.ShardedCacheState``) is a
pytree like any other: its shards' slabs are among the in-place tensors,
so a graph's key holds every slab's address. A state whose tensors lie
on more than one device (a mesh over distinct cards) raises
``NotImplementedError``: one CUDA graph records the work of one card.

With the span recorder on (``core/trace.py``) a call records its host
spans (``entry``, ``entry.key``, ``entry.load``, ``entry.replay``,
``entry.clone``, ``entry.capture``), and the recorder's state is part of
the static key: a traced call replays a graph of its own, whose phase
events time every replay. ``len(Compiled.graphs)`` counts the captures
whether or not the recorder is on: a graph more for one shape means a key
changed (a state tensor moved), and its capture stalled that call.

A capture or replay that fails raises; nothing falls back to running
``fn`` eagerly. ``fn`` must leave every in-place tensor's storage where it
was (:func:`write_back`) and must not sync with the host: an ``.item()``
or a boolean-mask index in the body fails the capture.
"""
from __future__ import annotations

import gc
import time
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence)

import torch

from repro_torch.core import trace
from repro_torch.kernels import ops


def _flatten(tree):
    """(leaves, spec) of a pytree of dicts, tuples, lists and NamedTuples;
    every other object is a leaf. ``spec`` is hashable and rebuilds the
    tree with :func:`_unflatten`."""
    if isinstance(tree, dict):
        keys = tuple(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([x for p in parts for x in p[0]],
                (dict, keys, tuple(p[1] for p in parts)))
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(v) for v in tree]
        return ([x for p in parts for x in p[0]],
                (type(tree), None, tuple(p[1] for p in parts)))
    return [tree], None


def _unflatten(leaves: Iterator, spec):
    if spec is None:
        return next(leaves)
    kind, keys, subs = spec
    if kind is dict:
        return {k: _unflatten(leaves, s) for k, s in zip(keys, subs)}
    vals = [_unflatten(leaves, s) for s in subs]
    return kind(*vals) if hasattr(kind, "_fields") else kind(vals)


def tensors_of(tree) -> List[torch.Tensor]:
    """Every tensor of a pytree, in order; an ``nn.Module`` contributes
    its parameters and buffers."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    return [x for x in _flatten(tree)[0] if isinstance(x, torch.Tensor)]


def write_back(dst, src) -> None:
    """Copy each tensor of the pytree ``src`` into the tensor at the same
    place in ``dst`` where the two do not share storage. A function that
    returns a state with fresh leaves (the admission budget's ``refill``
    and ``spend`` return new tensors) then leaves it in ``dst``'s own
    tensors, which the next replay of a graph reads."""
    for a, b in zip(tensors_of(dst), tensors_of(src), strict=True):
        if a.data_ptr() != b.data_ptr():
            a.copy_(b)


def _address_key(trees: Sequence) -> tuple:
    """What a graph bakes in of its in-place arguments: each tensor's
    address, shape, strides and dtype."""
    return tuple((x.data_ptr(), tuple(x.shape), x.stride(), x.dtype)
                 for tree in trees for x in tensors_of(tree))


def _input_sig(x):
    """An input leaf's part of the key: a tensor's shape and dtype, a host
    int (a clock), or None."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    if x is None:
        return None
    if type(x) is int:
        return int
    raise TypeError(f"a compiled call takes tensors, ints and None as "
                    f"inputs, got {type(x).__name__}")


def _clone(tree):
    leaves, spec = _flatten(tree)
    return _unflatten(iter([x.clone() if isinstance(x, torch.Tensor) else x
                            for x in leaves]), spec)


class CapturedGraph:
    """One static key's graph: its static input buffers (a host int is
    staged into an int32 0-d tensor) and outputs, the launches per kernel
    it replays, how long its first call took (``capture_s``: the eager run
    and the capture), the memory its pool holds, the bytes a replay copies
    in and clones out, and the phase events it records."""

    def __init__(self, leaves: List, dev):
        self.buffers = [
            None if x is None else
            torch.empty(x.shape, dtype=x.dtype, device=dev)
            if isinstance(x, torch.Tensor) else
            torch.empty((), dtype=torch.int32, device=dev) for x in leaves]

    def first_call(self, call: Callable, spec, leaves: List, dev):
        """The key's first call, ``call(inputs)``: run it eagerly on a side
        stream (the call's real execution, whose output this returns),
        then capture it. Nothing here keeps ``call``, so the graph holds
        no reference to the tensors it was captured on."""
        t0 = time.time_ns()
        run = lambda: call(_unflatten(iter(self.buffers), spec))
        self.load(leaves)
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first = run()
        cur.wait_stream(side)
        for t in tensors_of(first):
            t.record_stream(cur)
        # then the capture, which records without executing: its launches
        # are taken back out of the counts and added on each replay. A
        # graph freed while another is being captured (a dead server's,
        # collected as cyclic garbage) destroys its executable inside the
        # capture, which invalidates the capture: collect first, and keep
        # the collector off until the capture ends. cuBLAS keeps a
        # workspace per (handle, stream); one made during a capture lives
        # in that graph's pool, so the cached workspaces are dropped
        # around each capture (as torch's own graph trees do).
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = ops.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        gc_was_on = gc.isenabled()
        gc.disable()
        torch._C._cuda_clearCublasWorkspaces()
        try:
            with torch.cuda.graph(self.graph):
                self.out = run()
        finally:
            torch._C._cuda_clearCublasWorkspaces()
            if gc_was_on:
                gc.enable()
            after = ops.launch_counts()
            self.launches = {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}
            ops.add_launch_counts({k: -n for k, n in self.launches.items()})
            self.phases = trace.take_captured()
        torch.cuda.empty_cache()
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.load_bytes = sum(b.nbytes for b in self.buffers if b is not None)
        self.clone_bytes = sum(t.nbytes for t in tensors_of(self.out))
        t1 = time.time_ns()
        self.capture_s = (t1 - t0) / 1e9
        if trace.on:
            trace.span("entry.capture", t0, t1)
        return first

    def load(self, leaves: Iterable) -> None:
        """Stage a call's inputs into the static buffers."""
        for buf, x in zip(self.buffers, leaves, strict=True):
            if isinstance(x, torch.Tensor):
                buf.copy_(x)
            elif x is not None:
                buf.fill_(x)

    def replay(self, leaves: Iterable, t: Optional[int] = None):
        """Load, replay, clone. ``t``: a traced call's clock where its
        ``entry.load`` span starts (None: the recorder is off)."""
        self.load(leaves)
        if t is not None:
            t = trace.span("entry.load", t)
        self.graph.replay()
        ops.add_launch_counts(self.launches)
        if t is not None:
            trace.replayed(self.phases)
            t = trace.span("entry.replay", t)
        out = _clone(self.out)
        if t is not None:
            trace.span("entry.clone", t)
        return out


class Compiled:
    """``fn`` compiled as one CUDA graph per static key (module docstring).

    ``inplace`` counts the leading arguments that ``fn`` reads and writes
    in place; the last of them is the state, whose device decides where
    the call runs. ``assemble(inplace_args, out)`` builds the caller's
    result from ``fn``'s output. Keyword arguments named in
    ``static_argnames`` are static (part of the key); others are inputs.
    """

    def __init__(self, fn: Callable, *, inplace: int, assemble: Callable,
                 static_argnames: Sequence[str] = ()):
        self._fn = fn
        self._inplace = inplace
        self._assemble = assemble
        self._static = frozenset(static_argnames)
        self.graphs: Dict[tuple, CapturedGraph] = {}

    def __call__(self, *args, **kwargs):
        traced = trace.on
        if traced:
            t = trace.begin_call()
        bound, args = args[:self._inplace], args[self._inplace:]
        state = tensors_of(bound[-1])
        devices = {x.device for x in state}
        if len(devices) > 1:
            raise NotImplementedError(
                f"a compiled entry point runs one device's work, and this "
                f"state lies on {len(devices)} devices "
                f"({', '.join(sorted(map(str, devices)))}): a mesh over "
                "distinct cards is not captured as a CUDA graph; call the "
                "eager serve_step / serve_many / flush instead")
        if not state or not state[0].is_cuda:
            res = self._assemble(bound, self._fn(*bound, *args, **kwargs))
            if traced:
                trace.end_call()
            return res
        dev = state[0].device
        static = tuple(sorted((k, v) for k, v in kwargs.items()
                              if k in self._static))
        names = tuple(sorted(k for k in kwargs if k not in self._static))
        leaves, spec = _flatten((tuple(args),
                                 tuple(kwargs[k] for k in names)))
        key = (spec, names, static, tuple(map(_input_sig, leaves)),
               _address_key(bound), traced)
        with torch.cuda.device(dev):
            entry = self.graphs.get(key)
            if traced:
                t = trace.span("entry.key", t)
            if entry is None:
                def call(inputs):
                    pos, kw = inputs
                    return self._fn(*bound, *pos, **dict(zip(names, kw)),
                                    **dict(static))

                entry = CapturedGraph(leaves, dev)
                out = entry.first_call(call, spec, leaves, dev)
                self.graphs[key] = entry
            else:
                out = entry.replay(leaves, t if traced else None)
        res = self._assemble(bound, out)
        if traced:
            trace.end_call()
        return res
