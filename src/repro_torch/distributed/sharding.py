"""Logical-axis sharding rules, and placement of the bucket-sharded cache
tier.

Twin of ``repro/distributed/sharding.py``. Its first half maps the models'
LOGICAL axis names (``"batch"``, ``"heads"``, ``"rows"``, ...) onto the
physical axes of a :class:`~repro_torch.launch.mesh.ModelMesh` through a
rule set a model family: :func:`logical_to_spec` gives a :class:`Spec`
(the port's own tuple type in place of ``jax.sharding.PartitionSpec``),
dropping axes the mesh lacks and using each mesh axis at most once;
:func:`divisible_or_replicate` replicates a dim its axes do not divide.
:func:`constrain` computes and checks a tensor's spec and returns the
tensor itself: a sharding constraint never changes a value, and the
port's model-axis functions run every shard on one device, so nothing
moves (the planner's trace alone records what the constraint would move,
``launch/layout.py``). The shard loops that do split work (the sharded
bag, top-k, decode and GIN forward) take their shard counts from the same
mesh.

In the cache-tier half, shard s
of a 1-D ``("shard",)`` :class:`~repro_torch.launch.mesh.CacheMesh` owns
the contiguous bucket range ``[s*nb/N, (s+1)*nb/N)`` of every table. Where
the reference lays one ``jax.Array`` over the mesh with a
``NamedSharding``, the port holds a :class:`ShardedCacheState`: one slab a
shard, each a plain ``CacheState`` (or ``MultiCacheState``, split along
its bucket axis 1) on its shard's device. The write and touch rings and
the admission budget exist once, on the mesh's first device: one
controller needs one copy (the reference's "replicated" is a placement).
"""
from __future__ import annotations

from typing import (Callable, Dict, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch

from repro_torch.core import cache as cache_lib
from repro_torch.distributed import collectives as coll

Axis = Union[None, str, Tuple[str, ...]]

# ---------------------------------------------------------------- rule sets
# logical axis name -> physical mesh axis (or tuple of axes); the
# reference's rule sets, entry for entry.
LM_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "vocab": "model",
    "expert": "model",
    "expert_ffn": "data",
    "layers": None,
    "pos": None,
}

RECSYS_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "rows": "model",
    "embed": None,
    "ffn": "model",
    "seq": None,
    "heads": None,
    "candidates": ("data", "model"),
    "fields": None,
    "interests": None,
}

GNN_RULES: Dict[str, Axis] = {
    "nodes": ("pod", "data"),
    "edges": ("pod", "data"),
    "batch": ("pod", "data"),
    "feat": None,
    "hidden": None,
    "layers": None,
}

RULES_BY_FAMILY = {"lm": LM_RULES, "recsys": RECSYS_RULES, "gnn": GNN_RULES}

# ``constrain``'s entry that leaves a dim as the tensor has it
UNCONSTRAINED = coll.UNCONSTRAINED


class Spec(tuple):
    """A partition spec: one entry a dim, each None (replicated), a mesh
    axis name or a tuple of them. ``Spec("data", None)``; compares equal
    to the plain tuple of its entries."""

    def __new__(cls, *entries: Axis) -> "Spec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


class Placement(NamedTuple):
    """Where a tensor lives: a spec over a mesh (the reference's
    ``NamedSharding``)."""

    mesh: object
    spec: Spec


def logical_to_spec(logical: Sequence[Optional[str]],
                    rules: Dict[str, Axis],
                    mesh_axes: Sequence[str]) -> Spec:
    """Map logical axis names to a spec valid on ``mesh_axes``: a name
    missing from the rules, or whose mesh axes the mesh lacks, is
    replicated, and each mesh axis is used at most once a spec."""
    used = set()
    out = []
    for name in logical:
        if name == UNCONSTRAINED:
            out.append(UNCONSTRAINED)
            continue
        phys = rules.get(name) if name else None
        if phys is None:
            out.append(None)
            continue
        cand = phys if isinstance(phys, tuple) else (phys,)
        keep = tuple(a for a in cand if a in mesh_axes and a not in used)
        used.update(keep)
        out.append(None if not keep else keep[0] if len(keep) == 1
                   else keep)
    return Spec(*out)


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, str) for a in x)


def _map_logical(fn: Callable, tree):
    """``fn`` over the logical-axis tuples of a tree of dicts, lists and
    NamedTuples (None stays None)."""
    if _is_logical(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_logical(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_logical(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_logical(fn, v) for v in tree)
    if tree is None:
        return None
    raise TypeError(f"not a logical-axis tree leaf: {tree!r}")


def tree_spec(logical_tree, family: str, mesh):
    """A tree of logical-axis tuples -> the same tree of specs."""
    rules = RULES_BY_FAMILY[family]
    return _map_logical(
        lambda lg: logical_to_spec(lg, rules, mesh.axis_names), logical_tree)


def tree_sharding(logical_tree, family: str, mesh):
    """:func:`tree_spec` with each spec placed on ``mesh``."""
    rules = RULES_BY_FAMILY[family]
    return _map_logical(
        lambda lg: Placement(mesh, logical_to_spec(lg, rules,
                                                   mesh.axis_names)),
        logical_tree)


def divisible_or_replicate(spec: Sequence[Axis], shape: Sequence[int],
                           mesh) -> Spec:
    """Replicate every dim whose mesh-axis product does not divide it
    (e.g. 56 heads on a 16-way model axis)."""
    out = []
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, entry in zip(shape, entries):
        if entry is None or entry == UNCONSTRAINED:
            out.append(entry)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        out.append(entry if dim % size == 0 else None)
    return Spec(*out)


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]],
              family: str, mesh=None) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical names: the
    spec is computed and checked (as many names as ``x`` has dims at
    most, a mesh on one device) and ``x`` itself is returned. No-op when
    ``mesh`` is None. Under the planner's trace (only there) a view of
    ``x`` resharded to the spec is returned instead, its collectives and
    those of its backward recorded (``collectives.reshard``). There a
    dimension that its axes do not divide stays split over the minor ones
    that do, where ``divisible_or_replicate`` gives it whole: GSPMD keeps
    the split its inputs carry (the reference's compile of Arctic's
    training on the (2, 16, 16) mesh runs one row of each 16-row
    microbatch a device)."""
    if mesh is None:
        return x
    mesh.device()                       # refuses a mesh of distinct devices
    if len(logical) > x.dim():
        raise ValueError(f"{len(logical)} logical axes {tuple(logical)} for "
                         f"a tensor of shape {tuple(x.shape)}")
    spec = logical_to_spec(logical, RULES_BY_FAMILY[family], mesh.axis_names)
    divisible_or_replicate(spec, x.shape, mesh)
    return coll.reshard(x, spec)


class ShardedCacheState(NamedTuple):
    """One table split by bucket range: ``shards[s]`` holds global buckets
    ``[s*nbl, (s+1)*nbl)`` on shard s's device. Reads like the unsharded
    table where the serving tier needs it (global ``n_buckets``,
    ``ways``); :meth:`gather` gives the global planes back."""

    shards: Tuple

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_buckets(self) -> int:
        """Global buckets (per model slab for a stacked tier)."""
        return sum(s.n_buckets for s in self.shards)

    @property
    def ways(self) -> int:
        return self.shards[0].ways

    def gather(self):
        """The global table as one (Multi)CacheState on the first shard's
        device (new tensors)."""
        first = self.shards[0]
        dev = first.key_hi.device
        axis = coll.bucket_axis(first)
        return type(first)(*(torch.cat([t.to(dev) for t in leaves], axis)
                             for leaves in zip(*self.shards)))


def gather_cache(tier):
    """A sharded table's global planes; an unsharded table as it is."""
    return tier.gather() if isinstance(tier, ShardedCacheState) else tier


def _own(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device=dev).copy_(x)


def split_cache(tier, devices: Sequence[torch.device]) -> ShardedCacheState:
    """An unsharded table split into ``len(devices)`` slabs, each copied
    to its shard's device."""
    axis = coll.bucket_axis(tier)
    nbl = cache_lib.shard_local_buckets(tier.n_buckets, len(devices))
    return ShardedCacheState(tuple(
        type(tier)(*(_own(t.narrow(axis, s * nbl, nbl), dev) for t in tier))
        for s, dev in enumerate(devices)))


def init_sharded(init: Callable, n_buckets: int, mesh) -> ShardedCacheState:
    """An empty sharded table: ``init(local_buckets, device)`` allocates
    each shard's slab on its device (an empty table is the same fill
    everywhere, so no global table is ever allocated)."""
    nbl = cache_lib.shard_local_buckets(n_buckets, mesh.n_shards)
    return ShardedCacheState(tuple(init(nbl, dev) for dev in mesh.devices))


def mesh_device(device, mesh) -> torch.device:
    """Where a sharded state's rings and budget live: the mesh's first
    device, which ``device`` must agree with in kind (the CPU is only
    taken when asked for)."""
    device = cache_lib.resolve_device(device)
    first = mesh.devices[0]
    if device.type != first.type:
        raise ValueError(f"device={device} but the mesh's first shard is on "
                         f"{first}")
    return first


def validate_cache_sharding(mesh, n_buckets_list) -> int:
    """Check a cache-tier mesh: a 1-D ``shard`` axis whose size divides
    every tier's bucket count. Returns the shard count."""
    if coll.SHARD_AXIS not in mesh.axis_names:
        raise ValueError(
            f"cache-tier mesh needs a '{coll.SHARD_AXIS}' axis, got "
            f"{mesh.axis_names}")
    n_shards = mesh.shape[coll.SHARD_AXIS]
    for nb in n_buckets_list:
        cache_lib.shard_local_buckets(nb, n_shards)  # raises on indivisible
    return n_shards


def _place_tier(tier, mesh):
    if isinstance(tier, ShardedCacheState):
        if tuple(s.key_hi.device for s in tier.shards) == mesh.devices:
            return tier
        tier = tier.gather()
    return split_cache(tier, mesh.devices)


def place_server_state(state, mesh):
    """A ``ServerState`` or ``MultiServerState`` placed for the
    bucket-sharded tier: both tables split along their bucket axis over
    the mesh, the rings and the budget on its first device. A table
    already split over the same devices is kept as it is (placing a
    placed state is a no-op); one split otherwise is gathered and split
    again."""
    validate_cache_sharding(
        mesh, {state.direct.n_buckets, state.failover.n_buckets})
    dev = mesh.devices[0]
    return state._replace(
        direct=_place_tier(state.direct, mesh),
        failover=_place_tier(state.failover, mesh),
        writebuf=coll._on(state.writebuf, dev),
        touchbuf=coll._on(state.touchbuf, dev),
        budget=coll._on(state.budget, dev))
