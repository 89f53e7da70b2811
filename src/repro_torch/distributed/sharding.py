"""Placement of the bucket-sharded cache tier.

Twin of the cache-tier half of ``repro/distributed/sharding.py``: shard s
of a 1-D ``("shard",)`` :class:`~repro_torch.launch.mesh.CacheMesh` owns
the contiguous bucket range ``[s*nb/N, (s+1)*nb/N)`` of every table. Where
the reference lays one ``jax.Array`` over the mesh with a
``NamedSharding``, the port holds a :class:`ShardedCacheState`: one slab a
shard, each a plain ``CacheState`` (or ``MultiCacheState``, split along
its bucket axis 1) on its shard's device. The write and touch rings and
the admission budget exist once, on the mesh's first device: one
controller needs one copy (the reference's "replicated" is a placement).

The logical-axis rules of the model-axis sharding (the reference's
``:22``-``:173``) are not here.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from repro_torch.core import cache as cache_lib
from repro_torch.distributed import collectives as coll


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
