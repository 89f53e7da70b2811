"""The cache tier's device mesh.

Twin of ``make_cache_mesh`` in ``repro/launch/mesh.py``: a 1-D ``"shard"``
mesh for the bucket-sharded cache tier, each shard holding a contiguous
range of every table's buckets (``distributed/collectives.py``). The
reference's ``jax.sharding.Mesh`` is driven by one controller, which runs
the shard-mapped probe and flush on every device of the mesh; here one
Python process does the same over a tuple of torch devices, one a shard.

The reference's model-axis meshes (``make_production_mesh``,
``make_host_mesh``) are not here: they belong to the model-axis sharding.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Dict, Optional, Sequence, Tuple

import torch

SHARD_AXIS = "shard"


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``: the device its tensors report."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class CacheMesh:
    """A 1-D mesh of ``len(devices)`` shards: shard s lives on
    ``devices[s]``. Several shards may share a device (on one card all of
    them do); the write and touch rings, the admission budget and the
    probe's combined results live on ``devices[0]``."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self) -> None:
        devs = tuple(_indexed(torch.device(d)) for d in self.devices)
        if not devs:
            raise ValueError("a cache mesh needs at least one shard")
        object.__setattr__(self, "devices", devs)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (SHARD_AXIS,)

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        """``{"shard": N}``, as ``jax.sharding.Mesh.shape`` reads."""
        return {SHARD_AXIS: self.n_shards}


def make_cache_mesh(n_shards: int,
                    devices: Optional[Sequence] = None) -> CacheMesh:
    """A ``("shard",)`` mesh of ``n_shards`` shards.

    ``devices`` (one per shard) places them explicitly, e.g. on the CPU.
    By default the shards use the first ``n_shards`` cards, or, with fewer
    cards, go round-robin over the cards there are (on one card every
    shard shares ``cuda:0``, as the reference's forced host devices share
    one CPU); the placement is logged once on stderr. Without a card and
    without ``devices`` it raises: nothing meant for the card runs on the
    CPU unasked."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is not None:
        if len(devices) != n_shards:
            raise ValueError(f"{len(devices)} devices for {n_shards} "
                             "shards")
        devs = tuple(torch.device(d) for d in devices)
        for d in devs:
            if d.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"device {d} but no CUDA card is "
                                   "available")
        return CacheMesh(devs)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_cache_mesh places the shards on CUDA cards and none is "
            "available; pass devices=['cpu'] * n_shards to run on the CPU")
    n_cards = torch.cuda.device_count()
    devs = tuple(torch.device("cuda", s % n_cards) for s in range(n_shards))
    print(f"[cache mesh] {n_shards} shards on {min(n_shards, n_cards)} "
          f"card(s): " + ", ".join(str(d) for d in devs), file=sys.stderr)
    return CacheMesh(devs)
