"""Device meshes: the model-axis meshes and the cache tier's mesh.

Twin of ``repro/launch/mesh.py``. The reference's ``jax.sharding.Mesh`` is
driven by one controller, which runs a ``shard_map`` body on every device
of the mesh; here one Python process does the same over torch devices:

* :class:`ModelMesh` (``make_host_mesh``, ``make_production_mesh``): the
  named ``("data", "model")`` or ``("pod", "data", "model")`` grid of the
  model-axis sharding (``distributed/sharding.py`` maps logical axes onto
  it; ``distributed/collectives.py`` and the models loop over its shards).
  Every function that takes one computes on ONE device and refuses a grid
  of distinct devices (:meth:`ModelMesh.device`).
* :class:`CacheMesh` (``make_cache_mesh``): a 1-D ``"shard"`` mesh for the
  bucket-sharded cache tier, each shard holding a contiguous range of
  every table's buckets, one torch device a shard.

Hardware model of the roofline terms (``launch/dryrun.py``), under the
reference's names: one NVIDIA H100 SXM, "NVIDIA H100 80GB HBM3, 700.00 W"
as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
reads it (NVIDIA's data sheet, dense rates at the full 700 W):

  * 989 TFLOP/s bf16 on the tensor cores (``PEAK_FLOPS_BF16``)
  * 3.35 TB/s HBM3 (``HBM_BW``)
  * 450 GB/s NVLink 4 per direction (``ICI_BW``)

The production meshes have a 16-wide model axis. On a real HGX cluster
one NVLink domain holds 8 GPUs, so such an axis spans two domains and
part of its traffic crosses the slower inter-node network: there the
collective term at the NVLink rate is a lower bound.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Dict, Optional, Sequence, Tuple

import torch

SHARD_AXIS = "shard"
# H100 SXM constants of the roofline terms (the module docstring)
PEAK_FLOPS_BF16 = 989e12          # FLOP/s per card, dense bf16
HBM_BW = 3.35e12                  # bytes/s per card
ICI_BW = 450e9                    # bytes/s per direction, NVLink 4
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


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


@dataclasses.dataclass(frozen=True)
class ModelMesh:
    """A named device grid: ``devices`` holds ``prod(dims)`` torch devices
    in row-major order over ``axis_names`` (the last axis fastest), as
    ``jax.sharding.Mesh.devices.flat``. One device may appear several
    times (the tests lay out large meshes on the CPU so)."""

    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self) -> None:
        dims, names = tuple(self.dims), tuple(self.axis_names)
        devs = tuple(_indexed(torch.device(d)) for d in self.devices)
        if len(dims) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} do not name dims {dims}")
        if any(n < 1 for n in dims) or len(devs) != math.prod(dims):
            raise ValueError(f"{len(devs)} devices for a mesh of {dims}")
        object.__setattr__(self, "dims", dims)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape`` reads."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    def device(self) -> torch.device:
        """The one device every shard of this mesh lives on. A grid of
        distinct devices raises: the model-axis functions run their
        shards one after another on one device, and nothing here can
        test a mesh across devices (the reference's are TPU pods)."""
        if len(set(self.devices)) != 1:
            raise NotImplementedError(
                "a model mesh over distinct devices "
                f"({sorted(set(map(str, self.devices)))}) is not supported: "
                "the model-axis sharding runs every shard on one device")
        return self.devices[0]


def _local_devices(devices: Optional[Sequence], what: str):
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if any(d.type == "cuda" for d in devs) \
                and not torch.cuda.is_available():
            raise RuntimeError("a cuda device but no CUDA card is available")
        return devs
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} places the mesh on the CUDA cards and "
                           "none is available; pass devices=[...] to run "
                           "on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_host_mesh(devices: Optional[Sequence] = None) -> ModelMesh:
    """All local cards (or ``devices``) on a ``("data", "model")`` mesh
    whose model axis is the largest of 4, 2, 1 dividing the device count:
    ``(1, 1)`` on one H100."""
    devs = _local_devices(devices, "make_host_mesh")
    n = len(devs)
    model = next(m for m in (4, 2, 1) if n % m == 0)
    return ModelMesh((n // model, model), ("data", "model"), tuple(devs))


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> ModelMesh:
    """The reference's production mesh: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")`` with
    ``multi_pod``. It takes the first devices of ``devices`` (or of the
    local cards) and refuses when there are fewer than the mesh has."""
    dims, names = PRODUCTION_SHAPES[bool(multi_pod)]
    devs = _local_devices(devices, "make_production_mesh")
    need = math.prod(dims)
    if len(devs) < need:
        raise ValueError(f"a {dims} mesh needs {need} devices, "
                         f"{len(devs)} given")
    return ModelMesh(dims, names, tuple(devs[:need]))


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
