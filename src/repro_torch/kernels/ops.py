"""Public entry points of the hand-written kernels and their launch counts.

Twin of ``repro/kernels/ops.py``. Each wrapper runs its plain version
(``ref``) on CPU tensors and its CUDA kernel on CUDA tensors, building the
kernel library at first use (``build``). Every wrapper counts its launches
in its module's ``LAUNCHES``; :func:`launch_counts` gathers them so a run
can show that its path went through the kernels. The flash / decode
attention kernels and the per-query probe join with their slices.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import cache_probe as _probe
from repro_torch.kernels import embedding_bag as _bag
from repro_torch.kernels import ref
from repro_torch.kernels.cache_probe import (cache_probe, cache_probe_dual,
                                             cache_probe_dual_multi,
                                             cache_probe_tiled)
from repro_torch.kernels.embedding_bag import embedding_bag

# kernel name -> (counter dict, key)
_COUNTERS = {
    "cache_probe_dual": (_probe.LAUNCHES, "dual"),
    "cache_probe_dual_multi": (_probe.LAUNCHES, "dual_multi"),
    "cache_probe_tiled": (_probe.LAUNCHES, "tiled"),
    "embedding_bag": (_bag.LAUNCHES, "embedding_bag"),
}


def launch_counts() -> Dict[str, int]:
    """Launches of every kernel since the last reset, by kernel name."""
    return {name: d[k] for name, (d, k) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for d, k in _COUNTERS.values():
        d[k] = 0


__all__ = ["cache_probe", "cache_probe_tiled", "cache_probe_dual",
           "cache_probe_dual_multi", "embedding_bag", "launch_counts", "reset_launch_counts", "ref"]
