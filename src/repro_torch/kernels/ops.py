"""Public entry points of the hand-written kernels and their launch counts.

Twin of ``repro/kernels/ops.py``. Each wrapper runs its plain version
(``ref``) on CPU tensors and its CUDA kernel on CUDA tensors, building the
kernel library at first use (``build``). Every wrapper counts its launches
in its module's ``LAUNCHES``; :func:`launch_counts` gathers them so a run
can show that its path went through the kernels. Every TPU kernel of the
reference has its counterpart here.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import cache_probe as _probe
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import embedding_bag as _bag
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels.cache_probe import (cache_probe, cache_probe_dual,
                                             cache_probe_dual_multi,
                                             cache_probe_perquery,
                                             cache_probe_tiled)
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.flash_attention import flash_attention

# kernel name -> (counter dict, key)
_COUNTERS = {
    "cache_probe_dual": (_probe.LAUNCHES, "dual"),
    "cache_probe_dual_multi": (_probe.LAUNCHES, "dual_multi"),
    "cache_probe_perquery": (_probe.LAUNCHES, "perquery"),
    "cache_probe_tiled": (_probe.LAUNCHES, "tiled"),
    "decode_attention": (_decode.LAUNCHES, "decode_attention"),
    "embedding_bag": (_bag.LAUNCHES, "embedding_bag"),
    "flash_attention": (_flash.LAUNCHES, "flash_attention"),
}


def launch_counts() -> Dict[str, int]:
    """Launches of every kernel since the last reset, by kernel name."""
    return {name: d[k] for name, (d, k) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for d, k in _COUNTERS.values():
        d[k] = 0


def add_launch_counts(delta: Dict[str, int]) -> None:
    """Add ``delta`` (kernel name -> launches) to the counts. A CUDA graph
    replay launches the kernels captured in it without calling their
    wrappers, so the replay adds them here (``core/graph.py``)."""
    for name, n in delta.items():
        d, k = _COUNTERS[name]
        d[k] += n


__all__ = ["cache_probe", "cache_probe_tiled", "cache_probe_dual",
           "cache_probe_dual_multi", "cache_probe_perquery",
           "decode_attention", "embedding_bag", "flash_attention",
           "launch_counts", "reset_launch_counts", "add_launch_counts",
           "ref"]
