"""Build-at-first-use loader for the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``. Libraries are cached by the hash of their source and flags in
``src/repro_torch/_build/`` (listed in ``.gitignore``), so a checkout builds
everything it needs from its own sources and nothing else.

Failures raise: there is no fallback to a plain version on the card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("cache_probe", "decode_attention", "embedding_bag",
           "flash_attention")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built at first use and need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that has no library yet, all ``nvcc``
    processes at once, and wait for them. Returns name -> library path.
    The compiler's ``-Xptxas -v`` report lands beside each library as
    ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for name, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        targets[name].with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            errors.append(f"{name}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, targets[name])  # atomic: concurrent builders agree
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The SM count of a CUDA ``device``, read from its properties once per
    process: the kernels size their grids from it."""
    import torch

    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None
                     else index)


def check(lib: ctypes.CDLL, strerror: str, code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code (``cudaGetLastError``
    right after the launch)."""
    if code != 0:
        fn = getattr(lib, strerror)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {code}: "
                           f"{fn(code).decode(errors='replace')}")


def refuse_grad(what: str, plain: str, *tensors) -> None:
    """Raise RuntimeError when autograd is recording and a float input
    needs a gradient: a kernel launched through raw pointers returns an
    output with no ``grad_fn``, so the gradient would be lost without a
    word. ``plain`` names the differentiable plain version to use."""
    import torch

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad and t.is_floating_point()
            for t in tensors):
        raise RuntimeError(f"{what} has no backward: its inputs need a "
                           f"gradient; use {plain} (differentiable) or "
                           "call it under torch.no_grad()")
