"""Sharded, atomic, resumable checkpoints (npz-per-shard + json manifest).

Twin of ``repro/ft/checkpoint.py``, in the same on-disk format: a
checkpoint written by either package restores in the other. Layout::

    <dir>/step_000123/
        manifest.json      # leaf names, shapes, dtypes and crc32s, shard
                           # map, optional caller metadata (``user_meta``)
        shard_00000.npz    # flat leaves (or row-ranges of big leaves)
        ...
        COMMITTED          # written LAST: absence marks a torn checkpoint

Atomicity: writes go to ``step_X.tmp-<nonce>`` and the directory is renamed
into place only after the COMMITTED marker is fsync'd; the PARENT directory
is fsync'd after the rename so the commit itself survives power loss.
``latest_step`` skips uncommitted/torn directories. ``save`` also
garbage-collects orphaned ``.tmp-*`` directories left by earlier crashes
and, with ``retain_last_k``, prunes all but the newest K committed
checkpoints. Leaves larger than ``max_shard_bytes`` are row-split, one
shard a piece, and each leaf carries one crc32 of its whole contents.

A tree is dicts, NamedTuples, tuples and lists of tensors (or numpy
arrays). Leaves are named as ``jax.tree_util.keystr`` names them, in its
order: dict keys sorted, ``['key']``; NamedTuple fields in field order,
``.name``; sequence items ``[i]``. Each tensor is saved as the numpy array
``.cpu().numpy()`` gives, so the manifest's dtypes are numpy's names
(``"float32"``).

:func:`restore` rebuilds a tree whose leaf shapes must match the
checkpoint; :func:`restore_raw` returns the flat ``{name: np.ndarray}``
dict for callers that re-shape the state themselves (the elastic rehash,
``ft/snapshot.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import secrets
import shutil
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cache import resolve_device

PyTree = Any
_COMMITTED = "COMMITTED"


class ChecksumError(ValueError):
    """A restored leaf's content hash disagrees with the manifest: silent
    bit-rot in a COMMITTED shard. Restore paths that have a cold fallback
    (``ft/snapshot.restore_server``) catch this and fail open to cold."""


def _map_leaves(fn: Callable[[str, Any], Any], tree: PyTree,
                path: str = "") -> PyTree:
    """Rebuild ``tree`` with each leaf replaced by ``fn(name, leaf)``,
    visiting leaves in ``jax.tree_util`` order under its ``keystr``
    names. None is an empty subtree, as in JAX."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, tree[k], f"{path}[{k!r}]")
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v, f"{path}.{f}")
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _leaf_paths(tree: PyTree) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    _map_leaves(lambda name, leaf: out.append((name, leaf)), tree)
    return out


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _crc32(arr: np.ndarray) -> int:
    """crc32 of the array's C-order bytes (``tobytes()``), without the
    copy."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return zlib.crc32(flat) & 0xFFFFFFFF


def _gc_tmp_dirs(directory: str, keep: Optional[str] = None) -> None:
    """Remove orphaned ``.tmp-<nonce>`` directories (crashed mid-save)."""
    if not os.path.isdir(directory):
        return
    for name in os.listdir(directory):
        full = os.path.join(directory, name)
        if ".tmp-" in name and full != keep:
            shutil.rmtree(full, ignore_errors=True)


def _fsync_dir(directory: str) -> None:
    """Flush directory metadata (the rename) to disk; best-effort on
    filesystems without directory fsync."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save(directory: str, step: int, tree: PyTree,
         max_shard_bytes: int = 256 << 20,
         meta: Optional[Dict[str, Any]] = None,
         retain_last_k: Optional[int] = None) -> str:
    """Write one atomic checkpoint; returns the final path.

    ``meta`` is a JSON-serializable dict stored in the manifest
    (``read_meta`` returns it). ``retain_last_k`` prunes all but the
    newest K committed checkpoints after the commit (:func:`gc_old`);
    orphaned ``.tmp-*`` directories from crashed saves are
    garbage-collected unconditionally.
    """
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp-" + secrets.token_hex(4)
    os.makedirs(tmp, exist_ok=True)
    _gc_tmp_dirs(directory, keep=tmp)

    manifest: Dict[str, Any] = {"step": step, "leaves": {}, "shards": []}
    if meta is not None:
        manifest["user_meta"] = meta
    shard_idx = 0
    buf: Dict[str, np.ndarray] = {}
    buf_bytes = 0

    def flush():
        nonlocal shard_idx, buf, buf_bytes
        if not buf:
            return
        name = f"shard_{shard_idx:05d}.npz"
        np.savez(os.path.join(tmp, name), **buf)
        manifest["shards"].append(name)
        shard_idx += 1
        buf, buf_bytes = {}, 0

    for key, leaf in _leaf_paths(tree):
        arr = _as_numpy(leaf)
        # whole-leaf hash, taken before the row split, so a restore
        # verifies the reassembled array (a part at the wrong offset fails)
        entry = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                 "crc32": _crc32(arr), "parts": []}
        if arr.nbytes > max_shard_bytes and arr.ndim >= 1 and arr.shape[0] > 1:
            rows_per = max(1, int(max_shard_bytes
                                  // max(arr.nbytes // arr.shape[0], 1)))
            for lo in range(0, arr.shape[0], rows_per):
                hi = min(lo + rows_per, arr.shape[0])
                pname = f"{key}::rows{lo}_{hi}"
                flush()
                buf[pname] = arr[lo:hi]
                entry["parts"].append({"name": pname, "rows": [lo, hi],
                                       "shard": shard_idx})
                flush()
        else:
            if buf_bytes + arr.nbytes > max_shard_bytes:
                flush()
            buf[key] = arr
            buf_bytes += arr.nbytes
            entry["parts"].append({"name": key, "rows": None,
                                   "shard": shard_idx})
        manifest["leaves"][key] = entry
    flush()

    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    # commit marker, then atomic rename
    with open(os.path.join(tmp, _COMMITTED), "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # the rename lives in the PARENT directory's metadata: fsync it, or a
    # power loss can roll the commit back though COMMITTED is durable
    _fsync_dir(directory)
    if retain_last_k is not None:
        gc_old(directory, keep_last=retain_last_k)
    return final


def latest_step(directory: str) -> Optional[int]:
    """Highest committed step; torn checkpoints are skipped."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        if not name.startswith("step_") or ".tmp-" in name:
            continue
        if not os.path.exists(os.path.join(directory, name, _COMMITTED)):
            continue
        try:
            s = int(name.split("_")[1])
        except ValueError:
            continue
        best = s if best is None else max(best, s)
    return best


def _manifest(directory: str, step: int) -> Dict[str, Any]:
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def read_meta(directory: str, step: int) -> Optional[Dict[str, Any]]:
    """The caller metadata stored by ``save(..., meta=...)`` (or None)."""
    return _manifest(directory, step).get("user_meta")


def restore_raw(directory: str, step: int) -> Dict[str, np.ndarray]:
    """Load a checkpoint as a flat ``{name: np.ndarray}`` dict, no shape
    contract: the restore side of shape-changing (elastic) transitions.
    Raises :class:`ChecksumError` on a leaf whose contents disagree with
    its manifest crc32."""
    path = os.path.join(directory, f"step_{step:08d}")
    manifest = _manifest(directory, step)
    shard_data: Dict[int, Any] = {}

    def shard(i: int):
        if i not in shard_data:
            shard_data[i] = np.load(
                os.path.join(path, manifest["shards"][i]))
        return shard_data[i]

    out_by_key = {}
    try:
        for key, entry in manifest["leaves"].items():
            arr = np.empty(entry["shape"], dtype=entry["dtype"])
            for part in entry["parts"]:
                data = shard(part["shard"])[part["name"]]
                if part["rows"] is None:
                    arr = data
                else:
                    lo, hi = part["rows"]
                    arr[lo:hi] = data
            want = entry.get("crc32")  # absent in pre-checksum checkpoints
            if want is not None:
                got = _crc32(arr)
                if got != want:
                    raise ChecksumError(
                        f"checkpoint leaf {key!r} at step {step}: crc32 "
                        f"{got:#010x} != manifest {want:#010x} (bit-rot or "
                        "misassembled parts)")
            out_by_key[key] = arr
    finally:
        for z in shard_data.values():
            z.close()
    return out_by_key


def restore(directory: str, step: int, like: PyTree,
            device=None) -> PyTree:
    """Restore into the structure of ``like``, a tree of tensors whose
    shapes must equal the checkpoint's. Each leaf is made with the dtype of
    ``like``'s tensor, on ``device`` (default: that tensor's device; a
    ``meta`` tensor describes a leaf without holding one, like JAX's
    ``ShapeDtypeStruct``)."""
    out_by_key = restore_raw(directory, step)
    if device is not None:
        device = resolve_device(device)

    def load(key, leaf):
        arr = out_by_key[key]
        assert list(arr.shape) == list(leaf.shape), (key, arr.shape,
                                                     leaf.shape)
        return torch.as_tensor(arr, dtype=leaf.dtype,
                               device=leaf.device if device is None
                               else device)

    return _map_leaves(load, like)


def gc_old(directory: str, keep_last: int = 3) -> None:
    """Delete all but the newest ``keep_last`` committed checkpoints and any
    stale tmp directories."""
    if not os.path.isdir(directory):
        return
    steps = []
    for name in os.listdir(directory):
        full = os.path.join(directory, name)
        if ".tmp-" in name:
            shutil.rmtree(full, ignore_errors=True)
            continue
        if name.startswith("step_") and os.path.exists(
                os.path.join(full, _COMMITTED)):
            steps.append((int(name.split("_")[1]), full))
    for _, full in sorted(steps)[:-keep_last]:
        shutil.rmtree(full, ignore_errors=True)


@dataclasses.dataclass
class CheckpointManager:
    """Cadenced save + resume + retention, for a train loop. Restores land
    on ``device`` (the card unless the caller asks for the CPU)."""

    directory: str
    every_steps: int = 100
    keep_last: int = 3
    device: Any = "cuda"

    def maybe_save(self, step: int, tree: PyTree) -> Optional[str]:
        if step % self.every_steps != 0:
            return None
        path = save(self.directory, step, tree)
        gc_old(self.directory, self.keep_last)
        return path

    def restore_latest(self, like: PyTree) -> Tuple[Optional[int], PyTree]:
        device = resolve_device(self.device)
        step = latest_step(self.directory)
        if step is None:
            return None, like
        return step, restore(self.directory, step, like, device=device)
