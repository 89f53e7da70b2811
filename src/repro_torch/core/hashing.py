"""Vectorized hashing of 64-bit cache keys carried as two int32 words.

Twin of ``repro/core/hashing.py``: keys travel as an (hi, lo) pair of
int32 tensors and hash with the same xxhash32-style avalanche. The hash
needs uint32 wraparound, which torch has no dtype for (and its ``>>`` on
int32 is an arithmetic shift), so every step runs on int64 holding a value
in ``[0, 2**32)``, masked after each multiply and shift. The multiplies are
split into 16-bit halves so that no int64 product overflows.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Sentinel key marking an empty slot. Real user ids are non-negative, so a
# negative hi-word can never collide with a real key.
EMPTY_HI = -0x80000000
EMPTY_LO = 0

_M32 = 0xFFFFFFFF
_PRIME32_2 = 0x85EBCA77
_PRIME32_3 = 0xC2B2AE3D
_PRIME32_4 = 0x27D4EB2F
_PRIME32_5 = 0x165667B1


class Key64(NamedTuple):
    """A batch of 64-bit keys as two int32 words."""

    hi: torch.Tensor
    lo: torch.Tensor

    @staticmethod
    def from_int(ids, device="cuda") -> "Key64":
        """Build from python/numpy int64-like ids (host side), on
        ``device``; a CUDA device without a card raises."""
        from repro_torch.core.cache import resolve_device

        device = resolve_device(device)
        ids = np.asarray(ids, dtype=np.int64)
        hi = (ids >> 32).astype(np.int32)
        lo = (ids & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        return Key64(torch.as_tensor(hi, device=device),
                     torch.as_tensor(lo, device=device))

    def equal(self, other: "Key64") -> torch.Tensor:
        return (self.hi == other.hi) & (self.lo == other.lo)

    def is_empty(self) -> torch.Tensor:
        return (self.hi == EMPTY_HI) & (self.lo == EMPTY_LO)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> their uint32 value, held in int64."""
    return x.to(torch.int64) & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32): both partial products stay
    below 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _avalanche(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 15)
    h = _mul32(h, _PRIME32_2)
    h = h ^ (h >> 13)
    h = _mul32(h, _PRIME32_3)
    h = h ^ (h >> 16)
    return h


def hash_u32(key: Key64, seed: int = 0) -> torch.Tensor:
    """xxhash32-style hash of a 64-bit key. Returns the uint32 value held
    in an int64 tensor (torch has no uint32 arithmetic)."""
    h = (seed + _PRIME32_5 + 8) & _M32
    h = (h + _mul32(_u32(key.lo), _PRIME32_3)) & _M32
    h = _mul32(_rotl32(h, 17), _PRIME32_4)
    h = (h + _mul32(_u32(key.hi), _PRIME32_3)) & _M32
    h = _mul32(_rotl32(h, 17), _PRIME32_4)
    return _avalanche(h)


def bucket_index(key: Key64, n_buckets: int, seed: int = 0) -> torch.Tensor:
    """Map keys to int32 bucket indices in [0, n_buckets). n_buckets must
    be a power of two (mask instead of modulo)."""
    if n_buckets <= 0 or n_buckets & (n_buckets - 1):
        raise ValueError(f"n_buckets must be a power of 2, got {n_buckets}")
    return (hash_u32(key, seed) & (n_buckets - 1)).to(torch.int32)
