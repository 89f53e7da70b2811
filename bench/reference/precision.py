"""The matrix products of the plain references, at a stated precision.

``"float32"`` multiplies float32 operands with TF32 off (``matmul``
refuses to run while a TF32 switch is on). The lower precisions are the
benchmark's controls: their operands are rounded before a float32 product,
as a tensor-core path of that precision would take them.

* ``"tf32"``: each operand rounded to TF32's 10 mantissa bits (nearest,
  ties to even);
* ``"fp8"``: each operand scaled by its largest magnitude to float8 e4m3's
  range (448), rounded to float8 e4m3, and scaled back.
"""
from __future__ import annotations

import torch

PRECISIONS = ("float32", "tf32", "fp8")
_FP8_MAX = 448.0


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to 10 mantissa bits, nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    low = bits & 0x1FFF
    half = 0x1000
    up = (low > half) | ((low == half) & ((bits & 0x2000) != 0))
    rounded = (bits & ~0x1FFF) + up.to(torch.int32) * 0x2000
    return rounded.view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def rounder(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    return {"float32": lambda x: x, "tf32": _tf32, "fp8": _fp8}[precision]


def matmul_at(precision: str):
    """``mm(a, b)``: ``a @ b`` in float32 from operands rounded to
    ``precision``."""
    rnd = rounder(precision)

    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("the plain references run float32 products "
                               "with TF32 off")
        return rnd(a.to(torch.float32)) @ rnd(b.to(torch.float32))

    return mm
