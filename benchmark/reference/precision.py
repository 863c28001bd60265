"""The arithmetic of the reference (float64) and of its control (TF32).

``F64`` computes every product and sum in float64.  ``TF32`` is the
precision below the configuration's float32 with TF32 off: float32 storage,
and every matrix product's inputs rounded to TF32 (10 mantissa bits; round
to nearest, ties away from zero, as ``cvt.rna.tf32.f32`` does), summed in
float32, as the card's tensor cores compute a TF32 product.  The rounding
is made by hand, on the card as on a CPU: cuBLAS leaves some products
(those of a short inner dimension) off the tensor cores even where
``allow_tf32`` is on, and the control must be TF32 throughout.
"""

from __future__ import annotations

import torch

F64 = "f64"
TF32 = "tf32"


def dtype_of(prec: str) -> torch.dtype:
    return torch.float64 if prec == F64 else torch.float32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & torch.tensor(-0x80000000, dtype=torch.int32)
    mag = (bits & 0x7FFFFFFF) + 0x1000
    return ((mag & ~0x1FFF) | sign).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ b in ``prec``; float32 products are taken in full float32
    (``allow_tf32`` off) on rounded inputs."""
    dt = dtype_of(prec)
    a, b = a.to(dt), b.to(dt)
    if prec == TF32:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b
