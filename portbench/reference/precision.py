"""The control's precision: float32 with TF32 matrix products.

A TF32 tensor-core product rounds each input to TF32 (10 explicit mantissa
bits, round to nearest, ties to even) and accumulates in float32. The
mode below does the same to every matrix product the reference makes
(``@``, ``matmul``, ``bmm``, ``mm``, ``mv``, ``einsum``), on any device,
so the result does not depend on which products cuBLAS would give the
tensor cores. Everything else stays float32.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.Tensor.__rmatmul__, torch.bmm, torch.Tensor.bmm, torch.mm,
             torch.Tensor.mm, torch.mv, torch.Tensor.mv, torch.einsum}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), kept as float32."""
    if x.dtype != torch.float32:
        raise TypeError(f"round_tf32 takes float32, got {x.dtype}")
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    r = (i + 0x0FFF + lsb) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, r.view(torch.float32), x)


class TF32Products(TorchFunctionMode):
    """Within the mode every float32 matrix product takes TF32 inputs."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(round_tf32(a) if isinstance(a, torch.Tensor)
                         and a.dtype == torch.float32 else a for a in args)
        return func(*args, **kwargs)
