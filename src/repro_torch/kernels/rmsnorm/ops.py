"""Front door of the fused RMSNorm kernel.

``rmsnorm`` launches the Triton kernel (``rmsnorm.py``) for tensors on the
card and takes the plain version (``ref.py``) for tensors on the CPU.
Launches route through the (no-op by default) kernel profiler.
"""

from __future__ import annotations

import torch

from .ref import rmsnorm_ref
from .rmsnorm import kernel
from ...obs.profiling import profiled

__all__ = ["rmsnorm", "rmsnorm_triton"]

ROWS = 4


def rmsnorm_triton(x, scale, eps: float = 1e-5):
    """The Triton kernel.  x (..., D) contiguous CUDA; scale (D,) -> the
    dtype ``x * scale`` promotes to."""
    d = x.shape[-1]
    if not (x.is_cuda and scale.is_cuda):
        raise ValueError("rmsnorm_triton takes CUDA tensors")
    if not x.is_contiguous() or scale.shape != (d,) \
            or not scale.is_contiguous():
        raise ValueError(f"x {tuple(x.shape)} must be contiguous and scale "
                         f"{tuple(scale.shape)} of shape ({d},)")
    import triton
    out = torch.empty(x.shape, dtype=torch.result_type(x, scale),
                      device=x.device)
    rows = x.numel() // d if d else 0
    grid = (triton.cdiv(rows, ROWS),)
    kernel()[grid](x, scale, out, rows, d, eps, ROWS=ROWS,
                   BLOCK_D=triton.next_power_of_2(d), num_warps=4)
    rmsnorm_triton.launches += 1
    return out


rmsnorm_triton.launches = 0


def _rmsnorm(x, scale, eps: float = 1e-5):
    if x.is_cuda:
        return rmsnorm_triton(x, scale, eps)
    return rmsnorm_ref(x, scale, eps)


def rmsnorm(x, scale, eps: float = 1e-5):
    """x (..., D), scale (D,) -> same shape as x."""
    return profiled("rmsnorm", _rmsnorm, x, scale, eps=eps)
