"""Front door of the fused RMSNorm kernel.

``rmsnorm`` launches the CUDA kernel (``csrc/rmsnorm.cu``) for tensors on
the card and takes the plain version (``ref.py``) for tensors on the CPU.
Launches route through the (no-op by default) kernel profiler.
"""

from __future__ import annotations

import functools

import torch

from ..build import check, current_stream, library
from .ref import rmsnorm_ref
from ...obs.profiling import profiled

__all__ = ["MAX_D", "check_width", "rmsnorm", "rmsnorm_cuda"]

#: the widest row the kernel takes (no model in the repo is wider); the
#: kernel's ``kMaxD``
MAX_D = 7168
_ENTRY = {torch.bfloat16: "rmsnorm_bf16", torch.float32: "rmsnorm_f32"}


@functools.cache
def check_width(d: int, dtype: torch.dtype) -> None:
    """Raise ``ValueError`` for a dtype or a row width ``d`` the kernel does
    not take: it takes bf16 or f32, D a multiple of 8 (bf16) or 4 (f32) up
    to ``MAX_D``.  The kernel itself picks its instantiation from D and the
    dtype (``geometry`` in ``csrc/rmsnorm.cu``)."""
    if dtype not in _ENTRY:
        raise ValueError(f"the RMSNorm kernel takes bf16 or f32, not {dtype}")
    per_vec = 16 // dtype.itemsize
    if d <= 0 or d % per_vec or d > MAX_D:
        raise ValueError(f"the RMSNorm kernel takes D a multiple of "
                         f"{per_vec} up to {MAX_D} in {dtype}, not {d}")


def rmsnorm_cuda(x, scale, eps: float = 1e-5):
    """The CUDA kernel.  x (..., D) and scale (D,), both bf16 or both f32,
    contiguous, 16-byte aligned, on the card -> x's shape and dtype."""
    d = x.shape[-1]
    if not (x.is_cuda and scale.is_cuda) or x.dtype != scale.dtype:
        raise ValueError(f"rmsnorm_cuda takes x and scale on the card in one "
                         f"dtype, not {x.dtype} on {x.device} and "
                         f"{scale.dtype} on {scale.device}")
    if not x.is_contiguous() or scale.shape != (d,) \
            or not scale.is_contiguous():
        raise ValueError(f"x {tuple(x.shape)} must be contiguous and scale "
                         f"{tuple(scale.shape)} of shape ({d},)")
    check_width(d, x.dtype)
    xp, sp = x.data_ptr(), scale.data_ptr()
    if (xp | sp) % 16:
        raise ValueError("x and scale must be 16-byte aligned")
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows:
        err = getattr(library(), _ENTRY[x.dtype])(
            xp, sp, out.data_ptr(), rows, d, eps, current_stream(x.device))
        rmsnorm_cuda.launches += 1
        check(err, "rmsnorm")
    return out


rmsnorm_cuda.launches = 0


def _rmsnorm(x, scale, eps: float = 1e-5):
    if x.is_cuda:
        return rmsnorm_cuda(x, scale, eps)
    return rmsnorm_ref(x, scale, eps)


def rmsnorm(x, scale, eps: float = 1e-5):
    """x (..., D), scale (D,) -> same shape as x."""
    return profiled("rmsnorm", _rmsnorm, x, scale, eps=eps)
