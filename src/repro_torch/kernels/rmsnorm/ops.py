"""Front door of the fused RMSNorm kernel and its backward.

``rmsnorm`` launches the CUDA kernel (``csrc/rmsnorm.cu``) for tensors on
the card and takes the plain version (``ref.py``) for tensors on the CPU.
Where autograd records it (grad mode on and x or the scale requiring a
gradient), it is ``RMSNormFunction``, whose backward launches the
backward kernel on the card (``rmsnorm_bwd_cuda``) and takes its plain
version (``rmsnorm_bwd_ref``) on the CPU; nothing falls back.  Launches
route through the (no-op by default) kernel profiler.
"""

from __future__ import annotations

import functools

import torch

from ..build import check, current_stream, library
from .ref import rmsnorm_bwd_ref, rmsnorm_ref
from ...obs.profiling import profiled
from ...parallel import op_cost

__all__ = ["MAX_D", "BWD_MAX_BLOCKS", "RMSNormFunction", "check_width",
           "rmsnorm", "rmsnorm_bwd_cuda", "rmsnorm_cuda"]

#: the widest row the kernel takes (no model in the repo is wider); the
#: kernel's ``kMaxD``
MAX_D = 7168
#: the most blocks the backward's first launch takes, so the most rows of
#: f32 partial sums of dscale its scratch holds; the kernel's
#: ``kBwdMaxBlocks``, which refuses a smaller scratch
BWD_MAX_BLOCKS = 528
_ENTRY = {torch.bfloat16: "rmsnorm_bf16", torch.float32: "rmsnorm_f32"}
_BWD_ENTRY = {torch.bfloat16: "rmsnorm_bwd_bf16",
              torch.float32: "rmsnorm_bwd_f32"}


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
        if op_cost.active():
            op_cost.credit("rmsnorm", (x, scale), out)
        check(err, "rmsnorm")
    return out


rmsnorm_cuda.launches = 0


def rmsnorm_bwd_cuda(x, scale, g, eps: float = 1e-5):
    """The backward kernel: (dx, dscale) for x (..., D), scale (D,) and the
    output's gradient g (x's shape), all bf16 or all f32, contiguous,
    16-byte aligned, on the card.  dscale sums over every row in a fixed
    order (no atomics): two calls give the same bits."""
    d = x.shape[-1]
    if not (x.is_cuda and scale.is_cuda and g.is_cuda) \
            or not x.dtype == scale.dtype == g.dtype:
        raise ValueError(f"rmsnorm_bwd_cuda takes x, scale and g on the card "
                         f"in one dtype, not {x.dtype}/{scale.dtype}/"
                         f"{g.dtype} on {x.device}/{scale.device}/"
                         f"{g.device}")
    if g.shape != x.shape or scale.shape != (d,) or not (
            x.is_contiguous() and g.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} must "
                         f"be contiguous of one shape and scale "
                         f"{tuple(scale.shape)} of shape ({d},)")
    check_width(d, x.dtype)
    xp, sp, gp = x.data_ptr(), scale.data_ptr(), g.data_ptr()
    if (xp | sp | gp) % 16:
        raise ValueError("x, scale and g must be 16-byte aligned")
    dx = torch.empty_like(x)
    rows = x.numel() // d
    if not rows:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    scratch = torch.empty((min(rows, BWD_MAX_BLOCKS), d), dtype=torch.float32,
                          device=x.device)
    err = getattr(library(), _BWD_ENTRY[x.dtype])(
        xp, sp, gp, dx.data_ptr(), dscale.data_ptr(), scratch.data_ptr(),
        scratch.shape[0], rows, d, eps, current_stream(x.device))
    rmsnorm_bwd_cuda.launches += 1
    if op_cost.active():
        op_cost.credit("rmsnorm_bwd", (x, scale, g), (dx, dscale))
    check(err, "rmsnorm_bwd")
    return dx, dscale


rmsnorm_bwd_cuda.launches = 0


def _forward(x, scale, eps: float):
    if x.is_cuda:
        return rmsnorm_cuda(x, scale, eps)
    return rmsnorm_ref(x, scale, eps)


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm with its gradient: the kernels on the card, the plain
    versions on the CPU.  Saves x and the scale, not the output."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        g = g.contiguous()
        if x.is_cuda:
            dx, dscale = rmsnorm_bwd_cuda(x, scale, g, ctx.eps)
        else:
            dx, dscale = rmsnorm_bwd_ref(x, scale, g, ctx.eps)
        return dx, dscale, None


def _rmsnorm(x, scale, eps: float = 1e-5):
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNormFunction.apply(x, scale, eps)
    return _forward(x, scale, eps)


def rmsnorm(x, scale, eps: float = 1e-5):
    """x (..., D), scale (D,) -> same shape as x; differentiable."""
    return profiled("rmsnorm", _rmsnorm, x, scale, eps=eps)
