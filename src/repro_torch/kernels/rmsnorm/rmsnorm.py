"""Triton kernel: fused row RMSNorm for Hopper.

Replaces ``repro/kernels/rmsnorm/rmsnorm.py`` ``rmsnorm_pallas``.  Bound:
device memory — one read of x and one write of y per element, a few flops
each.  Design: one program per block of ``ROWS`` rows; the row (D=960 for
smollm, padded to the power of two 1024 with masked lanes) is loaded once,
reduced in f32 and scaled in registers, so nothing but x, the scale vector
and y crosses device memory.  ``triton`` is imported when the kernel is
first built, never when this module is imported.
"""

from __future__ import annotations

import functools


@functools.cache
def kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, s_ptr, o_ptr, n_rows, d, eps,
                       ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < d
        mask = (rows[:, None] < n_rows) & cmask[None, :]
        offs = rows[:, None].to(tl.int64) * d + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=1) / d
        y = (x * (1.0 / tl.sqrt(var + eps))[:, None])
        # cast to x's dtype before the scale, as layers.rmsnorm does
        y = y.to(x_ptr.dtype.element_ty).to(tl.float32)
        s = tl.load(s_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        tl.store(o_ptr + offs, (y * s).to(o_ptr.dtype.element_ty), mask=mask)

    return rmsnorm_kernel
