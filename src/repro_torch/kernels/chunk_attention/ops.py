"""Front door of the chunked prefill's causal attention kernel.

``chunk_attention`` launches the CUDA kernel
(``csrc/chunk_prefill_attention.cu``) for tensors on the card and takes
the plain version (``ref.chunk_attention_ref``) for tensors on the CPU;
the launch routes through the (no-op by default) kernel profiler.  The
kernel reads the prefix's and the chunk's K/V where they lie, in their
GQA layout, computes only the real rows and the keys they attend to, and
writes zeros in the padding rows.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..build import check, current_stream, library, refuse_grad
from .ref import BLOCK_M, BLOCK_N, causal_cells, chunk_attention_ref
from ...obs.profiling import profiled
from ...parallel import op_cost

__all__ = ["HEAD_DIMS", "chunk_attention", "chunk_attention_cuda"]

#: head dims the kernel is built for (its template's instantiations)
HEAD_DIMS = (32, 64, 128)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library, once its tiles are checked against ours."""
    lib = library()
    bm, bn = ctypes.c_int(), ctypes.c_int()
    lib.chunk_attention_geometry(ctypes.byref(bm), ctypes.byref(bn))
    if (bm.value, bn.value) != (BLOCK_M, BLOCK_N):
        raise RuntimeError(
            f"the kernel library walks {bm.value}-row by {bn.value}-key "
            f"tiles, not {BLOCK_M} by {BLOCK_N}")
    return lib


def _check_kv(name: str, t, b: int, hkv: int, hd: int) -> None:
    """A (B, n, Hkv, hd) bf16 CUDA tensor whose rows are contiguous and
    16-byte aligned; its batch stride may be anything aligned (an expanded
    prefix has 0)."""
    if t.dim() != 4 or t.shape[0] != b or tuple(t.shape[2:]) != (hkv, hd):
        raise ValueError(f"{name} must be ({b}, n, {hkv}, {hd}), not "
                         f"{tuple(t.shape)}")
    if not t.is_cuda or t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be a CUDA bf16 tensor")
    if t.shape[1] and (t.stride()[1:] != (hkv * hd, hd, 1)
                       or (t.data_ptr() | 2 * t.stride(0)) % 16):
        raise ValueError(f"{name} must have contiguous, 16-byte aligned "
                         f"rows")


def chunk_attention_cuda(q, pk, pv, k, v, n_rows: int):
    """The CUDA kernel.  q (B, S, H, hd) bf16 contiguous; pk/pv
    (B, P, Hkv, hd) and k/v (B, S, Hkv, hd) bf16 with contiguous rows ->
    (B, S, H, hd) bf16.

    Chunk row r attends to keys 0 .. P + r (the prefix, then the chunk's
    rows up to r); rows at or past ``n_rows`` (0 <= n_rows <= S) get zeros
    and no key past row ``n_rows - 1`` is read.  Raises for a head dim
    other than ``HEAD_DIMS``.  Forward only: raises where autograd would
    record it."""
    refuse_grad("chunk_attention_cuda", q, pk, pv, k, v)
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, hd), not {tuple(q.shape)}")
    b, s, h, hd = q.shape
    hkv = k.shape[2] if k.dim() == 4 else 0
    if hd not in HEAD_DIMS or not hkv or h % hkv:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS} and H a "
                         f"multiple of Hkv, not hd {hd}, H {h}, Hkv {hkv}")
    if not 0 <= n_rows <= s:
        raise ValueError(f"n_rows must lie in [0, {s}], not {n_rows}")
    if not q.is_cuda or q.dtype != torch.bfloat16 or not q.is_contiguous() \
            or q.data_ptr() % 16:
        raise ValueError("q must be a contiguous, 16-byte aligned CUDA bf16 "
                         "tensor")
    for name, t in (("k", k), ("v", v)):
        _check_kv(name, t, b, hkv, hd)
        if t.shape[1] != s:
            raise ValueError(f"{name} must have the chunk's {s} rows")
    for name, t in (("pk", pk), ("pv", pv)):
        _check_kv(name, t, b, hkv, hd)
    p = pk.shape[1]
    if pv.shape[1] != p:
        raise ValueError("pk and pv differ in length")
    out = torch.empty_like(q)
    err = _library().chunk_attention_bf16(
        q.data_ptr(), pk.data_ptr(), pv.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), pk.stride(0), pv.stride(0),
        k.stride(0), v.stride(0), b, s, p, n_rows, h, hkv, hd,
        1.0 / math.sqrt(hd), current_stream(q.device))
    chunk_attention_cuda.launches += 1
    if op_cost.active():
        # the real rows' products, and q, K, V read once and out written
        op_cost.credit("chunk_attention", (), (),
                       flops=4.0 * b * h * hd * causal_cells(p, n_rows),
                       nbytes=q.element_size() * b * hd * (
                           (n_rows + s) * h + 2 * (p + n_rows) * hkv))
    check(err, "chunk_attention")
    return out


chunk_attention_cuda.launches = 0


def _chunk_attention(q, pk, pv, k, v, n_rows):
    if q.is_cuda:
        return chunk_attention_cuda(q, pk, pv, k, v, n_rows)
    return chunk_attention_ref(q, pk, pv, k, v, n_rows)


def chunk_attention(q, pk, pv, k, v, n_rows: int):
    """q (B, S, H, hd); pk/pv (B, P, Hkv, hd); k/v (B, S, Hkv, hd) ->
    (B, S, H, hd): chunk row r attends causally to the prefix and the
    chunk's rows up to r; rows at or past ``n_rows`` are zeros."""
    return profiled("chunk_attention", _chunk_attention, q, pk, pv, k, v,
                    n_rows)

