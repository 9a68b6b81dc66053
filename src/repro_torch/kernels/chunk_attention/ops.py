"""Front door of the chunked prefill's causal attention kernel.

``chunk_attention`` launches the CUDA kernel
(``csrc/chunk_prefill_attention.cu``) for tensors on the card and takes
the plain version (``ref.chunk_attention_ref``) for tensors on the CPU;
the launch routes through the (no-op by default) kernel profiler.  The
kernel reads the prefix's and the chunk's K/V where they lie, in their
GQA layout, computes only the real rows and the keys they attend to, and
writes zeros in the padding rows.  Queries and keys share a width, values
may have another (latent attention: 192 and 128), and the softmax scale
is passed in (1/sqrt(hd) by default).
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

#: (query/key width, value width) pairs the kernel is built for (its
#: template's instantiations): the families' head dims, and DeepSeek-V2's
#: latent attention
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (192, 128))


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


def chunk_attention_cuda(q, pk, pv, k, v, n_rows: int, scale=None):
    """The CUDA kernel.  q (B, S, H, hd) bf16 contiguous; pk (B, P, Hkv,
    hd), pv (B, P, Hkv, hd_v), k (B, n, Hkv, hd) and v (B, n, Hkv, hd_v)
    bf16 with contiguous rows, n >= n_rows -> (B, S, H, hd_v) bf16.

    Chunk row r attends to keys 0 .. P + r (the prefix, then the chunk's
    rows up to r) with scores scaled by ``scale`` (1/sqrt(hd) when None);
    rows at or past ``n_rows`` (0 <= n_rows <= S) get zeros and no key
    past row ``n_rows - 1`` is read.  Raises for a (hd, hd_v) other than
    ``HEAD_DIMS``'.  Forward only: raises where autograd would record
    it."""
    refuse_grad("chunk_attention_cuda", q, pk, pv, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k and v must be (B, S, H, hd), not "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, hd = q.shape
    hkv, hd_v = k.shape[2], v.shape[-1]
    if (hd, hd_v) not in HEAD_DIMS or not hkv or h % hkv:
        raise ValueError(f"the kernel takes (head_dim, value dim) in "
                         f"{HEAD_DIMS} and H a multiple of Hkv, not "
                         f"({hd}, {hd_v}), H {h}, Hkv {hkv}")
    if not 0 <= n_rows <= s:
        raise ValueError(f"n_rows must lie in [0, {s}], not {n_rows}")
    if not q.is_cuda or q.dtype != torch.bfloat16 or not q.is_contiguous() \
            or q.data_ptr() % 16:
        raise ValueError("q must be a contiguous, 16-byte aligned CUDA bf16 "
                         "tensor")
    for name, t, w in (("k", k, hd), ("v", v, hd_v)):
        _check_kv(name, t, b, hkv, w)
        if not n_rows <= t.shape[1] <= s:
            raise ValueError(f"{name} must hold the chunk's {n_rows} real "
                             f"rows and at most its {s}")
    for name, t, w in (("pk", pk, hd), ("pv", pv, hd_v)):
        _check_kv(name, t, b, hkv, w)
    p = pk.shape[1]
    if pv.shape[1] != p:
        raise ValueError("pk and pv differ in length")
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    out = q.new_empty((b, s, h, hd_v))
    err = _library().chunk_attention_bf16(
        q.data_ptr(), pk.data_ptr(), pv.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), pk.stride(0), pv.stride(0),
        k.stride(0), v.stride(0), b, s, p, n_rows, h, hkv, hd, hd_v,
        scale, current_stream(q.device))
    chunk_attention_cuda.launches += 1
    if op_cost.active():
        # the real rows' products, and q, K, V read once and out written
        op_cost.credit("chunk_attention", (), (),
                       flops=2.0 * b * h * (hd + hd_v)
                       * causal_cells(p, n_rows),
                       nbytes=q.element_size() * b * (
                           n_rows * h * hd + s * h * hd_v
                           + (p + n_rows) * hkv * (hd + hd_v)))
    check(err, "chunk_attention")
    return out


chunk_attention_cuda.launches = 0


def _chunk_attention(q, pk, pv, k, v, n_rows, scale=None):
    if q.is_cuda:
        return chunk_attention_cuda(q, pk, pv, k, v, n_rows, scale)
    return chunk_attention_ref(q, pk, pv, k, v, n_rows, scale)


def chunk_attention(q, pk, pv, k, v, n_rows: int, scale=None):
    """q (B, S, H, hd); pk/pv (B, P, Hkv, hd / hd_v); k/v (B, n, Hkv,
    hd / hd_v), n >= n_rows -> (B, S, H, hd_v): chunk row r attends
    causally to the prefix and the chunk's rows up to r, scores scaled by
    ``scale`` (1/sqrt(hd) when None); rows at or past ``n_rows`` are
    zeros."""
    return profiled("chunk_attention", _chunk_attention, q, pk, pv, k, v,
                    n_rows, scale)

