"""Front door of the paged flash-decode kernel.

``paged_decode_attention`` launches the CUDA kernel
(``csrc/paged_decode_attention.cu``) for tensors on the card and takes the
plain version (``ref.py``) for tensors on the CPU.  Launches route through
the (no-op by default) kernel profiler.
"""

from __future__ import annotations

import math

import torch

from ..build import check, library
from .ref import paged_decode_attention_ref
from ...obs.profiling import profiled

__all__ = ["paged_decode_attention", "paged_decode_attention_cuda"]


def paged_decode_attention_cuda(q, k_pages, v_pages, block_tables, lengths):
    """The CUDA kernel.  q (B, H, hd) bf16; k/v_pages (NP, PS, Hkv, hd) bf16;
    block_tables (B, MP) int32; lengths (B,) int32 -> (B, H, hd) bf16.

    Table entries must index pages of ``k_pages`` for every page a
    sequence's length reaches; entries past it are never read."""
    np_, ps, hkv, hd = k_pages.shape
    b, h = q.shape[0], q.shape[1]
    if q.dim() != 3 or q.shape[2] != hd or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pages "
                         f"{tuple(k_pages.shape)}")
    if v_pages.shape != k_pages.shape:
        raise ValueError("k_pages and v_pages differ in shape")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError("block_tables (B, MP) and lengths (B,) must match q")
    for name, t, dt in (("q", q, torch.bfloat16),
                        ("k_pages", k_pages, torch.bfloat16),
                        ("v_pages", v_pages, torch.bfloat16),
                        ("block_tables", block_tables, torch.int32),
                        ("lengths", lengths, torch.int32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA {dt} tensor")
    g = h // hkv
    if g * hd > 1024 or hd % 8:
        raise ValueError(f"the kernel takes head_dim % 8 == 0 and "
                         f"group*head_dim <= 1024, not {hd} and {g * hd}")
    if (q.data_ptr() | k_pages.data_ptr() | v_pages.data_ptr()) % 16:
        raise ValueError("q and the pages must be 16-byte aligned")
    out = torch.empty_like(q)
    err = library().paged_decode_attention_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, hkv, g, hd, ps, block_tables.shape[1], 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    paged_decode_attention_cuda.launches += 1
    check(err, "paged_decode_attention")
    return out


paged_decode_attention_cuda.launches = 0


def _paged_decode_attention(q, k_pages, v_pages, block_tables, lengths):
    if q.is_cuda:
        return paged_decode_attention_cuda(q, k_pages, v_pages,
                                           block_tables, lengths)
    return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                      lengths)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths):
    """q (B, H, hd); k/v_pages (NP, PS, Hkv, hd); block_tables (B, MP);
    lengths (B,) -> (B, H, hd)."""
    return profiled("paged_decode_attention", _paged_decode_attention,
                    q, k_pages, v_pages, block_tables, lengths)
