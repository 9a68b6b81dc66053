"""Front doors of the flash-decode kernels.

``decode_attention`` (contiguous cache) and ``paged_decode_attention``
(paged arena) launch their CUDA kernels (``csrc/decode_attention.cu``,
``csrc/paged_decode_attention.cu``) for tensors on the card and take the
plain versions (``ref.py``) for tensors on the CPU.  Launches route
through the (no-op by default) kernel profiler.
"""

from __future__ import annotations

import math

import torch

from ..build import check, library
from .ref import decode_attention_ref, paged_decode_attention_ref
from ...obs.profiling import profiled

__all__ = ["decode_attention", "decode_attention_cuda",
           "paged_decode_attention", "paged_decode_attention_cuda",
           "tune_block_s"]


def tune_block_s(s: int, block_s: int = 512, floor: int = 128) -> int:
    """Clamp/autotune the kv block size for a cache of length ``s``.

    Never larger than ``s``, so the last grid block always starts inside
    the valid region and the pad path (``pad_s = (-s) % block_s``) can
    never launch a masked-only block; among power-of-two shrinks down to
    ``floor`` picks the one wasting the least padding (e.g. s=600 keeps
    a 40-row pad at block 128 instead of a 424-row pad at block 512).

    The Pallas kernel's block choice, kept as a host function under its
    JAX name; the CUDA kernel walks fixed 64-key tiles and stops at each
    row's length, so it has no block size to tune.
    """
    block_s = max(1, min(block_s, s))
    best, best_pad = block_s, (-s) % block_s
    bs = block_s
    while bs // 2 >= min(floor, s) and best_pad:
        bs //= 2
        pad = (-s) % bs
        if pad < best_pad:
            best, best_pad = bs, pad
    return best


def _check_cuda(*named) -> None:
    """Raise unless every (name, tensor, dtype) is a contiguous CUDA tensor
    of that dtype."""
    for name, t, dt in named:
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA {dt} tensor")


def _check_group(g: int, hd: int) -> None:
    if g * hd > 1024 or hd % 8:
        raise ValueError(f"the kernel takes head_dim % 8 == 0 and "
                         f"group*head_dim <= 1024, not {hd} and {g * hd}")


def decode_attention_cuda(q, k_cache, v_cache, lengths):
    """The CUDA kernel.  q (B, H, hd) bf16; k/v_cache (B, S, Hkv, hd) bf16;
    lengths (B,) int32 -> (B, H, hd) bf16.

    Row b attends over its first ``min(lengths[b], S)`` keys; keys past
    that are never read, and a row of length 0 gets zeros."""
    if k_cache.dim() != 4:
        raise ValueError(f"k_cache must be (B, S, Hkv, hd), not "
                         f"{tuple(k_cache.shape)}")
    b, s, hkv, hd = k_cache.shape
    if q.dim() != 3 or q.shape[0] != b or q.shape[2] != hd \
            or q.shape[1] % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit the cache "
                         f"{tuple(k_cache.shape)}")
    if v_cache.shape != k_cache.shape:
        raise ValueError("k_cache and v_cache differ in shape")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},), not {tuple(lengths.shape)}")
    _check_cuda(("q", q, torch.bfloat16), ("k_cache", k_cache, torch.bfloat16),
                ("v_cache", v_cache, torch.bfloat16),
                ("lengths", lengths, torch.int32))
    g = q.shape[1] // hkv
    _check_group(g, hd)
    if (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()) % 16:
        raise ValueError("q and the caches must be 16-byte aligned")
    out = torch.empty_like(q)
    err = library().decode_attention_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, s, hkv, g, hd,
        1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    decode_attention_cuda.launches += 1
    check(err, "decode_attention")
    return out


decode_attention_cuda.launches = 0


def _decode_attention(q, k_cache, v_cache, lengths):
    if q.is_cuda:
        return decode_attention_cuda(q, k_cache, v_cache, lengths)
    return decode_attention_ref(q, k_cache, v_cache, lengths)


def decode_attention(q, k_cache, v_cache, lengths):
    """q (B, H, hd); k/v_cache (B, S, Hkv, hd); lengths (B,) -> (B, H, hd)."""
    return profiled("decode_attention", _decode_attention,
                    q, k_cache, v_cache, lengths)


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
    _check_cuda(("q", q, torch.bfloat16), ("k_pages", k_pages, torch.bfloat16),
                ("v_pages", v_pages, torch.bfloat16),
                ("block_tables", block_tables, torch.int32),
                ("lengths", lengths, torch.int32))
    g = h // hkv
    _check_group(g, hd)
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
