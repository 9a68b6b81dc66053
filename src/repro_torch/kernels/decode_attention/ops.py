"""Front doors of the flash-decode kernels.

``decode_attention`` (contiguous cache) and ``paged_decode_attention``
(paged arena) launch their CUDA kernels (``csrc/decode_attention.cu``,
``csrc/paged_decode_attention.cu``) for tensors on the card and take the
plain versions (``ref.py``) for tensors on the CPU.  Launches route
through the (no-op by default) kernel profiler.

Both kernels split each (sequence, kv head) over a cluster of
``SPLIT_RANKS`` blocks, dealing its keys round robin in granules of
``SPLIT_GRANULE`` keys (the contiguous kernel) or one page (the paged
kernel); ``ref.py``'s split versions model that partition on the host.

``paged_mla_decode_attention`` is the latent-attention instance of the
paged kernel (DeepSeek-V2's absorbed decode): one 576-wide latent row a
key, shared by 16 query heads, its first 512 columns the values.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..build import check, current_stream, library, refuse_grad
from .ref import (MLA_SHAPE, SPLIT_GRANULE, SPLIT_RANKS, attended_keys,
                  decode_attention_ref, paged_decode_attention_ref,
                  paged_mla_decode_attention_ref)
from ...obs.profiling import profiled
from ...parallel import op_cost

__all__ = ["SPLIT_GRANULE", "SPLIT_RANKS", "decode_attention",
           "decode_attention_cuda", "paged_decode_attention",
           "paged_decode_attention_cuda", "paged_mla_decode_attention",
           "paged_mla_decode_attention_cuda", "tune_block_s"]


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library, once its partition is checked against ours."""
    lib = library()
    ranks, granule = ctypes.c_int(), ctypes.c_int()
    lib.decode_attention_geometry(ctypes.byref(ranks), ctypes.byref(granule))
    if (ranks.value, granule.value) != (SPLIT_RANKS, SPLIT_GRANULE):
        raise RuntimeError(
            f"the kernel library splits keys over {ranks.value} ranks in "
            f"{granule.value}-key granules, not {SPLIT_RANKS} and "
            f"{SPLIT_GRANULE}")
    return lib


def tune_block_s(s: int, block_s: int = 512, floor: int = 128) -> int:
    """Clamp/autotune the kv block size for a cache of length ``s``.

    Never larger than ``s``, so the last grid block always starts inside
    the valid region and the pad path (``pad_s = (-s) % block_s``) can
    never launch a masked-only block; among power-of-two shrinks down to
    ``floor`` picks the one wasting the least padding (e.g. s=600 keeps
    a 40-row pad at block 128 instead of a 424-row pad at block 512).

    The Pallas kernel's block choice, kept as a host function under its
    JAX name; the CUDA kernel deals fixed granules to its ranks and stops
    at each row's length, so it has no block size to tune.
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


def _credit(name, q, out, index, hkv: int, hd: int, keys) -> None:
    """A decode-attention launch to the op counter: the keys it reads
    (``keys()``, read on the host outside the counter) and their values,
    q, out and the index tensors; the two products' FLOPs."""
    n = op_cost.untracked(keys)
    op_cost.credit(name, (), (), flops=4.0 * n * q.shape[1] * hd,
                   nbytes=2 * q.nbytes + 2 * n * hkv * hd * q.element_size()
                   + op_cost.tensor_bytes(index))


def decode_attention_cuda(q, k_cache, v_cache, lengths, window: int = 0):
    """The CUDA kernel.  q (B, H, hd) bf16; k/v_cache (B, S, Hkv, hd) bf16;
    lengths (B,) int32 -> (B, H, hd) bf16.

    Row b attends over its first ``min(lengths[b], S)`` keys, and with a
    sliding ``window`` > 0 only over those at or past ``lengths[b] -
    window``; no other key is read, and a row with no key to attend gets
    zeros.  Forward only: raises where autograd would record it."""
    refuse_grad("decode_attention_cuda", q, k_cache, v_cache)
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
    if window < 0:
        raise ValueError(f"window must be >= 0, not {window}")
    _check_cuda(("q", q, torch.bfloat16), ("k_cache", k_cache, torch.bfloat16),
                ("v_cache", v_cache, torch.bfloat16),
                ("lengths", lengths, torch.int32))
    g = q.shape[1] // hkv
    _check_group(g, hd)
    if (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()) % 16:
        raise ValueError("q and the caches must be 16-byte aligned")
    out = torch.empty_like(q)
    err = _library().decode_attention_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, s, hkv, g, hd, int(window),
        1.0 / math.sqrt(hd), current_stream(q.device))
    decode_attention_cuda.launches += 1
    if op_cost.active():
        _credit("decode_attention", q, out, lengths, hkv, hd,
                lambda: int(attended_keys(lengths, s, window).sum()))
    check(err, "decode_attention")
    return out


decode_attention_cuda.launches = 0


def _decode_attention(q, k_cache, v_cache, lengths, window):
    if q.is_cuda:
        return decode_attention_cuda(q, k_cache, v_cache, lengths, window)
    return decode_attention_ref(q, k_cache, v_cache, lengths, window)


def decode_attention(q, k_cache, v_cache, lengths, window: int = 0):
    """q (B, H, hd); k/v_cache (B, S, Hkv, hd); lengths (B,) -> (B, H, hd);
    ``window`` > 0 attends only to the last ``window`` keys of a row."""
    return profiled("decode_attention", _decode_attention,
                    q, k_cache, v_cache, lengths, window)


def paged_decode_attention_cuda(q, k_pages, v_pages, block_tables, lengths):
    """The CUDA kernel.  q (B, H, hd) bf16; k/v_pages (NP, PS, Hkv, hd) bf16;
    block_tables (B, MP) int32; lengths (B,) int32 -> (B, H, hd) bf16.

    Table entries must index pages of ``k_pages`` for every page a
    sequence's length reaches; entries past it are never read.  A page is
    staged whole in shared memory, so the kernel refuses (``RuntimeError``)
    a page longer than 256 keys at hd 64, 128 at hd 128, 64 at hd 256, 32
    at hd 512 and 16 at hd 1024.  Forward only: raises where autograd
    would record it."""
    refuse_grad("paged_decode_attention_cuda", q, k_pages, v_pages)
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
    err = _library().paged_decode_attention_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, hkv, g, hd, ps, block_tables.shape[1], 1.0 / math.sqrt(hd),
        current_stream(q.device))
    paged_decode_attention_cuda.launches += 1
    if op_cost.active():
        _credit("paged_decode_attention", q, out, (lengths, block_tables),
                hkv, hd, lambda: int(lengths.sum()))
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


def paged_mla_decode_attention_cuda(q, pages, block_tables, lengths,
                                    scale: float):
    """The CUDA kernel's latent instance.  q (B, 16, 576) bf16 (the
    absorbed queries [q~ | q_pe]); pages (NP, PS, 576) bf16 latent rows;
    block_tables (B, MP) int32; lengths (B,) int32 -> (B, 16, 512) bf16:
    softmax(scale q . row) over the first ``lengths[b]`` rows of the
    sequence's pages, times their first 512 columns.  PS must divide 32;
    table entries past a sequence's last page are never read, and a row
    of length 0 gets zeros.  Forward only: raises where autograd would
    record it."""
    refuse_grad("paged_mla_decode_attention_cuda", q, pages)
    g, kw, vw = MLA_SHAPE
    if pages.dim() != 3 or pages.shape[2] != kw:
        raise ValueError(f"pages must be (NP, PS, {kw}), not "
                         f"{tuple(pages.shape)}")
    np_, ps, _ = pages.shape
    b = q.shape[0]
    if q.dim() != 3 or tuple(q.shape[1:]) != (g, kw):
        raise ValueError(f"q must be (B, {g}, {kw}), not {tuple(q.shape)}")
    if 32 % ps:
        raise ValueError(f"the kernel takes pages of a divisor of 32 keys, "
                         f"not {ps}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError("block_tables (B, MP) and lengths (B,) must match q")
    _check_cuda(("q", q, torch.bfloat16), ("pages", pages, torch.bfloat16),
                ("block_tables", block_tables, torch.int32),
                ("lengths", lengths, torch.int32))
    if (q.data_ptr() | pages.data_ptr()) % 16:
        raise ValueError("q and the pages must be 16-byte aligned")
    out = q.new_empty((b, g, vw))
    err = _library().paged_mla_decode_attention_bf16(
        q.data_ptr(), pages.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, ps, block_tables.shape[1],
        float(scale), current_stream(q.device))
    paged_mla_decode_attention_cuda.launches += 1
    if op_cost.active():
        n = op_cost.untracked(lambda: int(lengths.sum()))
        op_cost.credit("paged_decode_attention", (), (),
                       flops=2.0 * n * g * (kw + vw),
                       nbytes=q.nbytes + out.nbytes + n * kw * q.element_size()
                       + op_cost.tensor_bytes((lengths, block_tables)))
    check(err, "paged_mla_decode_attention")
    return out


paged_mla_decode_attention_cuda.launches = 0


def _paged_mla_decode_attention(q, pages, block_tables, lengths, scale,
                                v_dim):
    if q.is_cuda:
        if v_dim != MLA_SHAPE[2]:
            raise ValueError(f"the kernel's values are the first "
                             f"{MLA_SHAPE[2]} columns, not {v_dim}")
        return paged_mla_decode_attention_cuda(q, pages, block_tables,
                                               lengths, scale)
    return paged_mla_decode_attention_ref(q, pages, block_tables, lengths,
                                          scale, v_dim)


def paged_mla_decode_attention(q, pages, block_tables, lengths,
                               scale: float, v_dim: int):
    """q (B, H, r + dr); pages (NP, PS, r + dr); block_tables (B, MP);
    lengths (B,) -> (B, H, v_dim = r): the absorbed latent attention over
    the pages (the kernel at DeepSeek-V2-Lite's ``MLA_SHAPE``; the plain
    version at any size on the CPU).  Profiled as the paged decode
    attention: it is that kernel's latent instance."""
    return profiled("paged_decode_attention", _paged_mla_decode_attention,
                    q, pages, block_tables, lengths, scale, v_dim)
