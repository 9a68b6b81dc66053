"""Plain PyTorch versions of the chunked prefill's causal attention kernel
(``csrc/chunk_prefill_attention.cu``): the tiles it walks (``row_tiles``,
``key_tiles``, ``attended_cells``), the function it computes
(``chunk_attention_ref``) and a plain model of its tile walk
(``chunk_attention_tiled_ref``).

Chunk row r of a chunk after a P-token prefix sits at absolute position
P + r and attends to keys 0 .. P + r: prefix row j is key j, chunk row i
is key P + i.  Only the first ``n_rows`` rows are real; the rest trail as
padding and come out as zeros.  The chunk's K/V hold at least its real
rows (no key past them is read).  Queries and keys are ``hd`` wide, values
``hd_v`` (the same but for latent attention's 192 and 128), and the scores
are scaled by ``scale`` (1/sqrt(hd) when None).
"""

from __future__ import annotations

import math

import torch

#: query rows of a row tile (a block of the kernel); the wrapper in
#: ``ops.py`` checks the kernel library against these two
BLOCK_M = 64
#: keys of a key tile; key tile t holds absolute keys BLOCK_N t ..
BLOCK_N = 64


def row_tiles(n_rows: int) -> int:
    """Row tiles that hold a real row; every later one is written as zeros
    and reads nothing."""
    return -(-n_rows // BLOCK_M)


def key_tiles(prefix: int, n_rows: int, tile: int) -> int:
    """Key tiles row tile ``tile`` walks: from absolute key 0 through the
    position of its last real row."""
    last = min((tile + 1) * BLOCK_M, n_rows) - 1
    return (prefix + last) // BLOCK_N + 1


def attended_cells(prefix: int, n_rows: int) -> int:
    """(row, key) cells of the tiles the kernel computes for one head of
    one sequence: BLOCK_M x BLOCK_N for each (row tile, key tile) a block
    walks.  (A warp skips a key tile wholly past its 16 rows, so the
    tensor cores do a little less.)"""
    return BLOCK_M * BLOCK_N * sum(key_tiles(prefix, n_rows, i)
                                   for i in range(row_tiles(n_rows)))


def causal_cells(prefix: int, n_rows: int) -> int:
    """(row, key) cells the real rows attend to: row r to P + r + 1 keys."""
    return n_rows * prefix + n_rows * (n_rows + 1) // 2


def _keys(pk, pv, k, v, groups: int):
    """The prefix's and the chunk's K/V as one key axis, each kv head
    repeated for its ``groups`` query heads: (B, P + S, H, hd)."""
    kk, vv = torch.cat([pk, k], dim=1), torch.cat([pv, v], dim=1)
    return (kk.repeat_interleave(groups, dim=2),
            vv.repeat_interleave(groups, dim=2))


def chunk_attention_ref(q, pk, pv, k, v, n_rows: int, scale=None):
    """q (B, S, H, hd); pk (B, P, Hkv, hd), pv (B, P, Hkv, hd_v); k/v
    (B, n, Hkv, ...) with n >= n_rows -> (B, S, H, hd_v) in q's dtype.

    The formula in f32 throughout: every chunk row attends causally over
    the prefix and the chunk; rows at or past ``n_rows`` are zeros."""
    b, s, h, hd = q.shape
    p = pk.shape[1]
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    k, v = k[:, :n_rows], v[:, :n_rows]
    kk, vv = _keys(pk, pv, k, v, h // k.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * scale
    qpos = torch.arange(s, device=q.device)[:, None] + p
    kpos = torch.arange(p + n_rows, device=q.device)[None, :]
    scores = scores.masked_fill(kpos > qpos, float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1),
                       vv.float())
    out[:, n_rows:] = 0
    return out.to(q.dtype)


def chunk_attention_tiled_ref(q, pk, pv, k, v, n_rows: int, scale=None):
    """The kernel's algorithm in f32, one row tile at a time.

    Row tile i walks ``key_tiles(P, n_rows, i)`` key tiles from absolute
    key 0 with an online softmax (running max m, sum l, accumulator);
    keys past a row's position score -inf, and no key past the tile's
    last real row is read.  As in the kernel the probabilities are
    rounded to v's dtype before P.V and the output is acc / l in q's
    dtype; rows at or past ``n_rows`` are zeros.  It differs from the
    kernel only in the order of the products' sums and in exp2."""
    b, s, h, hd = q.shape
    p = pk.shape[1]
    kk, vv = _keys(pk, pv, k, v, h // k.shape[2])
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    hd_v = v.shape[-1]
    out = torch.zeros((b, s, h, hd_v), dtype=torch.float32, device=q.device)
    for i in range(row_tiles(n_rows)):
        rows = slice(i * BLOCK_M, min((i + 1) * BLOCK_M, n_rows))
        qt = q[:, rows].float()
        pos = torch.arange(rows.start, rows.stop, device=q.device) + p
        last = p + rows.stop - 1
        m = torch.full((b, h, qt.shape[1]), float("-inf"), device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, qt.shape[1], hd_v), device=q.device)
        for t in range(key_tiles(p, n_rows, i)):
            keys = slice(t * BLOCK_N, min((t + 1) * BLOCK_N, last + 1))
            sc = torch.einsum("bqhd,bkhd->bhqk", qt,
                              kk[:, keys].float()) * scale
            kpos = torch.arange(keys.start, keys.stop, device=q.device)
            sc = sc.masked_fill(kpos[None, :] > pos[:, None], float("-inf"))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            pr = torch.exp(sc - m_new[..., None])
            l = l * alpha + pr.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", pr.to(v.dtype).float(),
                vv[:, keys].float())
            m = m_new
        out[:, rows] = (acc / l[..., None]).transpose(1, 2)
    return out.to(q.dtype)
