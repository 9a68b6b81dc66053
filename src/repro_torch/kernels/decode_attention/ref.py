"""Plain PyTorch versions of the flash-decode kernels (contiguous and
paged), the ports of ``repro.kernels.decode_attention.ref``, and plain
models of the kernels' split-key algorithm (``*_split_ref``)."""

from __future__ import annotations

import math

import torch


def decode_attention_ref(q, k_cache, v_cache, lengths, window: int = 0):
    """q (B, H, hd); k/v (B, S, Hkv, hd); lengths (B,) -> (B, H, hd).

    f32 throughout, output cast to q's dtype, as the JAX ref.  A sliding
    ``window`` > 0 also masks the keys below ``lengths - window``, as the
    model's ``layers.decode_attention`` does (the JAX ref has no window).
    A row with no key to attend (length 0) gives NaN here (a softmax over
    no keys); the kernels give 0.
    """
    b, s, hkv, hd = k_cache.shape
    h = q.shape[1]
    g = h // hkv
    qg = q.reshape(b, hkv, g, hd).float()
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    pos = torch.arange(s, device=q.device)[None, :]
    mask = pos < lengths[:, None]
    if window:
        mask = mask & (pos >= lengths[:, None] - window)
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths):
    """Gather pages into a contiguous cache and attend.

    q (B, H, hd); k/v_pages (NP, PS, Hkv, hd); block_tables (B, MP);
    lengths (B,) -> (B, H, hd).

    Mirrors ``repro.kernels.decode_attention.ref.paged_decode_attention_ref``
    (scores in the input dtype then cast to f32, probs cast back to the
    value dtype), which is what the JAX engine runs off the TPU, so the
    port's CPU model agrees tightly with the JAX model.
    """
    np_, ps, hkv, hd = k_pages.shape
    b, mp = block_tables.shape
    h = q.shape[1]
    g = h // hkv
    tables = block_tables.long()
    kc = k_pages[tables].reshape(b, mp * ps, hkv, hd)
    vc = v_pages[tables].reshape(b, mp * ps, hkv, hd)
    qg = q.reshape(b, hkv, g, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, kc).float() * scale
    pos = torch.arange(mp * ps, device=q.device)
    mask = pos[None, :] < lengths[:, None]
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(vc.dtype), vc)
    return out.reshape(b, h, hd)


#: blocks of the kernels' cluster that share one (sequence, kv head); the
#: wrapper in ``ops.py`` checks the kernel library against these two
SPLIT_RANKS = 8
#: keys of a contiguous-cache granule; granule j goes to rank j % SPLIT_RANKS
SPLIT_GRANULE = 16


def _split_attend(qg, k, v, n: int, granule: int):
    """One sequence as the kernels' cluster computes it, in f32.

    qg (Hkv, G, hd); k/v (T, Hkv, hd) with key t at row t; the first ``n``
    keys attend -> (Hkv, G, hd) f32.  Key t belongs to rank
    ``(t // granule) % SPLIT_RANKS``.  Each rank takes the softmax of its
    own keys, (m_r, l_r, acc_r), or (-1e30, 0, 0) when it has none; the
    ranks combine in rank order, each rescaled by exp(m_r - max_r m_r), and
    the output is acc / max(l, 1e-20): zeros when ``n`` is 0.  The kernels
    walk a rank's keys in tiles with an online softmax, which differs from
    this only in rounding.
    """
    hkv, g, hd = qg.shape
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("kgd,tkd->kgt", qg.float(), k[:n].float()) * scale
    keys = torch.arange(n, device=qg.device)
    owner = (keys // granule) % SPLIT_RANKS
    parts = []
    for r in range(SPLIT_RANKS):
        idx = keys[owner == r]
        if not len(idx):
            parts.append((torch.full((hkv, g, 1), -1e30, device=qg.device),
                          torch.zeros((hkv, g, 1), device=qg.device),
                          torch.zeros((hkv, g, hd), device=qg.device)))
            continue
        s = scores[..., idx]
        m_r = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m_r)
        parts.append((m_r, p.sum(dim=-1, keepdim=True),
                      torch.einsum("kgt,tkd->kgd", p, v[idx].float())))
    m = torch.stack([m_r for m_r, _, _ in parts]).amax(dim=0)
    acc = torch.zeros((hkv, g, hd), device=qg.device)
    l = torch.zeros((hkv, g, 1), device=qg.device)
    for m_r, l_r, a_r in parts:
        w = torch.exp(m_r - m)
        acc = acc + w * a_r
        l = l + w * l_r
    return acc / torch.clamp(l, min=1e-20)


def attended_keys(lengths, s: int, window: int = 0):
    """Keys each row of a contiguous-cache decode attends to (and the
    kernel reads): those before the row's end ``min(lengths, s)`` from its
    first key ``max(0, lengths - window)``, taken from the unclamped
    length as the reference's mask does (0 without a window); with a
    window that fits the cache, ``min(lengths, window)``."""
    end = lengths.clamp(0, s)
    if window <= 0:
        return end
    return (end - (lengths - window).clamp(min=0)).clamp(min=0)


def decode_attention_split_ref(q, k_cache, v_cache, lengths,
                               window: int = 0):
    """The contiguous kernel's algorithm, in f32, one row at a time.

    q (B, H, hd); k/v (B, S, Hkv, hd); lengths (B,) -> (B, H, hd) in q's
    dtype.  Row b attends over its ``attended_keys``, the last before its
    end ``min(lengths[b], S)``, dealt to the ranks in
    ``SPLIT_GRANULE``-key granules counted from its first key; a row with
    no key to attend gets zeros, as from the kernel.  Each row is computed
    alone, so its output does not depend on its batch-mates."""
    b, s, hkv, hd = k_cache.shape
    h = q.shape[1]
    qg = q.reshape(b, hkv, h // hkv, hd)
    ends = lengths.clamp(0, s).tolist()
    keys = attended_keys(lengths, s, window).tolist()
    out = [_split_attend(qg[i], k_cache[i, ends[i] - keys[i]:],
                         v_cache[i, ends[i] - keys[i]:], keys[i],
                         SPLIT_GRANULE) for i in range(b)]
    return torch.stack(out).reshape(b, h, hd).to(q.dtype)


def paged_decode_attention_split_ref(q, k_pages, v_pages, block_tables,
                                     lengths):
    """The paged kernel's algorithm, in f32, one sequence at a time.

    q (B, H, hd); k/v_pages (NP, PS, Hkv, hd); block_tables (B, MP);
    lengths (B,) -> (B, H, hd) in q's dtype.  A granule is one page: page
    j of a sequence goes to rank j % ``SPLIT_RANKS``.  Only the table entries
    and slots a sequence's length reaches are read."""
    np_, ps, hkv, hd = k_pages.shape
    b, mp = block_tables.shape
    h = q.shape[1]
    qg = q.reshape(b, hkv, h // hkv, hd)
    out = []
    for i in range(b):
        n = max(0, min(int(lengths[i]), mp * ps))
        pages = block_tables[i, :-(-n // ps)].long()
        k = k_pages[pages].reshape(-1, hkv, hd)
        v = v_pages[pages].reshape(-1, hkv, hd)
        out.append(_split_attend(qg[i], k, v, n, ps))
    return torch.stack(out).reshape(b, h, hd).to(q.dtype)


#: (query heads, latent row width, value width) of the paged kernel's
#: latent instance: DeepSeek-V2-Lite's 16 heads over [c_kv (512) | k_pe
#: (64)], the values c_kv
MLA_SHAPE = (16, 576, 512)


def paged_mla_decode_attention_ref(q, pages, block_tables, lengths,
                                   scale: float, v_dim: int):
    """The latent decode attention in f32, one sequence at a time.

    q (B, H, W); pages (NP, PS, W); block_tables (B, MP); lengths (B,) ->
    (B, H, v_dim) in q's dtype: row b's scores scale * q . row over the
    first ``lengths[b]`` latent rows of its pages, softmax, times the
    rows' first ``v_dim`` columns.  A row of length 0 gets zeros."""
    ps = pages.shape[1]
    b, mp = block_tables.shape
    out = torch.zeros((b, q.shape[1], v_dim), dtype=torch.float32,
                      device=q.device)
    for i in range(b):
        n = max(0, min(int(lengths[i]), mp * ps))
        if n == 0:
            continue
        rows = pages[block_tables[i, :-(-n // ps)].long()].reshape(
            -1, pages.shape[2])[:n].float()
        p = torch.softmax(q[i].float() @ rows.T * scale, dim=-1)
        out[i] = p @ rows[:, :v_dim]
    return out.to(q.dtype)
