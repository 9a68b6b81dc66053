"""Plain PyTorch versions of the flash-decode kernels (contiguous and
paged), the ports of ``repro.kernels.decode_attention.ref``."""

from __future__ import annotations

import math

import torch


def decode_attention_ref(q, k_cache, v_cache, lengths):
    """q (B, H, hd); k/v (B, S, Hkv, hd); lengths (B,) -> (B, H, hd).

    f32 throughout, output cast to q's dtype, as the JAX ref.  A row of
    length 0 gives NaN here (a softmax over no keys); the kernels give 0.
    """
    b, s, hkv, hd = k_cache.shape
    h = q.shape[1]
    g = h // hkv
    qg = q.reshape(b, hkv, g, hd).float()
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    mask = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
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
