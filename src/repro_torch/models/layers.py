"""Core dense layers in PyTorch, mirroring ``repro.models.layers``.

Params are nested dicts of tensors with the JAX package's layouts (every
matmul weight stored (in_dim, out_dim), so ``x @ w`` matches
``layers.dense``).  The plain large products stay ``torch.matmul``, as the
JAX package leaves them to XLA; every norm goes through the port's RMSNorm
kernel (``kernels.rmsnorm``).  Forward only: the port serves, it does not
train.  Cross-attention (enc-dec) is not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.rmsnorm.ops import rmsnorm as _rmsnorm_kernel

# ---------------------------------------------------------------------------
# dense / embed / norm
# ---------------------------------------------------------------------------


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def embed(p, tokens):
    return p["emb"][tokens]


def rmsnorm(p, x, eps: float = 1e-5):
    """``layers.rmsnorm`` through the port's kernel (same formula and cast
    order as the jnp version and as ``rmsnorm_pallas``)."""
    return _rmsnorm_kernel(x, p["scale"], eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA)
# ---------------------------------------------------------------------------


def _repeat_kv(k, groups: int):
    """(B, S, Hkv, hd) -> (B, S, Hkv*groups, hd)."""
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d) \
        .reshape(b, s, h * groups, d)


def full_attention(q, k, v, causal: bool = True, q_offset: int = 0):
    """Reference O(S^2)-memory attention.  q: (B,Sq,H,hd), k/v: (B,Sk,H,hd)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = scores.masked_fill(~mask[None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def flash_attention(q, k, v, causal: bool = True, q_block: int = 512,
                    kv_block: int = 1024):
    """Double-blocked flash attention (forward): an online softmax over
    kv blocks per q block, never more than a (q_block x kv_block) score
    tile per (batch, head) — the forward of ``layers.flash_attention``."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if sq <= q_block and sk <= kv_block:
        return full_attention(q, k, v, causal=causal)
    q_block = min(q_block, sq)
    kv_block = min(kv_block, sk)
    scale = 1.0 / math.sqrt(hd)
    nq = -(-sq // q_block)
    nk = -(-sk // kv_block)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * q_block - sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * kv_block - sk))
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * kv_block - sk))
    outs = []
    for qi in range(nq):
        q_tile = qp[:, qi * q_block:(qi + 1) * q_block]
        qpos = qi * q_block + torch.arange(q_block, device=q.device)
        m = torch.full((b, h, q_block), -1e30, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, q_block), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, q_block, hd), dtype=torch.float32,
                          device=q.device)
        for kj in range(nk):
            k_tile = kp[:, kj * kv_block:(kj + 1) * kv_block]
            v_tile = vp[:, kj * kv_block:(kj + 1) * kv_block]
            s = torch.einsum("bqhd,bkhd->bhqk", q_tile, k_tile).float() * scale
            kpos = kj * kv_block + torch.arange(kv_block, device=q.device)
            mask = kpos[None, :] < sk
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            s = torch.where(mask[None, None], s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(mask[None, None], p, 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(v_tile.dtype), v_tile).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-20)[..., None]
        outs.append(out.to(q.dtype).transpose(1, 2))       # (b, qb, h, hd)
    return torch.cat(outs, dim=1)[:, :sq]


def decode_attention(q, k_cache, v_cache, length, window: int = 0):
    """Single-token attention against a KV cache.

    q: (B, H, hd); k/v_cache: (B, Smax, Hkv, hd); length: (B,) valid lengths.
    """
    b, smax, hkv, hd = k_cache.shape
    h = q.shape[1]
    groups = h // hkv
    qg = q.reshape(b, hkv, groups, hd)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float() * scale
    pos = torch.arange(smax, device=q.device)
    mask = pos[None, :] < length[:, None]                   # (B, Smax)
    if window:
        mask = mask & (pos[None, :] >= (length[:, None] - window))
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, h, hd)


def attention_apply(p, x, cfg, positions=None, kv_cache=None, length=None,
                    kv_out: bool = False, prefix_kv=None, q_offset: int = 0,
                    kv_len: int | None = None):
    """GQA attention (the non-cross modes of ``layers.attention_apply``).

    * prefill: x (B,S,D); returns (out, (k,v) if kv_out)
    * decode:  x (B,1,D) with kv_cache=(k,v) (B,Smax,Hkv,hd), length (B,);
      the caches are updated in place and returned
    * cached prefill: prefix_kv=(pk,pv) (B,P,Hkv,hd) already-RoPE'd KV for
      a reused prompt prefix; x holds only the suffix and ``q_offset=P``
      places it at the right absolute positions.  kv_out returns the
      full-context (prefix+suffix) KV.  ``kv_len`` pads the attended keys
      with zeros to that length (the causal mask hides them), so the
      attention's shapes do not depend on P.
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads

    q = dense(p["wq"], x).reshape(b, s, h, hd)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :] + q_offset

    if kv_cache is None:
        k = dense(p["wk"], x).reshape(b, s, hkv, hd)
        v = dense(p["wv"], x).reshape(b, s, hkv, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        if prefix_kv is not None:
            pk, pv = prefix_kv
            k = torch.cat([pk, k], dim=1)
            v = torch.cat([pv, v], dim=1)
            ka, va = k, v
            if kv_len is not None and kv_len > k.shape[1]:
                pad = (0, 0, 0, 0, 0, kv_len - k.shape[1])
                ka, va = F.pad(k, pad), F.pad(v, pad)
            out = full_attention(q, _repeat_kv(ka, h // hkv),
                                 _repeat_kv(va, h // hkv), causal=True,
                                 q_offset=q_offset)
        else:
            out = flash_attention(q, _repeat_kv(k, h // hkv),
                                  _repeat_kv(v, h // hkv), causal=True,
                                  q_block=cfg.q_block, kv_block=cfg.kv_block)
        out = dense(p["wo"], out.reshape(b, s, h * hd))
        return (out, (k, v)) if kv_out else (out, None)

    # single-step decode
    k_cache, v_cache = kv_cache
    q = apply_rope(q, positions, cfg.rope_theta)            # (B,1,H,hd)
    k_new = apply_rope(dense(p["wk"], x).reshape(b, 1, hkv, hd), positions,
                       cfg.rope_theta)
    v_new = dense(p["wv"], x).reshape(b, 1, hkv, hd)
    # write the new KV at `length` (per-batch position): the values the
    # JAX one-hot scatter produces, written in place
    rows = torch.arange(b, device=x.device)
    k_cache[rows, length.long()] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, length.long()] = v_new[:, 0].to(v_cache.dtype)
    out = decode_attention(q[:, 0], k_cache, v_cache, length + 1,
                           window=cfg.sliding_window)
    out = dense(p["wo"], out.reshape(b, 1, h * hd))
    return out, (k_cache, v_cache)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_apply(p, x):
    return dense(p["w_down"], F.silu(dense(p["w_gate"], x))
                 * dense(p["w_up"], x))
