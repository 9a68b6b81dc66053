"""Core dense layers in PyTorch, mirroring ``repro.models.layers``.

Params are nested dicts of tensors with the JAX package's layouts (every
matmul weight stored (in_dim, out_dim), so ``x @ w`` matches
``layers.dense``).  The plain large products stay ``torch.matmul``, as the
JAX package leaves them to XLA; every norm goes through the port's RMSNorm
kernel (``kernels.rmsnorm``) and, on the card, the contiguous-cache decode
attention through the port's flash-decode kernel
(``kernels.decode_attention``) and the cached prefill's attention through
its fused causal kernel (``kernels.chunk_attention``).  The training path
is differentiable:
the RMSNorm kernel has a backward kernel, and ``flash_attention`` is an
autograd function with the JAX package's flash backward.

``ParamInit`` draws the random weights of every module's ``*_init``: on a
given device from a given ``torch.Generator``, in bounded pieces, so a
full-width stacked weight never has an f32 copy of itself in memory.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.chunk_attention.ops import \
    chunk_attention as _chunk_attention_kernel
from ..kernels.decode_attention.ops import \
    decode_attention as _decode_attention_kernel
from ..kernels.rmsnorm.ops import rmsnorm as _rmsnorm_kernel
from ..parallel import ctx as pctx
from ..parallel import op_cost
from . import trace

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

#: the most elements one f32 draw holds (512 MB); a larger weight is drawn
#: slice by slice along its leading axes
DRAW_CHUNK = 1 << 27


class ParamInit:
    """Random parameters with the JAX package's dtypes: normals drawn in f32
    from ``generator`` on ``device``, scaled, then cast, one slice of at
    most ``DRAW_CHUNK`` elements at a time."""

    def __init__(self, generator: torch.Generator, device):
        self.gen = generator
        self.device = device

    def normal(self, shape, std: float, dtype=torch.bfloat16):
        out = torch.empty(tuple(shape), dtype=dtype, device=self.device)
        self._fill(out, std)
        return out

    def _fill(self, out, std: float) -> None:
        if out.is_meta:                 # shapes only (``init_abstract``)
            return
        if out.numel() <= DRAW_CHUNK or out.dim() == 0:
            out.copy_(torch.randn(out.shape, generator=self.gen,
                                  device=self.device,
                                  dtype=torch.float32) * std)
            return
        # as many leading slices as fit in one draw, else one at a time
        rows = DRAW_CHUNK // out[0].numel()
        if rows == 0:
            for part in out:
                self._fill(part, std)
            return
        for i in range(0, out.shape[0], rows):
            self._fill(out[i:i + rows], std)

    def zeros(self, shape, dtype=torch.bfloat16):
        return torch.zeros(tuple(shape), dtype=dtype, device=self.device)

    def ones(self, shape, dtype=torch.bfloat16):
        return torch.ones(tuple(shape), dtype=dtype, device=self.device)

    def dense(self, lead, d_in: int, d_out: int, bias: bool = False):
        """``layers.dense_init`` for ``lead`` stacked layers."""
        p = {"w": self.normal(lead + (d_in, d_out), 1.0 / math.sqrt(d_in))}
        if bias:
            p["b"] = self.zeros(lead + (d_out,))
        return p

    def rmsnorm(self, lead, d: int):
        return {"scale": self.ones(lead + (d,))}

    def attention(self, lead, cfg, bias: bool = False):
        """``layers.attention_init``."""
        d, hd = cfg.d_model, cfg.resolved_head_dim
        return {"wq": self.dense(lead, d, cfg.n_heads * hd, bias),
                "wk": self.dense(lead, d, cfg.n_kv_heads * hd, bias),
                "wv": self.dense(lead, d, cfg.n_kv_heads * hd, bias),
                "wo": self.dense(lead, cfg.n_heads * hd, d)}

    def mla(self, lead, cfg):
        """Latent attention (``mla_project``): q (D, H (dn + dr)), the
        latent's down projection [c_kv | k_pe] (D, r + dr), its norm, the
        up projection to per-head [k_nope | v] (r, H (dn + dv)) and the
        output (H dv, D)."""
        m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
        r = m.kv_lora_rank
        return {"wq": self.dense(lead, d, h * m.qk_head_dim),
                "wkva": self.dense(lead, d, r + m.qk_rope_head_dim),
                "kv_ln": self.rmsnorm(lead, r),
                "wkvb": self.dense(lead, r,
                                   h * (m.qk_nope_head_dim + m.v_head_dim)),
                "wo": self.dense(lead, h * m.v_head_dim, d)}

    def mlp(self, lead, d_model: int, d_ff: int):
        """``layers.mlp_init``."""
        return {"w_gate": self.dense(lead, d_model, d_ff),
                "w_up": self.dense(lead, d_model, d_ff),
                "w_down": self.dense(lead, d_ff, d_model)}


# ---------------------------------------------------------------------------
# dense / embed / norm
# ---------------------------------------------------------------------------


def dense(p, x):
    y = pctx.matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def embed(p, tokens):
    return pctx.embedding(p["emb"], tokens)


def rmsnorm(p, x, eps: float = 1e-5):
    """``layers.rmsnorm`` through the port's kernel (same formula and cast
    order as the jnp version and as ``rmsnorm_pallas``)."""
    return _rmsnorm_kernel(x.contiguous(), p["scale"], eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention scale for a context stretched by ``factor``."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_range(mla, head_dim: int, theta: float) -> tuple[int, int]:
    """The rotary pairs between which YaRN blends the extrapolated and the
    interpolated frequencies: the correction dims of ``beta_fast`` and
    ``beta_slow`` rotations over the original context, clipped."""
    def dim(rotations):
        return (head_dim * math.log(mla.original_max_position
                                    / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    return (max(math.floor(dim(mla.beta_fast)), 0),
            min(math.ceil(dim(mla.beta_slow)), head_dim - 1))


def rope_frequencies(head_dim: int, theta: float, device=None, mla=None):
    """The rotation frequencies of the hd/2 pairs; with ``mla`` (an
    ``MLAConfig``) YaRN's: the extrapolated ``theta^(-2i/hd)`` and the
    interpolated ones (divided by the factor) blended by a linear ramp
    between ``yarn_range``'s dims, as DeepSeek-V2's modelling code does."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    freqs = 1.0 / (theta ** exps)
    if mla is None:
        return freqs
    inter = 1.0 / (mla.rope_factor * theta ** exps)
    low, high = yarn_range(mla, head_dim, theta)
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float32,
                                     device=device) - low)
                       / (high - low if high > low else 0.001), 0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + freqs * keep


def rope_tables(positions, head_dim: int, theta: float, device=None,
                mla=None):
    """cos and sin of the rotation angles at ``positions`` (broadcastable
    to (..., S)): (..., S, 1, hd/2) f32 each.  A step whose layers share
    their positions computes them once (on the card's host each call is
    about 0.2 ms of launches).  With ``mla`` the frequencies are YaRN's
    and cos/sin are scaled by mscale(factor, mscale) / mscale(factor,
    mscale_all_dim), 1 for DeepSeek-V2-Lite."""
    freqs = rope_frequencies(head_dim, theta, device, mla)     # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    if mla is not None:
        ms = (yarn_mscale(mla.rope_factor, mla.mscale)
              / yarn_mscale(mla.rope_factor, mla.mscale_all_dim))
        if ms != 1.0:
            cos, sin = cos * ms, sin * ms
    return cos, sin


def apply_rope(x, positions, theta: float, tables=None):
    """x: (..., S, H, hd); positions: broadcastable to (..., S);
    ``tables``: ``rope_tables`` at these positions, if already made."""
    cos, sin = (tables if tables is not None else
                rope_tables(positions, x.shape[-1], theta, x.device))
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
    return pctx.reshape(k[:, :, :, None, :].expand(b, s, h, groups, d),
                        (b, s, h * groups, d))


def full_attention(q, k, v, causal: bool = True, q_offset: int = 0,
                   scale: float | None = None):
    """Reference O(S^2)-memory attention.  q: (B,Sq,H,hd), k/v: (B,Sk,H,hd)
    (v may be another width); ``scale`` defaults to 1/sqrt(hd)."""
    if scale is None:
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


def _tile_mask(qi, kj, q_block, kv_block, sk, causal, device):
    """(q_block, kv_block) validity mask for tile (qi, kj)."""
    qpos = qi * q_block + torch.arange(q_block, device=device)
    kpos = kj * kv_block + torch.arange(kv_block, device=device)
    mask = kpos[None, :] < sk
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    return mask


def _flash_fwd(q, k, v, causal, sk, q_block, kv_block):
    """The online softmax over kv blocks, per q block, on padded q
    (B, nq*qb, H, hd) and k/v (B, nk*kb, H, hd): (out (B, nq*qb, H, hd) in
    q's dtype, m and l (B, H, nq*qb) f32)."""
    b, sqp, h, hd = q.shape
    nq, nk = sqp // q_block, k.shape[1] // kv_block
    scale = 1.0 / math.sqrt(hd)
    outs, ms, ls = [], [], []
    for qi in range(nq):
        q_tile = q[:, qi * q_block:(qi + 1) * q_block]
        m = pctx.shard_bh(torch.full((b, h, q_block), -1e30,
                                     dtype=torch.float32, device=q.device))
        l = pctx.shard_bh(torch.zeros((b, h, q_block), dtype=torch.float32,
                                      device=q.device))
        acc = pctx.shard_bh(torch.zeros((b, h, q_block, hd),
                                        dtype=torch.float32, device=q.device))
        for kj in range(nk):
            k_tile = k[:, kj * kv_block:(kj + 1) * kv_block]
            v_tile = v[:, kj * kv_block:(kj + 1) * kv_block]
            s = torch.einsum("bqhd,bkhd->bhqk", q_tile, k_tile).float() * scale
            mask = _tile_mask(qi, kj, q_block, kv_block, sk, causal, q.device)
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
        ms.append(m)
        ls.append(l)
    return torch.cat(outs, dim=1), torch.cat(ms, dim=-1), torch.cat(ls, dim=-1)


def _flash_bwd(q, k, v, out, m, l, dout, causal, sk, q_block, kv_block):
    """JAX's ``_flash_bwd``: each score tile recomputed from the saved
    O(S) residuals (out, m, l), ``delta = sum(dO * O)``; dq summed over kv
    blocks and dk/dv over q blocks, each in JAX's order, in f32."""
    b, sqp, h, hd = q.shape
    nq, nk = sqp // q_block, k.shape[1] // kv_block
    scale = 1.0 / math.sqrt(hd)
    l_safe = torch.clamp(l, min=1e-20)
    delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)
    dq = torch.zeros_like(q, dtype=torch.float32)
    dk = torch.zeros_like(k, dtype=torch.float32)
    dv = torch.zeros_like(v, dtype=torch.float32)
    for qi in range(nq):
        qs = slice(qi * q_block, (qi + 1) * q_block)
        q_tile = q[:, qs]
        do_t = dout[:, qs].float().transpose(1, 2)          # (b, h, qb, hd)
        m_q, l_q, d_q = m[..., qs], l_safe[..., qs], delta[..., qs]
        for kj in range(nk):
            ks = slice(kj * kv_block, (kj + 1) * kv_block)
            k_tile, v_tile = k[:, ks], v[:, ks]
            s = torch.einsum("bqhd,bkhd->bhqk", q_tile, k_tile).float() * scale
            mask = _tile_mask(qi, kj, q_block, kv_block, sk, causal, q.device)
            p = torch.exp(s - m_q[..., None]) / l_q[..., None]
            p = torch.where(mask[None, None], p, 0.0)
            dp = torch.einsum("bhqd,bkhd->bhqk", do_t, v_tile.float())
            ds = p * (dp - d_q[..., None])
            dq[:, qs] += scale * torch.einsum("bhqk,bkhd->bqhd", ds,
                                              k_tile.float())
            dv[:, ks] += torch.einsum("bhqk,bhqd->bkhd", p, do_t)
            dk[:, ks] += scale * torch.einsum("bhqk,bqhd->bkhd", ds,
                                              q_tile.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """``layers._flash`` (JAX's ``custom_vjp``): the blocked forward, which
    saves (q, k, v, out, m, l) — O(S), not a score tile of each block
    pair — and the flash backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sk, q_block, kv_block):
        out, m, l = op_cost.region("flash_attention", _flash_fwd, q, k, v,
                                   causal, sk, q_block, kv_block)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.blocking = (causal, sk, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = op_cost.region("flash_attention_bwd", _flash_bwd,
                               *ctx.saved_tensors, dout.contiguous(),
                               *ctx.blocking)
        return grads + (None,) * 4


def flash_attention(q, k, v, causal: bool = True, q_block: int = 512,
                    kv_block: int = 1024):
    """Double-blocked flash attention with a flash backward
    (``layers.flash_attention``): an online softmax over kv blocks per q
    block, never more than a (q_block x kv_block) score tile per (batch,
    head) in either direction, O(S) residuals."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if sq <= q_block and sk <= kv_block:
        return full_attention(q, k, v, causal=causal)
    q_block = min(q_block, sq)
    kv_block = min(kv_block, sk)
    pq, pk = (-sq) % q_block, (-sk) % kv_block
    qp = F.pad(q, (0, 0, 0, 0, 0, pq)) if pq else q
    kp, vp = (F.pad(a, (0, 0, 0, 0, 0, pk)) if pk else a for a in (k, v))
    # padded keys are masked by the true sk in each tile's mask
    out = FlashAttention.apply(qp, kp, vp, causal, sk, q_block, kv_block)
    return out[:, :sq]


def decode_attention(q, k_cache, v_cache, length, window: int = 0):
    """Single-token attention against a KV cache.

    q: (B, H, hd); k/v_cache: (B, Smax, Hkv, hd); length: (B,) valid lengths.

    ``window`` > 0 attends only to the keys at or past ``length - window``.

    On the card this is the port's flash-decode kernel
    (``kernels.decode_attention``: f32 scores, reads only the keys each
    row attends to, the window's too; a row with none gets zeros, where
    the formula gives NaN).  On the CPU it is ``decode_attention_plain``,
    which keeps the JAX layer's cast order (bf16 scores and probs), so the
    CPU model agrees tightly with the JAX model.
    """
    if q.is_cuda:
        return _decode_attention_kernel(q.contiguous(), k_cache, v_cache,
                                        length.to(torch.int32), window)
    return decode_attention_plain(q, k_cache, v_cache, length, window)


def decode_attention_plain(q, k_cache, v_cache, length, window: int = 0):
    """The plain code of ``decode_attention`` on any device: the JAX
    layer's formula and cast order.  Under ``parallel.ctx``, on a DTensor
    cache (sequence-sharded by ``cache_specs``), it is
    ``ctx.decode_on_seq_shards``: each rank attends to its slice of the
    cache, and the softmax is combined across the slices."""
    if pctx.on_mesh(k_cache):
        return pctx.decode_on_seq_shards(q, k_cache, v_cache, length, window)
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
                    kv_len: int | None = None, memory=None,
                    n_rows: int | None = None, rope=None):
    """GQA attention (``layers.attention_apply``).

    * prefill: x (B,S,D); returns (out, (k,v) if kv_out)
    * cross-attention: memory (B,Sm,D) — K/V from memory, no RoPE and no
      causal mask; kv_out returns the memory's K/V
    * decode:  x (B,1,D) with kv_cache=(k,v) (B,Smax,Hkv,hd), length (B,);
      the caches are updated in place and returned
    * cached prefill: prefix_kv=(pk,pv) (B,P,Hkv,hd) already-RoPE'd KV for
      a reused prompt prefix; x holds only the suffix and ``q_offset=P``
      places it at the right absolute positions.  kv_out returns the
      suffix's KV alone (the caller holds the prefix's).  ``kv_len`` pads the attended keys with zeros to
      that length (the causal mask hides them), so the attention's shapes
      do not depend on P.  On the card the attention is the fused causal
      kernel (``kernels.chunk_attention``: f32 scores, no padded keys,
      K/V read in their GQA layout), which computes only the first
      ``n_rows`` rows of x (all when None; the rest trail as padding) and
      gives zeros for the others; on the CPU, and on a mesh, it is
      ``full_attention`` with the JAX layer's cast order over every row.

    ``rope`` (prefill) is ``rope_tables`` at ``positions``, made once for
    every layer of a step.
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads

    q = pctx.reshape(dense(p["wq"], x), (b, s, h, hd))
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :] + q_offset

    if memory is not None:
        sm = memory.shape[1]
        k = pctx.reshape(dense(p["wk"], memory), (b, sm, hkv, hd))
        v = pctx.reshape(dense(p["wv"], memory), (b, sm, hkv, hd))
        q, kf, vf = map(pctx.shard_heads, (q, _repeat_kv(k, h // hkv),
                                           _repeat_kv(v, h // hkv)))
        out = pctx.per_shard(full_attention, q, kf, vf, causal=False)
        out = pctx.shard_hidden(dense(p["wo"],
                                      pctx.reshape(out, (b, s, h * hd))))
        return (out, (k, v)) if kv_out else (out, None)

    if kv_cache is None:
        k = pctx.reshape(dense(p["wk"], x), (b, s, hkv, hd))
        v = pctx.reshape(dense(p["wv"], x), (b, s, hkv, hd))
        q = apply_rope(q, positions, cfg.rope_theta, rope)
        k = apply_rope(k, positions, cfg.rope_theta, rope)
        if prefix_kv is not None:
            pk, pv = prefix_kv
            if q.is_cuda and not pctx.on_mesh(q):
                if q_offset != pk.shape[1]:
                    raise ValueError(f"q_offset {q_offset} is not the "
                                     f"prefix's length {pk.shape[1]}")
                out = _chunk_attention_kernel(
                    q, pk, pv, k, v, s if n_rows is None else n_rows)
            else:
                ka, va = torch.cat([pk, k], dim=1), torch.cat([pv, v], dim=1)
                if kv_len is not None and kv_len > ka.shape[1]:
                    pad = (0, 0, 0, 0, 0, kv_len - ka.shape[1])
                    ka, va = F.pad(ka, pad), F.pad(va, pad)
                q, kf, vf = map(pctx.shard_heads,
                                (q, _repeat_kv(ka, h // hkv),
                                 _repeat_kv(va, h // hkv)))
                out = pctx.per_shard(full_attention, q, kf, vf, causal=True,
                                     q_offset=q_offset)
        else:
            q, kf, vf = map(pctx.shard_heads, (q, _repeat_kv(k, h // hkv),
                                               _repeat_kv(v, h // hkv)))
            out = pctx.per_shard(flash_attention, q, kf, vf, causal=True,
                                 q_block=cfg.q_block, kv_block=cfg.kv_block)
        out = pctx.shard_hidden(dense(p["wo"],
                                      pctx.reshape(out, (b, s, h * hd))))
        return (out, (k, v)) if kv_out else (out, None)

    # single-step decode
    k_cache, v_cache = kv_cache
    q = apply_rope(q, positions, cfg.rope_theta)            # (B,1,H,hd)
    k_new = apply_rope(pctx.reshape(dense(p["wk"], x), (b, 1, hkv, hd)),
                       positions, cfg.rope_theta)
    v_new = pctx.reshape(dense(p["wv"], x), (b, 1, hkv, hd))
    # write the new KV at `length` (per-batch position): the values the
    # JAX one-hot scatter produces, written in place
    rows, pos = torch.arange(b, device=x.device), length.long()
    pctx.write_rows(k_cache, rows, pos, k_new[:, 0].to(k_cache.dtype))
    pctx.write_rows(v_cache, rows, pos, v_new[:, 0].to(v_cache.dtype))
    out = decode_attention(q[:, 0], k_cache, v_cache, length + 1,
                           window=cfg.sliding_window)
    # the output projection's partial sum over 'model' summed here, in
    # the activations' dtype, as in prefill (left to DTensor, some
    # versions carry it into the residual stream and sum it in f32 at each
    # norm that reads it)
    out = pctx.shard_hidden(dense(p["wo"], pctx.reshape(out, (b, 1, h * hd))))
    return out, (k_cache, v_cache)


# ---------------------------------------------------------------------------
# multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------
#
# Per token, ``mla_project`` makes q = x W_q (H heads of [q_nope | q_pe])
# and the latent [RMSNorm(c_kv) | RoPE(k_pe)] = x W_kva, normed and
# rotated: the 576 values a token of a layer caches (DeepSeek-V2-Lite).
# The prefill decompresses the latent into per-head K = [c W_UK | k_pe]
# and V = c W_UV (``mla_expand``, the non-absorbed form, through the
# chunk attention kernel); a decode step keeps the latent and absorbs
# W_UK into the query and W_UV into the output (``mla_absorb_query``,
# ``mla_absorb_out``), so its attention reads one latent row a key for all
# H heads (DESIGN.md §2.14).


def mla_scale(cfg) -> float:
    """The softmax scale: (dn + dr)^-1/2 times mscale(factor,
    mscale_all_dim) squared."""
    m = cfg.mla
    return (m.qk_head_dim ** -0.5
            * yarn_mscale(m.rope_factor, m.mscale_all_dim) ** 2)


def mla_rope_tables(positions, cfg, device=None):
    """``rope_tables`` of the rotary part at ``positions``: YaRN's."""
    return rope_tables(positions, cfg.mla.qk_rope_head_dim, cfg.rope_theta,
                       device, cfg.mla)


def mla_rope(x, tables):
    """x (..., S, heads, dr) rotated as DeepSeek-V2 does: its interleaved
    pairs (x0, x1), (x2, x3), ... are first permuted to halves
    (x0, x2, ..., x1, x3, ...), then rotated in the rotate-half form (in
    f32, as ``apply_rope``)."""
    cos, sin = tables
    xf = x.float()
    even, odd = xf[..., 0::2], xf[..., 1::2]
    return torch.cat([even * cos - odd * sin, even * sin + odd * cos],
                     dim=-1).to(x.dtype)


def mla_project(p, x, cfg, rope):
    """x (B, S, D), normed -> (q_nope (B,S,H,dn), q_pe (B,S,H,dr) rotated,
    latent (B,S,r+dr)): the latent is [RMSNorm_kv(c_kv) | RoPE(k_pe)], one
    k_pe shared by every head, in x's dtype."""
    m = cfg.mla
    b, s, _ = x.shape
    h, r, dn = cfg.n_heads, m.kv_lora_rank, m.qk_nope_head_dim
    q = dense(p["wq"], x).view(b, s, h, m.qk_head_dim)
    kva = dense(p["wkva"], x)
    c = rmsnorm(p["kv_ln"], kva[..., :r], cfg.norm_eps)
    # the queries' rotary parts and the shared k_pe, rotated at once
    pe = mla_rope(torch.cat([q[..., dn:], kva[..., None, r:]], dim=2), rope)
    return q[..., :dn], pe[:, :, :h], torch.cat([c, pe[:, :, h]], dim=-1)


def mla_expand(p, latent, cfg):
    """latent (B, n, r + dr) -> per-head K (B, n, H, dn + dr) =
    [c W_UK | k_pe] and V (B, n, H, dv) = c W_UV, each contiguous."""
    m = cfg.mla
    b, n, _ = latent.shape
    r, dn, dr = m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim
    with trace.span("model.mla_expand"):
        kv = dense(p["wkvb"], latent[..., :r]).view(b, n, cfg.n_heads, -1)
        k = torch.cat([kv[..., :dn], latent[..., None, r:].expand(
            b, n, cfg.n_heads, dr)], dim=-1)
        return k, kv[..., dn:].contiguous()


def mla_attention(p, x, cfg, rope, prefix=None, n_rows: int | None = None):
    """Causal latent attention of the rows x (B, S, D), normed, after the
    P-token latent ``prefix`` (B, P, r + dr) (none: P = 0), in the
    non-absorbed form.  Returns (out (B, S, D), the rows' latent
    (B, S, r + dr)).

    The prefix's and the first ``n_rows`` rows' latent (all when None; the
    rest trail as padding) are decompressed into per-head K and V; on the
    card the chunk attention kernel attends over them at key width
    dn + dr and value width dv with ``mla_scale`` and gives the padding
    rows zeros; on the CPU and on a mesh it is ``full_attention``."""
    m = cfg.mla
    b, s, _ = x.shape
    n = s if n_rows is None else n_rows
    p_len = 0 if prefix is None else prefix.shape[1]
    q_nope, q_pe, latent = mla_project(p, x, cfg, rope)
    q = torch.cat([q_nope, q_pe], dim=-1)
    lat = latent[:, :n] if prefix is None else torch.cat(
        [prefix.to(latent.dtype), latent[:, :n]], dim=1)
    k, v = mla_expand(p, lat, cfg)
    if q.is_cuda and not pctx.on_mesh(q):
        out = _chunk_attention_kernel(q, k[:, :p_len], v[:, :p_len],
                                      k[:, p_len:], v[:, p_len:], n,
                                      scale=mla_scale(cfg))
    else:
        out = full_attention(q, k, v, causal=True, q_offset=p_len,
                             scale=mla_scale(cfg))
    out = dense(p["wo"], out.reshape(b, s, cfg.n_heads * m.v_head_dim))
    return out, latent


def _mla_weights(p, cfg):
    """W_UK (H, dn, r) and W_UV (H, r, dv): views of the up projection."""
    m = cfg.mla
    w = p["wkvb"]["w"].view(m.kv_lora_rank, cfg.n_heads, -1)
    return (w[..., :m.qk_nope_head_dim].permute(1, 2, 0),
            w[..., m.qk_nope_head_dim:].permute(1, 0, 2))


def mla_absorb_query(p, q_nope, q_pe, cfg):
    """One query row per sequence, q_nope (B, H, dn) and q_pe (B, H, dr) ->
    (B, H, r + dr): [q_nope_h W_UK,h^T | q_pe_h], whose dot product with a
    latent row [c | k_pe] is the non-absorbed score q_h . k_h."""
    w_uk, _ = _mla_weights(p, cfg)
    qa = torch.matmul(q_nope.transpose(0, 1), w_uk).transpose(0, 1)
    return torch.cat([qa, q_pe], dim=-1)


def mla_absorb_out(p, o_lat, cfg):
    """The latent attention output o_lat (B, H, r) -> (B, 1, D): each head's
    õ_h W_UV,h, then the output projection."""
    _, w_uv = _mla_weights(p, cfg)
    o = torch.matmul(o_lat.transpose(0, 1), w_uv).transpose(0, 1)
    b = o.shape[0]
    return dense(p["wo"], o.reshape(b, 1, -1))


def mla_decode_plain(q, latent, length, scale: float, v_dim: int):
    """The absorbed decode attention over a contiguous latent cache: q
    (B, H, r + dr), latent (B, Smax, r + dr), length (B,) -> (B, H, v_dim)
    in q's dtype; row b attends its first ``length[b]`` latent rows, whose
    first ``v_dim`` columns are the values.  f32 scores and softmax."""
    s = torch.einsum("bhc,bsc->bhs", q.float(), latent.float()) * scale
    pos = torch.arange(latent.shape[1], device=q.device)
    s = s.masked_fill(~(pos[None, :] < length[:, None])[:, None, :],
                      float("-inf"))
    out = torch.einsum("bhs,bsc->bhc", torch.softmax(s, dim=-1),
                       latent[..., :v_dim].float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_apply(p, x):
    h = pctx.shard_ffn(F.silu(dense(p["w_gate"], x)) * dense(p["w_up"], x))
    return pctx.shard_hidden(dense(p["w_down"], h))


def cross_entropy_loss(logits, labels, ignore_id: int = -1):
    """Mean token cross-entropy in f32; labels == ignore_id are masked."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0)[..., None].long())[..., 0]
    nll = logz - gold
    mask = (labels != ignore_id).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
