"""Mamba2 (SSD) blocks in PyTorch, mirroring ``repro.models.ssm``.

A multi-head state-space block: input projection to (z, x, B, C, dt),
short causal depthwise conv over the sequence, selective scan with a
per-head scalar decay (A = -exp(a_log) shared per head), gated RMSNorm and
output projection.  Prefill runs the chunked SSD scan (a loop over chunks
with an intra-chunk einsum); decode is a single O(1) state update.  The
gated RMSNorm stays plain PyTorch, as it is jnp in the JAX block.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..parallel import ctx as pctx
from ..parallel import op_cost


def _dims(d_model: int, ssm_cfg) -> tuple[int, int, int]:
    d_inner = ssm_cfg.expand * d_model
    n_heads = ssm_cfg.n_ssm_heads or max(1, d_inner // 64)
    return d_inner, n_heads, d_inner // n_heads


def mamba2_init(init, d_model: int, ssm_cfg, lead: tuple = ()) -> dict:
    """``ssm.mamba2_init`` for ``lead`` stacked blocks (``init`` is a
    ``layers.ParamInit``)."""
    d_inner, n_heads, _ = _dims(d_model, ssm_cfg)
    n = ssm_cfg.state_dim
    zxbcdt = d_inner * 2 + 2 * n * n_heads + n_heads
    f32 = torch.float32
    return {
        "in_proj": {"w": init.normal(lead + (d_model, zxbcdt),
                                     1.0 / math.sqrt(d_model))},
        "conv_w": init.normal(lead + (ssm_cfg.conv_width, d_inner), 0.1),
        "a_log": init.zeros(lead + (n_heads,), f32),
        "dt_bias": init.zeros(lead + (n_heads,), f32),
        "d_skip": init.ones(lead + (n_heads,), f32),
        "norm_scale": init.ones(lead + (d_inner,)),
        "out_proj": {"w": init.normal(lead + (d_inner, d_model),
                                      1.0 / math.sqrt(d_inner))},
    }


def _pad_seq(a, pad: int, value: float = 0.0):
    """Pad axis 1 of ``a`` with ``pad`` steps of ``value``."""
    if not pad:
        return a
    widths = [0, 0] * (a.dim() - 2) + [0, pad]
    return F.pad(a, widths, value=value)


def _ssd_scan(state, xh, bh, ch, dt, decay, ck: int):
    """The chunked scan over S > 1 steps; returns (y (B,S,H,hd) f32, state).

    Padded steps are no-ops on the carried state: decay 1 (log 0) and zero
    input (dt 0); the causal decay matrix is masked before ``exp``."""
    bsz, s = xh.shape[0], xh.shape[1]
    pad = (-s) % ck
    xh_, bh_, ch_, dt_ = (_pad_seq(a, pad) for a in (xh, bh, ch, dt))
    dec_ = _pad_seq(decay, pad, value=1.0)
    causal = torch.tril(torch.ones((ck, ck), device=xh.device))[None, :, :,
                                                                 None]
    ys = []
    # cut once (JAX's ``chunkify``): the backward joins the chunks'
    # gradients once, where slicing each chunk out would write a zeroed
    # full-length gradient a chunk
    for xc, bc, cc, dtc, dc in zip(*(torch.split(a, ck, dim=1) for a in (
            xh_, bh_, ch_, dt_, dec_))):
        # cumulative decay within the chunk
        logd = torch.log(torch.clamp(dc, min=1e-20))               # (B,ck,H)
        cum = torch.cumsum(logd, dim=1)
        total = torch.exp(cum[:, -1])                               # (B,H)
        # contribution of the incoming state to each position
        y_state = torch.einsum("bhpn,bkhn->bkhp", state, cc) \
            * torch.exp(cum)[..., None]
        # intra-chunk (quadratic in ck): causal decay matrix
        rel = cum[:, :, None, :] - cum[:, None, :, :]              # (B,k,j,H)
        w = torch.exp(torch.where(causal > 0, rel, float("-inf"))) * causal
        scores = torch.einsum("bkhn,bjhn->bkjh", cc, bc)
        xin = dtc[..., None] * xc.float()                           # (B,ck,H,hd)
        y_intra = torch.einsum("bkjh,bkjh,bjhp->bkhp", scores, w, xin)
        # state update to pass on
        wend = torch.exp(cum[:, -1:, :] - cum)                      # (B,ck,H)
        state = pctx.shard_bh(state * total[..., None, None] + torch.einsum(
            "bkhp,bkhn,bkh->bhpn", xin, bc, wend))
        ys.append(y_state + y_intra)
    return torch.cat(ys, dim=1)[:, :s], state


def _ssd_step(state, xh, bh, ch, dt, decay):
    """One step (S = 1): the selective state update; returns (y (B,1,H,hd)
    f32, state)."""
    upd = torch.einsum("bhp,bhn->bhpn",
                       dt[:, 0][..., None] * xh[:, 0].float(), bh[:, 0])
    state = state * decay[:, 0][..., None, None] + upd
    return torch.einsum("bhpn,bhn->bhp", state, ch[:, 0])[:, None], state


def _scan(state, xh, bh, ch, dt, decay, ck: int):
    """The decode step's update or the chunked scan, by S."""
    if xh.shape[1] == 1:
        return _ssd_step(state, xh, bh, ch, dt, decay)
    return op_cost.region("ssd_scan", _ssd_scan, state, xh, bh, ch, dt,
                          decay, ck)


def _mix(head_d: int, chunk: int, dtype, state, z, xs, b, c, dt,
         conv_state, conv_w, a_log, dt_bias, d_skip, norm_scale, *, mean):
    """The block between its two products, each op on its own channels
    but for ``mean`` (over d_inner): the causal conv, the scan and the
    gated RMSNorm.  Returns (state, y (B, S, d_inner), new conv state)."""
    bsz, s = xs.shape[0], xs.shape[1]
    n_heads = dt.shape[-1]
    cw = conv_w.shape[0]

    # short causal conv over the sequence (depthwise)
    xs_pad = torch.cat([conv_state, xs], dim=1)
    new_conv_state = xs_pad[:, -(cw - 1):] if cw > 1 else conv_state
    idx = torch.arange(s, device=xs.device)[:, None] \
        + torch.arange(cw, device=xs.device)[None, :]
    windows = pctx.take_seq(xs_pad, idx)                      # (B, S, cw, d_inner)
    xs = F.silu(torch.einsum("bscd,cd->bsd", windows, conv_w))

    xh = pctx.reshape(xs, (bsz, s, n_heads, head_d))
    n = b.shape[-1] // n_heads
    bh = pctx.reshape(b, (bsz, s, n_heads, n)).float()
    ch = pctx.reshape(c, (bsz, s, n_heads, n)).float()
    dt = F.softplus(dt.float() + dt_bias)                         # (B,S,H)
    decay = torch.exp(-torch.exp(a_log)[None, None] * dt)         # (B,S,H)

    # each rank's (batch, head) shards, as GSPMD runs the scan
    y, state = pctx.per_shard_bh(_scan, state, xh, bh, ch, dt, decay, chunk)

    y = y + d_skip[None, None, :, None] * xh.float()
    y = pctx.reshape(y, (bsz, s, xs.shape[-1])).to(dtype)
    # gated RMSNorm (Mamba2)
    yf = y.float() * F.silu(z.float())
    var = mean(yf * yf)
    y = (yf * torch.rsqrt(var + 1e-5)).to(dtype) * norm_scale
    return state, y, new_conv_state


def mamba2_apply(p, x, ssm_cfg, state=None, conv_state=None):
    """x: (B, S, D).  state: (B, H, hd, N) f32 carried across calls
    (decode); conv_state: (B, conv_width - 1, d_inner).

    Returns (y, new_state, new_conv_state)."""
    bsz, s, d_model = x.shape
    d_inner, n_heads, head_d = _dims(d_model, ssm_cfg)
    n = ssm_cfg.state_dim
    cw = ssm_cfg.conv_width

    proj = pctx.shard_ffn(pctx.matmul(x, p["in_proj"]["w"]))
    # z, x, B, C, dt, each split over 'model' on its own width
    parts = pctx.split_channels(
        proj, [d_inner, d_inner, n_heads * n, n_heads * n, n_heads])
    if conv_state is None:
        conv_state = torch.zeros((bsz, cw - 1, d_inner), dtype=proj.dtype,
                                 device=x.device)
    if state is None:
        state = torch.zeros((bsz, n_heads, head_d, n), dtype=torch.float32,
                            device=x.device)
    # each rank's shards of the batch and of d_inner (its heads), as
    # GSPMD runs the block: one all-reduce of the mean square each way
    state, y, new_conv_state = pctx.per_shard_channels(
        functools.partial(_mix, head_d, ssm_cfg.chunk, x.dtype), state,
        *parts, conv_state, weights=(p["conv_w"], p["a_log"], p["dt_bias"],
                                     p["d_skip"], p["norm_scale"]))
    # the output projection's partial sum over 'model' summed here, as
    # the attention's and the MLP's are (see ``layers.attention_apply``)
    return (pctx.shard_hidden(pctx.matmul(y, p["out_proj"]["w"])), state,
            new_conv_state)
