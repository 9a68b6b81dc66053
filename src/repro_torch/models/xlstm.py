"""xLSTM blocks (sLSTM + mLSTM) in PyTorch, mirroring ``repro.models.xlstm``
[arXiv:2405.04517].

* **mLSTM**: matrix memory C (hd x hd per head) with exponential gating,
  stabilized with a running max log-gate.
* **sLSTM**: scalar memory per hidden unit with exponential input gates and
  a normalizer state.

Both are Python loops over the sequence for prefill and one O(1) state
update for decode; ``mlstm_apply(chunk=...)`` is the exact chunk-parallel
form.  The stabilizer is the JAX blocks' own: the mLSTM's log-max starts at
-1e30, the sLSTM's at -inf without a state and at the cache's -1e30 with
one, and every ``exp`` of a difference goes through ``isfinite``/``m_safe``
so no ``exp(-inf - -inf)`` is ever formed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel import ctx as pctx
from ..parallel import op_cost

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(init, d_model: int, n_heads: int, proj_factor: float = 2.0,
               lead: tuple = ()) -> dict:
    """``xlstm.mlstm_init`` for ``lead`` stacked blocks (``init`` is a
    ``layers.ParamInit``)."""
    d_inner = int(proj_factor * d_model)
    sc, sci = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_inner)

    def w(i, o, s):
        return init.normal(lead + (i, o), s)

    return {
        "up": w(d_model, 2 * d_inner, sc),          # (x, gate z)
        "wq": w(d_inner, d_inner, sci),
        "wk": w(d_inner, d_inner, sci),
        "wv": w(d_inner, d_inner, sci),
        "wi": w(d_inner, n_heads, sci),             # input gate (exp)
        "wf": w(d_inner, n_heads, sci),             # forget gate
        "wo_gate": w(d_inner, d_inner, sci),
        "down": w(d_inner, d_model, sci),
        "skip_scale": init.ones(lead + (d_inner,)),
    }


def _mlstm_step(C, n, m, qt, kt, vt, it, ft):
    """One stabilized mLSTM step: (C, n, m) -> (C, n, m_new), h."""
    m_new = torch.maximum(ft + m, it)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    fdec = torch.exp(torch.where(torch.isfinite(m), ft + m - m_safe,
                                 float("-inf")))
    iin = torch.exp(it - m_safe)
    C = C * fdec[..., None, None] + iin[..., None, None] \
        * (kt[..., :, None] * vt[..., None, :])
    n = n * fdec[..., None] + iin[..., None] * kt
    num = torch.einsum("bhd,bhde->bhe", qt, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qt, n)),
                        torch.exp(-m_safe))
    return (C, n, m_new), num / den[..., None]


def mlstm_apply(p, x, n_heads: int, state=None, chunk: int = 0):
    """x: (B,S,D).  state = (C, n, m): matrix memory, normalizer, log-max.

    ``chunk > 0`` (and S > 1) uses the exact chunk-parallel form."""
    b, s, _ = x.shape
    up = x @ p["up"]
    d_inner = up.shape[-1] // 2
    xi, z = torch.split(up, d_inner, dim=-1)
    hd = d_inner // n_heads

    q = pctx.reshape(xi @ p["wq"], (b, s, n_heads, hd)).float()
    k = pctx.reshape(xi @ p["wk"], (b, s, n_heads, hd)).float() \
        / math.sqrt(hd)
    v = pctx.reshape(xi @ p["wv"], (b, s, n_heads, hd)).float()
    ig = (xi @ p["wi"]).float()                          # (B,S,H) log-space
    fg = pctx.logsigmoid((xi @ p["wf"]).float())

    if state is None:
        dev = x.device
        C = torch.zeros((b, n_heads, hd, hd), dtype=torch.float32, device=dev)
        n = torch.zeros((b, n_heads, hd), dtype=torch.float32, device=dev)
        m = torch.full((b, n_heads), -1e30, dtype=torch.float32, device=dev)
    else:
        C, n, m = state

    if chunk and s > 1:
        h, (C, n, m) = op_cost.region(
            "mlstm_scan", pctx.per_shard_rows,
            lambda *a: _mlstm_chunked(*a, chunk), q, k, v, ig, fg, (C, n, m))
    else:
        h, (C, n, m) = op_cost.region("mlstm_scan", pctx.per_shard_rows,
                                      _mlstm_loop, q, k, v, ig, fg,
                                      (C, n, m))
    h = pctx.reshape(h, (b, s, d_inner))
    h = h.to(x.dtype) * torch.sigmoid(xi @ p["wo_gate"])
    h = h + p["skip_scale"] * xi
    out = (h * F.silu(z)) @ p["down"]
    return out, (C, n, m)


def _mlstm_loop(q, k, v, ig, fg, state):
    """The stabilized per-token recurrence over S steps."""
    return op_cost.scan(lambda st, *xt: _mlstm_step(*st, *xt), state,
                        q, k, v, ig, fg)


def _mlstm_chunked(q, k, v, ig, fg, state, chunk: int):
    """Exact chunk-parallel mLSTM (``xlstm._mlstm_chunked``'s derivation):
    per chunk an attention-like quadratic form plus one state hand-off,
    equal to the stabilized per-token loop."""
    b, s, h, hd = q.shape
    pad = (-s) % chunk
    if pad:
        widths = (0, 0, 0, 0, 0, pad)
        q, k, v = (F.pad(a, widths) for a in (q, k, v))
        # padded steps keep state/max unchanged: f=0 (no decay), i=-1e30
        # (no input)
        ig = F.pad(ig, (0, 0, 0, pad), value=-1e30)
        fg = F.pad(fg, (0, 0, 0, pad))
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                   device=q.device))
    C0, n0, m0 = state
    outs = []
    # split once: the backward concatenates the chunks' gradients once
    for qc, kc, vc, ic, fc in zip(*(torch.split(a, chunk, dim=1)
                                    for a in (q, k, v, ig, fg))):
        F_ = torch.cumsum(fc, dim=1)                       # (B,ck,H)
        a = ic - F_
        M = torch.maximum(m0[:, None, :], torch.cummax(a, dim=1).values)
        w_inter = torch.exp(torch.clamp(m0[:, None, :] - M, -80, 0))
        # pairwise decay weights (B,H,t,s), s<=t
        expw = torch.exp(torch.clamp(
            a.transpose(1, 2)[:, :, None, :]               # a_s
            - M.transpose(1, 2)[:, :, :, None], -80, 0))   # M_t
        expw = expw * causal[None, None]
        scores = torch.einsum("bqhd,bshd->bhqs", qc, kc)
        pw = scores * expw
        num = torch.einsum("bhqs,bshd->bqhd", pw, vc) \
            + w_inter[..., None] * torch.einsum("bqhd,bhde->bqhe", qc, C0)
        den = pw.sum(dim=-1).transpose(1, 2) \
            + w_inter * torch.einsum("bqhd,bhd->bqh", qc, n0)
        m_t = F_ + M
        denom = torch.maximum(torch.abs(den),
                              torch.exp(torch.clamp(-m_t, -80, 80)))
        outs.append(num / denom[..., None])                # (B,ck,H,hd)
        # chunk-end state
        M_L, F_L = M[:, -1], F_[:, -1]                     # (B,H)
        w_end = torch.exp(torch.clamp(a - M_L[:, None], -80, 0))
        carry = torch.exp(torch.clamp(m0 - M_L, -80, 0))
        C0 = carry[..., None, None] * C0 \
            + torch.einsum("bsh,bshd,bshe->bhde", w_end, kc, vc)
        n0 = carry[..., None] * n0 + torch.einsum("bsh,bshd->bhd", w_end, kc)
        m0 = F_L + M_L
    return torch.cat(outs, dim=1)[:, :s], (C0, n0, m0)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(init, d_model: int, n_heads: int, lead: tuple = ()) -> dict:
    """``xlstm.slstm_init`` for ``lead`` stacked blocks."""
    sc = 1.0 / math.sqrt(d_model)

    def w():
        return init.normal(lead + (d_model, d_model), sc)

    return {"wz": w(), "wi": w(), "wf": w(), "wo": w(), "r": w(),
            "down": w()}


def slstm_apply(p, x, state=None):
    """x: (B,S,D).  state = (c, n, m, h_prev)."""
    b, _, d = x.shape
    if state is None:
        dev, f32 = x.device, torch.float32
        c = torch.zeros((b, d), dtype=f32, device=dev)
        n = torch.zeros((b, d), dtype=f32, device=dev)
        m = torch.full((b, d), float("-inf"), dtype=f32, device=dev)
        h = torch.zeros((b, d), dtype=f32, device=dev)
    else:
        c, n, m, h = state

    xz = (x @ p["wz"]).float()
    xi = (x @ p["wi"]).float()
    xf = (x @ p["wf"]).float()
    xo = (x @ p["wo"]).float()
    hs, state = pctx.per_shard_rows(_slstm_loop, xz, xi, xf, xo, (c, n, m, h),
                                    weights=(p["r"],))
    return hs.to(x.dtype) @ p["down"], state


def _slstm_loop(xz, xi, xf, xo, state, r):
    """The stabilized sLSTM recurrence over S steps (the recurrent
    weight ``r`` in the inputs' dtype): the stacked h and the state."""
    def step(carry, zt, it, ft, ot):
        c, n, m, h = carry
        rec = (h.to(r.dtype) @ r).float()
        z = torch.tanh(zt + rec)
        i_log = it + rec
        f_log = pctx.logsigmoid(ft + rec)
        m_new = torch.maximum(f_log + m, i_log)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        fdec = torch.exp(torch.where(torch.isfinite(m), f_log + m - m_safe,
                                     float("-inf")))
        iin = torch.exp(i_log - m_safe)
        c = fdec * c + iin * z
        n = torch.maximum(fdec * n + iin, torch.exp(-m_safe))
        h = torch.sigmoid(ot) * (c / n)
        return (c, n, m_new, h), h
    return op_cost.scan(step, state, xz, xi, xf, xo)
