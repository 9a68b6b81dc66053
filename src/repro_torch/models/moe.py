"""Mixture-of-Experts layer with GShard-style grouped dispatch/combine, in
PyTorch, mirroring ``repro.models.moe``.

Top-k routing with capacity dropping; optional always-on shared experts
(DeepSeek-MoE).  Tokens are reshaped into groups so the dispatch tensor is
(G, Sg, E, C), bounded per group.  The dispatch and combine products stay
einsums, as the JAX package leaves them to XLA (``torch.einsum``; on a
mesh, ``parallel.ctx.einsum``, each rank contracting its experts' shard:
expert parallelism).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel import ctx as pctx
from ..parallel import op_cost
from .layers import mlp_apply


def moe_init(init, d_model: int, moe_cfg, lead: tuple = ()) -> dict:
    """``moe.moe_init`` for ``lead`` stacked layers (``init`` is a
    ``layers.ParamInit``): an f32 router, stacked expert FFNs (E, d, f) /
    (E, f, d) and the shared experts' MLP."""
    e, f = moe_cfg.n_experts, moe_cfg.d_ff_expert
    params = {
        "router": {"w": init.normal(lead + (d_model, e),
                                    1.0 / math.sqrt(d_model), torch.float32)},
        "w_gate": init.normal(lead + (e, d_model, f), 1.0 / math.sqrt(d_model)),
        "w_up": init.normal(lead + (e, d_model, f), 1.0 / math.sqrt(d_model)),
        "w_down": init.normal(lead + (e, f, d_model), 1.0 / math.sqrt(f)),
    }
    if moe_cfg.n_shared:
        params["shared"] = init.mlp(lead, d_model, f * moe_cfg.n_shared)
    return params


def _expert_ffn(expert_in, w_gate, w_up, w_down):
    """The experts' gated FFN over (E, G, C, D) slots.  On a mesh each
    product contracts the rank's slice of its weight's FSDP-sharded dim, a
    partial sum over 'data': it is summed where it is made, onto
    ``shard_experts``' placement (one all-reduce), before the SiLU, which
    would leave the reduction to DTensor's version."""
    h = pctx.shard_experts(
        F.silu(pctx.shard_experts(
            pctx.einsum("egcd,edf->egcf", expert_in, w_gate)))
        * pctx.shard_experts(pctx.einsum("egcd,edf->egcf", expert_in, w_up)))
    return pctx.shard_experts(
        pctx.einsum("egcf,efd->egcd", h, w_down))                  # (E,G,C,D)


def moe_apply(p, x, moe_cfg):
    """x: (B, S, D) -> ((B, S, D), aux): the Switch-style load-balancing
    loss rides along, as in the JAX layer."""
    b, s, d = x.shape
    e, k = moe_cfg.n_experts, moe_cfg.top_k
    sg = min(moe_cfg.group_size, b * s)
    tokens = pctx.reshape(x, (b * s, d))
    n = tokens.shape[0]
    pad = (-n) % sg
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    g = tokens.shape[0] // sg
    xs = pctx.shard_batch_seq(pctx.reshape(tokens, (g, sg, d)))

    logits = pctx.matmul(xs.float(), p["router"]["w"])              # (G,Sg,E)
    probs = torch.softmax(logits, dim=-1)
    # top-k with ``lax.top_k``'s order: descending, the lower expert first
    # among equal chances (pad tokens' uniform routing has such ties)
    gate_vals, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, sel = gate_vals[..., :k], sel[..., :k]               # (G,Sg,k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)                    # renorm

    cap = int(math.ceil(k * sg / e * moe_cfg.capacity_factor))
    # position of each (token, choice) within its expert queue
    sel_onehot = F.one_hot(sel, e).float()                          # (G,Sg,k,E)
    flat = sel_onehot.reshape(g, sg * k, e)
    pos_in_expert = (torch.cumsum(flat, dim=1) - flat).reshape(g, sg, k, e)
    pos = (pos_in_expert * sel_onehot).sum(-1)                      # (G,Sg,k)
    keep = pos < cap
    gate_vals = gate_vals * keep

    # combine tensor (G,Sg,E,C); a position past the capacity has no slot
    # (``jax.nn.one_hot`` of an out-of-range index is all zeros)
    slots = torch.arange(cap, device=x.device, dtype=pos.dtype)
    pos_oh = (pos[..., None] == slots).float()                      # (G,Sg,k,C)
    combine = pctx.einsum("gske,gskc,gsk->gsec", sel_onehot, pos_oh,
                          gate_vals)
    dispatch = (combine > 0).to(x.dtype)

    # expert-parallel segment: E over 'model' (the redistributions are
    # the all-to-alls)
    expert_in = pctx.shard_experts(
        pctx.einsum("gsec,gsd->egcd", dispatch, xs))               # (E,G,C,D)
    expert_out = op_cost.region("experts", _expert_ffn, expert_in,
                                p["w_gate"], p["w_up"], p["w_down"])
    out = pctx.shard_batch_seq(
        pctx.einsum("gsec,egcd->gsd", combine.to(x.dtype), expert_out))

    out = pctx.reshape(out, (g * sg, d))
    if pad:
        out = out[:n]
    out = pctx.reshape(out, (b, s, d))

    if moe_cfg.n_shared and "shared" in p:
        out = out + mlp_apply(p["shared"], x)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=(0, 1))                                     # (E,)
    ce = sel_onehot.sum(2).mean(dim=(0, 1))                         # (E,)
    aux = e * torch.sum(me * ce)
    return out, aux
