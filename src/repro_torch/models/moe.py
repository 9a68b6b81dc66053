"""Mixture-of-Experts layer with GShard-style grouped dispatch/combine, in
PyTorch, mirroring ``repro.models.moe``.

Top-k routing with capacity dropping; optional always-on shared experts
(DeepSeek-MoE).  Tokens are reshaped into groups so the dispatch tensor is
(G, Sg, E, C), bounded per group.  The dispatch and combine products stay
einsums, as the JAX package leaves them to XLA (``torch.einsum``; on a
mesh, ``parallel.ctx.einsum``, each rank contracting its experts' shard:
expert parallelism).

``moe_dropless`` is the serving layer (DESIGN.md §2.14): the capacity path
drops a token when its group overflows, so a token's output would depend on
its batch-mates, and a padded chunk would route its pad rows into the
experts.  It routes the real rows only, sorts the (token, choice) pairs by
expert and runs each projection as one grouped GEMM over the experts'
contiguous row groups (``torch._grouped_mm``; per-expert GEMMs over the
slices where the torch build lacks it), with no host sync on the grouped
route.  ``moe_apply`` stays for training and for JAX parity.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel import ctx as pctx
from ..parallel import op_cost
from . import trace
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
    if moe_cfg.norm_topk_prob:
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                            min=1e-9)                # renorm
    if moe_cfg.routed_scaling_factor != 1.0:
        gate_vals = gate_vals * moe_cfg.routed_scaling_factor

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


def route(p, x, moe_cfg):
    """Top-k routing of rows x (N, D): (gates (N, k) f32, experts (N, k)).
    The router runs in f32 over a softmax of the E scores; the k largest
    are taken greedily, renormalised when ``norm_topk_prob``, then scaled
    by ``routed_scaling_factor``."""
    logits = pctx.matmul(x.float(), p["router"]["w"])
    gates, sel = torch.topk(torch.softmax(logits, dim=-1), moe_cfg.top_k,
                            dim=-1)
    if moe_cfg.norm_topk_prob:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    if moe_cfg.routed_scaling_factor != 1.0:
        gates = gates * moe_cfg.routed_scaling_factor
    return gates, sel


def grouped_mm(x, w, offs):
    """Row group g of x (rows ``offs[g-1]`` to ``offs[g]``) times ``w[g]``:
    x (N, K), w (G, K, M), offs (G,) int32 cumulative ends -> (N, M).  One
    grouped GEMM where torch has it (``torch._grouped_mm``), else one GEMM
    a non-empty group over its slice (a host sync for the bounds)."""
    if hasattr(torch, "_grouped_mm"):
        return torch._grouped_mm(x, w, offs=offs)
    out = x.new_empty((x.shape[0], w.shape[-1]))
    ends = offs.tolist()
    for g, (a, b) in enumerate(zip([0] + ends[:-1], ends)):
        if b > a:
            out[a:b] = x[a:b] @ w[g]
    return out


def moe_dropless(p, x, moe_cfg, n_rows: int | None = None):
    """x (B, S, D) -> (B, S, D): the routed experts' weighted sum plus the
    shared experts, computed for the first ``n_rows`` rows of the
    flattened B * S (all when None); the rows after them trail as padding
    and get zeros.  No token is dropped and none depends on another's
    routing: the (row, choice) pairs are sorted by expert (a stable sort),
    each projection is one grouped GEMM over the experts' row groups
    (their bounds found on the device, so nothing waits for the host), and
    each row sums its k outputs in f32, weighted by its gates, in its own
    order (no atomics)."""
    b, s, d = x.shape
    e, k = moe_cfg.n_experts, moe_cfg.top_k
    flat = x.reshape(b * s, d)
    n = flat.shape[0] if n_rows is None else n_rows
    xr = flat[:n]
    with trace.span("model.moe_route"):
        gates, sel = route(p, xr, moe_cfg)
        # the pairs by expert, and each expert's end among them (no sync)
        choice, order = torch.sort(sel.reshape(-1), stable=True)
        offs = torch.searchsorted(choice, torch.arange(e, device=x.device),
                                  right=True, out_int32=True)
    with trace.span("model.moe_experts"):
        xs = xr[order // k]                                  # (n k, D)
        h = F.silu(grouped_mm(xs, p["w_gate"], offs)) \
            * grouped_mm(xs, p["w_up"], offs)
        ys = grouped_mm(h, p["w_down"], offs)
        y = torch.empty_like(ys)
        y[order] = ys                               # back to (row, choice)
        y = (y.view(n, k, d).float() * gates[..., None]).sum(1).to(x.dtype)
        if moe_cfg.n_shared and "shared" in p:
            y = y + mlp_apply(p["shared"], xr)
    trace.count("moe_real_rows", n * k)
    if n == b * s:
        return y.view(b, s, d)
    out = x.new_zeros((b * s, d))
    out[:n] = y
    return out.view(b, s, d)
