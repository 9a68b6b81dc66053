"""Plain PyTorch version of the fused RMSNorm kernel."""

from __future__ import annotations

import torch


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    """f32 mean of squares, ``rsqrt(var + eps)``, cast to x's dtype, then
    times ``scale`` — the cast order of ``repro.models.layers.rmsnorm``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rmsnorm_bwd_ref(x, scale, g, eps: float = 1e-5):
    """The gradient of ``rmsnorm_ref`` written out, in f32 inside:
    (dx in x's dtype, dscale in scale's dtype) for the output's gradient
    ``g``.  With r = rsqrt(mean(x * x) + eps) and dn = g * scale,
    dx = r * (dn - x * r^2 * mean(dn * x)), and dscale sums
    g * cast(x * r) (the forward's cast) over every row."""
    xf, gf = x.float(), g.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    dn = gf * scale.float()
    c = r * r * (dn * xf).mean(dim=-1, keepdim=True)
    dx = r * (dn - xf * c)
    n = (xf * r).to(x.dtype).float()
    dscale = (gf * n).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
