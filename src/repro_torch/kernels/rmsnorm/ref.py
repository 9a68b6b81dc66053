"""Plain PyTorch version of the fused RMSNorm kernel."""

from __future__ import annotations

import torch


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    """f32 mean of squares, ``rsqrt(var + eps)``, cast to x's dtype, then
    times ``scale`` — the cast order of ``repro.models.layers.rmsnorm``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale
