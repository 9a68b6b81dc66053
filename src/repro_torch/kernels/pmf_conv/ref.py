"""Plain PyTorch version of the batched PMF-convolution kernel.

Semantics of ``repro.kernels.pmf_conv.ref`` (dissertation Eqs. 5.2-5.5):

  inputs:  pet  (N, Le)   execution-time PMFs
           pct  (N, Lc)   previous completion-time PMFs
           dl   (N,)      deadline index on the output grid
           cut  (N,)      PEND cut index on the PCT grid (default: dl,
                          the JAX ref's one index for both)
  outputs: out  (N, Lc+Le-1) completion PMFs under PEND_DROP:
             conv(pet, pct * [t < cut]) + passthrough(pct * [t >= cut])
           success (N,)   P(complete <= dl) = sum_{t<=dl} conv part
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pmf_conv_ref(pet, pct, dl, cut=None):
    n, le = pet.shape
    lc = pct.shape[1]
    lo = lc + le - 1
    if cut is None:
        cut = dl
    t_c = torch.arange(lc, device=pct.device)[None, :]
    ok = (t_c < cut[:, None]).to(pct.dtype)
    pct_ok = pct * ok
    pct_late = pct * (1.0 - ok)
    out = _batched_conv(pet, pct_ok)
    t_o = torch.arange(lo, device=pct.device)[None, :]
    success = torch.sum(out * (t_o <= dl[:, None]), dim=1)
    out = out + F.pad(pct_late, (0, lo - lc))
    return out, torch.clamp(success, max=1.0)


def _batched_conv(pet, pct):
    """out[n, t] = sum_k pet[n, k] * pct[n, t-k], summed in increasing k."""
    n, le = pet.shape
    lc = pct.shape[1]
    lo = lc + le - 1
    pad = F.pad(pct, (0, lo - lc))
    t = torch.arange(lo, device=pct.device)[None, :]
    out = torch.zeros((n, lo), dtype=pet.dtype, device=pet.device)
    for k in range(le):
        out = out + pet[:, k:k + 1] * torch.roll(pad, k, dims=1) * (t >= k)
    return out
