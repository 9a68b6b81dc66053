"""Front door of the batched PMF-convolution kernel.

``batched_success`` is what the scheduler's success-chance signal calls
once per scaling decision: all (task x machine-tail) chances in a single
launch.  ``pmf_conv`` launches the CUDA kernel (``csrc/pmf_conv.cu``) for
tensors on the card and takes the plain version (``ref.py``) for tensors on
the CPU.  Launches route through the (no-op by default) kernel profiler.
"""

from __future__ import annotations

import numpy as np
import torch

from ..build import check, current_stream, library, refuse_grad
from .ref import pmf_conv_ref
from ...device import resolve_device
from ...obs.profiling import profiled
from ...parallel import op_cost

__all__ = ["pmf_conv", "pmf_conv_cuda", "pack_pmfs", "batched_success"]


def pmf_conv_cuda(pet, pct, dl, cut=None):
    """The CUDA kernel.  pet (N, Le), pct (N, Lc), dl (N,) and cut (N,)
    f32 on the card -> (out (N, Lc+Le-1), success (N,)).  ``cut`` None
    cuts at ``dl``, as the Pallas kernel does.  Forward only: raises
    where autograd would record it."""
    refuse_grad("pmf_conv_cuda", pet, pct)
    n, le = pet.shape
    lc = pct.shape[1]
    if cut is None:
        cut = dl
    if pct.shape[0] != n or dl.shape != (n,) or cut.shape != (n,):
        raise ValueError("pet, pct, dl and cut must share the row count")
    for name, t in (("pet", pet), ("pct", pct), ("dl", dl), ("cut", cut)):
        if not t.is_cuda or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA float32 "
                             "tensor")
    out = torch.empty((n, lc + le - 1), dtype=torch.float32,
                      device=pet.device)
    suc = torch.empty((n,), dtype=torch.float32, device=pet.device)
    err = library().pmf_conv_f32(
        pet.data_ptr(), pct.data_ptr(), dl.data_ptr(), cut.data_ptr(),
        out.data_ptr(), suc.data_ptr(), n, le, lc, current_stream(pet.device))
    pmf_conv_cuda.launches += 1
    if op_cost.active():
        op_cost.credit("pmf_conv", (pet, pct, dl, cut), (out, suc))
    check(err, "pmf_conv")
    return out, suc


pmf_conv_cuda.launches = 0


def _pmf_conv(pet, pct, dl, cut=None):
    if pet.is_cuda:
        return pmf_conv_cuda(pet, pct, dl, cut)
    return pmf_conv_ref(pet, pct, dl, cut)


def pmf_conv(pet, pct, dl, cut=None):
    """(out, success) for a batch of PEND_DROP convolutions: the PCT cut
    at ``cut`` (default ``dl``) on its grid, the success summed to ``dl``
    on the output grid."""
    return profiled("pmf_conv", _pmf_conv, pet, pct, dl, cut)


def pack_pmfs(pmfs, length: int) -> tuple[np.ndarray, np.ndarray]:
    """Compact + pad a list of core.pmf.PMF onto a fixed grid.

    Returns (values (N, length), offsets (N,)).  Mass beyond the grid is
    folded into the last bucket (impulse compaction's max-range clamp)."""
    vals = np.zeros((len(pmfs), length), np.float32)
    offs = np.zeros((len(pmfs),), np.int64)
    for i, p in enumerate(pmfs):
        offs[i] = p.offset
        v = np.asarray(p.values, np.float32)
        if len(v) > length:
            head, tail = v[:length - 1], v[length - 1:]
            vals[i, :length - 1] = head
            vals[i, length - 1] = tail.sum()
        else:
            vals[i, :len(v)] = v
    return vals, offs


def batched_success(pets, pcts, deadlines, length: int = 128,
                    device=None) -> np.ndarray:
    """Chance-of-success for N (task, machine-tail) pairs.

    ``pets``/``pcts``: lists of PMF; ``deadlines``: absolute times.
    ``device`` None runs on CUDA.  Each row carries two indices: the PEND
    cut on the PCT grid, ``dl - pct_off`` (the previous task frees the
    machine strictly before the deadline), and the success sum's end on
    the output grid, ``dl - pet_off - pct_off`` (out[t] sits at absolute
    time pet_off + pct_off + t).  So the success is Procedure 2's
    ``core.pmf.chance_of_success`` exactly.  The JAX front door
    (``repro.kernels.pmf_conv.ops.batched_success``) folds both into the
    second index, which cuts at ``dl - pet_off`` and drops the term
    ``pet[0] * pct(dl - pet_off)``.
    """
    dev = resolve_device(device)
    n = len(pets)
    pet_v, pet_o = pack_pmfs(pets, length)
    pct_v, pct_o = pack_pmfs(pcts, length)
    dls = np.asarray(deadlines, np.int64)
    dl_idx, cut_idx = dls - pet_o - pct_o, dls - pct_o
    # pet, pct and the two indices as four segments of one buffer: one
    # copy to the device, and only the success chances come back
    host = np.concatenate([pet_v.ravel(), pct_v.ravel(),
                           np.maximum(dl_idx, -1).astype(np.float32),
                           np.maximum(cut_idx, -1).astype(np.float32)])
    buf = torch.from_numpy(host).to(dev)
    m = n * length
    _, suc = pmf_conv(buf[:m].view(n, length), buf[m:2 * m].view(n, length),
                      buf[2 * m:2 * m + n], buf[2 * m + n:])
    return suc.cpu().numpy()
