"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on.

    ``None`` means CUDA: the port targets the card, and a host without one
    raises instead of falling back to the CPU.  Pass ``device="cpu"`` to
    run the plain PyTorch versions of the kernels on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port on the host")
    return dev
