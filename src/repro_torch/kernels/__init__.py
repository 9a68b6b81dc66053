"""Hand-written Hopper kernels, each beside its plain PyTorch version.

| kernel | route | source | replaces |
|---|---|---|---|
| decode attention | CUDA C++ | ``csrc/decode_attention.cu`` | ``decode_attention_pallas`` |
| paged decode attention | CUDA C++ | ``csrc/paged_decode_attention.cu`` | ``paged_decode_attention_pallas`` |
| RMSNorm | Triton | ``rmsnorm/rmsnorm.py`` | ``rmsnorm_pallas`` |
| PMF convolution | CUDA C++ | ``csrc/pmf_conv.cu`` | ``pmf_conv_pallas`` |

Every front door launches its kernel for a CUDA tensor and takes the plain
version only for a tensor on the CPU.  Each kernel wrapper counts its own
launches in a plain integer attribute, ``<wrapper>.launches``;
``launch_counts`` reads them and ``reset_launch_counts`` zeroes them.
"""

from __future__ import annotations


def _wrappers() -> dict:
    from .decode_attention.ops import (decode_attention_cuda,
                                       paged_decode_attention_cuda)
    from .pmf_conv.ops import pmf_conv_cuda
    from .rmsnorm.ops import rmsnorm_triton
    return {"decode_attention": decode_attention_cuda,
            "paged_decode_attention": paged_decode_attention_cuda,
            "rmsnorm": rmsnorm_triton, "pmf_conv": pmf_conv_cuda}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
