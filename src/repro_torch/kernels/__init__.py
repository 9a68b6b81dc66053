"""Hand-written Hopper kernels, each beside its plain PyTorch version.

| kernel | route | source | replaces |
|---|---|---|---|
| chunked-prefill attention | CUDA C++ | ``csrc/chunk_prefill_attention.cu`` | (none: the JAX cached prefill is plain jnp ``full_attention``) |
| decode attention | CUDA C++ | ``csrc/decode_attention.cu`` | ``decode_attention_pallas`` |
| paged decode attention | CUDA C++ | ``csrc/paged_decode_attention.cu`` | ``paged_decode_attention_pallas`` |
| its latent (MLA) instance | CUDA C++ | ``csrc/paged_decode_attention.cu`` | (none: the JAX package has no latent attention) |
| RMSNorm | CUDA C++ | ``csrc/rmsnorm.cu`` | ``rmsnorm_pallas`` |
| RMSNorm backward | CUDA C++ | ``csrc/rmsnorm.cu`` | (the gradient of ``rmsnorm_pallas``; no TPU kernel) |
| PMF convolution | CUDA C++ | ``csrc/pmf_conv.cu`` | ``pmf_conv_pallas`` |

All five build from ``csrc/`` into one library (``build.py``), which also
holds ``launch_floor``, an empty kernel that times the floor of a launch.
Every front door launches its kernel for a CUDA tensor and takes the plain
version only for a tensor on the CPU.  RMSNorm is differentiable
(``rmsnorm.ops.RMSNormFunction``); the forward-only kernels raise rather
than cut an autograd graph.  Each kernel wrapper counts its own
launches in a plain integer attribute, ``<wrapper>.launches``;
``launch_counts`` reads them and ``reset_launch_counts`` zeroes them.
"""

from __future__ import annotations


def _wrappers() -> dict:
    from .chunk_attention.ops import chunk_attention_cuda
    from .decode_attention.ops import (decode_attention_cuda,
                                       paged_decode_attention_cuda,
                                       paged_mla_decode_attention_cuda)
    from .pmf_conv.ops import pmf_conv_cuda
    from .rmsnorm.ops import rmsnorm_bwd_cuda, rmsnorm_cuda
    return {"chunk_attention": chunk_attention_cuda,
            "decode_attention": decode_attention_cuda,
            "paged_decode_attention": paged_decode_attention_cuda,
            "paged_mla_decode_attention": paged_mla_decode_attention_cuda,
            "rmsnorm": rmsnorm_cuda, "rmsnorm_bwd": rmsnorm_bwd_cuda,
            "pmf_conv": pmf_conv_cuda}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
