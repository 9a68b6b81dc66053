"""Build and load the port's CUDA C++ kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).
Each source compiles to its own object in a parallel ``nvcc`` process; one
link makes the library.  The library's name carries a hash of the sources
and flags, so an edit rebuilds and a stale build is never loaded.  Builds
land in ``build/repro_torch_ext/`` at the repository root (ignored by git).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("chunk_prefill_attention.cu", "decode_attention.cu",
           "paged_decode_attention.cu", "pmf_conv.cu", "rmsnorm.cu")
#: headers the sources include; they enter the library's hash
HEADERS = ("decode_attention.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_ext"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
#: C signatures: every pointer and the stream as c_void_p, so ctypes never
#: truncates a 64-bit address to an int
SIGNATURES = {
    "chunk_attention_geometry": [_IP, _IP],
    "chunk_attention_bf16": [_P, _P, _P, _P, _P, _P, _L, _L, _L, _L,
                             _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "decode_attention_geometry": [_IP, _IP],
    "decode_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _F, _P],
    "paged_decode_attention_bf16": [_P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _F, _P],
    "paged_mla_decode_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _F,
                                        _P],
    "pmf_conv_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "rmsnorm_bf16": [_P, _P, _P, _I, _I, _F, _P],
    "rmsnorm_f32": [_P, _P, _P, _I, _I, _F, _P],
    "rmsnorm_bwd_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "rmsnorm_bwd_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "rmsnorm_geometry": [_I, _I, _IP, _IP],
    "launch_floor": [_P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the library; returns its
    path.  The compiler's register/shared-memory report (``-Xptxas -v``)
    is kept beside it in ``ptxas.log``."""
    lib = BUILD_DIR / f"libreprotorch_{_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for name in SOURCES:
        obj = BUILD_DIR / (Path(name).stem + f".{os.getpid()}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for name, p in zip(SOURCES, procs):
        out, _ = p.communicate()
        logs.append(f"== {name}\n{out}")
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    (BUILD_DIR / "ptxas.log").write_text("\n".join(logs))
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink(missing_ok=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def current_stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``, which every
    kernel launches on.  ``torch._C._cuda_getCurrentRawStream`` returns it
    directly (PyTorch's own generated launchers call it);
    ``torch.cuda.current_stream(device).cuda_stream`` builds a ``Stream``
    object first, the largest part of a launch's host time (PERF.md §6)."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``RuntimeError`` where autograd would record a forward-only
    kernel (grad mode on and an input requiring a gradient): its output,
    written through ctypes, would carry no ``grad_fn`` and silently cut
    the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: call it under "
                           f"torch.no_grad() or on inputs that need no "
                           f"gradient")


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
