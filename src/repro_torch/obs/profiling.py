"""Kernel-launch profiler — dispatch-vs-execute attribution (DESIGN.md §2.9).

The port's twin of ``repro.obs.profiling``.  Each kernel front door
(``pmf_conv``, ``paged_decode_attention``, ``rmsnorm``) and each engine step
routes its call through :func:`profiled`, which is a zero-cost passthrough
until a :class:`KernelProfiler` is installed via :func:`install`.

When active, a launch is split into

  * ``dispatch_s`` — time to return from the call (PyTorch enqueues CUDA
    work asynchronously; the first call also builds the kernel), and
  * ``execute_s`` — additional time until ``torch.cuda.synchronize``
    returns (device execution of the enqueued work).  Host-only launches
    have no device work and report the sync of an idle stream.

The first launch per (kernel, shape-key) is flagged ``cold``.  ``torch`` is
imported only when a profiler is active, so the framework-free scheduling
path can import ``repro_torch.obs`` freely.
"""

from __future__ import annotations

import time

__all__ = ["KernelProfiler", "install", "profiled", "current"]

_PROFILER = None


def install(profiler) -> None:
    """Install (or with ``None``, remove) the process-wide profiler."""
    global _PROFILER
    _PROFILER = profiler


def current():
    return _PROFILER


def _shape_key(args, kwargs) -> tuple:
    parts = []
    for a in list(args) + sorted(kwargs.items(), key=lambda kv: kv[0]):
        v = a[1] if isinstance(a, tuple) and len(a) == 2 else a
        shape = getattr(v, "shape", None)
        if shape is not None:
            parts.append(("arr", tuple(shape), str(getattr(v, "dtype", ""))))
        elif isinstance(v, (int, float, bool, str, type(None))):
            parts.append(v)
        else:
            parts.append(type(v).__name__)
    return tuple(parts)


class KernelProfiler:
    """Records one dict per launch; aggregates into ``metrics`` when given
    a registry (``kernel_dispatch_s`` / ``kernel_execute_s`` histograms
    labeled by kernel name)."""

    def __init__(self, metrics=None, telemetry=None):
        self.records: list[dict] = []
        self.metrics = metrics
        self.telemetry = telemetry
        self._seen: set = set()

    def launch(self, name: str, fn, *args, **kwargs):
        key = (name, _shape_key(args, kwargs))
        cold = key not in self._seen
        self._seen.add(key)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        t1 = time.perf_counter()
        _sync()
        t2 = time.perf_counter()
        rec = {"kernel": name, "dispatch_s": t1 - t0,
               "execute_s": t2 - t1, "cold": cold}
        self.records.append(rec)
        if self.metrics is not None:
            self.metrics.observe("kernel_dispatch_s", rec["dispatch_s"],
                                 kernel=name, cold=str(cold).lower())
            self.metrics.observe("kernel_execute_s", rec["execute_s"],
                                 kernel=name)
            self.metrics.inc("kernel_launches", kernel=name)
        return out

    def summary(self) -> dict:
        out: dict = {}
        for r in self.records:
            s = out.setdefault(r["kernel"], {
                "launches": 0, "cold_launches": 0,
                "dispatch_s": 0.0, "execute_s": 0.0})
            s["launches"] += 1
            s["cold_launches"] += int(r["cold"])
            s["dispatch_s"] += r["dispatch_s"]
            s["execute_s"] += r["execute_s"]
        return out


def _sync() -> None:
    """Wait for the device work enqueued so far (where JAX's profiler calls
    ``jax.block_until_ready``); a no-op when CUDA was never initialised."""
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def profiled(name: str, fn, *args, **kwargs):
    """Route a kernel launch through the installed profiler (if any)."""
    if _PROFILER is None:
        return fn(*args, **kwargs)
    return _PROFILER.launch(name, fn, *args, **kwargs)
