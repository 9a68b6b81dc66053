"""What a traced run (``--trace 1``) reads from the program, and how.

* ``StepProbe`` is installed as the port's kernel profiler
  (``repro_torch.obs.profiling.install``), through whose ``profiled`` hook
  every engine step and every kernel front door already passes.  For the
  two step launches (``chunk_prefill``, ``paged_decode_step``) it keeps
  the port's own ``KernelProfiler`` split of host dispatch and device
  wait (the engine syncs after each step, so this adds no sync) and
  counts the FLOPs of the step's real rows and keys.  Kernel launches it
  passes straight through, unsynced: it only counts the bytes each needs
  while the device trace runs.
* ``DeviceTrace`` runs ``torch.profiler`` over a span of the window and
  reduces its trace to device busy time, time by kernel, and the idle
  gaps by what the host was doing.  Only these summaries are kept; the
  trace file is deleted once read.
"""

from __future__ import annotations

import bisect
import json
import re
import time
from contextlib import nullcontext
from pathlib import Path

from repro_torch.obs.profiling import KernelProfiler

STEPS = ("chunk_prefill", "paged_decode_step")
#: device kernels by the symbol of the port's CUDA sources
KERNEL_PATTERNS = {"rmsnorm": re.compile(r"\brmsnorm_kernel\b"),
                   "paged_decode_attention":
                       re.compile(r"\bpaged_decode_kernel\b")}
#: idle gaps shorter than this are launch gaps, counted in one lump
SMALL_GAP_US = 20.0


class StepProbe(KernelProfiler):
    def __init__(self, conf: dict, family, pages_per_seq: int):
        super().__init__()
        self.conf = conf
        self.family = family
        self.pages_per_seq = pages_per_seq
        self.layers = family.dims(conf)["L"]
        self.steps: list[dict] = []
        self.tracing = False
        self.kernels = {k: {"launches": 0, "bytes": 0, "flops": 0,
                            "counted": 0} for k in KERNEL_PATTERNS}

    def launch(self, name, fn, *args, **kwargs):
        if name in self.kernels:
            if self.tracing:
                self._count_kernel(name, args)
            return fn(*args, **kwargs)
        if name not in STEPS:
            return fn(*args, **kwargs)
        if name == "chunk_prefill":
            rows = int(kwargs["last"]) + 1
            prefix = int(args[2].shape[2])
            info = {"prefix": prefix, "rows": rows,
                    "flops": self.family.chunk_flops(self.conf, prefix,
                                                     rows)}
        else:
            lens = args[4].cpu().tolist()
            real = [n for n in lens if n > 0]
            info = {"rows": len(real), "batch": len(lens),
                    "flops": self.family.decode_flops(self.conf, real)}
            if self.tracing:
                keys = [n + 1 for n in lens]
                k = self.kernels["paged_decode_attention"]
                k["bytes"] += self.layers * self.family.paged_attention_bytes(
                    self.conf, keys, self.pages_per_seq)
                k["flops"] += self.layers * \
                    self.family.paged_attention_flops(self.conf, keys)
                k["counted"] += self.layers
        span = _annotate("engine." + name) if self.tracing else nullcontext()
        t0 = time.perf_counter()
        with span:
            out = super().launch(name, fn, *args, **kwargs)
        rec = self.records[-1]
        self.steps.append({"name": name, "t0": t0,
                           "t1": time.perf_counter(),
                           "dispatch_s": rec["dispatch_s"],
                           "execute_s": rec["execute_s"],
                           "traced": self.tracing, **info})
        return out

    def _count_kernel(self, name, args) -> None:
        k = self.kernels[name]
        k["launches"] += 1
        if name == "rmsnorm":
            x, scale = args[0], args[1]
            d = x.shape[-1]
            rows = x.numel() // d
            k["bytes"] += self.family.rmsnorm_bytes(rows, d, x.element_size())
            k["flops"] += self.family.rmsnorm_flops(rows, d)
            k["counted"] += 1


def _annotate(name: str):
    import torch
    return torch.profiler.record_function(name)


class Marks:
    """Named host spans for the device trace's idle-gap attribution, marked
    only while ``on`` (while the trace runs)."""

    def __init__(self):
        self.on = False

    def __call__(self, name: str):
        return _annotate(name) if self.on else nullcontext()


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name: str) -> str:
    name = re.sub(r"^void\s+|\(anonymous namespace\)::|at::native::|"
                  r"c10::", "", name)
    return name.split("(")[0][:100]


class DeviceTrace:
    """``torch.profiler`` over one span of the window (CPU and CUDA
    activity), reduced to summaries."""

    def __init__(self, path: Path):
        self.path = path
        self.prof = None
        self.summary = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        self.prof = None
        try:
            events = json.loads(self.path.read_text())["traceEvents"]
        finally:
            self.path.unlink(missing_ok=True)
        self.summary = reduce_trace(events, self.t1 - self.t0)


def reduce_trace(events, window_s: float) -> dict:
    """Device busy seconds, seconds by kernel, and idle gaps by host
    activity, from a Chrome trace's events (times in microseconds)."""
    dev, ann, ops = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append(iv)
        elif cat == "user_annotation":
            ann.append(iv)
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver"):
            ops.append(iv)
    busy = _merge([(a, b) for a, b, _ in dev])
    by_name: dict = {}
    kernel_s = {k: 0.0 for k in KERNEL_PATTERNS}
    kernel_n = {k: 0 for k in KERNEL_PATTERNS}
    for a, b, name in dev:
        s = (b - a) * 1e-6
        key = _short(name)
        by_name[key] = by_name.get(key, 0.0) + s
        for k, pat in KERNEL_PATTERNS.items():
            if pat.search(name):
                kernel_s[k] += s
                kernel_n[k] += 1
    gaps: dict = {}
    ann.sort()
    ops.sort()
    ann_starts = [a for a, _, _ in ann]
    op_starts = [a for a, _, _ in ops]
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        dur = g1 - g0
        if dur < SMALL_GAP_US:
            label = f"launch gaps under {SMALL_GAP_US:g} us"
        else:
            mid = 0.5 * (g0 + g1)
            label = (_innermost(ann, ann_starts, mid) or "harness") + ": " \
                + (_innermost(ops, op_starts, mid) or "python")
        gaps[label] = gaps.get(label, 0.0) + dur * 1e-6
    busy_s = sum(b - a for a, b in busy) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": window_s,
            "kernel_s": kernel_s, "kernel_n": kernel_n,
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in top_gaps],
            "n_device_events": len(dev)}


def _innermost(events, starts, t: float, look_back: int = 64):
    """Name of the latest-starting event that still covers ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    lo = max(-1, i - look_back)
    while i > lo:
        a, b, name = events[i]
        if a <= t <= b:
            return _short(name)
        i -= 1
    return None
