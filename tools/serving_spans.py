#!/usr/bin/env python3
"""A benchmark cell's runs read through the program's own spans, launch
counters and request stamps:

    python3 tools/serving_spans.py --workload smollm.longdoc.backlog \\
        --seeds 11 12 13 --trace-seed 14 --seconds 51 \\
        --out build/spans.json

Every run is ``perfbench.bench.run_cell``'s, as ``perfbench/run.py`` makes
it.  An attached run differs only in what this tool wraps around it from
outside: an ``obs.Telemetry`` attached to the Router as it is built, the
span totals read at the window's two ends (where ``run_cell`` reads the
engine's stats), each record given its request's ``t_admit`` / ``t_first``
stamps, and, in a traced run, the spans annotated while the harness's
marks are on and one ``obs.clock_anchor`` at the device trace's start.
The per-layer readers under ``perfbench/metrics/`` then read that context.

* ``--seeds``: two untraced runs of each seed, one attached and one not
  (which runs first alternates from seed to seed), each with the
  ``tokens_per_s`` the benchmark counts: the cost of tracing when on.
* ``--trace-seed``: one attached ``--trace 1`` run, whose device trace
  names each idle gap by the innermost program span over it; this tool
  also sums the gaps of 20 us or more by program span.

The cost of one span on this host is timed last.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import bench, probe  # noqa: E402
from repro_torch.obs import NULL, Telemetry, clock_anchor  # noqa: E402

#: the readers of what an attached run adds to the context
READERS = ("control_plane_share", "kv_host_roundtrip_share",
           "chunk_pad_share", "decode_occupancy", "queue_wait_ms",
           "prefill_wait_ms", "prefix_insert_share")
ANCHOR = "serving_spans.anchor"


@contextmanager
def attached(box: dict):
    """Wrap ``run_cell``'s Router, Driver, marks and device trace so that
    the run records spans and stamps into ``box``."""
    tel = box["tel"] = Telemetry(wall_clock=time.perf_counter)
    box["ends"], box["events"] = [], None
    saved = (bench.build_router, bench.Driver, bench.Marks,
             probe.DeviceTrace, probe.reduce_trace)
    build_router, Driver, Marks, DeviceTrace, reduce_trace = saved

    def build(*args, **kw):
        router, plane = build_router(*args, **kw)
        router.attach_telemetry(tel)
        runner = bench._unit_runner(plane)
        box["unit"] = {"max_batch": runner.cfgb.max_batch}
        stats = plane.sub.collect_stats

        def collect_stats():
            s = stats()
            if sys._getframe(1).f_code is bench.run_cell.__code__:
                box["ends"].append((s, tel.span_totals()))
            return s
        plane.sub.collect_stats = collect_stats
        return router, plane

    class StampedDriver(Driver):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            box["reqs"] = self.reqs

    class AnnotatingMarks(Marks):
        @property
        def on(self):
            return tel.annotate

        @on.setter
        def on(self, value):
            tel.annotate = value

    class AnchoredTrace(DeviceTrace):
        def start(self):
            super().start()
            box["anchor"] = clock_anchor(ANCHOR)

    def keep_events(events, window_s):
        box["events"] = events
        return reduce_trace(events, window_s)

    (bench.build_router, bench.Driver, bench.Marks, probe.DeviceTrace,
     probe.reduce_trace) = (build, StampedDriver, AnnotatingMarks,
                            AnchoredTrace, keep_events)
    try:
        yield tel
    finally:
        (bench.build_router, bench.Driver, bench.Marks, probe.DeviceTrace,
         probe.reduce_trace) = saved
        tel.annotate = False


def idle_by_span(events: list, names: set) -> dict:
    """Idle gaps of 20 us or more in a Chrome trace, by the innermost
    program span over each gap's midpoint; ``covered_share`` is the share
    of their seconds that lies under some program span."""
    dev, ann = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append(iv)
        elif e.get("cat") == "user_annotation" and e["name"] in names:
            ann.append(iv)
    ann.sort()
    starts = [a for a, _, _ in ann]
    busy = probe._merge([(a, b) for a, b, _ in dev])
    by: dict = {}
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        if g1 - g0 < probe.SMALL_GAP_US:
            continue
        label = probe._innermost(ann, starts, 0.5 * (g0 + g1),
                                 look_back=4096) or "(no program span)"
        by[label] = by.get(label, 0.0) + (g1 - g0) * 1e-6
    idle = sum(by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1])
    return {"idle_s": idle,
            "covered_share": 1.0 - by.get("(no program span)", 0.0) / idle
            if idle else None,
            "by_span": [[k, v] for k, v in top]}


def run(cell, seed: int, seconds: float, attach: bool, trace: bool,
        device: str = "cuda", conf: dict | None = None, log=print) -> dict:
    """One ``run_cell`` run, attached or not, and what the readers read."""
    box: dict = {}
    t_start = time.perf_counter()
    if not attach:
        out = bench.run_cell(cell, seed, seconds, trace, device, t_start,
                             conf=conf, keep=True)
    else:
        with attached(box):
            out = bench.run_cell(cell, seed, seconds, trace, device,
                                 t_start, conf=conf, keep=True)
    keep = out.pop("_keep")
    res = {"seed": seed, "attached": attach, "traced": trace,
           "correct": out["correct"],
           "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
    if "breakdown" in out:
        res["idle_gaps"] = out["breakdown"]["idle_gaps"]
    if attach:
        (stats0, spans0), (stats1, spans1) = box["ends"]
        records = keep["records"]
        for r in records:
            q = box["reqs"][r["index"]]
            r["admit"], r["first"] = q.t_admit, q.t_first
        ctx = {"w0": keep["w0"], "w1": keep["w1"],
               "window_s": keep["w1"] - keep["w0"], "records": records,
               "stats0": stats0, "stats1": stats1, "unit": box["unit"],
               "spans0": spans0, "spans1": spans1}
        res["readings"] = {name: bench.load_module(
            bench.PB / "metrics" / f"{name}.py", "serving_spans_" + name)
            .read(ctx) for name in READERS}
        res["spans"] = {k: {c: v[c] - spans0.get(k, {}).get(c, 0)
                            for c in v} for k, v in spans1.items()}
        if box["events"] is not None:
            anchor = next(e for e in box["events"]
                          if e.get("name") == ANCHOR
                          and e.get("cat") == "user_annotation")
            res["clock_offset_us"] = \
                float(anchor["ts"]) - 1e6 * box["anchor"]
            res["program"] = idle_by_span(box["events"], set(spans1))
    log(json.dumps({k: v for k, v in res.items() if k != "spans"}))
    return res


def span_cost_us(n: int = 200_000) -> dict:
    """Wall of one span on this host: a real recorder's (annotate off),
    ``NULL``'s, and the bare loop's, in microseconds."""
    tel = Telemetry()
    out = {}
    for name, ctx in (("loop", None), ("null", NULL), ("real", tel)):
        t0 = time.perf_counter()
        if ctx is None:
            for _ in range(n):
                pass
        else:
            for _ in range(n):
                with ctx.span("bench"):
                    pass
        out[name] = 1e6 * (time.perf_counter() - t0) / n
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="smollm.longdoc.backlog")
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--trace-seed", type=int, default=None)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("serving_spans: no CUDA card")
    cell = bench.Cell(bench.load_json(ROOT / "BENCHMARK.json"),
                      args.workload)
    log = lambda s: print(s, flush=True)  # noqa: E731
    result = {"device": torch.cuda.get_device_name(0),
              "workload": args.workload, "seconds": args.seconds,
              "windows": []}
    for i, seed in enumerate(args.seeds):
        for attach in ((True, False) if i % 2 == 0 else (False, True)):
            result["windows"].append(run(cell, seed, args.seconds, attach,
                                         False, log=log))
    if args.trace_seed is not None:
        result["windows"].append(run(cell, args.trace_seed, args.seconds,
                                     True, True, log=log))
    result["span_cost_us"] = span_cost_us()
    log(json.dumps({"span_cost_us": result["span_cost_us"]}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
