"""The readers of the unit runner's launch counters, spans and request
stamps, and what the program's own spans give a later harness: on a tiny
CPU run of a cell the readers return a number, and nothing where the
counters, spans or stamps are missing (a program without them, or a run
with no Telemetry attached); ``tools/serving_spans.py`` reads all six
from a ``run_cell`` run it wraps from outside; the runner's launch spans
count the step launches the harness's ``StepProbe`` records over the same
window; and the device trace's reduction names an idle gap by the
innermost program span."""

import importlib.util
import time

import pytest

from perfbench import bench
from perfbench.probe import Marks, StepProbe, reduce_trace
from perfbench.traffic import Traffic
from tiny import tiny_cell

NEW = ("chunk_pad_share", "decode_occupancy")
#: readers with no BENCHMARK.json entry yet: ``run_cell`` gives them no
#: spans or stamps, ``tools/serving_spans.py`` does
SPAN_READERS = ("control_plane_share", "kv_host_roundtrip_share",
                "queue_wait_ms", "prefill_wait_ms")


def _reader(name):
    return bench.load_module(bench.PB / "metrics" / f"{name}.py",
                             "test_reader_" + name)


def _tool():
    path = bench.ROOT / "tools" / "serving_spans.py"
    spec = importlib.util.spec_from_file_location("serving_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cell():
    return bench.Cell(bench.load_json(bench.ROOT / "BENCHMARK.json"),
                      "smollm.longdoc.backlog")


def test_readers_read_a_tiny_traced_run():
    cell, conf = tiny_cell("smollm.longdoc.backlog")
    out = bench.run_cell(cell, 2**31 + 17, 1.5, True, "cpu",
                         time.perf_counter(), conf=conf)
    for name in NEW:
        assert 0.0 < out["metrics"][name]["value"] <= 100.0, name
        assert out["metrics"][name]["unit"] == "%"


def test_readers_without_counters_read_nothing():
    readers = _cell().readers
    unit = {"max_batch": 32, "c_pad": 2048}
    # the parent's engine keeps none of these counters
    bare = {"completed": 3, "prefill_tokens": 100}
    for name in NEW:
        assert readers[name].read({"stats0": bare, "stats1": bare,
                                   "unit": unit}) is None
    s0 = {"chunk_cells": 10, "chunk_cells_launched": 40,
          "decode_rows": 7, "decode_launches": 1}
    idle = {"stats0": s0, "stats1": dict(s0), "unit": unit}
    for name in NEW:
        assert readers[name].read(idle) is None
    s1 = {"chunk_cells": 40, "chunk_cells_launched": 160,
          "decode_rows": 7 + 48, "decode_launches": 3}
    ctx = {"stats0": s0, "stats1": s1, "unit": unit}
    assert readers["chunk_pad_share"].read(ctx) == pytest.approx(75.0)
    assert readers["decode_occupancy"].read(ctx) == pytest.approx(75.0)


def test_span_readers_read_nothing_without_spans_or_stamps():
    ctx = {"w0": 0.0, "w1": 2.0, "records": [
        {"due": 0.1, "done": 1.0, "index": 0}]}
    for name in SPAN_READERS:
        assert _reader(name).read(ctx) is None, name
    ctx.update(spans0={}, spans1={})
    for name in SPAN_READERS:
        assert _reader(name).read(ctx) is None, name


def test_span_readers_arithmetic():
    def tot(self_s):
        return {"span_s": self_s, "span_self_s": self_s, "span_n": 1}
    spans0 = {"router.step": tot(0.1), "runner.kv_in": tot(0.2)}
    spans1 = {"router.step": tot(0.3), "cp.map": tot(0.1),
              "runner.kv_in": tot(0.4), "runner.kv_out": tot(0.1),
              "runner.step": tot(1.0)}
    records = [  # admitted and first token in the window, or not
        {"due": 0.5, "admit": 1.0, "first": 1.5},
        {"due": 1.0, "admit": 1.2, "first": 2.5},
        {"due": -1.0, "admit": -0.5, "first": 0.5},
        {"due": 1.5, "admit": None, "first": None}]
    ctx = {"w0": 0.0, "w1": 2.0, "spans0": spans0, "spans1": spans1,
           "records": records}
    assert _reader("control_plane_share").read(ctx) == pytest.approx(15.0)
    assert _reader("kv_host_roundtrip_share").read(ctx) == \
        pytest.approx(15.0)
    assert _reader("queue_wait_ms").read(ctx) == pytest.approx(350.0)
    assert _reader("prefill_wait_ms").read(ctx) == pytest.approx(750.0)


def test_the_tool_reads_all_six_from_a_wrapped_run():
    tool = _tool()
    saved = (bench.build_router, bench.Driver, bench.Marks)
    cell, conf = tiny_cell("smollm.longdoc.backlog")
    res = tool.run(cell, 2**31 + 29, 1.5, True, False, device="cpu",
                   conf=conf, log=lambda s: None)
    assert (bench.build_router, bench.Driver, bench.Marks) == saved
    assert res["correct"] and res["metrics"]["tokens_per_s"] > 0
    r = res["readings"]
    assert set(r) == set(tool.READERS)
    for name in ("control_plane_share", "kv_host_roundtrip_share",
                 "chunk_pad_share", "decode_occupancy"):
        assert 0.0 < r[name] < 100.0, name
    assert r["queue_wait_ms"] > 0.0 and r["prefill_wait_ms"] > 0.0
    assert res["spans"]["runner.chunk_launch"]["span_n"] > 0
    bare = tool.run(cell, 2**31 + 29, 1.0, False, False, device="cpu",
                    conf=conf, log=lambda s: None)
    assert "readings" not in bare and bare["metrics"]["tokens_per_s"] > 0


def test_launch_spans_count_the_probes_steps():
    from repro_torch.obs import NULL, Telemetry, profiling
    cell, conf = tiny_cell("smollm.longdoc.backlog")
    params = cell.family.make_weights(conf, 5, "cpu")
    router, plane = bench.build_router(cell, conf, params, "cpu")
    runner = bench._unit_runner(plane)
    drv = bench.Driver(router, plane, Traffic(cell.mix, 5, conf["vocab_size"]),
                       int(cell.settings["clients"]), Marks())
    drv.open()
    drv.pump(time.perf_counter() + 0.3)
    probe = StepProbe(conf, cell.family, runner.mp)
    tel = Telemetry()
    profiling.install(probe)
    router.attach_telemetry(tel)
    kinds = {"chunk_prefill", "paged_decode_step"}
    try:
        # until the probe has seen both launches (a loaded host is slow)
        drv.pump(time.perf_counter() + 120.0, stop=lambda now: kinds
                 <= {s["name"] for s in probe.steps})
    finally:
        router.attach_telemetry(NULL)
        profiling.install(None)
    spans = tel.span_totals()
    for span, step in (("runner.chunk_launch", "chunk_prefill"),
                       ("runner.decode_launch", "paged_decode_step")):
        n = sum(s["name"] == step for s in probe.steps)
        assert n > 0 and spans[span]["span_n"] == n, span
    assert plane.cp.tel is NULL and router.tel is NULL


def test_an_idle_gap_takes_the_innermost_program_span():
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    events = [x("k0", "kernel", 0.0, 10.0), x("k1", "kernel", 100.0, 10.0),
              x("harness.router_step", "user_annotation", 0.0, 200.0),
              x("runner.step", "user_annotation", 5.0, 150.0),
              x("runner.kv_out", "user_annotation", 20.0, 70.0)]
    sm = reduce_trace(events, 1e-3)
    assert sm["idle_gaps"] == [["runner.kv_out: python",
                                pytest.approx(90e-6)]]
