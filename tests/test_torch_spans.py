"""Timed spans, launch counters and request stamps inside the port's
serving loop (DESIGN.md §2.9), on ``device="cpu"``:

* ``Telemetry.span``: nested spans' totals and self times, the shared
  no-op span of ``NULL``, and no events;
* the batched unit runner's counters (``chunk_launches``, ``chunk_rows``,
  ``chunk_cells``, ``chunk_cells_launched``, ``chunk_attn_cells``,
  ``decode_launches``, ``decode_rows``) against the ``UnitBatch`` plans it
  ran, the shapes it launched and the tiles of the card's attention
  kernel;
* the wall stamps ``t_admit`` / ``t_first`` of the requests the runner
  answers, their difference in the histogram ``prefill_wait_s``, and no
  stamps on result-cache hits or the exclusive path;
* spans on and off give the same tokens;
* under ``torch.profiler`` with ``annotate`` set, each span is a
  ``user_annotation`` range, and ``clock_anchor`` places perf_counter
  stamps on the trace's clock.
"""

import json
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.kernels.chunk_attention.ref import attended_cells
from repro_torch.models import transformer as T
from repro_torch.obs import NULL, NullTelemetry, Telemetry, clock_anchor
from repro_torch.serving.batching import StepBatchingConfig
from repro_torch.serving.cluster import Router, make_engine_planes
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

TINY = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
            vocab=128, head_dim=32, remat=False)
BATCHING = StepBatchingConfig(max_batch=4, step_token_budget=16)
#: every span the Router, control plane, engine and unit runner open on a
#: batched run with no pruner and no handoff
SERVING_SPANS = {"router.submit", "router.step", "cp.arrive", "cp.finish",
                 "cp.map", "engine.admit", "engine.quantum", "runner.plan",
                 "runner.step", "runner.chunk_stage", "runner.kv_in",
                 "runner.chunk_launch", "runner.kv_out",
                 "runner.decode_stage", "runner.decode_launch",
                 "runner.sample", "runner.complete"}


@pytest.fixture(scope="module")
def tiny_model():
    cfg = get_arch("smollm-360m").reduced().scaled(**TINY)
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _config(**kw):
    kw = {"n_units": 1, "elasticity": None, "merging": "none",
          "pruning": None, "result_cache": False, "max_len": 96,
          "batch_buckets": (1, 2, 4), "batching": BATCHING, **kw}
    return EngineConfig(**kw)


def _prompts(n, seed=7, lo=4, hi=60):
    rng = np.random.default_rng(seed)
    return [tuple(int(x) for x in
                  rng.integers(1, 127, size=rng.integers(lo, hi)))
            for _ in range(n)]


def _busy(seconds=2e-4):
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

class TestSpan:
    def test_nested_self_times_add_up_to_the_outermost(self):
        tel = Telemetry()
        with tel.span("root"):
            _busy()
            with tel.span("a"):
                _busy()
                with tel.span("b"):
                    _busy()
            with tel.span("c"):
                _busy()
        t = tel.span_totals()
        assert {k: v["span_n"] for k, v in t.items()} == \
            {"root": 1, "a": 1, "b": 1, "c": 1}
        s = {k: v["span_s"] for k, v in t.items()}
        assert s["a"] + s["c"] <= s["root"] and s["b"] <= s["a"]
        for v in t.values():
            assert 0 < v["span_self_s"] <= v["span_s"]
        assert t["a"]["span_self_s"] == pytest.approx(s["a"] - s["b"])
        assert sum(v["span_self_s"] for v in t.values()) == \
            pytest.approx(s["root"], rel=1e-9)
        assert tel.events == [] and tel._open == []

    def test_a_name_nested_in_itself(self):
        tel = Telemetry()
        with tel.span("root"):
            with tel.span("x"):
                _busy()
                with tel.span("x"):
                    _busy()
        t = tel.span_totals()
        assert t["x"]["span_n"] == 2
        assert sum(v["span_self_s"] for v in t.values()) == \
            pytest.approx(t["root"]["span_s"], rel=1e-9)

    def test_null_span_is_one_shared_no_op(self):
        for null in (NULL, NullTelemetry()):
            s = null.span("a")
            assert s is null.span("b") is NULL.span("c")
            with s:
                with null.span("d"):
                    pass
            assert null.span_totals() == {} and null.events == []
            assert null.metrics.snapshot() == \
                {"counters": {}, "gauges": {}, "histograms": {}}

    def test_span_exits_on_an_exception(self):
        tel = Telemetry()
        with pytest.raises(KeyError):
            with tel.span("outer"):
                with tel.span("inner"):
                    raise KeyError("x")
        assert tel._open == []
        assert tel.span_totals()["inner"]["span_n"] == 1


# ---------------------------------------------------------------------------
# the batched engine: counters, stamps, tokens
# ---------------------------------------------------------------------------

def _planned_run(model, reqs, tel=None, launched=None):
    """Run ``reqs`` one a tick on a batched engine and record, for every
    step its unit runner executes, the chunks (start, rows) and decode
    rows the ``UnitBatch`` planned; ``launched`` gets the padded rows x
    keys of every chunk launch, read from its arguments."""
    cfg, params = model
    eng = ServingEngine(cfg, params, _config(), device="cpu")
    if tel is not None:
        eng.attach_telemetry(tel)
    runner = next(iter(eng._runners.values()))
    plans = []
    inner = runner.exec_step

    def exec_step(plan):
        if plan.exclusive is None:
            plans.append(([(s.prefill_done, c) for s, c in plan.chunks],
                          len(plan.decode)))
        return inner(plan)
    runner.exec_step = exec_step
    if launched is not None:
        chunk = runner._chunk

        def launch(params, toks, pk, pv, **kw):
            launched.append(toks.shape[1] * kw["kv_len"])
            return chunk(params, toks, pk, pv, **kw)
        runner._chunk = launch
    stats = eng.run([(float(i), r) for i, r in enumerate(reqs)])
    return eng, stats, plans


def test_launch_counters_equal_the_plans(tiny_model):
    reqs = [Request(prompt=p, n_new=5, deadline=1e9) for p in _prompts(6)]
    launched = []
    _, stats, plans = _planned_run(tiny_model, reqs, launched=launched)
    chunks = [pc for ch, _ in plans for pc in ch]
    assert stats["chunk_launches"] == len(chunks) > len(reqs)
    assert stats["chunk_rows"] == sum(c for _, c in chunks) == \
        sum(len(r.prompt) for r in reqs)
    assert stats["chunk_cells"] == sum(c * (p + c) for p, c in chunks)
    assert stats["decode_launches"] == sum(d > 0 for _, d in plans) > 0
    assert stats["decode_rows"] == sum(d for _, d in plans)
    # every request's first token comes from its final chunk
    assert stats["decode_rows"] == sum(r.n_new - 1 for r in reqs)
    eng_cfg = _config()
    kv_len = eng_cfg.max_len // eng_cfg.kv_block_size \
        * eng_cfg.kv_block_size + BATCHING.step_token_budget
    # counted at each launch: what the launches were handed
    assert len(launched) == len(chunks)
    assert stats["chunk_cells_launched"] == sum(launched) == \
        len(chunks) * BATCHING.step_token_budget * kv_len


def test_attention_cells_equal_the_tiles_of_the_plans(tiny_model):
    """``chunk_attn_cells`` is the kernel's tile count (``attended_cells``)
    summed over the planned chunks, above the real cells (at these 16-row
    chunks a 64 x 64 tile is larger than a launch, so no bound above)."""
    reqs = [Request(prompt=p, n_new=3, deadline=1e9)
            for p in _prompts(6, seed=11)]
    _, stats, plans = _planned_run(tiny_model, reqs)
    chunks = [pc for ch, _ in plans for pc in ch]
    assert stats["chunk_attn_cells"] == \
        sum(attended_cells(p, c) for p, c in chunks) > 0
    assert stats["chunk_cells"] < stats["chunk_attn_cells"]


def test_spans_on_and_off_give_the_same_tokens(tiny_model):
    prompts = _prompts(6, seed=3)
    off = [Request(prompt=p, n_new=4, deadline=1e9) for p in prompts]
    on = [Request(prompt=p, n_new=4, deadline=1e9) for p in prompts]
    _, s_off, _ = _planned_run(tiny_model, off)
    tel = Telemetry(wall_clock=time.perf_counter)
    _, s_on, _ = _planned_run(tiny_model, on, tel)
    assert [r.tokens for r in on] == [r.tokens for r in off]
    assert all(len(r.tokens) == 4 for r in on)
    # how the chunks interleave follows the walls; the rows do not
    for k in ("chunk_rows", "decode_rows"):
        assert s_on[k] == s_off[k], k
    totals = tel.span_totals()
    assert totals["runner.decode_launch"]["span_n"] == \
        s_on["decode_launches"]
    assert totals["runner.chunk_launch"]["span_n"] == s_on["chunk_launches"]
    assert totals["runner.step"]["span_n"] == totals["runner.plan"]["span_n"]
    # spans are counters, never events
    assert not [e for e in tel.events if "." in e["kind"]]


def test_stamps_of_runner_answers_only(tiny_model):
    """Every request the runner answers is stamped due <= t_admit <=
    t_first <= done, and its t_first - t_admit is observed into the
    histogram ``prefill_wait_s``; a result-cache hit and an exclusive
    (sampled) request are not stamped."""
    cfg, params = tiny_model
    eng = ServingEngine(cfg, params, _config(result_cache=True),
                        device="cpu")
    tel = Telemetry()
    eng.attach_telemetry(tel)
    prompts = _prompts(4, seed=5)
    reqs = [Request(prompt=p, n_new=3, deadline=1e9, session=i)
            for i, p in enumerate(prompts)]
    hit = Request(prompt=prompts[0], n_new=3, deadline=1e9, session=4)
    sampled = Request(prompt=prompts[1], n_new=3, temperature=0.7, seed=2,
                      deadline=1e9, session=5)
    done, outcome = {}, {}

    def on_complete(r, now, how):
        done[r.session], outcome[r.session] = time.perf_counter(), how
    eng.cp.on_complete = on_complete
    due = time.perf_counter()
    eng.run([(float(i), r) for i, r in enumerate(reqs)]
            + [(1e6, hit), (1e6 + 1, sampled)])
    assert outcome == {0: "done", 1: "done", 2: "done", 3: "done",
                       4: "served", 5: "done"}
    for r in reqs:
        assert due <= r.t_admit <= r.t_first <= done[r.session]
    waits = tel.metrics.histogram("prefill_wait_s")
    assert waits.count == len(reqs)
    assert waits.total == pytest.approx(
        sum(r.t_first - r.t_admit for r in reqs), rel=1e-9)
    assert hit.t_admit is hit.t_first is None and hit.tokens == reqs[0].tokens
    assert sampled.t_admit is sampled.t_first is None
    assert len(sampled.tokens) == 3


# ---------------------------------------------------------------------------
# the device trace's clock
# ---------------------------------------------------------------------------

def test_spans_annotate_the_profiler_trace(tiny_model, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    cfg, params = tiny_model
    tel = Telemetry(wall_clock=time.perf_counter)
    router = Router(make_engine_planes(cfg, params, _config(), 1,
                                       device="cpu"), telemetry=tel)
    trace = [(float(i), Request(prompt=p, n_new=3, deadline=1e9))
             for i, p in enumerate(_prompts(3, seed=9))]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tel.annotate = True
        t_anchor = clock_anchor()
        t_probe = time.perf_counter()
        with tel.span("probe"):
            _busy(1e-3)
        router.run(trace)
        tel.annotate = False
        with tel.span("after"):
            pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    names = {e["name"] for e in events}
    assert SERVING_SPANS <= names
    assert "after" not in names and "after" in tel.span_totals()
    ts = {e["name"]: float(e["ts"]) for e in events
          if e["name"] in ("clock_anchor", "probe")}
    offset = ts["clock_anchor"] - 1e6 * t_anchor
    assert abs(ts["probe"] - (1e6 * t_probe + offset)) < 200.0
    # the spans the router recorded with annotation on are counted too
    assert SERVING_SPANS <= set(tel.span_totals())


def test_an_infinite_value_lands_in_the_outermost_bin():
    """A request with no deadline completes with an infinite slack: the
    slack histogram clamps it as it clamps any value above ``hi``."""
    from repro_torch.obs import StreamingHistogram
    h = StreamingHistogram(hi=1e3)
    for v in (5.0, 2e3, float("inf"), -float("inf")):
        h.observe(v)
    assert h.pos[h._n_bins] == 2 and h.neg[h._n_bins] == 1
    assert h.count == 4 and h.vmax == float("inf")
