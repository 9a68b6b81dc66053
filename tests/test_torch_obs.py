"""The port's twin of ``tests/test_obs.py`` (DESIGN.md §2.9), on
``device="cpu"``: streaming-histogram error bounds vs numpy, metrics
registry + exporter formats, zero-perturbation of the telemetry recorder on
both substrates, sim<->engine event-stream diffability, decision
attribution (drop/defer reason + chance-of-success at decision time), the
kernel-profiler seam, the unified engine completion/drop accounting (one
path for cache hits, executions and drops), and the schema CLI as
``python -m repro_torch.obs.schema``.

Every engine and simulator runs with stub execution on ``device="cpu"``,
which ``torch_jax_side.PORT`` passes to each one it builds.
The zero-perturbation cases also run JAX's
``repro.core.simulation.Simulator`` on the same tasks, fleet, oracle and
seed: the port's ``ControlPlane.trace`` equals JAX's with telemetry on and
off, and the port's comparable event stream equals JAX's.
"""

import json
import math
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.obs import (MetricsRegistry, NullTelemetry,
                             StreamingHistogram, Telemetry, chrome_trace,
                             validate_chrome_trace, validate_metrics_snapshot,
                             write_chrome_trace, write_jsonl, write_metrics)
from repro_torch.obs import profiling
from repro_torch.serving.engine import Request
from repro_torch.serving.kvcache import PrefixKVCache
from torch_jax_side import JAX, PORT


# ---------------------------------------------------------------------------
# trace helpers (the decision-equivalence idiom from test_controlplane.py)
# ---------------------------------------------------------------------------

# pruning-heavy configuration: the trace below produces merges, defers,
# pruner drops (with chance attribution), expirations and deadlock drains
PRUNED_CFG = dict(heuristic="MSD", merging="conservative",
                  position_finder=None,
                  pruning=dict(initial_defer_threshold=0.1,
                               base_drop_threshold=0.3,
                               dynamic_defer=True))
MERGE_CFG = dict(heuristic="EDF", merging="adaptive", position_finder=None,
                 pruning=None)


def _stub_engine(trace, tel=None, cfg_kw=PRUNED_CFG, n_units=1):
    eng = PORT.stub_engine(n_units=n_units, tel=tel, **cfg_kw)
    return eng, eng.run(trace)


def _sim(trace, tel=None, cfg_kw=PRUNED_CFG, side=PORT):
    return side.simulate(trace, fleet=1, tel=tel, **cfg_kw)


def _jax_sim(tel=None, cfg_kw=PRUNED_CFG, **trace_kw):
    """JAX's simulator on the reference's trace: the referee of the
    port's decisions and events."""
    return _sim(JAX.request_trace(**trace_kw), tel, cfg_kw, side=JAX)


# ---------------------------------------------------------------------------
# streaming histogram
# ---------------------------------------------------------------------------

class TestStreamingHistogram:
    @pytest.mark.parametrize("dist", ["lognormal", "uniform", "exponential"])
    def test_quantiles_match_numpy_within_sketch_error(self, dist):
        rng = np.random.default_rng(0)
        vals = {"lognormal": rng.lognormal(0.0, 2.0, 5000),
                "uniform": rng.uniform(0.001, 100.0, 5000),
                "exponential": rng.exponential(10.0, 5000)}[dist]
        h = StreamingHistogram()
        for v in vals:
            h.observe(float(v))
        for q in (0.5, 0.9, 0.95, 0.99):
            exact = float(np.percentile(vals, q * 100,
                                        method="inverted_cdf"))
            got = h.quantile(q)
            # the true order statistic lands in some bin; the reported
            # geometric midpoint is off by at most a factor sqrt(growth)
            assert got == pytest.approx(exact, rel=h.growth - 1.0)

    def test_negative_values_keep_sign_structure(self):
        """Slack distributions straddle zero: quantiles of a symmetric
        sample must come out signed and ordered."""
        rng = np.random.default_rng(1)
        vals = np.concatenate([rng.exponential(5.0, 1000),
                               -rng.exponential(5.0, 1000)])
        h = StreamingHistogram()
        for v in vals:
            h.observe(float(v))
        assert h.quantile(0.05) < 0 < h.quantile(0.95)
        qs = [h.quantile(q) for q in (0.1, 0.3, 0.5, 0.7, 0.9)]
        assert qs == sorted(qs)
        assert h.mean == pytest.approx(float(vals.mean()), abs=1e-9)

    def test_empty_and_summary(self):
        h = StreamingHistogram()
        assert h.quantile(0.5) == 0.0
        s = h.summary()
        assert s["count"] == 0 and s["mean"] == 0.0
        h.observe(2.0)
        s = h.summary()
        assert set(s) == {"count", "mean", "min", "max", "p50", "p95", "p99"}
        assert s["count"] == 1 and s["min"] == s["max"] == 2.0

    def test_near_zero_collapses_and_clamps(self):
        h = StreamingHistogram(lo=1e-3, hi=1e3)
        h.observe(1e-9)          # below resolution floor -> zero bin
        h.observe(1e9)           # above hi -> clamped to outermost bin
        assert h.quantile(0.0) == 0.0
        assert h.quantile(1.0) <= 1e3 * h.growth ** 2

    def test_validates_params(self):
        with pytest.raises(ValueError):
            StreamingHistogram(lo=0.0)
        with pytest.raises(ValueError):
            StreamingHistogram(growth=1.0)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

class TestMetricsRegistry:
    def test_label_order_never_matters(self):
        m = MetricsRegistry()
        m.inc("drops", reason="pruned", plane=0)
        m.inc("drops", plane=0, reason="pruned")
        assert m.counter_value("drops", reason="pruned", plane=0) == 2

    def test_snapshot_validates_and_roundtrips(self):
        m = MetricsRegistry()
        m.inc("completed", 3)
        m.gauge("queue_depth", 7, plane=1)
        for v in (0.5, 1.0, 2.0):
            m.observe("latency", v)
        snap = m.snapshot()
        validate_metrics_snapshot(snap)
        snap2 = json.loads(json.dumps(snap))     # JSON-serializable
        assert snap2["counters"]["completed"] == 3
        assert snap2["gauges"]['queue_depth{plane="1"}'] == 7
        assert snap2["histograms"]["latency"]["count"] == 3

    def test_prometheus_exposition_format(self):
        m = MetricsRegistry()
        m.inc("drops", 2, reason="pruned")
        m.observe("latency", 1.0)
        text = m.to_prometheus()
        assert "# TYPE drops counter" in text
        assert 'drops{reason="pruned"} 2' in text
        assert "# TYPE latency summary" in text
        assert 'quantile="0.99"' in text
        assert "latency_count 1" in text
        assert text.endswith("\n")


# ---------------------------------------------------------------------------
# zero-perturbation + substrate diffability (the tentpole's core claims)
# ---------------------------------------------------------------------------

HOT = dict(n=40, deadline=20.0, rate=2.0)


class TestZeroPerturbation:
    @pytest.mark.parametrize("cfg_kw", [MERGE_CFG, PRUNED_CFG],
                             ids=["edf-adaptive", "msd-pruned"])
    def test_engine_decisions_identical_on_off(self, cfg_kw):
        trace = PORT.request_trace(**HOT)
        eng_on, st_on = _stub_engine(trace, Telemetry(), cfg_kw)
        eng_off, st_off = _stub_engine(trace, None, cfg_kw)
        assert eng_on.cp.trace == eng_off.cp.trace
        assert {k: v for k, v in st_on.items() if "wall" not in k} == \
            {k: v for k, v in st_off.items() if "wall" not in k}
        jax_sim, _ = _jax_sim(None, cfg_kw, **HOT)
        assert eng_on.cp.trace == jax_sim.cp.trace

    @pytest.mark.parametrize("cfg_kw", [MERGE_CFG, PRUNED_CFG],
                             ids=["edf-adaptive", "msd-pruned"])
    def test_simulator_decisions_identical_on_off(self, cfg_kw):
        trace = PORT.request_trace(**HOT)
        sim_on, _ = _sim(trace, Telemetry(), cfg_kw)
        sim_off, _ = _sim(trace, None, cfg_kw)
        assert sim_on.cp.trace == sim_off.cp.trace
        jax_on, _ = _jax_sim(JAX.Telemetry(), cfg_kw, **HOT)
        jax_off, _ = _jax_sim(None, cfg_kw, **HOT)
        assert sim_on.cp.trace == jax_on.cp.trace == jax_off.cp.trace

    def test_sim_and_engine_event_streams_diff_clean(self):
        """The same trace through the same oracle on both substrates emits
        *identical* comparable event streams — the trace-equivalence story
        extended to telemetry (engine wall stamps are stripped) — and JAX's
        simulator emits the same stream."""
        trace = PORT.request_trace(**HOT)
        tel_e, tel_s = Telemetry(wall_clock=None), Telemetry()
        _stub_engine(trace, tel_e)
        _sim(trace, tel_s)
        assert tel_e.comparable_events() == tel_s.comparable_events()
        assert len(tel_e.events) > 100       # the diff is not vacuous
        tel_j = JAX.Telemetry()
        _jax_sim(tel_j, PRUNED_CFG, **HOT)
        assert tel_s.comparable_events() == tel_j.comparable_events()

    def test_wall_stamps_ride_along_but_never_compare(self):
        import time
        trace = PORT.request_trace(n=10)
        tel = Telemetry(wall_clock=time.perf_counter)
        _stub_engine(trace, tel, MERGE_CFG)
        assert all("wall" in e for e in tel.events)
        assert all("wall" not in e for e in tel.comparable_events())

    def test_null_telemetry_records_nothing(self):
        trace = PORT.request_trace(n=10)
        null = NullTelemetry()
        _stub_engine(trace, null, MERGE_CFG)
        assert null.events == [] and null.comparable_events() == []
        assert null.metrics.snapshot() == \
            {"counters": {}, "gauges": {}, "histograms": {}}


class TestDecisionAttribution:
    @pytest.fixture(scope="class")
    def pruned_run(self):
        tel = Telemetry()
        _, stats = _stub_engine(
            PORT.request_trace(n=40, deadline=20.0, rate=2.0), tel)
        return tel, stats

    def test_drop_events_carry_reason_per_request(self, pruned_run):
        tel, stats = pruned_run
        drops = tel.events_of("drop")
        assert len(drops) == stats["dropped"]
        known = {"pruned", "evicted_running", "infeasible",
                 "expired_at_start", "deadlock", "dropped"}
        assert {e["reason"] for e in drops} <= known
        reasons = {e["reason"] for e in drops}
        assert "pruned" in reasons and "infeasible" in reasons

    def test_pruned_drops_carry_chance_and_threshold(self, pruned_run):
        tel, _ = pruned_run
        pruned = [e for e in tel.events_of("drop")
                  if e["reason"] == "pruned"]
        assert pruned
        for e in pruned:
            assert 0.0 <= e["chance"] <= e["threshold"] <= 1.0

    def test_defer_events_carry_chance_and_threshold(self, pruned_run):
        tel, stats = pruned_run
        defers = tel.events_of("defer")
        assert len(defers) == stats["deferred"]
        for e in defers:
            assert e["chance"] < e["threshold"]

    def test_lifecycle_accounting_closes(self, pruned_run):
        """Every arrived request terminates exactly once (complete|drop),
        and the event stream agrees with the engine's own counters."""
        tel, stats = pruned_run
        arrived = {e["req"] for e in tel.events_of("arrive")}
        completed = {e["req"] for e in tel.events_of("complete")}
        dropped = {e["req"] for e in tel.events_of("drop")}
        assert completed | dropped == arrived
        assert not (completed & dropped)
        assert len(completed) == stats["completed"]
        on_time = [e for e in tel.events_of("complete") if e["on_time"]]
        assert len(on_time) == stats["on_time"]
        for e in tel.events_of("complete"):
            assert e["on_time"] == (e["slack"] >= 0)

    def test_quantile_metrics_populated(self, pruned_run):
        tel, _ = pruned_run
        snap = tel.metrics.snapshot()
        for name in ("latency", "queue_wait", "slack"):
            assert snap["histograms"][name]["count"] > 0
        assert "pruning_wall_s" in snap["gauges"]
        assert snap["gauges"]["pruning_wall_s"] > 0.0

    def test_merge_savings_measured_per_fanout(self):
        tel = Telemetry()
        _, stats = _stub_engine(PORT.request_trace(n=40), tel, MERGE_CFG)
        assert stats["merges"] > 0
        savings = tel.events_of("merge_saving")
        assert savings
        for e in savings:
            # one execution served `fanout` requests: measured duration x
            # (fanout-1) duplicate executions avoided
            assert e["fanout"] > 1 and e["saving"] > 0.0
        h = tel.metrics.histogram("merge_saving")
        assert h.count == len(savings)


# ---------------------------------------------------------------------------
# unified completion/drop accounting (satellite: one path for every outcome)
# ---------------------------------------------------------------------------

class TestUnifiedAccounting:
    def test_mixed_complete_drop_trace_pins_counts(self):
        """Regression pin for the double-accounting fix: on a drop-heavy
        trace the four buckets partition exactly (completed = on_time +
        missed; every request lands in exactly one of completed/dropped)."""
        _, stats = _stub_engine(PORT.request_trace(n=40, deadline=20.0,
                                                   rate=2.0))
        assert stats["completed"] + stats["dropped"] == 40
        assert stats["on_time"] + stats["missed"] == stats["completed"]
        assert stats["dropped"] > 0 and stats["missed"] > 0
        # pinned counts: these move only if scheduling semantics change
        assert (stats["on_time"], stats["missed"], stats["dropped"]) == \
            (3, 7, 30)

    def test_late_result_cache_hit_counts_missed(self):
        """A result-cache hit served past its deadline is a missed request
        (simulator semantics) — previously it was silently uncounted."""
        eng = PORT.stub_engine(n_units=1, result_cache=True,
                               merging="none", pruning=None)
        prompt = (1, 2, 3)
        req0 = Request(prompt=prompt, op="generate", n_new=2, deadline=100.0)
        eng.cache[(req0.prompt, req0.op, req0.params_sig)] = [7, 8]
        on_time = Request(prompt=prompt, op="generate", n_new=2,
                          deadline=100.0)
        late = Request(prompt=prompt, op="generate", n_new=2, deadline=5.0)
        assert eng.ingest(on_time, now=10.0) is None      # hit, in time
        assert eng.ingest(late, now=10.0) is None         # hit, late
        assert eng.stats["cache_hits"] == 2
        assert eng.stats["completed"] == 2
        assert eng.stats["on_time"] == 1
        assert eng.stats["missed"] == 1
        assert late.status == "done" and late.tokens == [7, 8]


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

class TestExporters:
    @pytest.fixture(scope="class")
    def run_events(self):
        tel = Telemetry()
        _, stats = _stub_engine(
            PORT.request_trace(n=40, deadline=20.0, rate=2.0), tel, n_units=2)
        return tel, stats

    def test_chrome_trace_schema_and_tracks(self, run_events):
        tel, _ = run_events
        trace = chrome_trace(tel.events)
        validate_chrome_trace(trace)
        evs = trace["traceEvents"]
        machine_tracks = [e for e in evs
                          if e["ph"] == "M" and e["name"] == "thread_name"
                          and e["args"]["name"].startswith("machine")]
        # one named track per machine that executed (engine mids from 1)
        assert {e["args"]["name"] for e in machine_tracks} == \
            {"machine 1", "machine 2"}
        execs = [e for e in evs if e["ph"] == "X"]
        assert len(execs) == len(tel.events_of("exec_end"))
        assert all(e["dur"] >= 0 for e in execs)
        # exec spans land on the machine's own track
        assert {e["tid"] for e in execs} == {1, 2}

    def test_chrome_trace_lifecycle_spans_pair_up(self, run_events):
        tel, _ = run_events
        evs = chrome_trace(tel.events)["traceEvents"]
        opens = [e["id"] for e in evs if e["ph"] == "b"]
        closes = [e["id"] for e in evs if e["ph"] == "e"]
        assert sorted(opens) == sorted(closes)    # every request terminates
        drops = [e for e in evs if e["ph"] == "i" and e["name"] == "drop"]
        assert drops and all("reason" in e["args"] for e in drops)

    def test_jsonl_roundtrip(self, run_events, tmp_path):
        tel, _ = run_events
        p = tmp_path / "events.jsonl"
        write_jsonl(tel.events, p)
        back = [json.loads(line) for line in p.read_text().splitlines()]
        assert back == tel.events

    def test_metrics_writer_picks_format_by_suffix(self, run_events,
                                                   tmp_path):
        tel, _ = run_events
        write_metrics(tel.metrics, tmp_path / "m.prom")
        write_metrics(tel.metrics, tmp_path / "m.json")
        assert "# TYPE" in (tmp_path / "m.prom").read_text()
        snap = json.loads((tmp_path / "m.json").read_text())
        validate_metrics_snapshot(snap)

    def test_schema_cli_validates_and_rejects(self, run_events, tmp_path):
        tel, _ = run_events
        good_trace = tmp_path / "trace.json"
        good_metrics = tmp_path / "metrics.json"
        write_chrome_trace(tel.events, good_trace)
        write_metrics(tel.metrics, good_metrics)
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"traceEvents": [{"ph": "?"}]}))
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.schema",
             str(good_trace), str(good_metrics)],
            capture_output=True, text=True)
        assert out.returncode == 0, out.stdout
        assert "chrome-trace" in out.stdout
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.schema", str(bad)],
            capture_output=True, text=True)
        assert out.returncode == 1 and "INVALID" in out.stdout

    def test_virtual_clock_scaling(self):
        tel = Telemetry()
        tel.event(2.0, "exec_start", task=0, machine=1)
        tel.event(3.0, "exec_end", task=0, machine=1)
        evs = chrome_trace(tel.events, us_per_unit=1e4)["traceEvents"]
        span = [e for e in evs if e["ph"] == "X"][0]
        assert span["ts"] == pytest.approx(2e4)
        assert span["dur"] == pytest.approx(1e4)


# ---------------------------------------------------------------------------
# KV-cache events
# ---------------------------------------------------------------------------

class TestKVCacheTelemetry:
    def test_lookup_insert_evict_events(self):
        tel = Telemetry()
        cache = PrefixKVCache(n_blocks=2, block_size=4)
        cache.tel = tel
        cache.tel_attrs = {"plane": 0, "machine": 3}
        toks = tuple(range(8))
        assert not cache.lookup(toks)                       # miss
        cache.insert(toks)                                  # 2 blocks
        hit = cache.lookup(toks)
        assert hit.n_tokens == 8
        cache.release(hit)
        cache.insert(tuple(range(100, 108)))                # forces eviction
        kinds = [e["kind"] for e in tel.events]
        assert kinds.count("kv_lookup") == 2
        assert "kv_insert" in kinds and "kv_evict" in kinds
        assert all(e["machine"] == 3 for e in tel.events)
        miss, got = tel.events_of("kv_lookup")
        assert miss["hit"] is False and got["hit"] is True
        assert got["blocks"] == 2 and got["tokens"] == 8
        assert tel.metrics.counter_value("kv_hits") == 1
        assert tel.metrics.counter_value("kv_misses") == 1

    def test_engine_attach_reaches_per_unit_caches(self):
        """attach_telemetry wires every existing unit cache; the sim mirror
        is covered by the stream-diff test above."""
        eng = PORT.stub_engine(n_units=2, prefix_cache=True,
                               merging="none", pruning=None)
        tel = Telemetry()
        eng.attach_telemetry(tel, plane=5)
        assert eng.cp.plane_id == 5
        for mid, cache in eng.kvcaches.items():
            assert cache.tel is tel
            assert cache.tel_attrs == {"plane": 5, "machine": mid}


# ---------------------------------------------------------------------------
# kernel profiler seam (no JAX: profiled() wraps plain callables too)
# ---------------------------------------------------------------------------

class TestKernelProfiler:
    def teardown_method(self):
        profiling.install(None)

    def test_passthrough_without_profiler(self):
        assert profiling.current() is None
        assert profiling.profiled("f", lambda x: x + 1, 2) == 3

    def test_launch_records_and_flags_cold(self):
        m = MetricsRegistry()
        prof = profiling.KernelProfiler(metrics=m)
        profiling.install(prof)
        a = np.zeros((4, 8), np.float32)
        assert profiling.profiled("conv", np.sum, a) == 0.0
        profiling.profiled("conv", np.sum, a)           # same shape: warm
        profiling.profiled("conv", np.sum, np.zeros((2, 2)))  # new shape
        assert [r["cold"] for r in prof.records] == [True, False, True]
        assert all(r["dispatch_s"] >= 0 and r["execute_s"] >= 0
                   for r in prof.records)
        s = prof.summary()
        assert s["conv"]["launches"] == 3
        assert s["conv"]["cold_launches"] == 2
        assert m.counter_value("kernel_launches", kernel="conv") == 3
        assert m.histogram("kernel_dispatch_s", kernel="conv",
                           cold="true").count == 2

    def test_shape_key_separates_dtypes(self):
        prof = profiling.KernelProfiler()
        profiling.install(prof)
        profiling.profiled("k", np.sum, np.zeros(4, np.float32))
        profiling.profiled("k", np.sum, np.zeros(4, np.int32))
        assert [r["cold"] for r in prof.records] == [True, True]


# ---------------------------------------------------------------------------
# histogram error bound sanity directly against the sketch guarantee
# ---------------------------------------------------------------------------

def test_relative_error_bound_holds_pointwise():
    """For any in-range positive value, the bin representative is within a
    factor sqrt(growth) of the value — the sketch's advertised bound."""
    h = StreamingHistogram(lo=1e-4, hi=1e6, growth=1.05)
    rng = np.random.default_rng(7)
    for v in rng.lognormal(0.0, 3.0, 500):
        v = float(np.clip(v, 2e-4, 5e5))
        g = StreamingHistogram(lo=h.lo, hi=h.hi, growth=h.growth)
        g.observe(v)
        rep = g.quantile(0.5)
        assert abs(math.log(rep / v)) <= math.log(h.growth) / 2 + 1e-12
