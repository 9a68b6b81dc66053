"""The port's record → fit → replay loop (``repro_torch.obs.fit`` and
``repro_torch.obs.replay``) on its stub engine, and against the JAX
package's on the same record.

* The twins of ``tests/test_obs_loop.py``'s ``TestControlReplay`` (the
  control replay under the recording's own oracle matches the recorded
  decisions exactly, at 0.0 drift; a wrapped ring aligns on its suffix; a
  record without machines fails loudly) and ``TestFittedReplay`` (the
  span fit, the fitted replay's drift within the reference's 15%, the
  snapshot rates), all on the port's stub engine and ``FlightRecorder``.
* Cross-package: the port's stub engine records the same artifact as the
  JAX one on the same trace, and on one record (JSON round-tripped) the
  port's ``fit_table``, ``fit_oracle(...).summary()`` and ``drift_report``
  are ``==`` to the JAX package's — exact, since both are pure Python over
  copies of the same simulator.  One stated difference: the port's replay
  counts a result-cache hit (``served_at_ingest``) as completed, so on a
  record with such hits the two reports differ in ``counters.completed``
  alone, by exactly the replay's number of them.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core.pruning import PruningConfig as JaxPruningConfig
from repro.core.simulation import PETOracle as JaxPETOracle
from repro.core.tasks import PETMatrix as JaxPETMatrix
from repro.obs import FlightRecorder as JaxFlightRecorder
from repro.obs import drift_report as jax_drift_report
from repro.obs import fit_oracle as jax_fit_oracle
from repro.obs import fit_table as jax_fit_table
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.core.pruning import PruningConfig
from repro_torch.core.simulation import PETOracle
from repro_torch.core.tasks import PETMatrix
from repro_torch.obs import (FlightRecorder, drift_report, fit_oracle,
                             fit_table, validate_drift_report)
from repro_torch.obs.replay import replay_record
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine


def _pet(PM=PETMatrix, seed=3):
    return PM.generate(["generate"], ["m0"], np.random.default_rng(seed),
                       mean_range=(8, 16))


def _request_trace(n=40, seed=1, n_prompts=5, deadline=80.0, rate=0.5,
                   Req=Request):
    rng = np.random.default_rng(seed)
    prompts = [tuple(rng.integers(1, 1000, size=8).tolist())
               for _ in range(n_prompts)]
    out, t = [], 0.0
    for _ in range(n):
        out.append((t, Req(
            prompt=prompts[int(rng.integers(0, n_prompts))], op="generate",
            n_new=int(rng.integers(1, 4)), seed=int(rng.integers(0, 2)),
            deadline=t + deadline)))
        t += float(rng.exponential(1.0 / rate))
    return out


PRUNED_CFG = dict(heuristic="MSD", merging="conservative",
                  position_finder=None,
                  pruning=PruningConfig(initial_defer_threshold=0.1,
                                        base_drop_threshold=0.3,
                                        dynamic_defer=True))
MERGE_CFG = dict(heuristic="EDF", merging="adaptive", position_finder=None,
                 pruning=None)
CALM_CFG = dict(heuristic="EDF", merging="none", position_finder=None,
                pruning=None)


def _record_run(trace, cfg_kw=MERGE_CFG, n_units=1, capacity=1 << 15,
                jax=False, result_cache=False):
    """One recorded stub-engine run of either package: the serve-CLI
    wiring in miniature."""
    Rec, Eng, Cfg, PM, PO = (
        (JaxFlightRecorder, JaxServingEngine, JaxEngineConfig, JaxPETMatrix,
         JaxPETOracle) if jax else
        (FlightRecorder, ServingEngine, EngineConfig, PETMatrix, PETOracle))
    rec = Rec(capacity=capacity)
    for t, item in trace:
        rec.note_arrival(t, item)
    kw = dict(cfg_kw)
    if jax and kw.get("pruning") is not None:
        kw["pruning"] = JaxPruningConfig(**vars(kw["pruning"]))
    eng = Eng(None, None, Cfg(n_units=n_units, elasticity=None,
                              result_cache=result_cache, prefix_cache=False,
                              **kw),
              stub_oracle=PO(_pet(PM), seed=11),
              **({} if jax else {"device": "cpu"}))
    eng.attach_telemetry(rec)
    stats = eng.run(trace)
    rec.note_machines(eng.machines)
    rec.note_engine_config(eng.cfg)
    rec.note_stats(stats)
    return rec, eng, stats


def _json_roundtrip(obj):
    return json.loads(json.dumps(obj))


class TestControlReplay:
    @pytest.mark.parametrize("cfg_kw", [MERGE_CFG, PRUNED_CFG],
                             ids=["edf-adaptive", "msd-pruned"])
    def test_control_replay_matches_decisions_exactly(self, cfg_kw):
        trace = _request_trace(n=40, deadline=20.0, rate=2.0)
        rec, eng, stats = _record_run(trace, cfg_kw)
        record = _json_roundtrip(rec.to_artifact())
        report = drift_report(record, oracle=PETOracle(_pet(), seed=11),
                              control=True)
        validate_drift_report(report)
        assert report["control"] is True
        assert report["events_truncated"] == 0
        assert report["decisions"]["match"] is True
        assert report["decisions"]["divergence_index"] == -1
        assert report["decisions"]["recorded"] == \
            report["decisions"]["replayed"] > 0
        assert report["max_stage_drift_pct"] == 0.0
        for row in report["counters"].values():
            assert row["gap"] == 0

    def test_ring_wrap_aligns_on_recorded_suffix(self):
        trace = _request_trace(n=40, deadline=20.0, rate=2.0)
        rec, eng, stats = _record_run(trace, MERGE_CFG, capacity=64)
        assert rec.events_dropped > 0
        record = _json_roundtrip(rec.to_artifact())
        report = drift_report(record, oracle=PETOracle(_pet(), seed=11),
                              control=True)
        assert report["events_truncated"] == rec.events_dropped
        assert report["decisions"]["match"] is True

    def test_replay_without_machine_table_fails_loudly(self):
        trace = _request_trace(n=6)
        rec = FlightRecorder(capacity=256)
        for t, item in trace:
            rec.note_arrival(t, item)
        eng = ServingEngine(None, None, EngineConfig(
            n_units=1, elasticity=None, result_cache=False,
            prefix_cache=False, **MERGE_CFG),
            stub_oracle=PETOracle(_pet(), seed=11), device="cpu")
        eng.attach_telemetry(rec)
        eng.run(trace)
        with pytest.raises(ValueError, match="machine table"):
            drift_report(_json_roundtrip(rec.to_artifact()))


@pytest.fixture(scope="module")
def calm_record():
    trace = _request_trace(n=60, seed=2, deadline=250.0, rate=0.08)
    rec, eng, stats = _record_run(trace, CALM_CFG, n_units=2)
    return _json_roundtrip(rec.to_artifact())


class TestFittedReplay:
    def test_fit_table_recovers_recorded_spans(self, calm_record):
        table = fit_table(calm_record)
        assert set(table) == {("generate", "m0")}
        mu, sd, n = table[("generate", "m0")]
        assert 6.0 < mu < 20.0
        assert sd >= 0.0
        assert n == sum(1 for e in calm_record["events"]
                        if e["kind"] == "exec_end")

    def test_fitted_drift_within_bound(self, calm_record):
        report = drift_report(calm_record)
        validate_drift_report(report)
        assert report["stages"]["service"]["scored"]
        assert report["stages"]["latency"]["scored"]
        assert report["max_stage_drift_pct"] <= 15.0
        assert report["counters"]["completed"]["replayed"] == \
            report["counters"]["completed"]["recorded"]

    def test_fit_oracle_reads_snapshot_rates_and_arrival_shape(self):
        record = {
            "estimator_snapshots": [{"t": 50.0, "estimator": {
                "rel_std": 0.2, "prefill_rate": 0.5, "decode_rate": 1.5,
                "ewma": []}}],
            "arrivals": [{"type": "request", "prompt": [1] * 6, "n_new": 4},
                         {"type": "request", "prompt": [1] * 6, "n_new": 4}],
            "events": [], "machines": []}
        orc = fit_oracle(record)
        assert (orc.prefill_rate, orc.decode_rate, orc.rel_std) == \
            (0.5, 1.5, 0.2)
        task = SimpleNamespace(ttype="generate", tokens=(1,) * 6)
        machine = SimpleNamespace(mtype="m0", speed=2.0)
        mu, sd = orc.mean_std(task, machine)
        assert mu == pytest.approx((6 * 0.5 + 4 * 1.5) / 2.0)
        assert sd == pytest.approx(0.2 * 9.0 / 2.0)
        assert orc.sample(task, machine) > 0.0


# ---------------------------------------------------------------------------
# cross-package: the same record, the same numbers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg_kw,n_units,trace_kw", [
    (CALM_CFG, 2, dict(n=60, seed=2, deadline=250.0, rate=0.08)),
    (MERGE_CFG, 1, dict(n=40, deadline=20.0, rate=2.0)),
    (PRUNED_CFG, 1, dict(n=40, deadline=20.0, rate=2.0))],
    ids=["calm", "edf-adaptive", "msd-pruned"])
def test_same_record_same_fit_and_drift(cfg_kw, n_units, trace_kw):
    ours, _, _ = _record_run(_request_trace(**trace_kw), cfg_kw, n_units)
    ref, _, _ = _record_run(_request_trace(Req=JaxRequest, **trace_kw),
                            cfg_kw, n_units, jax=True)
    record = _json_roundtrip(ours.to_artifact())
    # both stub engines record the same artifact, host wall times aside;
    # the port's unit-runner launch counters (and the model's counts it
    # adds up) and its prefix-cache insert walls stay 0 on a stub engine
    walls = ("mapping_wall_s", "pruning_wall_s")
    launches = ("chunk_launches", "chunk_rows", "chunk_cells",
                "chunk_cells_launched", "chunk_attn_cells", "decode_launches",
                "decode_rows", "moe_real_rows",
                "mla_expand_tokens", "kv_insert_wall_s", "kv_download_wall_s")
    assert {k: v for k, v in record.items() if k != "stats"} == \
        {k: v for k, v in _json_roundtrip(ref.to_artifact()).items()
         if k != "stats"}
    assert {k: record["stats"][k] for k in launches} == \
        dict.fromkeys(launches, 0)
    assert {k: v for k, v in record["stats"].items()
            if k not in walls + launches} == \
        {k: v for k, v in ref.to_artifact()["stats"].items()
         if k not in walls}
    assert fit_table(record) == jax_fit_table(record)
    assert fit_oracle(record).summary() == jax_fit_oracle(record).summary()
    for seed in (0, 5):
        assert fit_oracle(record, seed=seed).summary() == \
            jax_fit_oracle(record, seed=seed).summary()
    assert drift_report(record) == jax_drift_report(record)
    assert drift_report(record, oracle=PETOracle(_pet(), seed=11),
                        control=True) == \
        jax_drift_report(record, oracle=JaxPETOracle(_pet(JaxPETMatrix),
                                                     seed=11), control=True)


def test_result_cache_hits_count_as_completed():
    """A request answered from the result cache emits ``served_at_ingest``
    and no ``complete``.  The port's replay counts it completed, as the
    engine's counter does, so its report is the JAX package's ``==`` but
    for ``counters.completed``, whose replayed value is higher by exactly
    the replay's ``served_at_ingest`` events; under the recording's own
    oracle the port's completed gap is then 0."""
    trace = _request_trace(n=40, deadline=20.0, rate=2.0)
    rec, _, stats = _record_run(trace, MERGE_CFG, result_cache=True)
    record = _json_roundtrip(rec.to_artifact())
    served = sum(e["kind"] == "served_at_ingest" for e in record["events"])
    assert served > 0 and stats["cache_hits"] == served
    for ours, theirs, orc in (
            ({}, {}, None),
            ({"oracle": PETOracle(_pet(), seed=11), "control": True},
             {"oracle": JaxPETOracle(_pet(JaxPETMatrix), seed=11),
              "control": True}, PETOracle(_pet(), seed=11))):
        a, b = drift_report(record, **ours), jax_drift_report(record,
                                                              **theirs)
        validate_drift_report(a)
        ca, cb = a.pop("counters"), b.pop("counters")
        assert a == b
        done_a, done_b = ca.pop("completed"), cb.pop("completed")
        assert ca == cb
        _, tel = replay_record(record, oracle=orc)
        replayed = len(tel.events_of("served_at_ingest"))
        assert replayed > 0
        assert done_a["recorded"] == done_b["recorded"] == stats["completed"]
        assert done_a["replayed"] - done_b["replayed"] == replayed
        if orc is not None:
            assert replayed == served
            assert done_a["gap"] == 0 and done_b["gap"] == -served
