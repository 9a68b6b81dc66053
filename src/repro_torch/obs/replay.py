"""Replay + drift audit — the measured sim↔live story (DESIGN.md §2.12).

``replay_record`` re-drives a flight-recorded arrival sequence through the
discrete-event simulator; ``drift_report`` diffs the replayed telemetry
against the recorded stream and emits one structured divergence report:

  * **per-stage latency deltas** — mean queue wait, execution span and
    end-to-end latency, recorded vs replayed, as drift percentages;
  * **decision-trace divergence point** — the first index at which the
    replayed admission/merge/map/exec/drop sequence departs from the
    recorded one (``-1`` = exact match).  Replaying under the *same*
    oracle that drove a stub-execution recording is the control
    experiment: the trace must match exactly (trace-equivalence, §2.2),
    which pins the recorder's serialization fidelity.  Replaying under a
    telemetry-fitted oracle (``obs.fit``) turns "how close is the
    simulator to the live engine" into a number;
  * **on-time / cost gaps** — recorded final counters vs replayed
    ``SimStats``.

Stages whose recorded mean is below ``min_stage_mean`` (sub-tick noise,
e.g. zero queueing at low load) are reported but excluded from
``max_stage_drift_pct``.  If the recording's ring buffer wrapped
(``events_dropped > 0``) the decision comparison aligns on the recorded
suffix and the report says so (``events_truncated``).

Module scope is stdlib-only; simulator machinery is imported lazily.

A copy of ``repro.obs.replay`` for the port, unchanged but for this line
and one repair: ``stage_stats`` counts a ``served_at_ingest`` event (a
result-cache hit) as completed, as the engine's ``completed`` counter does,
so a replay's completed counter compares like with like.
"""

from __future__ import annotations

from statistics import fmean

__all__ = ["rebuild_arrivals", "rebuild_tasks", "rebuild_machines",
           "sim_config_from", "replay_record", "drift_report",
           "decision_sequence", "stage_stats"]

# decision-bearing event kinds, and the attrs that identify the decision
# (timing- and estimate-valued attrs like t/wait/chance stay out so a
# fitted-oracle replay is judged on *choices*, not clock readings)
_DECISION_KINDS = ("admit", "merge", "merge_rejected", "defer", "map",
                   "exec_start", "drop")
_DECISION_ATTRS = ("req", "task", "into", "level", "reason", "position",
                   "machine", "n_requests")


# -- artifact -> scheduling-core objects -------------------------------------

def rebuild_arrivals(record: dict) -> list:
    """Arrival rows -> [(t, Request | Task)] in recorded order."""
    from ..serving.engine import Request
    from ..core.tasks import Task
    out = []
    for a in record.get("arrivals", []):
        if a.get("type") == "request":
            item = Request(prompt=tuple(a["prompt"]), op=a["op"],
                           n_new=a["n_new"], temperature=a["temperature"],
                           seed=a["seed"], deadline=a["deadline"],
                           tenant=a.get("tenant"), session=a.get("session"),
                           turn=a.get("turn", 0),
                           priority=a.get("priority", 0))
        else:
            item = Task(ttype=a["ttype"], data_id=a["data_id"], op=a["op"],
                        params=tuple(a["params"]), arrival=a["t"],
                        deadline=a["deadline"], user=a.get("user", "u0"),
                        priority=a.get("priority", 0),
                        tokens=tuple(a["tokens"]) if a.get("tokens")
                        else None, tenant=a.get("tenant"),
                        session=a.get("session"), turn=a.get("turn", 0))
        out.append((a["t"], item))
    return out


def rebuild_tasks(record: dict) -> list:
    """Arrivals as simulator Tasks — Requests go through ``to_task`` with
    their arrival ordinal, the exact transform engine ingestion applies,
    so similarity keys and merge identities are re-derived bit-for-bit."""
    tasks = []
    for i, (t, item) in enumerate(rebuild_arrivals(record)):
        tasks.append(item.to_task(t, i) if hasattr(item, "to_task")
                     else item)
    return tasks


def rebuild_machines(record: dict) -> list:
    from ..core.tasks import Machine
    return [Machine(mid=m["mid"], mtype=m.get("mtype", "m0"),
                    speed=m.get("speed", 1.0),
                    queue_size=m.get("queue_size", 4),
                    cost_rate=m.get("cost_rate", 1.0))
            for m in record.get("machines", [])]


def sim_config_from(record: dict, **overrides):
    """SimConfig mirroring the recorded control knobs (hard deadlines ride
    with pruning, matching ``EngineConfig.control()``)."""
    from ..core.pruning import DropMode, PruningConfig
    from ..core.simulation import SimConfig
    ec = record.get("engine_config", {})
    pruning = None
    if ec.get("pruning") is not None:
        blob = dict(ec["pruning"])
        if "drop_mode" in blob:
            blob["drop_mode"] = DropMode(blob["drop_mode"])
        pruning = PruningConfig(**blob)
    kw = {"heuristic": ec.get("heuristic", "EDF"),
          "merging": ec.get("merging", "none"),
          "position_finder": ec.get("position_finder"),
          "pruning": pruning, "hard_deadlines": pruning is not None,
          "alpha": ec.get("alpha", 2.0),
          "merge_degree_cap": ec.get("merge_degree_cap", 5),
          "result_cache": ec.get("result_cache", False),
          "elasticity": None}
    kw.update(overrides)
    return SimConfig(**kw)


# -- replay ------------------------------------------------------------------

def replay_record(record: dict, oracle=None, telemetry=None, device=None,
                  **cfg_overrides):
    """Re-drive the recorded arrivals through the simulator.

    ``oracle`` defaults to a freshly fitted one (``obs.fit.fit_oracle``);
    pass the recording's own stub oracle for the control experiment.
    ``device`` is the simulator's (``Simulator``): where an ``elasticity``
    override's success-chance signal runs.
    Returns ``(sim, telemetry)`` after the run completes.
    """
    from ..core.simulation import Simulator
    from .telemetry import Telemetry
    if oracle is None:
        from .fit import fit_oracle
        oracle = fit_oracle(record)
    tel = telemetry if telemetry is not None else Telemetry()
    machines = rebuild_machines(record)
    if not machines:
        raise ValueError("flight record carries no machine table; "
                         "was FlightRecorder.note_machines() called?")
    sim = Simulator(rebuild_tasks(record), machines, oracle,
                    sim_config_from(record, **cfg_overrides), device=device)
    sim.attach_telemetry(tel)
    sim.run()
    return sim, tel


# -- diffing -----------------------------------------------------------------

def decision_sequence(events) -> list[tuple]:
    return [(e["kind"],) + tuple(e.get(a) for a in _DECISION_ATTRS)
            for e in events if e.get("kind") in _DECISION_KINDS]


def stage_stats(events) -> dict:
    """Per-stage means + lifecycle counters from one event stream."""
    waits, services, lats = [], [], []
    open_spans: dict = {}
    on_time = completed = dropped = 0
    for e in events:
        kind = e.get("kind")
        if kind == "exec_start":
            if "wait" in e:
                waits.append(e["wait"])
            open_spans[(e.get("machine"), e.get("task"))] = e["t"]
        elif kind == "exec_end":
            t0 = open_spans.pop((e.get("machine"), e.get("task")), None)
            if t0 is not None:
                services.append(e["t"] - t0)
        elif kind == "complete":
            completed += 1
            on_time += int(bool(e.get("on_time")))
            if "latency" in e:
                lats.append(e["latency"])
        elif kind == "served_at_ingest":
            # a result-cache hit: answered at ingest, with no ``complete``
            # event, and counted completed by the engine
            completed += 1
        elif kind == "drop":
            dropped += 1
    return {"stage_means": {"wait": fmean(waits) if waits else 0.0,
                            "service": fmean(services) if services else 0.0,
                            "latency": fmean(lats) if lats else 0.0},
            "completed": completed, "on_time": on_time, "dropped": dropped}


def _drift_pct(rec: float, rep: float) -> float:
    return 100.0 * abs(rep - rec) / max(abs(rec), 1e-9)


def drift_report(record: dict, oracle=None, control: bool = False,
                 min_stage_mean: float = 1.0, **cfg_overrides) -> dict:
    """record -> replay -> structured divergence report (see module doc)."""
    from .schema import SCHEMA_VERSION
    sim, tel = replay_record(record, oracle=oracle, **cfg_overrides)
    rec_events = record.get("events", [])
    rec_dec = decision_sequence(rec_events)
    rep_dec = decision_sequence(tel.comparable_events())
    truncated = int(record.get("events_dropped", 0))
    rep_cmp = rep_dec[-len(rec_dec):] if truncated and rec_dec else rep_dec
    divergence = -1
    for i, (a, b) in enumerate(zip(rec_dec, rep_cmp)):
        if a != b:
            divergence = i
            break
    else:
        if len(rec_dec) != len(rep_cmp):
            divergence = min(len(rec_dec), len(rep_cmp))

    rec_side = stage_stats(rec_events)
    rep_side = stage_stats(tel.comparable_events())
    stages = {}
    drifts = []
    for name in ("wait", "service", "latency"):
        r = rec_side["stage_means"][name]
        p = rep_side["stage_means"][name]
        row = {"recorded_mean": round(r, 6), "replayed_mean": round(p, 6),
               "drift_pct": round(_drift_pct(r, p), 4),
               "scored": bool(r >= min_stage_mean)}
        stages[name] = row
        if row["scored"]:
            drifts.append(row["drift_pct"])

    rec_stats = record.get("stats", {})
    counters = {}
    for name, rep_val in (("completed", rep_side["completed"]),
                          ("on_time", rep_side["on_time"]),
                          ("dropped", rep_side["dropped"])):
        r = rec_stats.get(name, rec_side[name])
        counters[name] = {"recorded": r, "replayed": rep_val,
                          "gap": rep_val - r}
    rec_cost = rec_stats.get("cost")
    cost = {"recorded": rec_cost, "replayed": round(sim.stats.cost, 6)}
    if rec_cost is not None:
        cost["gap_pct"] = round(_drift_pct(rec_cost, sim.stats.cost), 4)

    return {"kind": "drift_report", "schema": SCHEMA_VERSION,
            "control": bool(control), "events_truncated": truncated,
            "decisions": {"recorded": len(rec_dec),
                          "replayed": len(rep_dec),
                          "divergence_index": divergence,
                          "match": divergence == -1},
            "stages": stages,
            "max_stage_drift_pct": round(max(drifts), 4) if drifts else 0.0,
            "counters": counters, "cost": cost}
