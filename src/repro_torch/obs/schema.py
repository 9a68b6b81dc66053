"""Schema checks for exported artifacts (used by tests and the CI smoke).

Hand-rolled validators (the container has no ``jsonschema``): each raises
``ValueError`` with a path-qualified message on the first violation.

CLI::

    python -m repro.obs.schema trace.json [metrics.json]

exits non-zero on the first invalid artifact — the bench-smoke CI job runs
this over the emitted Perfetto trace and metrics snapshot.

A copy of ``repro.obs.schema`` for the port, unchanged but for this line.
"""

from __future__ import annotations

import json
import sys

__all__ = ["SCHEMA_VERSION", "validate_chrome_trace",
           "validate_metrics_snapshot", "validate_telemetry_summary",
           "validate_slo_alert", "validate_drift_report",
           "validate_flight_record"]

#: version of the consolidated ``stats["telemetry"]`` summary emitted by
#: ``repro.launch.serve``.  v2 added the optional per-tenant / per-turn
#: ``workload`` section (closed-loop sessions, DESIGN.md §2.11) and the
#: ``tenant``-labelled lifecycle metrics.  v3 adds the observability-loop
#: artifacts (DESIGN.md §2.12): ``flight_record`` (obs.recorder),
#: ``drift_report`` (obs.replay) and ``slo_alert`` events (obs.slo).
#: v4 adds prefill/decode disaggregation (DESIGN.md §2.13): ``handoff`` /
#: ``kv_migrate`` lifecycle events, the ``kv_migrations`` /
#: ``kv_blocks_migrated`` / ``handoffs`` counters, and Perfetto *flow*
#: arrows (phases ``s``/``t``/``f``) drawn from the source machine's track
#: to the destination's for every migration.
SCHEMA_VERSION = 4

_PHASES = {"X", "B", "E", "b", "e", "n", "i", "I", "M", "C", "s", "t", "f"}
_HIST_KEYS = {"count", "mean", "min", "max", "p50", "p95", "p99"}


def _fail(path: str, msg: str):
    raise ValueError(f"{path}: {msg}")


def validate_chrome_trace(obj) -> None:
    """Chrome trace-event JSON (object form with ``traceEvents``)."""
    if not isinstance(obj, dict):
        _fail("$", "trace must be a JSON object")
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        _fail("$.traceEvents", "missing or not a list")
    for i, ev in enumerate(evs):
        p = f"$.traceEvents[{i}]"
        if not isinstance(ev, dict):
            _fail(p, "event must be an object")
        ph = ev.get("ph")
        if ph not in _PHASES:
            _fail(p + ".ph", f"unknown phase {ph!r}")
        if not isinstance(ev.get("name"), str):
            _fail(p + ".name", "missing or not a string")
        if not isinstance(ev.get("pid"), int):
            _fail(p + ".pid", "missing or not an int")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                _fail(p + ".ts", "missing or not a number")
            if ts < 0:
                _fail(p + ".ts", "negative timestamp")
            if not isinstance(ev.get("tid"), int):
                _fail(p + ".tid", "missing or not an int")
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                _fail(p + ".dur", "complete event needs dur >= 0")
        if ph in ("b", "e", "n") and "id" not in ev:
            _fail(p + ".id", "async event needs an id")
        if ph in ("s", "t", "f") and "id" not in ev:
            _fail(p + ".id", "flow event needs an id")
        if "args" in ev and not isinstance(ev["args"], dict):
            _fail(p + ".args", "args must be an object")


def validate_metrics_snapshot(obj) -> None:
    """Output of ``MetricsRegistry.snapshot()``."""
    if not isinstance(obj, dict):
        _fail("$", "snapshot must be a JSON object")
    for sect in ("counters", "gauges", "histograms"):
        if sect not in obj or not isinstance(obj[sect], dict):
            _fail(f"$.{sect}", "missing or not an object")
    for name, v in obj["counters"].items():
        if not isinstance(v, (int, float)):
            _fail(f"$.counters[{name!r}]", "value must be a number")
    for name, v in obj["gauges"].items():
        if not isinstance(v, (int, float)):
            _fail(f"$.gauges[{name!r}]", "value must be a number")
    for name, h in obj["histograms"].items():
        p = f"$.histograms[{name!r}]"
        if not isinstance(h, dict):
            _fail(p, "summary must be an object")
        missing = _HIST_KEYS - set(h)
        if missing:
            _fail(p, f"missing keys {sorted(missing)}")
        for k in _HIST_KEYS:
            if not isinstance(h[k], (int, float)):
                _fail(f"{p}.{k}", "must be a number")
        if h["count"] < 0:
            _fail(f"{p}.count", "negative count")


def validate_telemetry_summary(obj) -> None:
    """Consolidated ``stats["telemetry"]`` summary from the serve CLI.

    Requires ``schema == SCHEMA_VERSION``, numeric ``counters``/``wall``
    sections and a valid metrics snapshot; the ``workload`` section (when
    present: closed-loop / staged runs) must carry ``per_turn`` or
    ``per_stage`` rows plus per-tenant accounting.
    """
    if not isinstance(obj, dict):
        _fail("$", "summary must be a JSON object")
    if obj.get("schema") != SCHEMA_VERSION:
        _fail("$.schema", f"expected {SCHEMA_VERSION}, got {obj.get('schema')!r}")
    for sect in ("counters", "wall"):
        if not isinstance(obj.get(sect), dict):
            _fail(f"$.{sect}", "missing or not an object")
        for name, v in obj[sect].items():
            if not isinstance(v, (int, float)):
                _fail(f"$.{sect}[{name!r}]", "value must be a number")
    validate_metrics_snapshot(obj.get("metrics"))
    wl = obj.get("workload")
    if wl is None:
        return
    if not isinstance(wl, dict):
        _fail("$.workload", "must be an object")
    if not isinstance(wl.get("mode"), str):
        _fail("$.workload.mode", "missing or not a string")
    rows = wl.get("per_turn", wl.get("per_stage"))
    if not isinstance(rows, list) or not rows:
        _fail("$.workload", "needs a non-empty per_turn or per_stage list")
    for i, row in enumerate(rows):
        p = f"$.workload.rows[{i}]"
        if not isinstance(row, dict):
            _fail(p, "row must be an object")
        for k in ("submitted", "completed", "on_time", "dropped"):
            if not isinstance(row.get(k), (int, float)):
                _fail(f"{p}.{k}", "missing or not a number")
    tenants = wl.get("tenants")
    if not isinstance(tenants, dict) or not tenants:
        _fail("$.workload.tenants", "missing or empty")
    for name, t in tenants.items():
        p = f"$.workload.tenants[{name!r}]"
        if not isinstance(t, dict):
            _fail(p, "must be an object")
        for k in ("submitted", "completed", "on_time", "dropped",
                  "on_time_rate"):
            if not isinstance(t.get(k), (int, float)):
                _fail(f"{p}.{k}", "missing or not a number")


def validate_slo_alert(ev) -> None:
    """One ``slo_alert`` telemetry event (obs.slo), as a plain dict."""
    if not isinstance(ev, dict):
        _fail("$", "slo_alert must be an object")
    if ev.get("kind", "slo_alert") != "slo_alert":
        _fail("$.kind", f"expected 'slo_alert', got {ev.get('kind')!r}")
    if not isinstance(ev.get("t"), (int, float)):
        _fail("$.t", "missing or not a number")
    if not isinstance(ev.get("tenant"), str):
        _fail("$.tenant", "missing or not a string")
    burn = ev.get("burn")
    if not isinstance(burn, (int, float)) or burn < 0:
        _fail("$.burn", "missing or negative")
    obj = ev.get("objective")
    if not isinstance(obj, (int, float)) or not 0.0 < obj <= 1.0:
        _fail("$.objective", "must be in (0, 1]")
    err = ev.get("error_rate")
    if not isinstance(err, (int, float)) or not 0.0 <= err <= 1.0:
        _fail("$.error_rate", "must be in [0, 1]")
    win = ev.get("window")
    if not isinstance(win, (int, float)) or win <= 0:
        _fail("$.window", "must be a positive number")


def validate_drift_report(obj) -> None:
    """Replay divergence report emitted by ``obs.replay.drift_report``."""
    if not isinstance(obj, dict):
        _fail("$", "report must be a JSON object")
    if obj.get("kind") != "drift_report":
        _fail("$.kind", f"expected 'drift_report', got {obj.get('kind')!r}")
    if obj.get("schema") != SCHEMA_VERSION:
        _fail("$.schema",
              f"expected {SCHEMA_VERSION}, got {obj.get('schema')!r}")
    dec = obj.get("decisions")
    if not isinstance(dec, dict):
        _fail("$.decisions", "missing or not an object")
    for k in ("recorded", "replayed"):
        if not isinstance(dec.get(k), int) or dec[k] < 0:
            _fail(f"$.decisions.{k}", "must be a non-negative int")
    if not isinstance(dec.get("divergence_index"), int):
        _fail("$.decisions.divergence_index", "must be an int (-1 = match)")
    if not isinstance(dec.get("match"), bool):
        _fail("$.decisions.match", "must be a bool")
    stages = obj.get("stages")
    if not isinstance(stages, dict) or not stages:
        _fail("$.stages", "missing or empty")
    for name, row in stages.items():
        p = f"$.stages[{name!r}]"
        if not isinstance(row, dict):
            _fail(p, "must be an object")
        for k in ("recorded_mean", "replayed_mean", "drift_pct"):
            if not isinstance(row.get(k), (int, float)):
                _fail(f"{p}.{k}", "missing or not a number")
        if row["drift_pct"] < 0:
            _fail(f"{p}.drift_pct", "negative drift")
    mx = obj.get("max_stage_drift_pct")
    if not isinstance(mx, (int, float)) or mx < 0:
        _fail("$.max_stage_drift_pct", "missing or negative")
    counters = obj.get("counters")
    if not isinstance(counters, dict):
        _fail("$.counters", "missing or not an object")
    for name, row in counters.items():
        p = f"$.counters[{name!r}]"
        if not isinstance(row, dict):
            _fail(p, "must be an object")
        for k in ("recorded", "replayed"):
            if not isinstance(row.get(k), (int, float)):
                _fail(f"{p}.{k}", "missing or not a number")


def validate_flight_record(obj, path: str = "$") -> None:
    """Flight-record artifact emitted by ``obs.recorder.FlightRecorder``."""
    if not isinstance(obj, dict):
        _fail(path, "record must be a JSON object")
    if obj.get("kind") != "flight_record":
        _fail(f"{path}.kind",
              f"expected 'flight_record', got {obj.get('kind')!r}")
    if obj.get("schema") != SCHEMA_VERSION:
        _fail(f"{path}.schema",
              f"expected {SCHEMA_VERSION}, got {obj.get('schema')!r}")
    cap = obj.get("capacity")
    if not isinstance(cap, int) or cap <= 0:
        _fail(f"{path}.capacity", "must be a positive int")
    dropped = obj.get("events_dropped")
    if not isinstance(dropped, int) or dropped < 0:
        _fail(f"{path}.events_dropped", "must be a non-negative int")
    evs = obj.get("events")
    if not isinstance(evs, list):
        _fail(f"{path}.events", "missing or not a list")
    if len(evs) > cap:
        _fail(f"{path}.events", f"{len(evs)} events exceed capacity {cap}")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict) or "t" not in ev or "kind" not in ev:
            _fail(f"{path}.events[{i}]", "event needs t and kind")
    for sect in ("arrivals", "estimator_snapshots", "machines"):
        if not isinstance(obj.get(sect), list):
            _fail(f"{path}.{sect}", "missing or not a list")
    if not isinstance(obj.get("stats"), dict):
        _fail(f"{path}.stats", "missing or not an object")


def _validate_file(path: str) -> str:
    with open(path) as fh:
        obj = json.load(fh)
    if isinstance(obj, dict) and "traceEvents" in obj:
        validate_chrome_trace(obj)
        return "chrome-trace"
    if isinstance(obj, dict) and obj.get("kind") == "drift_report":
        validate_drift_report(obj)
        return "drift-report"
    if isinstance(obj, dict) and obj.get("kind") == "flight_record":
        validate_flight_record(obj)
        return "flight-record"
    if isinstance(obj, dict) and "schema" in obj:
        validate_telemetry_summary(obj)
        return "telemetry-summary"
    validate_metrics_snapshot(obj)
    return "metrics-snapshot"


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m repro.obs.schema FILE [FILE ...]")
        return 2
    for path in argv:
        try:
            kind = _validate_file(path)
        except (ValueError, OSError, json.JSONDecodeError) as e:
            print(f"INVALID {path}: {e}")
            return 1
        print(f"ok {path} ({kind})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
