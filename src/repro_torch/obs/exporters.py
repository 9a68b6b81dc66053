"""Exporters: JSONL event log, Chrome trace-event JSON, metrics snapshots.

The Chrome trace targets the subset of the trace-event format that Perfetto
and chrome://tracing both render:

  * one *process* per plane (``pid``), one *thread* per machine (``tid``),
    named via ``"M"`` metadata events — mapping decisions are visually
    auditable as spans landing on machine tracks;
  * complete ``"X"`` spans for executions (exec_start → exec_end);
  * async ``"b"``/``"e"`` pairs per request lifecycle (arrive → complete/
    drop) on the request's own id, so queue wait is the gap before its
    execution span;
  * instant ``"i"`` events for control decisions (admit/merge/drop/defer/
    route/scale/kv), carrying reason and chance-of-success in ``args``.

Timestamps: the trace-event ``ts`` unit is microseconds.  Virtual time
(engine ticks or simulated seconds) is scaled by ``us_per_unit`` so both
substrates produce overlay-comparable timelines.

A copy of ``repro.obs.exporters`` for the port, unchanged but for this line
and a cross-reference to DESIGN.md in place of a change number.
"""

from __future__ import annotations

import json
import re

__all__ = ["write_jsonl", "chrome_trace", "write_chrome_trace",
           "write_metrics", "parse_prometheus"]

# event kinds that open/close a request's async lifecycle span
_OPEN = {"arrive"}
_CLOSE = {"complete", "drop"}
# control-decision kinds rendered as instants on the plane's control track
_INSTANT = {"admit", "merge", "merge_rejected", "drop", "defer", "route",
            "scale_up", "scale_down", "kv_evict", "served_at_ingest",
            "map", "handoff"}
# kinds drawn as flow arrows between machine tracks (src -> dst), §2.13
_FLOW = {"kv_migrate"}
_CONTROL_TID = 1_000_000        # synthetic tid for the control-decision track


def write_jsonl(events, path) -> None:
    with open(path, "w") as fh:
        for ev in events:
            fh.write(json.dumps(ev, sort_keys=True) + "\n")


def _args(ev: dict) -> dict:
    return {k: v for k, v in ev.items() if k not in ("t", "kind", "wall")}


def _req_name(ev: dict) -> str:
    """Lifecycle span label; tenant-labelled traffic (DESIGN.md §2.11)
    keeps its tier visible in the Perfetto track, e.g. ``req 5 [gold]``."""
    name = f"req {ev.get('req')}"
    tenant = ev.get("tenant")
    return f"{name} [{tenant}]" if tenant else name


def chrome_trace(events, us_per_unit: float = 1e6) -> dict:
    """Convert a telemetry event list into a Chrome trace-event object."""
    trace: list[dict] = []
    procs: set[int] = set()
    threads: set[tuple[int, int]] = set()
    open_exec: dict = {}          # (plane, machine, req/task) -> start ev
    flow_id = 0                   # incrementing id shared by each s/f pair

    def ts(ev):
        return ev["t"] * us_per_unit

    for ev in events:
        pid = int(ev.get("plane", 0))
        procs.add(pid)
        kind = ev["kind"]
        if kind == "exec_start":
            tid = int(ev.get("machine", 0))
            threads.add((pid, tid))
            open_exec[(pid, tid, ev.get("task"))] = ev
        elif kind == "exec_end":
            tid = int(ev.get("machine", 0))
            threads.add((pid, tid))
            start = open_exec.pop((pid, tid, ev.get("task")), None)
            t0 = ts(start) if start else ts(ev)
            trace.append({
                "name": f"exec task {ev.get('task')}",
                "ph": "X", "pid": pid, "tid": tid,
                "ts": t0, "dur": max(ts(ev) - t0, 0.0),
                "cat": "exec", "args": _args(ev),
            })
        elif kind in _OPEN:
            trace.append({
                "name": _req_name(ev),
                "ph": "b", "cat": "request", "id": int(ev.get("req", 0)),
                "pid": pid, "tid": _CONTROL_TID, "ts": ts(ev),
                "args": _args(ev),
            })
        elif kind in _CLOSE:
            trace.append({
                "name": _req_name(ev),
                "ph": "e", "cat": "request", "id": int(ev.get("req", 0)),
                "pid": pid, "tid": _CONTROL_TID, "ts": ts(ev),
                "args": _args(ev),
            })
        elif kind in _FLOW and ev.get("src") is not None \
                and ev.get("dst") is not None:
            # KV migration (§2.13): a flow arrow from the source machine's
            # track to the destination's, so every prefill→decode handoff
            # (and retirement rescue) is visually traceable in Perfetto
            flow_id += 1
            src, dst = int(ev["src"]), int(ev["dst"])
            threads.add((pid, src))
            threads.add((pid, dst))
            common = {"name": kind, "cat": "kv", "id": flow_id,
                      "pid": pid, "ts": ts(ev)}
            trace.append({**common, "ph": "s", "tid": src,
                          "args": _args(ev)})
            trace.append({**common, "ph": "f", "bp": "e", "tid": dst})
        if kind in _INSTANT:
            trace.append({
                "name": kind, "ph": "i", "s": "t",
                "pid": pid, "tid": _CONTROL_TID, "ts": ts(ev),
                "cat": "decision", "args": _args(ev),
            })

    meta: list[dict] = []
    for pid in sorted(procs):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": f"plane {pid}"}})
    for pid, tid in sorted(threads):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": f"machine {tid}"}})
    for pid in sorted(procs):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": _CONTROL_TID, "args": {"name": "control plane"}})
    return {"traceEvents": meta + trace, "displayTimeUnit": "ms"}


def write_chrome_trace(events, path, us_per_unit: float = 1e6) -> None:
    with open(path, "w") as fh:
        json.dump(chrome_trace(events, us_per_unit), fh)


def write_metrics(metrics, path) -> None:
    """Prometheus text for ``.prom``/``.txt`` paths, JSON snapshot else."""
    p = str(path)
    if p.endswith(".prom") or p.endswith(".txt"):
        body = metrics.to_prometheus()
    else:
        body = json.dumps(metrics.snapshot(), indent=2, sort_keys=True)
    with open(path, "w") as fh:
        fh.write(body)


_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="([^"]*)"')


def parse_prometheus(text: str) -> dict:
    """Inverse of ``MetricsRegistry.to_prometheus`` for round-trip tests:
    ``{(name, ((label, value), ...)): float}``.  Label sets are sorted
    tuples, so per-tenant series are addressable as
    ``out[("tenant_completed", (("tenant", "gold"),))]``."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        if not head:
            continue
        if "{" in head:
            name, _, rest = head.partition("{")
            labels = tuple(sorted(_LABEL_RE.findall(rest)))
        else:
            name, labels = head, ()
        out[(name, labels)] = float(val)
    return out
