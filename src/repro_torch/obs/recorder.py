"""Flight recorder — one replayable artifact per serving run (DESIGN.md §2.12).

:class:`FlightRecorder` is a :class:`~repro.obs.telemetry.Telemetry` whose
event log is a *bounded ring buffer* plus the side channels an offline
replay needs:

  * the arrival payloads (``note_arrival``) — enough to rebuild every
    ``Request``/``Task`` bit-for-bit, so a replay re-derives the same
    similarity keys, merge identities and deadlines;
  * periodic ``TimeEstimator`` EWMA snapshots (``watch_estimator`` /
    ``snapshot_estimator``) via the estimator's ``dump()``;
  * kernel-profiler compile/execute splits (``use_profiler``);
  * the fleet table (``note_machines``), the control knobs
    (``note_engine_config``) and the run's final counters (``note_stats``)
    so a drift audit has ground truth to diff against.

Zero-perturbation argument (same as the base telemetry, §2.9): decision
code only ever *writes* into the recorder — nothing on the admission /
merge / prune / map path reads it back, so attaching one cannot change a
decision.  The ring bound adds the second half of the argument: memory
stays constant no matter how long the run is, so the recorder can be left
on in production.  ``tests/test_obs_loop.py`` pins both properties
(decision-trace equality recorder-on vs recorder-off, ring never exceeds
capacity).

The serialized artifact is a single JSON object (``kind: flight_record``,
versioned by ``obs.schema.SCHEMA_VERSION``) consumed by ``obs.fit`` and
``obs.replay``.  No JAX or numpy at module scope.

A copy of ``repro.obs.recorder`` for the port, unchanged but for this line.
"""

from __future__ import annotations

import json
from collections import deque

from .telemetry import Telemetry

__all__ = ["FlightRecorder", "RECORD_KIND", "load_record"]

RECORD_KIND = "flight_record"


def _arrival_blob(t: float, item) -> dict:
    """Serialize a Request (engine/router ingestion) or a Task (simulator
    ingestion) into a JSON-safe arrival row."""
    if hasattr(item, "prompt"):            # serving Request
        return {"type": "request", "t": t,
                "prompt": list(item.prompt), "op": item.op,
                "n_new": item.n_new, "temperature": item.temperature,
                "seed": item.seed, "deadline": item.deadline,
                "tenant": item.tenant, "session": item.session,
                "turn": item.turn, "priority": item.priority}
    return {"type": "task", "t": t,        # scheduling-core Task
            "ttype": item.ttype, "data_id": item.data_id, "op": item.op,
            "params": list(item.params), "deadline": item.deadline,
            "user": item.user, "priority": item.priority,
            "tokens": list(item.tokens) if item.tokens else None,
            "tenant": item.tenant, "session": item.session,
            "turn": item.turn}


class FlightRecorder(Telemetry):
    """Bounded-ring telemetry recorder serializable to one artifact."""

    def __init__(self, capacity: int = 65536, metrics=None, wall_clock=None,
                 snapshot_interval: float = 0.0, max_snapshots: int = 64):
        super().__init__(metrics=metrics, wall_clock=wall_clock)
        self.capacity = int(capacity)
        # the base class appends events to a plain list; a maxlen deque is a
        # drop-in (append / iterate / clear) that makes the log a ring
        self.events = deque(maxlen=self.capacity)  # type: ignore[assignment]
        self.events_dropped = 0
        self.arrivals: list[dict] = []
        self.est_snapshots = deque(maxlen=max(1, int(max_snapshots)))
        self.machines: list[dict] = []
        self.engine_config: dict = {}
        self.run_stats: dict = {}
        self.meta: dict = {}
        self.snapshot_interval = float(snapshot_interval)
        self._watched = None
        self._last_snap: float | None = None
        self._profiler = None

    # -- event stream (ring) --------------------------------------------------
    def event(self, t: float, kind: str, **attrs) -> None:
        if len(self.events) == self.capacity:
            self.events_dropped += 1
        super().event(t, kind, **attrs)
        if (self._watched is not None and self.snapshot_interval > 0.0
                and (self._last_snap is None
                     or t - self._last_snap >= self.snapshot_interval)):
            self.snapshot_estimator(t)

    # -- side channels --------------------------------------------------------
    def note_arrival(self, t: float, item) -> None:
        """Record one submitted Request/Task payload (replay input)."""
        self.arrivals.append(_arrival_blob(t, item))

    def watch_estimator(self, estimator, interval: float = 0.0) -> None:
        """Snapshot ``estimator.dump()`` every ``interval`` virtual-time
        units as events stream through (0 keeps snapshots manual)."""
        self._watched = estimator
        if interval > 0.0:
            self.snapshot_interval = float(interval)

    def snapshot_estimator(self, t: float, estimator=None) -> None:
        est = estimator if estimator is not None else self._watched
        if est is None:
            return
        self._last_snap = t
        self.est_snapshots.append({"t": round(t, 6),
                                   "estimator": est.dump()})

    def use_profiler(self, profiler) -> None:
        """Reference a KernelProfiler whose records/summary ride along."""
        self._profiler = profiler

    def note_machines(self, machines) -> None:
        """Record the fleet table (mids must survive into the replay so the
        rebuilt simulator pool is identical to the recorded one)."""
        self.machines = [{"mid": m.mid, "mtype": m.mtype,
                          "speed": m.speed, "cost_rate": m.cost_rate,
                          "queue_size": m.queue_size} for m in machines]

    def note_engine_config(self, cfg) -> None:
        """Record the control knobs a faithful replay must reproduce
        (EngineConfig and SimConfig both expose this subset)."""
        import dataclasses
        import enum
        pruning = getattr(cfg, "pruning", None)
        blob = None
        if pruning is not None:
            blob = {k: (v.value if isinstance(v, enum.Enum) else v)
                    for k, v in dataclasses.asdict(pruning).items()}
        self.engine_config = {
            "heuristic": getattr(cfg, "heuristic", "EDF"),
            "merging": getattr(cfg, "merging", "none"),
            "position_finder": getattr(cfg, "position_finder", None),
            "alpha": getattr(cfg, "alpha", 2.0),
            "merge_degree_cap": getattr(cfg, "merge_degree_cap", 5),
            "result_cache": getattr(cfg, "result_cache", False),
            "pruning": blob,
        }

    def note_stats(self, stats: dict) -> None:
        """Keep the run's numeric counters as drift-audit ground truth."""
        self.run_stats = {k: v for k, v in stats.items()
                          if isinstance(v, (int, float, bool))}

    # -- serialization --------------------------------------------------------
    def to_artifact(self) -> dict:
        from .schema import SCHEMA_VERSION
        art = {"kind": RECORD_KIND, "schema": SCHEMA_VERSION,
               "capacity": self.capacity,
               "events": [dict(e) for e in self.events],
               "events_dropped": self.events_dropped,
               "arrivals": list(self.arrivals),
               "estimator_snapshots": list(self.est_snapshots),
               "machines": list(self.machines),
               "engine_config": dict(self.engine_config),
               "stats": dict(self.run_stats),
               "meta": dict(self.meta)}
        if self._profiler is not None:
            art["kernel"] = {"summary": self._profiler.summary(),
                             "launches": len(self._profiler.records)}
        return art

    def save(self, path: str) -> dict:
        art = self.to_artifact()
        with open(path, "w") as f:
            json.dump(art, f)
        return art


def load_record(path: str) -> dict:
    """Load + sanity-check a flight-record artifact."""
    with open(path) as f:
        obj = json.load(f)
    from .schema import validate_flight_record
    validate_flight_record(obj, path=path)
    return obj
