"""Telemetry recorder — per-request lifecycle events (DESIGN.md §2.9).

One :class:`Telemetry` instance is shared by every layer of a plane (or a
whole router): the control plane emits lifecycle events, the KV caches emit
hit/miss/evict events, the autoscaler emits scale events.  Events are plain
dicts with a virtual-clock timestamp ``t`` (ticks on the engine, simulated
seconds on the simulator) so the streams from both substrates are directly
diffable; an optional monotonic ``wall`` stamp rides along on the engine for
Chrome-trace wall-clock tracks and is excluded from equivalence diffs.

The default recorder everywhere is :data:`NULL` — a no-op whose ``event()``
does nothing and whose metrics sink discards writes.  Decision code never
*reads* telemetry, so attaching a real recorder is provably
zero-perturbation (tested in tests/test_obs.py by diffing decision traces
with telemetry on vs off).
"""

from __future__ import annotations

from .metrics import MetricsRegistry, NullMetrics

__all__ = ["Telemetry", "NullTelemetry", "NULL"]


class Telemetry:
    """Append-only event recorder plus a metrics registry.

    ``wall_clock`` — optional zero-arg callable returning wall seconds
    (the engine passes ``time.perf_counter``); when set, every event also
    carries a ``wall`` key.  ``attrs`` set via :meth:`scoped` ride on every
    event from that scope (e.g. ``plane=2``).
    """

    enabled = True

    def __init__(self, metrics: MetricsRegistry | None = None,
                 wall_clock=None):
        self.events: list[dict] = []
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.wall_clock = wall_clock

    def event(self, t: float, kind: str, **attrs) -> None:
        ev = {"t": round(float(t), 9), "kind": kind}
        for k, v in attrs.items():
            if v is not None:
                ev[k] = v
        if self.wall_clock is not None:
            ev["wall"] = self.wall_clock()
        self.events.append(ev)

    # -- conveniences ---------------------------------------------------------
    def events_of(self, *kinds: str) -> list[dict]:
        want = set(kinds)
        return [e for e in self.events if e["kind"] in want]

    def comparable_events(self) -> list[dict]:
        """Events with substrate-only keys (``wall``) stripped — the stream
        the sim↔engine diff tests compare."""
        return [{k: v for k, v in e.items() if k != "wall"}
                for e in self.events]

    def clear(self) -> None:
        self.events.clear()


class NullTelemetry:
    """Inert recorder: the default wired into every layer."""

    enabled = False
    events: list = []           # class-level, never written
    wall_clock = None
    metrics = NullMetrics()

    def event(self, t, kind, **attrs):
        pass

    def events_of(self, *kinds):
        return []

    def comparable_events(self):
        return []

    def clear(self):
        pass


NULL = NullTelemetry()
