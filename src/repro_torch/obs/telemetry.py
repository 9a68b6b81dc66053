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

Timed spans (:meth:`Telemetry.span`) are registry counters, not events:
``span_s``, ``span_self_s`` (the part no nested span covers) and ``span_n``,
each labelled ``span=<name>``, on ``time.perf_counter``.  They write no
event, so the simulator's and the engine's streams stay diffable.  With
``annotate`` set, each span is also a ``torch.profiler.record_function``
range, so a device trace names its idle gaps by the program's spans.
"""

from __future__ import annotations

import time

from .metrics import MetricsRegistry, NullMetrics

__all__ = ["Telemetry", "NullTelemetry", "NULL", "clock_anchor"]


class _Span:
    """A named span of one recorder.  Reentrant: what an open span needs
    (start, seconds its children took, profiler range) lives on the
    recorder's stack, so one object serves every use of the name."""

    __slots__ = ("tel", "name")

    def __init__(self, tel: "Telemetry", name: str):
        self.tel = tel
        self.name = name

    def __enter__(self):
        rf = None
        if self.tel.annotate:
            from torch.profiler import record_function
            rf = record_function(self.name)
            rf.__enter__()
        self.tel._open.append([time.perf_counter(), 0.0, rf])
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        stack = self.tel._open
        t0, inner, rf = stack.pop()
        dt = t1 - t0
        if stack:
            stack[-1][1] += dt
        m = self.tel.metrics
        m.inc("span_s", dt, span=self.name)
        m.inc("span_self_s", dt - inner, span=self.name)
        m.inc("span_n", 1, span=self.name)
        if rf is not None:
            rf.__exit__(*exc)
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


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
        #: also mark every span as a ``torch.profiler`` range (set only
        #: while a device trace runs)
        self.annotate = False
        self._spans: dict[str, _Span] = {}
        self._open: list[list] = []

    def span(self, name: str) -> _Span:
        """Context manager timing ``name`` into the registry's span
        counters.  It never syncs the device and adds no event."""
        s = self._spans.get(name)
        if s is None:
            s = self._spans[name] = _Span(self, name)
        return s

    def span_totals(self) -> dict:
        """``{name: {"span_s": ..., "span_self_s": ..., "span_n": ...}}``
        over every span recorded so far."""
        out: dict = {}
        for (name, labels), v in self.metrics.counters.items():
            if name in ("span_s", "span_self_s", "span_n"):
                out.setdefault(dict(labels)["span"], {})[name] = v
        return out

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
    annotate = False
    metrics = NullMetrics()

    def event(self, t, kind, **attrs):
        pass

    def span(self, name):
        return _NULL_SPAN

    def span_totals(self):
        return {}

    def events_of(self, *kinds):
        return []

    def comparable_events(self):
        return []

    def clear(self):
        pass


NULL = NullTelemetry()


def clock_anchor(name: str = "clock_anchor") -> float:
    """Mark the running ``torch.profiler`` session with a range ``name``
    and return the ``time.perf_counter`` reading taken inside it: the
    range's trace ``ts`` (microseconds) minus 1e6 times the reading is the
    offset that places perf_counter stamps (spans, request stamps) on the
    trace's timeline."""
    from torch.profiler import record_function
    with record_function(name + ".warm"):
        pass        # a session's first range pays its set-up (~1 ms)
    with record_function(name):
        return time.perf_counter()
