"""Metrics registry: counters, gauges, and streaming histograms (DESIGN.md §2.9).

Dependency-free by design — the registry must be importable from the pure
control-plane path (no numpy, no JAX) so the simulator can run with metrics
enabled in environments where only the stdlib is present.

The histogram is a signed log-binned sketch: values in ``[lo, hi]`` land in
geometric bins whose edges grow by ``growth`` per bin, so any reported
quantile is the representative of the bin holding the true order statistic —
a relative error of at most ``growth - 1`` (default 5%).  Unlike a P² sketch
it is deterministic, mergeable, and exact about *counts*, which is what the
zero-perturbation tests diff.
"""

from __future__ import annotations

import json
import math

__all__ = ["StreamingHistogram", "MetricsRegistry", "NullMetrics"]


class StreamingHistogram:
    """Log-binned streaming histogram with bounded relative quantile error.

    ``lo`` is the resolution floor: magnitudes below it collapse into a
    single near-zero bin (reported as 0.0), magnitudes above ``hi`` clamp
    to the outermost bin.  Negative values get a mirrored bin array, so
    slack distributions (which straddle zero) keep their sign structure.
    """

    __slots__ = ("lo", "hi", "growth", "_log_g", "_n_bins",
                 "pos", "neg", "zeros", "count", "total", "vmin", "vmax")

    def __init__(self, lo: float = 1e-4, hi: float = 1e6,
                 growth: float = 1.05):
        if not (lo > 0 and hi > lo and growth > 1.0):
            raise ValueError("need 0 < lo < hi and growth > 1")
        self.lo = lo
        self.hi = hi
        self.growth = growth
        self._log_g = math.log(growth)
        self._n_bins = int(math.ceil(math.log(hi / lo) / self._log_g)) + 1
        self.pos: dict[int, int] = {}
        self.neg: dict[int, int] = {}
        self.zeros = 0
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    # -- write ---------------------------------------------------------------
    def _bin(self, mag: float) -> int:
        if not mag < self.hi:
            return self._n_bins     # an infinite slack (no deadline) too
        idx = int(math.log(mag / self.lo) / self._log_g) + 1
        return min(max(idx, 1), self._n_bins)

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        mag = abs(v)
        if mag < self.lo:
            self.zeros += 1
        elif v > 0:
            b = self._bin(mag)
            self.pos[b] = self.pos.get(b, 0) + 1
        else:
            b = self._bin(mag)
            self.neg[b] = self.neg.get(b, 0) + 1

    # -- read ----------------------------------------------------------------
    def _representative(self, idx: int, sign: int) -> float:
        # geometric midpoint of the bin [lo*g^(i-1), lo*g^i]
        val = self.lo * (self.growth ** (idx - 0.5))
        return sign * val

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1]; 0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        q = min(max(q, 0.0), 1.0)
        # rank of the k-th order statistic (1-based), inverted-CDF convention
        rank = max(1, int(math.ceil(q * self.count)))
        seen = 0
        for idx in sorted(self.neg, reverse=True):   # most negative first
            seen += self.neg[idx]
            if seen >= rank:
                return self._representative(idx, -1)
        if seen + self.zeros >= rank:
            return 0.0
        seen += self.zeros
        for idx in sorted(self.pos):
            seen += self.pos[idx]
            if seen >= rank:
                return self._representative(idx, +1)
        return self.vmax if math.isfinite(self.vmax) else 0.0

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


def _key(name: str, labels: dict | None):
    if not labels:
        return (name, ())
    return (name, tuple(sorted(labels.items())))


def _fmt_labels(label_items) -> str:
    if not label_items:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in label_items)
    return "{" + inner + "}"


class MetricsRegistry:
    """Labeled counters, gauges, and histograms with snapshot/Prometheus
    export.  Keys are ``(name, sorted-label-tuple)`` so label order never
    matters."""

    def __init__(self):
        self.counters: dict = {}
        self.gauges: dict = {}
        self.histograms: dict = {}

    enabled = True

    # -- write ---------------------------------------------------------------
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        k = _key(name, labels)
        self.counters[k] = self.counters.get(k, 0) + value

    def gauge(self, name: str, value: float, **labels) -> None:
        self.gauges[_key(name, labels)] = value

    def observe(self, name: str, value: float, **labels) -> None:
        k = _key(name, labels)
        h = self.histograms.get(k)
        if h is None:
            h = self.histograms[k] = StreamingHistogram()
        h.observe(value)

    # -- read ----------------------------------------------------------------
    def counter_value(self, name: str, **labels) -> float:
        return self.counters.get(_key(name, labels), 0)

    def histogram(self, name: str, **labels) -> StreamingHistogram | None:
        return self.histograms.get(_key(name, labels))

    def snapshot(self) -> dict:
        """JSON-serializable view: counters/gauges keyed by
        ``name{label="v",...}`` strings, histograms as quantile summaries."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for (name, items), v in sorted(self.counters.items()):
            out["counters"][name + _fmt_labels(items)] = v
        for (name, items), v in sorted(self.gauges.items()):
            out["gauges"][name + _fmt_labels(items)] = v
        for (name, items), h in sorted(self.histograms.items()):
            out["histograms"][name + _fmt_labels(items)] = h.summary()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (snapshot semantics)."""
        lines = []
        seen_type: set[str] = set()
        for (name, items), v in sorted(self.counters.items()):
            if name not in seen_type:
                lines.append(f"# TYPE {name} counter")
                seen_type.add(name)
            lines.append(f"{name}{_fmt_labels(items)} {v}")
        for (name, items), v in sorted(self.gauges.items()):
            if name not in seen_type:
                lines.append(f"# TYPE {name} gauge")
                seen_type.add(name)
            lines.append(f"{name}{_fmt_labels(items)} {v}")
        for (name, items), h in sorted(self.histograms.items()):
            if name not in seen_type:
                lines.append(f"# TYPE {name} summary")
                seen_type.add(name)
            lbl = dict(items)
            for q in (0.5, 0.95, 0.99):
                qi = tuple(sorted({**lbl, "quantile": str(q)}.items()))
                lines.append(f"{name}{_fmt_labels(qi)} {h.quantile(q)}")
            lines.append(f"{name}_sum{_fmt_labels(items)} {h.total}")
            lines.append(f"{name}_count{_fmt_labels(items)} {h.count}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)


class NullMetrics:
    """Zero-cost sink used by :data:`repro.obs.telemetry.NULL`."""

    enabled = False

    def inc(self, name, value=1.0, **labels):
        pass

    def gauge(self, name, value, **labels):
        pass

    def observe(self, name, value, **labels):
        pass

    def counter_value(self, name, **labels):
        return 0

    def histogram(self, name, **labels):
        return None

    def snapshot(self):
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def to_prometheus(self):
        return ""

    def to_json(self):
        return "{}"
