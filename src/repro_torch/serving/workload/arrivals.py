"""Arrival processes: seeded, streaming, substrate-free (DESIGN.md §2.11).

An :class:`ArrivalProcess` is a time-varying relative intensity
``weight(t)`` with a known envelope ``peak`` (its maximum over time),
consumed two ways:

* ``iter_times(rng, rate)`` — unbounded *streaming* generation by
  Lewis-Shedler thinning at the peak intensity: candidates arrive as a
  homogeneous Poisson stream at ``rate * peak`` and each survives with
  probability ``weight(t) / peak``.  O(1) memory, one instant at a time —
  this is what lets the closed-loop driver sustain millions of simulated
  users without ever materializing a trace.
* ``sample_times(rng, n, span)`` — the dissertation's bounded
  rejection-sampling loop (uniform candidate over the span, accepted with
  probability ``weight(t) / peak``).  The Chapter 4/5 generators re-hosted
  in :mod:`repro.serving.workload.generators` run exactly this loop with
  their original RNG, so re-hosting changed none of their output.

The module also carries the workload subsystem's determinism primitive:
``mix64`` / ``unit_float``, a SplitMix64-style avalanche hash used to
derive per-(session, turn) draws as *pure functions* of the seed.  Pure
draws are what keep the generator deterministic regardless of completion
order, and they cost ~1µs — constructing a numpy ``Generator`` per event
would dominate the control plane at million-user scale.

A copy of ``repro.serving.workload.arrivals`` for the port, unchanged but for this line.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["ArrivalProcess", "PoissonProcess", "DiurnalProcess",
           "BurstyProcess", "SpikeSchedule", "mix64", "unit_float",
           "sample_think"]


_MASK = (1 << 64) - 1


def mix64(*vals: int) -> int:
    """SplitMix64-style avalanche over a tuple of ints.

    Python's builtin ``hash`` is salted per process and numpy Generator
    construction is too slow for per-event use, so this is the seed-stable
    hash stream every pure per-(uid, turn) draw in the subsystem uses."""
    h = 0x9E3779B97F4A7C15
    for v in vals:
        h = (h + (int(v) & _MASK)) & _MASK
        h ^= h >> 30
        h = (h * 0xBF58476D1CE4E5B9) & _MASK
        h ^= h >> 27
        h = (h * 0x94D049BB133111EB) & _MASK
        h ^= h >> 31
    return h


def unit_float(*vals: int) -> float:
    """Deterministic uniform in [0, 1) from the hash stream."""
    return mix64(*vals) / 2.0 ** 64


def sample_think(spec, u1: float, u2: float = 0.5) -> float:
    """One think-time draw from a distribution spec using pre-drawn
    uniforms (pure — independent of completion order).

    Specs: ``("const", v)`` | ``("uniform", lo, hi)`` | ``("exp", mean)``
    | ``("lognorm", median, sigma)``.
    """
    kind = spec[0]
    if kind == "const":
        return float(spec[1])
    if kind == "uniform":
        lo, hi = float(spec[1]), float(spec[2])
        return lo + (hi - lo) * u1
    if kind == "exp":
        return -float(spec[1]) * math.log(max(1.0 - u1, 1e-12))
    if kind == "lognorm":
        # Box-Muller from the two pre-drawn uniforms
        z = math.sqrt(-2.0 * math.log(max(u1, 1e-12))) \
            * math.cos(2.0 * math.pi * u2)
        return float(spec[1]) * math.exp(float(spec[2]) * z)
    raise ValueError(f"unknown think-time distribution {spec!r}")


class ArrivalProcess:
    """Base: constant intensity (weight 1 everywhere, peak 1)."""

    #: maximum of ``weight`` over time — thinning envelope / acceptance scale
    peak: float = 1.0

    def weight(self, t: float) -> float:
        """Relative intensity at ``t`` (1.0 = base rate)."""
        return 1.0

    # -- streaming (closed-loop driver) --------------------------------------
    def iter_times(self, rng, rate: float, start: float = 0.0):
        """Yield arrival instants forever: thinned Poisson at mean base
        intensity ``rate`` arrivals per time unit."""
        t = float(start)
        peak = self.peak
        scale = 1.0 / (rate * peak)
        while True:
            t += rng.exponential(scale)
            if peak <= 1.0 or rng.random() * peak <= self.weight(t):
                yield t

    # -- bounded (Chapter 4/5 generators) ------------------------------------
    def sample_times(self, rng, n: int, span: float) -> list[float]:
        """``n`` sorted instants over ``[0, span)`` by rejection sampling —
        draw-for-draw the dissertation generators' original loop."""
        peak = self.peak
        times: list[float] = []
        while len(times) < n:
            t = float(rng.uniform(0, span))
            if rng.random() < self.weight(t) / peak:
                times.append(t)
        times.sort()
        return times


class PoissonProcess(ArrivalProcess):
    """Homogeneous Poisson arrivals (the open-loop baseline)."""


@dataclass
class DiurnalProcess(ArrivalProcess):
    """Cyclic high-load windows over a base rate — the Chapter-4 daily
    pattern.  ``peaks`` are (start, end) offsets inside one ``cycle``;
    weight is ``high`` inside any window, 1.0 outside."""

    cycle: float
    peaks: tuple = ()
    high: float = 2.0

    @property
    def peak(self) -> float:
        return self.high

    @classmethod
    def two_peak(cls, cycle: float, high: float = 2.0,
                 width: float = 0.1) -> "DiurnalProcess":
        """The classic two-peak day: rush windows of ``width`` · cycle
        centered at 35% and 75% of the cycle."""
        c = float(cycle)
        half = width / 2.0
        return cls(cycle=c, high=high,
                   peaks=(((0.35 - half) * c, (0.35 + half) * c),
                          ((0.75 - half) * c, (0.75 + half) * c)))

    def weight(self, t: float) -> float:
        x = t % self.cycle
        return self.high if any(a <= x < b for a, b in self.peaks) else 1.0


@dataclass
class BurstyProcess(ArrivalProcess):
    """Spike-on-base (Chapter 5, Fig. 5.9): weight ``high`` inside any
    absolute (start, end) window, 1.0 outside."""

    windows: tuple = ()
    high: float = 4.0

    @property
    def peak(self) -> float:
        return self.high

    def weight(self, t: float) -> float:
        return self.high if any(a <= t < b for a, b in self.windows) else 1.0


class SpikeSchedule:
    """Keyed spike windows (the Chapter-5 *per-type* bursts): each key gets
    its own window set over a shared base rate."""

    def __init__(self, windows: dict, high: float = 4.0):
        self.windows = windows
        self.high = high

    @classmethod
    def sample(cls, rng, keys, span: float, n_range: tuple = (2, 5),
               width: float = 0.05, high: float = 4.0) -> "SpikeSchedule":
        """Draw ``n_range`` windows of ``width``·span per key — the exact
        draw sequence of the original Chapter-5 generator."""
        windows = {}
        for k in keys:
            n = int(rng.integers(*n_range))
            starts = rng.uniform(0, span * 0.9, size=n)
            windows[k] = [(s, s + span * width) for s in starts]
        return cls(windows, high=high)

    def weight(self, key, t: float) -> float:
        return (self.high
                if any(a <= t < b for a, b in self.windows[key]) else 1.0)

    def process(self, key) -> BurstyProcess:
        """The per-key view as a standalone :class:`BurstyProcess`."""
        return BurstyProcess(windows=tuple(self.windows[key]), high=self.high)
