"""PMF algebra for probabilistic task scheduling (dissertation Ch. 5).

Tasks carry a *Probabilistic Execution Time* (PET) — a probability mass
function over a discrete time grid.  The *Probabilistic Completion Time*
(PCT) of a task in a machine queue is the convolution of its PET with the
PCT of the task ahead of it (Fig. 5.3), with three closed forms depending on
the dropping regime (Eqs. 5.2-5.5):

  * ``NO_DROP``  - every mapped task runs to completion (Eq. 5.2)
  * ``PEND_DROP``- pending tasks whose deadline passed are dropped (Eq. 5.4)
  * ``EVICT_DROP``- even the executing task is evicted at its deadline (Eq. 5.5)

All PMFs live on an integer time grid.  A PMF is stored as a dense vector of
probabilities plus an integer ``offset`` (the absolute time of index 0), so
shifting a PMF is O(1).

The module also implements the dissertation's two overhead-reduction
techniques (§5.5): *impulse compaction* (approximating a PMF onto a coarser
bucket grid, Fig. 5.7) and *memoized chance-of-success* (Procedure 2 /
Fig. 5.8 - success probability without materializing the convolution).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

__all__ = [
    "DropMode",
    "PMF",
    "convolve_pct",
    "chance_of_success",
    "queue_pcts",
]


class DropMode(enum.Enum):
    NO_DROP = "no_drop"
    PEND_DROP = "pend_drop"
    EVICT_DROP = "evict_drop"


@dataclass(frozen=True)
class PMF:
    """A probability mass function on the integer time grid.

    ``values[k]`` is the probability of the event occurring at absolute time
    ``offset + k``.  Values need not sum to one (truncated PMFs legitimately
    carry less mass), but must be non-negative.
    """

    values: np.ndarray
    offset: int = 0

    def __post_init__(self):
        v = np.asarray(self.values, dtype=np.float64)
        if v.ndim != 1:
            raise ValueError(f"PMF values must be 1-D, got shape {v.shape}")
        if v.size and v.min() < -1e-12:
            raise ValueError("PMF values must be non-negative")
        object.__setattr__(self, "values", np.maximum(v, 0.0))

    # -- constructors -----------------------------------------------------
    @staticmethod
    def impulse(t: int, p: float = 1.0) -> "PMF":
        return PMF(np.array([p], dtype=np.float64), offset=int(t))

    @staticmethod
    def from_samples(samples) -> "PMF":
        """Histogram integer-rounded samples into a PMF."""
        s = np.asarray(samples, dtype=np.float64)
        s = np.maximum(np.rint(s).astype(np.int64), 0)
        lo, hi = int(s.min()), int(s.max())
        counts = np.bincount(s - lo, minlength=hi - lo + 1).astype(np.float64)
        return PMF(counts / counts.sum(), offset=lo)

    @staticmethod
    def from_normal(mean: float, std: float, n_sigma: float = 4.0) -> "PMF":
        """Discretized Normal, truncated at ``mean ± n_sigma·std`` and at 1."""
        std = max(std, 1e-9)
        lo = max(1, int(np.floor(mean - n_sigma * std)))
        hi = max(lo, int(np.ceil(mean + n_sigma * std)))
        t = np.arange(lo, hi + 1, dtype=np.float64)
        pdf = np.exp(-0.5 * ((t - mean) / std) ** 2)
        pdf /= pdf.sum()
        return PMF(pdf, offset=lo)

    @staticmethod
    def from_gamma(mean: float, cv: float = 0.3, n: int = 64) -> "PMF":
        """Discretized Gamma with coefficient-of-variation ``cv``.

        Gamma-distributed execution times follow the HC-systems literature
        the dissertation builds on (Shestak et al.).
        """
        from scipy import stats

        k = 1.0 / (cv * cv)
        theta = mean / k
        qs = np.linspace(0.001, 0.999, n)
        xs = stats.gamma.ppf(qs, a=k, scale=theta)
        return PMF.from_samples(xs)

    # -- basic stats -------------------------------------------------------
    @property
    def mass(self) -> float:
        return float(self.values.sum())

    @property
    def support_end(self) -> int:
        return self.offset + len(self.values) - 1

    def times(self) -> np.ndarray:
        return np.arange(self.offset, self.offset + len(self.values))

    def mean(self) -> float:
        m = self.mass
        if m <= 0:
            return 0.0
        return float((self.times() * self.values).sum() / m)

    def var(self) -> float:
        m = self.mass
        if m <= 0:
            return 0.0
        mu = self.mean()
        return float((((self.times() - mu) ** 2) * self.values).sum() / m)

    def std(self) -> float:
        return float(np.sqrt(self.var()))

    def skewness(self) -> float:
        """Bounded sample skewness ``s`` (Eq. 5.6), clamped to [-1, 1].

        The dissertation treats |S| >= 1 as "highly skewed" and works with the
        bounded value.
        """
        m = self.mass
        if m <= 0:
            return 0.0
        mu, sd = self.mean(), self.std()
        if sd < 1e-12:
            return 0.0
        t = self.times()
        s = float((((t - mu) / sd) ** 3 * self.values).sum() / m)
        return float(np.clip(s, -1.0, 1.0))

    # -- transforms ---------------------------------------------------------
    def shift(self, dt: int) -> "PMF":
        return PMF(self.values, offset=self.offset + int(dt))

    def normalize(self) -> "PMF":
        m = self.mass
        return self if m <= 0 else PMF(self.values / m, offset=self.offset)

    def scale(self, factor: float) -> "PMF":
        """Scale the *time axis* by ``factor`` (machine speed heterogeneity)."""
        if factor == 1.0:
            return self
        t = np.maximum(np.rint(self.times() * factor).astype(np.int64), 0)
        lo, hi = int(t.min()), int(t.max())
        out = np.zeros(hi - lo + 1, dtype=np.float64)
        np.add.at(out, t - lo, self.values)
        return PMF(out, offset=lo)

    def cdf_at(self, t: int) -> float:
        """P(X <= t)."""
        idx = int(t) - self.offset
        if idx < 0:
            return 0.0
        idx = min(idx, len(self.values) - 1)
        return float(self.values[: idx + 1].sum())

    def success_before(self, deadline: int) -> float:
        """Eq. 5.1 - probability of completing at or before ``deadline``."""
        return self.cdf_at(deadline)

    def compact(self, bucket: int, lo: int | None = None, hi: int | None = None) -> "PMF":
        """Impulse compaction (Fig. 5.7): group impulses into ``bucket``-wide
        bins inside [lo, hi]; everything below ``lo`` collapses onto ``lo``
        and everything at/above ``hi`` collapses onto ``hi``.

        This is the dissertation's approximation to cut convolution cost; it
        doubles as the length-normalizer feeding the fixed-shape batched
        ``pmf_conv`` kernel.
        """
        if bucket < 1:
            raise ValueError("bucket must be >= 1")
        t = self.times()
        lo = int(t.min()) if lo is None else int(lo)
        hi = int(t.max()) if hi is None else int(hi)
        if hi < lo:
            hi = lo
        tt = np.clip(t, lo, hi)
        # bucket index relative to lo; bucket centers at lo + b*bucket
        b = (tt - lo) // bucket
        nb = int(b.max()) + 1 if len(b) else 1
        vals = np.zeros(nb, dtype=np.float64)
        np.add.at(vals, b, self.values)
        if bucket == 1:
            return PMF(vals, offset=lo)
        # re-expand bucket grid onto the integer grid (stride = bucket)
        dense = np.zeros((nb - 1) * bucket + 1, dtype=np.float64)
        dense[::bucket] = vals
        return PMF(dense, offset=lo)

    def __repr__(self) -> str:  # pragma: no cover
        return f"PMF(offset={self.offset}, n={len(self.values)}, mass={self.mass:.4f}, mean={self.mean():.2f})"


# ---------------------------------------------------------------------------
# Completion-time construction (Eqs. 5.2-5.5)
# ---------------------------------------------------------------------------

def _raw_convolve(pet: PMF, pct_prev: PMF) -> PMF:
    vals = np.convolve(pct_prev.values, pet.values)
    return PMF(vals, offset=pet.offset + pct_prev.offset)


def convolve_pct(pet: PMF, pct_prev: PMF | None, deadline: int | None,
                 mode: DropMode = DropMode.NO_DROP) -> PMF:
    """PCT(i, j) from PET(i, j) and PCT(i-1, j).

    ``pct_prev is None`` means the machine is idle: the PET is already the
    PCT (the caller is expected to have shifted the PET by the start time).

    For ``PEND_DROP``/``EVICT_DROP`` the returned PMF describes *when the
    machine becomes free of task i* (the dissertation's PCT semantics): mass
    where task i was dropped passes through from PCT(i-1, j).
    """
    if pct_prev is None:
        out = pet
        if mode is DropMode.EVICT_DROP and deadline is not None:
            out = _collapse_tail(out, deadline)
        return out

    if mode is DropMode.NO_DROP or deadline is None:
        return _raw_convolve(pet, pct_prev)

    # Split prev mass: the part finishing strictly before the deadline lets
    # task i run (Eq. 5.3's f(t,k) keeps (t-k) < delta_i); the rest means
    # task i is dropped and the machine frees whenever i-1 frees.
    dl = int(deadline)
    cut = dl - pct_prev.offset  # first index with time >= deadline
    cut = max(0, min(cut, len(pct_prev.values)))
    prev_ok = PMF(pct_prev.values[:cut], offset=pct_prev.offset) if cut > 0 else None
    late_vals = pct_prev.values[cut:]

    if prev_ok is not None and prev_ok.mass > 0:
        conv = _raw_convolve(pet, prev_ok)
    else:
        conv = PMF(np.zeros(1), offset=dl)

    # add pass-through of late prev mass (Eq. 5.4 second term)
    out = _add(conv, PMF(late_vals, offset=pct_prev.offset + cut)) if late_vals.size else conv

    if mode is DropMode.EVICT_DROP:
        out = _collapse_tail(out, dl)
    return out


def _add(a: PMF, b: PMF) -> PMF:
    lo = min(a.offset, b.offset)
    hi = max(a.support_end, b.support_end)
    out = np.zeros(hi - lo + 1, dtype=np.float64)
    out[a.offset - lo: a.offset - lo + len(a.values)] += a.values
    out[b.offset - lo: b.offset - lo + len(b.values)] += b.values
    return PMF(out, offset=lo)


def _collapse_tail(p: PMF, deadline: int) -> PMF:
    """Eq. 5.5 - mass at t > deadline collapses onto the deadline impulse
    (the task is evicted at its deadline, freeing the machine)."""
    idx = int(deadline) - p.offset
    if idx >= len(p.values) - 1:
        return p
    if idx < 0:
        # whole support is past the deadline
        return PMF(np.array([p.mass]), offset=int(deadline))
    vals = p.values[: idx + 1].copy()
    vals[idx] += p.values[idx + 1:].sum()
    return PMF(vals, offset=p.offset)


def chance_of_success(pet: PMF, pct_prev: PMF | None, deadline: int,
                      droppable_prev: bool = True) -> float:
    """Memoized chance-of-success (Procedure 2, Fig. 5.8).

    P(task i completes <= deadline) without materializing the convolution:

        p = sum_k  e(k) * P(prev frees at c, c + k <= deadline[, c < deadline])

    Implemented with a cumulative sum over the previous PCT — O(|E| + |C|)
    instead of the O(|E|·|C|) convolution.  ``droppable_prev`` bounds the
    start times to strictly-before-deadline (task i would itself be dropped
    once its deadline passes).
    """
    dl = int(deadline)
    if pct_prev is None:
        return pet.success_before(dl)
    csum = np.cumsum(pct_prev.values)
    # latest time the previous task may free the machine, per PET impulse k
    t_latest = dl - pet.times()
    if droppable_prev:
        t_latest = np.minimum(t_latest, dl - 1)  # i dropped once its dl passes
    idx = t_latest - pct_prev.offset
    cdf = np.where(idx < 0, 0.0, csum[np.clip(idx, 0, len(csum) - 1)])
    return float(min(pet.values @ cdf, 1.0))


def queue_pcts(pets: list[PMF], deadlines: list[int], start: PMF | None = None,
               mode: DropMode = DropMode.PEND_DROP) -> list[PMF]:
    """Fold Eqs. 5.2-5.5 along a machine queue; returns PCT per position."""
    pcts: list[PMF] = []
    prev = start
    for pet, dl in zip(pets, deadlines):
        prev = convolve_pct(pet, prev, dl, mode=mode)
        pcts.append(prev)
    return pcts
