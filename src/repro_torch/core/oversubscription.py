"""Oversubscription quantification and reaction (Sections 4.5 and 5.3.5).

Two complementary signals:

* **OSL** (Eq. 4.3) - deadline-miss *severity* over the current queues;
  drives the adaptive merge-aggressiveness ``alpha = 2 - 4*OSL``.
* **EWMA miss counter** (Eq. 5.11) with a **Schmitt trigger** (20%
  hysteresis) - decides when the pruner escalates from deferring-only to
  active task dropping.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .tasks import Machine

__all__ = ["oversubscription_level", "adaptive_alpha", "DropToggle"]


def oversubscription_level(machines: list[Machine], exec_time, now: float,
                           alpha: float = 2.0) -> float:
    """OSL per Eq. 4.3 over all machine-queued tasks.

    Infeasible tasks (W_i < 0) and on-time tasks contribute 0; late tasks
    contribute (C - delta) / W  — miss severity relative to waitable time.
    """
    total, n = 0.0, 0
    for m in machines:
        t = max(now, m.run_end if m.running else now)
        for task in m.queue:
            mu, sigma = exec_time(task, m)
            e = max(mu + alpha * sigma, 0.0)
            t += e
            n += 1
            w = task.deadline - task.arrival - e
            if w <= 0 or t <= task.deadline:
                continue
            total += min((t - task.deadline) / w, 4.0)  # cap pathological ratios
    return total / n if n else 0.0


def adaptive_alpha(osl: float) -> float:
    """alpha = 2 - 4*OSL, clamped to [-2, 2] (Section 4.5.3).

    OSL=0   -> alpha=+2   (97.7% worst-case confidence: conservative)
    OSL>=1  -> alpha=-2   (2.3%: merge aggressively)
    """
    return float(max(-2.0, min(2.0, 2.0 - 4.0 * osl)))


@dataclass
class DropToggle:
    """EWMA oversubscription tracker with Schmitt-trigger hysteresis.

    d_tau = mu_tau * lam + d_(tau-1) * (1 - lam)        (Eq. 5.11)

    Dropping engages when d >= on_level and disengages only when
    d <= off_level (default 20% separation, Section 5.3.5).
    """

    lam: float = 0.3
    on_level: float = 2.0
    off_level: float | None = None
    use_schmitt: bool = True
    d: float = 0.0
    engaged: bool = False
    history: list = field(default_factory=list)

    def __post_init__(self):
        if self.off_level is None:
            self.off_level = 0.8 * self.on_level

    def observe(self, misses_since_last_event: int) -> bool:
        """Update the EWMA with the misses since the previous mapping event;
        returns whether dropping is engaged."""
        self.d = misses_since_last_event * self.lam + self.d * (1.0 - self.lam)
        self.history.append(self.d)
        if self.use_schmitt:
            if not self.engaged and self.d >= self.on_level:
                self.engaged = True
            elif self.engaged and self.d <= self.off_level:
                self.engaged = False
        else:
            self.engaged = self.d >= self.on_level
        return self.engaged
