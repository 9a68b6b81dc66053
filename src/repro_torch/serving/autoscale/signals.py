"""Ch. 5 chance-of-success signals for elasticity decisions.

The pruning chapter derives per-batch *chance-of-success* values from
PET/PCT convolutions and argues the system should react to degrading
success probability — not raw queue depth — when deciding how aggressively
to spend resources.  ``batch_chances`` is that signal for one scaling
decision: every queued task's probability of meeting its deadline given
the machine pool as it stands, evaluated in a single batched ``pmf_conv``
launch (the port's ``pmf_conv`` kernel) so the controller's overhead stays
amortized per mapping event, with a pure-NumPy ``chance_of_success`` path
as the fallback (companion-survey framing: keep the control loop's
success-probability evaluation approximate and cheap).

Approximation contract (this is a *control signal*, not the pruner):

* machines with a pruner attached contribute their real, memoized tail PCT
  chain (``Pruner.machine_pcts``); machines without one contribute an
  impulse at their mean-stacked availability time;
* batch tasks are greedily stacked onto the earliest-available machine,
  later tasks seeing earlier ones as a mean-time shift of the tail — so a
  long queue genuinely degrades the aggregate chance instead of every task
  scoring against an idle pool.
"""

from __future__ import annotations

import numpy as np

from ...core.oversubscription import oversubscription_level
from ...core.pmf import PMF, chance_of_success

__all__ = ["ScaleSignals", "batch_chances"]


def _kernel_success(pets, pcts, dls, grid: int, pad_to: int = 0,
                    device=None):
    """Batched kernel path: one ``pmf_conv`` launch on the port's device
    (the CUDA kernel on the card, its plain version on the CPU).  Kernel
    errors propagate — a failed kernel must not silently degrade.

    Rows are padded to ``pad_to`` with zero-success filler so the kernel
    sees one fixed (N, grid) shape across decisions."""
    from ...kernels.pmf_conv.ops import batched_success
    n = len(pets)
    if pad_to > n:
        filler = PMF.impulse(0)
        pets = pets + [filler] * (pad_to - n)
        pcts = pcts + [filler] * (pad_to - n)
        dls = list(dls) + [-1] * (pad_to - n)   # dl<0: success 0, sliced off
    return np.asarray(batched_success(pets, pcts, dls, length=grid,
                                      device=device))[:n]


def batch_chances(batch, machines, oracle, now: float, pruner=None, *,
                  signal_tasks: int = 32, grid: int = 64,
                  use_kernel: bool = True, device=None) -> np.ndarray:
    """Per-task success chance over (a prefix of) the batch queue.

    Returns a float array of len ``min(len(batch), signal_tasks)``; empty
    when there is nothing queued or no machines to run it on.
    """
    if not batch or not machines:
        return np.zeros(0)
    tasks = batch[:signal_tasks]

    # per-machine state: mean-stacked availability + tail PCT of the real
    # queue (the pruner's memoized chain when one is attached)
    avail, tails, extra = {}, {}, {}
    for m in machines:
        t = max(now, m.run_end if m.running is not None else now)
        for q in m.queue:
            mu, _ = oracle.mean_std(q, m)
            t += mu
        avail[m.mid] = t
        extra[m.mid] = 0.0
        tail = None
        if pruner is not None:
            chain = pruner.machine_pcts(m, now)
            tail = chain[-1][1] if chain else None
        tails[m.mid] = tail

    pets, pcts, dls, idx = [], [], [], []
    out = np.zeros(len(tasks))
    for i, task in enumerate(tasks):
        m = min(machines, key=lambda mm: (avail[mm.mid], mm.mid))
        start = avail[m.mid]
        dl = task.effective_deadline
        mu, _ = oracle.mean_std(task, m)
        # stacking accrues for *every* scored task — slack (even
        # infinite-deadline) work still occupies the machine ahead of
        # whatever queues behind it
        avail[m.mid] = start + mu
        shift = extra[m.mid]
        extra[m.mid] += mu
        if not np.isfinite(dl):
            out[i] = 1.0
            continue
        tail = tails[m.mid]
        if tail is None:
            pct = PMF.impulse(int(round(start)))
        else:
            pct = tail.shift(int(round(shift)))
        pets.append(oracle.pmf(task, m))
        pcts.append(pct)
        dls.append(int(dl))
        idx.append(i)

    if not pets:
        return out
    suc = (_kernel_success(pets, pcts, dls, grid, pad_to=signal_tasks,
                           device=device)
           if use_kernel else None)
    if suc is None:
        suc = np.array([chance_of_success(pe, pc, dl)
                        for pe, pc, dl in zip(pets, pcts, dls)])
    out[np.asarray(idx)] = np.clip(suc, 0.0, 1.0)
    return out


def substrate_signals(scaler, cp, machines, oracle, now: float):
    """``ScaleSignals`` for a control-plane substrate (engine/simulator):
    queue depth from the shared batch queue, lazy chance array over the
    substrate's machines and oracle, lazy Eq. 4.3 oversubscription level
    over the machine queues, pruner-backed tails when one is attached."""
    cfg = scaler.cfg
    return ScaleSignals(
        now, len(cp.batch),
        chances_fn=lambda: batch_chances(
            cp.batch, machines, oracle, now, pruner=cp.pruner,
            signal_tasks=cfg.signal_tasks, grid=cfg.signal_grid,
            use_kernel=cfg.use_kernel, device=scaler.device),
        osl_fn=lambda: oversubscription_level(machines, oracle.mean_std,
                                              now),
        extra_machine_seconds=scaler.extra_machine_seconds,
        extra_cost=scaler.extra_pool_cost,
        slo_fn=scaler.slo_fn)


class ScaleSignals:
    """What a scaler policy may consult for one decision.

    The chance array and the OSL scalar are lazy and memoized: the
    ``queue`` policy never pays a convolution, the probabilistic policies
    share one batched kernel launch between ``chance()`` and ``at_risk()``,
    and the Eq. 4.3 walk only runs when ``pressure_signal="osl"`` reads it.
    """

    def __init__(self, now: float, qlen: int, chances_fn=None, osl_fn=None,
                 extra_machine_seconds: float = 0.0,
                 extra_cost: float = 0.0, slo_fn=None):
        self.now = now
        self.qlen = qlen
        self.extra_machine_seconds = extra_machine_seconds
        self.extra_cost = extra_cost
        self._fn = chances_fn
        self._osl_fn = osl_fn
        self._slo_fn = slo_fn
        self._chances = None
        self._osl = None
        self._slo = None

    def chances(self) -> np.ndarray:
        if self._chances is None:
            self._chances = (np.zeros(0) if self._fn is None
                             else np.asarray(self._fn()))
        return self._chances

    def osl(self) -> float:
        """Eq. 4.3 oversubscription level over the machine queues —
        deadline-miss severity as the elasticity pressure (0 without a
        wired-in signal)."""
        if self._osl is None:
            self._osl = 0.0 if self._osl_fn is None else float(self._osl_fn())
        return self._osl

    def chance(self) -> float:
        """Aggregate (mean) success chance; 1.0 with an empty queue."""
        c = self.chances()
        return float(c.mean()) if c.size else 1.0

    def at_risk(self, threshold: float) -> int:
        """Queued tasks whose individual success chance is <= threshold."""
        c = self.chances()
        return int((c <= threshold).sum()) if c.size else 0

    def slo_burn(self) -> float:
        """Per-tenant SLO burn pressure (obs.slo, DESIGN.md §2.12):
        the attached monitor's fleet-wide burn, normalized so 1.0 means
        some tenant is at its alert threshold.  0.0 without a subscribed
        monitor — every pre-SLO decision trace is untouched."""
        if self._slo is None:
            self._slo = 0.0 if self._slo_fn is None else float(self._slo_fn())
        return self._slo
