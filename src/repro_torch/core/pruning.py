"""Probabilistic task pruning mechanism (dissertation Sections 5.2-5.4).

The pruner is a *pluggable module* (Fig. 5.5): given mapping metadata it
emits dropping decisions (applied to machine queues) and deferring decisions
(applied to the mapper).  Components:

  * ``DropThresholdEstimator`` - per-task threshold from PMF skewness and
    queue position (Eq. 5.7).
  * ``DeferThresholdEstimator`` - dynamic threshold from selective factor
    Delta, competency Gamma (Eq. 5.8), instantaneous robustness psi
    (Eq. 5.9), update rule (Eq. 5.10).
  * ``FairnessModule`` - per-task-type sufferage concessions (PAMF, §5.4.2).
  * ``Pruner`` - orchestration; engages dropping only when the
    ``DropToggle`` (Eq. 5.11 + Schmitt trigger) reports oversubscription.

Overhead controls from §5.5 are first-class: ``compaction_bucket`` applies
impulse compaction to every PET/PCT before convolving, and success chances
use the memoized Procedure-2 algorithm instead of full convolutions.  The
batched equivalent on the card lives in ``repro_torch.kernels.pmf_conv``.
"""

from __future__ import annotations

from dataclasses import dataclass

from .oversubscription import DropToggle
from .pmf import PMF, DropMode, chance_of_success, convolve_pct
from .tasks import Machine, Task

__all__ = ["PruningConfig", "Pruner", "FairnessModule"]


@dataclass
class PruningConfig:
    base_drop_threshold: float = 0.25
    rho: float = 0.15                  # Eq. 5.7 scale
    theta: float = 0.05                # Eq. 5.10 adjustment constant
    initial_defer_threshold: float = 0.5
    min_defer_threshold: float = 0.0
    max_defer_threshold: float = 0.95
    lam: float = 0.3                   # Eq. 5.11 EWMA weight
    toggle_on: float = 2.0
    use_schmitt: bool = True
    drop_mode: DropMode = DropMode.PEND_DROP
    drop_running: bool = False         # EVICT mode may kill executing tasks
    fairness_factor: float = 0.0       # 0 disables the fairness module
    compaction_bucket: int = 0         # impulse compaction (0 = exact)
    memoize: bool = True               # §5.5 macro-level memoization
    defer_enabled: bool = True
    drop_enabled: bool = True
    dynamic_defer: bool = False        # Eq. 5.10 estimator (PAM/PAMF runs);
                                       # plain "-P" variants use the fixed
                                       # initial threshold (§5.6 sweeps)


class FairnessModule:
    """Tracks per-task-type pruning sufferage and yields threshold
    concessions so no type is starved (PAMF, Section 5.4.2)."""

    def __init__(self, factor: float):
        self.factor = factor
        self.pruned: dict[str, int] = {}
        self.served: dict[str, int] = {}

    def note_pruned(self, ttype: str) -> None:
        self.pruned[ttype] = self.pruned.get(ttype, 0) + 1

    def note_served(self, ttype: str) -> None:
        self.served[ttype] = self.served.get(ttype, 0) + 1

    def sufferage(self, ttype: str) -> float:
        p = self.pruned.get(ttype, 0)
        s = self.served.get(ttype, 0)
        return p / (p + s + 1.0)

    def concession(self, ttype: str) -> float:
        """Multiplier in (0, 1]; heavily-pruned types get lower thresholds."""
        if self.factor <= 0:
            return 1.0
        return max(0.0, 1.0 - self.factor * self.sufferage(ttype))


class Pruner:
    """The pruning mechanism of Fig. 5.5, pluggable into any heuristic.

    ``oracle`` provides the PET view: any object with
    ``pmf(task, machine) -> PMF`` (see ``repro.core.simulation.PETOracle``).
    """

    def __init__(self, oracle, cfg: PruningConfig | None = None):
        self.oracle = oracle
        self.cfg = cfg or PruningConfig()
        self.toggle = DropToggle(lam=self.cfg.lam, on_level=self.cfg.toggle_on,
                                 use_schmitt=self.cfg.use_schmitt)
        self.defer_threshold = self.cfg.initial_defer_threshold
        self.fairness = FairnessModule(self.cfg.fairness_factor)
        self.stats = {"dropped": 0, "deferred": 0, "drop_passes": 0,
                      "convolutions": 0}
        #: decision-time telemetry (pure recording — never read back):
        #: tid -> {chance, threshold, position[, evicted]} for the latest
        #: drop pass; (tid, chance, threshold) per defer decision, drained
        #: by the control plane each mapping event
        self.drop_info: dict[int, dict] = {}
        self.defer_log: list[tuple] = []
        self._chain_cache: dict = {}
        self._chance_cache: dict = {}

    # ------------------------------------------------------------------ PCTs
    def _maybe_compact(self, p: PMF) -> PMF:
        b = self.cfg.compaction_bucket
        if b and len(p.values) > 4 * b:
            return p.compact(b)
        return p

    def _task_pet(self, task: Task, machine: Machine) -> PMF:
        return self._maybe_compact(self.oracle.pmf(task, machine))

    def _queue_start_pct(self, machine: Machine, now: float) -> PMF | None:
        if machine.running is not None:
            return PMF.impulse(int(max(now, machine.run_end)))
        return None

    def _chain_key(self, machine: Machine, now: float):
        # the chain depends on `now` only while the running task is overdue
        start = int(max(now, machine.run_end)) if machine.running else int(now)
        return (machine.mid, machine.running.tid if machine.running else -1,
                start if (machine.running is None or machine.run_end <= now)
                else int(machine.run_end),
                tuple(t.tid for t in machine.queue))

    def machine_pcts(self, machine: Machine, now: float
                     ) -> list[tuple[Task, PMF, float]]:
        """PCT chain along one machine queue.

        Returns (task, PCT, success-chance) per position.  The PCT is the
        Eq. 5.2-5.5 fold ("when does the machine free of this slot"); the
        success chance is the memoized Procedure-2 value, which correctly
        excludes pass-through/collapsed mass belonging to *previous* tasks.

        Chains are memoized per (machine, running, queue) state — §5.5's
        macro-level memoization: queues rarely change between consecutive
        mapping events, so recomputing every convolution is redundant.
        """
        key = self._chain_key(machine, now)
        hit = self._chain_cache.get(key) if self.cfg.memoize else None
        if hit is not None:
            return hit
        prev = self._queue_start_pct(machine, now)
        out = []
        for task in machine.queue:
            self.stats["convolutions"] += 1
            pet = self._task_pet(task, machine)
            dl = int(task.effective_deadline)
            if prev is None:
                shifted = pet.shift(int(now))
                success = shifted.success_before(dl)
                pct = convolve_pct(shifted, None, dl, mode=self.cfg.drop_mode)
            else:
                success = chance_of_success(
                    pet, prev, dl,
                    droppable_prev=self.cfg.drop_mode is not DropMode.NO_DROP)
                pct = convolve_pct(pet, prev, dl, mode=self.cfg.drop_mode)
            pct = self._maybe_compact(pct)
            out.append((task, pct, success))
            prev = pct
        if len(self._chain_cache) > 4096:
            self._chain_cache.clear()
        self._chain_cache[key] = out
        return out

    def success_chance(self, task: Task, machine: Machine, now: float,
                       tail_pct: PMF | None = None) -> float:
        """Chance the task meets its deadline if appended to ``machine``'s
        queue (memoized Procedure 2 - no convolution materialized).

        Results are cached per (task, machine-queue-state): a machine's tail
        PCT only changes when its queue does, so repeated evaluations across
        mapping events are free (§5.5 macro-level memoization).
        """
        ckey = None
        if tail_pct is None and self.cfg.memoize:
            ckey = (task.tid, self._chain_key(machine, now))
            hit = self._chance_cache.get(ckey)
            if hit is not None:
                return hit
        elif tail_pct is None:
            pass
        if tail_pct is None:
            chain = self.machine_pcts(machine, now)
            tail_pct = chain[-1][1] if chain else self._queue_start_pct(machine, now)
        pet = self._task_pet(task, machine)
        if tail_pct is None:
            p = pet.shift(int(now)).success_before(int(task.effective_deadline))
        else:
            p = chance_of_success(
                pet, tail_pct, int(task.effective_deadline),
                droppable_prev=self.cfg.drop_mode is not DropMode.NO_DROP)
        if ckey is not None:
            if len(self._chance_cache) > 65536:
                self._chance_cache.clear()
            self._chance_cache[ckey] = p
        return p

    # -------------------------------------------------------------- dropping
    def drop_threshold(self, task: Task, pct: PMF, position: int) -> float:
        """Base threshold adjusted by skewness & queue position (Eq. 5.7)."""
        phi = (-pct.skewness() * self.cfg.rho) / (position + 1.0)
        thr = (self.cfg.base_drop_threshold + phi) * self.fairness.concession(task.ttype)
        return float(min(max(thr, 0.0), 0.95))

    def drop_pass(self, machines: list[Machine], now: float,
                  misses_since_last: int) -> list[Task]:
        """Engage Eq. 5.11 toggle; when oversubscribed, walk machine queues
        head-first and drop tasks whose success chance <= threshold."""
        self.stats["drop_passes"] += 1
        self.drop_info = {}
        engaged = self.toggle.observe(misses_since_last)
        if not (engaged and self.cfg.drop_enabled):
            return []
        dropped: list[Task] = []
        for m in machines:
            if self.cfg.drop_running and m.running is not None:
                # EVICT mode: an executing task past its deadline is killed
                if now >= m.running.effective_deadline:
                    dropped.append(m.running)
                    self.drop_info[m.running.tid] = {
                        "chance": 0.0, "threshold": None, "position": -1,
                        "evicted": True}
            keep: list[Task] = []
            for pos, (task, pct, p) in enumerate(self.machine_pcts(m, now)):
                thr = self.drop_threshold(task, pct, pos)
                if p <= thr:
                    dropped.append(task)
                    self.drop_info[task.tid] = {
                        "chance": p, "threshold": thr, "position": pos}
                    self.fairness.note_pruned(task.ttype)
                else:
                    keep.append(task)
            m.queue = keep
        self.stats["dropped"] += len(dropped)
        return dropped

    # -------------------------------------------------------------- deferring
    def refresh_defer_threshold(self, batch: list[Task],
                                machines: list[Machine], chance_fn,
                                now: float) -> None:
        """Deferring Threshold Estimator pass (Eq. 5.10) for heuristics that
        do not refresh it themselves (PAM/PAMF fold the update into their
        phase-1 chance matrix; every other heuristic gets it from the
        control plane on each mapping event, per Fig. 5.5).

        ``chance_fn(task, machine) -> float`` supplies success chances.
        """
        if not self.cfg.dynamic_defer:
            return
        free = [m for m in machines if m.free_slots > 0]
        if not free:
            return
        best = {t.tid: max(chance_fn(t, m) for m in free) for t in batch}
        self.update_defer_threshold(batch, machines, best, now)

    def instantaneous_robustness(self, machines: list[Machine], now: float) -> float:
        """psi - mean success chance over everything queued (Eq. 5.9)."""
        probs = []
        for m in machines:
            for _task, _pct, p in self.machine_pcts(m, now):
                probs.append(p)
        return sum(probs) / len(probs) if probs else 1.0

    def update_defer_threshold(self, batch: list[Task], machines: list[Machine],
                               best_chances: dict[int, float], now: float) -> float:
        """Eq. 5.10 update from Delta, Gamma and psi."""
        cfg = self.cfg
        free_slots = sum(m.free_slots for m in machines)
        delta = len(batch) / max(free_slots, 1)                    # selective factor
        v = self.defer_threshold
        if batch:
            gamma = sum(1 for t in batch
                        if best_chances.get(t.tid, 0.0) >= v) / len(batch)  # Eq. 5.8
        else:
            gamma = 1.0
        if delta < 1.0:
            v_n = v - cfg.theta
        elif gamma == 0.0:
            v_n = v - cfg.theta
        else:
            psi = self.instantaneous_robustness(machines, now)
            v_n = psi - cfg.theta
        self.defer_threshold = float(min(max(v_n, cfg.min_defer_threshold),
                                         cfg.max_defer_threshold))
        return self.defer_threshold

    def should_defer(self, task: Task, best_chance: float) -> bool:
        if not self.cfg.defer_enabled:
            return False
        thr = self.defer_threshold * self.fairness.concession(task.ttype)
        if best_chance < thr:
            self.stats["deferred"] += 1
            self.defer_log.append((task.tid, best_chance, thr))
            self.fairness.note_pruned(task.ttype)
            return True
        return False
