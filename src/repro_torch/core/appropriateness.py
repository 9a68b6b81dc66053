"""Merge-appropriateness identification (dissertation Section 4.4).

Merging must not cause more deadline misses than it avoids.  The *Merge
Impact Evaluator* replays the batch queue onto a *virtual queue* (a copy of
the machine states) under the scheduler's dispatch discipline, using the
worst-case execution estimate

    E_i = mu_i + alpha * sigma_i                     (Eq. 4.1)

and the completion model

    C_i^m = tau + e_r^m + sum_p (mu_p + alpha*sigma_p) + E_i   (Eq. 4.2)

``alpha`` defaults to 2 (97.7% confidence) and is relaxed toward -2 under
oversubscription (Section 4.5.3).  Two position-finding heuristics are
provided for the relaxed-queuing-policy case (Section 4.4.5): *logarithmic
probing* and *linear probing*.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable

from .merging import MergeLevel
from .oversubscription import adaptive_alpha, oversubscription_level
from .tasks import Machine, Task

__all__ = ["VirtualQueueEvaluator", "PositionFinder", "MergeDecision",
           "MergeGate", "shallow_merged_view"]

# exec_time(task, machine) -> (mu, sigma); merged tasks included
ExecTimeFn = Callable[[Task, Machine], tuple[float, float]]


@dataclass
class MergeDecision:
    do_merge: bool
    position: int | None      # insertion index in the batch queue (relaxed mode)
    miss_delta: int           # misses(with merge) - misses(without)
    reason: str = ""


class VirtualQueueEvaluator:
    """Replays a candidate batch queue on copied machine state (Eq. 4.2)."""

    def __init__(self, machines: list[Machine], exec_time: ExecTimeFn,
                 now: float = 0.0, alpha: float = 2.0):
        self.machines = machines
        self.exec_time = exec_time
        self.now = now
        self.alpha = alpha

    # -- Eq. 4.1 ----------------------------------------------------------
    def worst_case(self, task: Task, machine: Machine) -> float:
        mu, sigma = self.exec_time(task, machine)
        return max(mu + self.alpha * sigma, 0.0)

    def _machine_avail(self) -> list[float]:
        """tau + e_r^m + queued worst cases, per machine (Eq. 4.2 terms A-C)."""
        avail = []
        for m in self.machines:
            t = max(self.now, m.run_end if m.running else self.now)
            for q in m.queue:
                t += self.worst_case(q, m)
            avail.append(t)
        return avail

    def replay(self, batch: list[Task]) -> dict[int, float]:
        """Greedy head-of-queue dispatch of ``batch`` onto the earliest-free
        machine; returns tid -> estimated completion time."""
        avail = self._machine_avail()
        out: dict[int, float] = {}
        for task in batch:
            j = min(range(len(avail)), key=avail.__getitem__)
            c = avail[j] + self.worst_case(task, self.machines[j])
            avail[j] = c
            out[task.tid] = c
        return out

    def count_misses(self, batch: list[Task]) -> int:
        """Deadline misses across *requests* (children of merged tasks count
        individually - that is what the user experiences)."""
        completions = self.replay(batch)
        # queued-on-machine tasks can also miss; include them
        misses = 0
        for m in self.machines:
            t = max(self.now, m.run_end if m.running else self.now)
            for q in m.queue:
                t += self.worst_case(q, m)
                for r in q.all_requests():
                    if t > r.deadline:
                        misses += 1
        for task in batch:
            c = completions[task.tid]
            for r in task.all_requests():
                if c > r.deadline:
                    misses += 1
        return misses

    def completion_of(self, batch: list[Task], tid: int) -> float:
        return self.replay(batch)[tid]


class PositionFinder:
    """Section 4.4.5 position-finding heuristics (relaxed queuing policy)."""

    def __init__(self, evaluator: VirtualQueueEvaluator):
        self.ev = evaluator

    # -- helpers -------------------------------------------------------------
    def _probe(self, queue: list[Task], merged: Task, pos: int,
               base_misses: int) -> tuple[bool, bool]:
        """Returns (merged_ok, others_ok) for ``merged`` inserted at ``pos``."""
        cand = queue[:pos] + [merged] + queue[pos:]
        completions = self.ev.replay(cand)
        c = completions[merged.tid]
        merged_ok = c <= merged.effective_deadline
        others_ok = self.ev.count_misses(cand) - sum(
            1 for r in merged.all_requests() if c > r.deadline
        ) <= base_misses
        return merged_ok, others_ok

    def logarithmic(self, queue: list[Task], merged: Task,
                    base_misses: int) -> int | None:
        """Binary-probe the queue (case analysis (i)-(iv) of Section 4.4.5).

        O(n * m * log n): each probe replays the virtual queue once.
        """
        lo, hi = 0, len(queue)
        while lo <= hi:
            mid = (lo + hi) // 2
            merged_ok, others_ok = self._probe(queue, merged, mid, base_misses)
            if merged_ok and others_ok:          # (i) found
                return mid
            if not merged_ok and others_ok:      # (ii) run earlier
                if mid == 0:
                    return None
                hi = mid - 1
            elif merged_ok and not others_ok:    # (iii) run later
                if mid >= len(queue):
                    return None
                lo = mid + 1
            else:                                # (iv) hopeless
                return None
        return None

    def linear(self, queue: list[Task], merged: Task,
               base_misses: int) -> int | None:
        """Latest position where the merged task itself still meets its
        deadline (phase 1, O(n*m)), then one impact check (phase 2)."""
        # Phase 1: completion of merged after each prefix — one replay pass.
        best_pos = None
        for pos in range(len(queue) + 1):
            cand = queue[:pos] + [merged]
            c = self.ev.replay(cand)[merged.tid]
            if c <= merged.effective_deadline:
                best_pos = pos            # keep extending: we want the latest
            else:
                break
        if best_pos is None:
            return None
        # Phase 2: verify tasks behind the insertion are unharmed.
        _, others_ok = self._probe(queue, merged, best_pos, base_misses)
        return best_pos if others_ok else None


def shallow_merged_view(existing: Task, arriving: Task) -> Task:
    """A copy of ``existing`` with ``arriving`` merged in, for what-if
    evaluation without mutating live state."""
    view = copy.copy(existing)
    view.children = list(existing.children) + [arriving]
    return view


def _by_rank(task: Task) -> float:
    return task.queue_rank if task.queue_rank is not None else task.arrival


class MergeGate:
    """Merge-appropriateness policy (Section 4.4) behind one call.

    Owns the full decision ladder shared by the simulator and the serving
    engine: TASK-level merges are free; ``aggressive`` always merges (the
    position finder, when configured, still *places* the compound task);
    ``conservative`` evaluates the virtual queue at the base ``alpha``;
    ``adaptive`` first relaxes ``alpha`` by the oversubscription level
    (Section 4.5.3).  With a position finder the decision is positional:
    merge only if a queue slot exists where neither the compound task nor
    the tasks behind it miss more deadlines (Section 4.4.5).
    """

    def __init__(self, policy: str, alpha: float = 2.0,
                 position_finder: str | None = None):
        if position_finder not in (None, "linear", "log"):
            raise ValueError(f"unknown position finder {position_finder!r}")
        self.policy = policy
        self.alpha = alpha
        self.position_finder = position_finder

    def _find_position(self, pf: PositionFinder, batch: list[Task],
                       existing: Task, cand: Task, base: int) -> int | None:
        rest = sorted((t for t in batch if t.tid != existing.tid), key=_by_rank)
        return (pf.linear(rest, cand, base) if self.position_finder == "linear"
                else pf.logarithmic(rest, cand, base))

    def evaluate(self, existing: Task, arriving: Task, level: MergeLevel,
                 batch: list[Task], machines: list[Machine],
                 exec_time: ExecTimeFn, now: float) -> MergeDecision:
        if level is MergeLevel.TASK:
            # identical request: free reuse, no side effect
            return MergeDecision(True, None, 0, "task-level")
        if self.policy == "aggressive":
            pos = None
            if self.position_finder:
                # aggressive merging ignores appropriateness (§4.6.1); the
                # finder is still consulted to *place* the compound task
                ev = VirtualQueueEvaluator(machines, exec_time, now=now,
                                           alpha=self.alpha)
                base = ev.count_misses(batch + [arriving])
                cand = shallow_merged_view(existing, arriving)
                pos = self._find_position(PositionFinder(ev), batch,
                                          existing, cand, base)
            return MergeDecision(True, pos, 0, "aggressive")
        alpha = self.alpha
        if self.policy == "adaptive":
            osl = oversubscription_level(machines, exec_time, now)
            alpha = adaptive_alpha(osl)
        ev = VirtualQueueEvaluator(machines, exec_time, now=now, alpha=alpha)
        base = ev.count_misses(batch + [arriving])
        cand = shallow_merged_view(existing, arriving)
        if self.position_finder and any(t.tid == existing.tid for t in batch):
            pos = self._find_position(PositionFinder(ev), batch, existing,
                                      cand, base)
            if pos is None:
                return MergeDecision(False, None, 0, "no viable position")
            return MergeDecision(True, pos, 0, "position found")
        cand_queue = [cand if t.tid == existing.tid else t for t in batch]
        delta = ev.count_misses(cand_queue) - base
        return MergeDecision(delta <= 0, None, delta, "virtual-queue replay")
