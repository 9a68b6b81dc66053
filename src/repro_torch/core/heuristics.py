"""Task-machine mapping heuristics (dissertation Sections 2.5, 5.4.2).

Immediate-mode (on arrival):  RR, MET, MCT, KPB
Cost-aware (Fig. 5.19 axis):  MEC, MCMD
Batch-mode (two-phase):       MM, MSD, MMU, MOC
Homogeneous:                  FCFS-RR, EDF, SJF, MU
Pruning-aware:                PAM, PAMF

Every heuristic exposes ``map_batch(batch, machines, ctx)`` returning a list
of (task, machine) assignments (machine queues are mutated in place).  The
resource-allocation system owns the pruner's *dropping* pass (Fig. 5.5);
heuristics consult the pruner only for *deferring* decisions, via the
``MappingContext`` which memoizes per-machine tail PCTs — optimization (1)
of §5.5 ("PCT of last task in the machine queue is predetermined before the
mapping event").
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Protocol

from .pruning import Pruner
from .tasks import Machine, Task

__all__ = ["ExecOracle", "MappingContext", "Heuristic", "make_heuristic",
           "pick_handoff_machine", "HEURISTICS"]


class ExecOracle(Protocol):
    """Execution-time knowledge: estimator view + PMF view."""

    def mean_std(self, task: Task, machine: Machine) -> tuple[float, float]: ...
    def pmf(self, task: Task, machine: Machine) -> PMF: ...


@dataclass
class MappingContext:
    oracle: ExecOracle
    now: float = 0.0
    pruner: Pruner | None = None
    k_percent: float = 0.5          # KPB parameter
    moc_threshold: float = 0.3      # MOC robustness culling threshold
    alpha: float = 0.0              # worst-case coefficient (0 = mean estimate)
    prefix_fn: object = None        # (task, machine) -> cached-prefix tokens
    _avail: dict = field(default_factory=dict)     # mid -> float
    _exec: dict = field(default_factory=dict)      # (tid, mid) -> float
    _pfx: dict = field(default_factory=dict)       # (tid, mid) -> int

    # -- scalar time estimates ------------------------------------------------
    def exec_mean(self, task: Task, machine: Machine) -> float:
        key = (task.tid, machine.mid)
        v = self._exec.get(key)
        if v is None:
            mu, sd = self.oracle.mean_std(task, machine)
            v = max(mu + self.alpha * sd, 0.0)
            self._exec[key] = v
        return v

    def avail(self, machine: Machine) -> float:
        if machine.mid not in self._avail:
            t = max(self.now, machine.run_end if machine.running else self.now)
            for q in machine.queue:
                t += self.exec_mean(q, machine)
            self._avail[machine.mid] = t
        return self._avail[machine.mid]

    def expected_completion(self, task: Task, machine: Machine) -> float:
        return self.avail(machine) + self.exec_mean(task, machine)

    def exec_cost(self, task: Task, machine: Machine) -> float:
        """Cost-normalized PET score (Fig. 5.19's cost axis): expected
        occupancy time on ``machine`` priced at its per-time cost rate.
        A slow-but-cheap machine wins whenever rate drops faster than
        speed — exactly the trade the cost-aware heuristics arbitrate."""
        return self.exec_mean(task, machine) * machine.cost_rate

    def prefix_overlap(self, task: Task, machine: Machine) -> int:
        """KV-locality term: prompt tokens of ``task`` already held in a
        prefix cache ``machine`` can attach to (0 without a cache).  The
        same score the front-door router uses across planes, exposed here
        so per-plane heuristics are prefix-cache-aware through one API."""
        if self.prefix_fn is None:
            return 0
        key = (task.tid, machine.mid)
        v = self._pfx.get(key)
        if v is None:
            v = self.prefix_fn(task, machine)
            self._pfx[key] = v
        return v

    # -- probabilistic estimates --------------------------------------------
    def chance(self, task: Task, machine: Machine) -> float:
        if self.pruner is None:
            # Normal surrogate from mean/std when no pruner is attached
            mu = self.expected_completion(task, machine)
            _, sd = self.oracle.mean_std(task, machine)
            z = (task.effective_deadline - mu) / max(sd, 1e-9)
            return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))
        # the pruner memoizes chains + chances per machine-queue state
        return self.pruner.success_chance(task, machine, self.now)

    def assign(self, task: Task, machine: Machine) -> None:
        # completion must be evaluated before the append (avail is memoized
        # on the pre-assignment queue)
        self._avail[machine.mid] = self.expected_completion(task, machine)
        machine.queue.append(task)

    def defer_ok(self, task: Task, best_chance: float) -> bool:
        if self.pruner is None:
            return True
        return not self.pruner.should_defer(task, best_chance)


class Heuristic:
    name = "base"
    batch_mode = True

    def map_batch(self, batch: list[Task], machines: list[Machine],
                  ctx: MappingContext) -> list[tuple[Task, Machine]]:
        raise NotImplementedError


# --------------------------------------------------------------------------
# Immediate-mode heuristics (Section 2.5.1)
# --------------------------------------------------------------------------

class RoundRobin(Heuristic):
    name, batch_mode = "RR", False

    def __init__(self):
        self._rr = itertools.count()

    def map_batch(self, batch, machines, ctx):
        out = []
        for task in batch:
            for _ in range(len(machines)):
                m = machines[next(self._rr) % len(machines)]
                if m.free_slots > 0:
                    out.append((task, m))
                    ctx.assign(task, m)
                    break
        return out


class _ImmediateBest(Heuristic):
    batch_mode = False

    def score(self, task, machine, ctx) -> float:
        raise NotImplementedError

    def candidates(self, task, machines, ctx):
        return [m for m in machines if m.free_slots > 0]

    def map_batch(self, batch, machines, ctx):
        out = []
        for task in batch:
            cands = self.candidates(task, machines, ctx)
            if not cands:
                continue
            best = min(cands, key=lambda m: self.score(task, m, ctx))
            if ctx.pruner is not None and not ctx.defer_ok(
                    task, ctx.chance(task, best)):
                continue
            out.append((task, best))
            ctx.assign(task, best)
        return out


class MET(_ImmediateBest):
    name = "MET"

    def score(self, task, machine, ctx):
        return ctx.exec_mean(task, machine)


class MCT(_ImmediateBest):
    name = "MCT"

    def score(self, task, machine, ctx):
        return ctx.expected_completion(task, machine)


class MEC(_ImmediateBest):
    """Minimum Execution Cost: cost-normalized PET scoring — run each task
    where (expected execution time x machine cost rate) is lowest,
    regardless of queue depth (the cost analogue of MET)."""
    name = "MEC"

    def score(self, task, machine, ctx):
        return ctx.exec_cost(task, machine)


class MCMD(_ImmediateBest):
    """Min-Cost-Meeting-Deadline: among machines whose expected completion
    meets the task's effective deadline, the cheapest execution wins
    (earliest completion breaks cost ties); when no free machine can meet
    the deadline any more, fall back to earliest completion so QoS degrades
    before the budget does.  On a heterogeneous fleet this drains slack
    work onto slow-but-cheap machines and reserves the fast expensive ones
    for urgent tasks — Fig. 5.19's cost-vs-QoS knob as a mapping policy."""
    name = "MCMD"

    def score(self, task, machine, ctx):
        completion = ctx.expected_completion(task, machine)
        if completion <= task.effective_deadline:
            return (0, ctx.exec_cost(task, machine), completion)
        return (1, completion, 0.0)


class KPB(_ImmediateBest):
    name = "KPB"

    def candidates(self, task, machines, ctx):
        free = [m for m in machines if m.free_slots > 0]
        if not free:
            return free
        ranked = sorted(free, key=lambda m: ctx.exec_mean(task, m))
        k = max(1, int(round(len(ranked) * ctx.k_percent)))
        return ranked[:k]

    def score(self, task, machine, ctx):
        return ctx.expected_completion(task, machine)


# --------------------------------------------------------------------------
# Batch-mode two-phase heuristics (Section 2.5.2)
# --------------------------------------------------------------------------

class _TwoPhase(Heuristic):
    """Phase 1: best machine per task.  Phase 2: best (task, machine) pair;
    repeat until queues fill or the batch queue empties.

    Incremental implementation: after an assignment only the tasks whose
    phase-1 choice was the assigned machine are re-evaluated (the avail of
    every other machine is unchanged), turning the naive O(b^2 m) loop into
    ~O(b m + b r).
    """

    def phase2_key(self, task, machine, completion, ctx):
        raise NotImplementedError

    def map_batch(self, batch, machines, ctx):
        pending = {t.tid: t for t in batch}
        out = []
        free = [m for m in machines if m.free_slots > 0]
        if not free:
            return out

        def phase1(t):
            return min(((ctx.expected_completion(t, m), m) for m in free),
                       key=lambda x: x[0])

        best = {tid: phase1(t) for tid, t in pending.items()}
        while pending and free:
            tid = min(pending, key=lambda i: self.phase2_key(
                pending[i], best[i][1], best[i][0], ctx))
            t = pending.pop(tid)
            c, m = best.pop(tid)
            if ctx.pruner is not None and not ctx.defer_ok(t, ctx.chance(t, m)):
                continue
            out.append((t, m))
            ctx.assign(t, m)
            if m.free_slots <= 0:
                free.remove(m)
                if not free:
                    break
                best = {tid: phase1(tt) if best[tid][1] is m else best[tid]
                        for tid, tt in pending.items()}
            else:
                for tid, tt in pending.items():
                    if best[tid][1] is m:
                        best[tid] = phase1(tt)
        return out


class MinMin(_TwoPhase):
    name = "MM"

    def phase2_key(self, task, machine, completion, ctx):
        return completion


class MSD(_TwoPhase):
    name = "MSD"

    def phase2_key(self, task, machine, completion, ctx):
        return (task.effective_deadline, completion)


class MMU(_TwoPhase):
    name = "MMU"

    def phase2_key(self, task, machine, completion, ctx):
        slack = task.effective_deadline - completion
        return -(1.0 / slack) if slack > 1e-9 else -float("inf")


class MOC(_TwoPhase):
    """Max Ontime Completions: phase 1 maximizes robustness; a culling phase
    removes sub-threshold tasks; top-3 permutation picks the mapping."""
    name = "MOC"

    def map_batch(self, batch, machines, ctx):
        pending = list(batch)
        out = []
        while pending and any(m.free_slots > 0 for m in machines):
            free = [m for m in machines if m.free_slots > 0]
            pairs = []
            for t in pending:
                scored = [(ctx.chance(t, m), m) for m in free]
                c, m = max(scored, key=lambda x: x[0])
                pairs.append((t, m, c))
            viable = [p for p in pairs if p[2] >= ctx.moc_threshold]
            if not viable:
                break
            top = sorted(viable, key=lambda p: -p[2])[:3]
            t, m, r = top[0]
            pending.remove(t)
            if ctx.pruner is not None and not ctx.defer_ok(t, r):
                continue
            out.append((t, m))
            ctx.assign(t, m)
        return out


# --------------------------------------------------------------------------
# Homogeneous-system heuristics (Section 2.5.3) + Max Urgency queuing
# --------------------------------------------------------------------------

class _SortedDispatch(Heuristic):
    """Sort the batch by a queuing key; dispatch head to earliest-free unit."""

    def sort_key(self, task, machines, ctx):
        raise NotImplementedError

    def pick_machine(self, task, free, ctx):
        # earliest-available unit wins; KV locality breaks exact ties, so a
        # shared-prefix task lands on the unit already holding its blocks
        # when the pool gives the scheduler a free choice (idle machines).
        # The locality term is only evaluated among actual ties: a prefix
        # lookup is a trie walk, not worth paying when avail discriminates.
        best = min(ctx.avail(m) for m in free)
        tied = [m for m in free if ctx.avail(m) == best]
        if len(tied) == 1:
            return tied[0]
        return max(tied, key=lambda m: ctx.prefix_overlap(task, m))

    def map_batch(self, batch, machines, ctx):
        out = []
        for task in sorted(batch, key=lambda t: self.sort_key(t, machines, ctx)):
            free = [m for m in machines if m.free_slots > 0]
            if not free:
                break
            m = self.pick_machine(task, free, ctx)
            if ctx.pruner is not None and not ctx.defer_ok(
                    task, ctx.chance(task, m)):
                continue
            out.append((task, m))
            ctx.assign(task, m)
        return out


class FCFSRR(_SortedDispatch):
    name = "FCFS-RR"

    def sort_key(self, task, machines, ctx):
        # queue_rank defaults to arrival; the position finder re-ranks merged
        # tasks to relocate them in the FCFS dispatch order (Section 4.4.5)
        return task.queue_rank if task.queue_rank is not None else task.arrival


class EDF(_SortedDispatch):
    name = "EDF"

    def sort_key(self, task, machines, ctx):
        return task.effective_deadline


class SJF(_SortedDispatch):
    name = "SJF"

    def sort_key(self, task, machines, ctx):
        return min(ctx.exec_mean(task, m) for m in machines)


class MU(_SortedDispatch):
    """Max-Urgency queuing (Section 4.4.4): U = 1/(deadline - E)."""
    name = "MU"

    def sort_key(self, task, machines, ctx):
        e = min(ctx.exec_mean(task, m) for m in machines)
        slack = task.effective_deadline - ctx.now - e
        return -(1.0 / slack) if slack > 1e-9 else -float("inf")


# --------------------------------------------------------------------------
# Pruning-aware heuristics (Section 5.4.2)
# --------------------------------------------------------------------------

class PAM(Heuristic):
    """Phase 1: machine with highest chance of success per task.  Phase 2:
    among those pairs, map the lowest expected completion (prefers tasks
    that are both high-chance and short).

    Incremental: the per-(task, machine) chance matrix is built once per
    mapping event and only the assigned machine's column is refreshed after
    each mapping (its queue is the only thing that changed)."""
    name = "PAM"

    def map_batch(self, batch, machines, ctx):
        assert ctx.pruner is not None, "PAM requires the pruning mechanism"
        pruner = ctx.pruner
        pending = {t.tid: t for t in batch}
        free = [m for m in machines if m.free_slots > 0]
        if not free:
            return []
        chances: dict[int, dict[int, float]] = {tid: {} for tid in pending}

        def fill_column(m):
            for tid, t in pending.items():
                chances[tid][m.mid] = pruner.success_chance(t, m, ctx.now)

        for m in free:
            fill_column(m)

        def best(tid):
            row = chances[tid]
            mid = max(row, key=row.get)
            return row[mid], mid

        if pruner.cfg.dynamic_defer:   # Eq. 5.10 refresh with phase-1 chances
            pruner.update_defer_threshold(
                list(pending.values()), machines,
                {tid: best(tid)[0] for tid in pending}, ctx.now)

        by_mid = {m.mid: m for m in machines}
        out = []
        while pending and free:
            sel = None
            for tid, t in pending.items():
                c, mid = best(tid)
                ec = ctx.expected_completion(t, by_mid[mid])
                if sel is None or ec < sel[3]:
                    sel = (tid, mid, c, ec)
            tid, mid, c, _ = sel
            t = pending.pop(tid)
            m = by_mid[mid]
            if not ctx.defer_ok(t, c):
                continue
            out.append((t, m))
            ctx.assign(t, m)
            if m.free_slots <= 0:
                free.remove(m)
                for row in chances.values():
                    row.pop(mid, None)
                if not free:
                    break
            else:
                fill_column(m)
        return out


class PAMF(PAM):
    """PAM + fairness concessions (requires ``fairness_factor > 0``)."""
    name = "PAMF"


# --------------------------------------------------------------------------
# Prefill→decode handoff scoring (DESIGN.md §2.13)
# --------------------------------------------------------------------------

def pick_handoff_machine(task: Task, src: Machine, machines: list[Machine],
                         ctx: MappingContext,
                         migrate_cost_fn=None) -> Machine | None:
    """Decode-machine selection at the prefill→decode boundary: the MCMD
    trade extended with the modeled KV transfer price.  Among machines that
    still meet the deadline after paying the migration delay, the cheapest
    (execution cost + transfer cost) wins with completion breaking ties;
    when none can, earliest completion — QoS degrades before the budget
    does, exactly like MCMD.  Prefix locality enters through the cost
    model: blocks the destination already holds are not re-sent, so a
    machine with the prefix resident scores a cheaper transfer.  The
    source itself is excluded (it must get back to prefilling) unless it
    is the only decode-capable machine."""
    cands = [m for m in machines if m.phase != "prefill" and m is not src]
    if not cands:
        cands = [m for m in machines if m.phase != "prefill"]
    if not cands:
        return None

    def key(m):
        mig = (migrate_cost_fn(task, src, m)
               if migrate_cost_fn is not None else 0.0)
        completion = ctx.expected_completion(task, m) + mig
        if completion <= task.effective_deadline:
            return (0, ctx.exec_cost(task, m) + mig, completion, m.mid)
        return (1, completion, 0.0, m.mid)

    return min(cands, key=key)


HEURISTICS = {h.name: h for h in
              [RoundRobin, MET, MCT, KPB, MEC, MCMD, MinMin, MSD, MMU, MOC,
               FCFSRR, EDF, SJF, MU, PAM, PAMF]}


def make_heuristic(name: str) -> Heuristic:
    key = name.upper()
    if key not in HEURISTICS:
        raise KeyError(f"unknown heuristic {name!r}; have {sorted(HEURISTICS)}")
    return HEURISTICS[key]()
