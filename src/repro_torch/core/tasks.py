"""Task, machine and PET-matrix model shared by the scheduling core.

Terminology follows the dissertation: a *task* is one serverless request
(media segment + operation + parameters in the paper; model + request shape
in the TPU adaptation).  A *machine* is a processing unit (VM/container in
the paper; a mesh slice running a compiled executable here).  The *PET
matrix* maps (task type, machine type) to a probabilistic execution time.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .pmf import PMF

_task_counter = itertools.count()


@dataclass
class Task:
    ttype: str                     # task type (row of the PET matrix)
    data_id: str                   # media segment / prompt identity
    op: str                        # operation (e.g. "bitrate", "prefill")
    params: tuple = ()             # operation parameters
    arrival: float = 0.0
    deadline: float = float("inf")
    user: str = "u0"
    priority: int = 0
    tokens: Optional[tuple] = None  # prompt token ids (prefix-reuse scoring);
                                    # None for workloads without token detail
    # workload identity (serving.workload: closed-loop sessions, staged
    # DAGs, SLO tiers) — None/0 for open-loop traffic
    tenant: Optional[str] = None    # SLO tier name; rides into obs labels
    session: Optional[int] = None   # closed-loop session / DAG uid
    turn: int = 0                   # conversation turn / DAG stage ordinal
    tid: int = field(default_factory=lambda: next(_task_counter))

    # merging state --------------------------------------------------------
    children: list["Task"] = field(default_factory=list)
    merged_into: Optional[int] = None   # tid of the compound task
    # lifecycle -------------------------------------------------------------
    status: str = "queued"              # queued|mapped|running|done|missed|dropped
    completion: Optional[float] = None
    machine: Optional[int] = None
    queue_rank: Optional[float] = None  # FCFS dispatch order; position finder
                                        # relocates merged tasks by re-ranking

    # -- similarity keys (Section 4.3) --------------------------------------
    def key_task_level(self) -> tuple:
        return (self.data_id, self.op, self.params)

    def key_data_op(self) -> tuple:
        return (self.data_id, self.op)

    def key_data_only(self) -> tuple:
        return (self.data_id,)

    # -- merged-task helpers -------------------------------------------------
    @property
    def is_merged(self) -> bool:
        return bool(self.children)

    # -- control-plane placeholders ------------------------------------------
    WARMUP_OP = "__warmup__"

    @classmethod
    def warmup_placeholder(cls, now: float) -> "Task":
        """A pseudo-task occupying a machine that is cold-starting: the
        virtual-queue/PCT estimators see the machine as busy until the
        warm-up completes, without any request-level accounting."""
        return cls(ttype="warmup", data_id="_", op=cls.WARMUP_OP,
                   arrival=now, deadline=float("inf"), status="running")

    @property
    def is_placeholder(self) -> bool:
        return self.op == self.WARMUP_OP

    def all_requests(self) -> list["Task"]:
        """The compound task plus every merged-in request (flattened)."""
        out = [self]
        for c in self.children:
            out.extend(c.all_requests())
        return out

    @property
    def effective_deadline(self) -> float:
        """Merged tasks keep individual deadlines; the queue sees the earliest."""
        return min(t.deadline for t in self.all_requests())

    def urgency(self, expected_exec: float, now: float = 0.0) -> float:
        """Max-Urgency metric U_i = 1 / (delta_i - E_i) (Section 4.4.4)."""
        slack = self.effective_deadline - now - expected_exec
        return 1.0 / slack if slack > 1e-9 else float("inf")

    def waitable(self, expected_exec: float) -> float:
        """W_i = delta_i - A_i - E_i (Section 4.5.2)."""
        return self.deadline - self.arrival - expected_exec

    def __hash__(self):
        return self.tid

    def __repr__(self):  # pragma: no cover
        tag = f"+{len(self.children)}" if self.children else ""
        return f"Task#{self.tid}{tag}({self.ttype},{self.op},dl={self.deadline:.0f})"


@dataclass
class Machine:
    mid: int
    mtype: str = "m0"
    speed: float = 1.0              # consistent heterogeneity: time scale 1/speed
    queue_size: int = 4             # pending slots (excl. executing task)
    cost_rate: float = 1.0          # $ per time unit (Fig. 5.19 cost model)
    power: float = 1.0              # energy per time unit
    phase: str = "mixed"            # disaggregation role (§2.13): "prefill"
    # machines run chunked prefills then hand the sequence off, "decode"
    # machines run the batched decode loops, "mixed" does both
    max_batch: int = 1              # >1: step-level continuous batching —
    # the control plane co-schedules up to this many tasks on the machine
    # through the substrate's UnitBatch (DESIGN.md §2.10); ``running`` then
    # mirrors the oldest active task and ``run_end``/``busy_until`` the end
    # of the in-flight scheduling quantum
    # runtime state ----------------------------------------------------------
    queue: list[Task] = field(default_factory=list)
    running: Optional[Task] = None
    run_end: float = 0.0            # sampled ground-truth end of running task
    busy_until: float = 0.0
    active: list[Task] = field(default_factory=list)  # batched-mode co-runners

    @property
    def free_slots(self) -> int:
        return max(0, self.queue_size - len(self.queue))

    def all_tasks(self) -> list[Task]:
        if self.max_batch > 1:
            return list(self.active) + list(self.queue)
        return ([self.running] if self.running else []) + list(self.queue)


class PETMatrix:
    """(task type x machine type) -> execution-time PMF, with per-machine
    consistent-heterogeneity scaling."""

    def __init__(self, pmfs: dict[tuple[str, str], PMF]):
        self._pmfs = dict(pmfs)

    @property
    def task_types(self) -> list[str]:
        return sorted({k[0] for k in self._pmfs})

    @property
    def machine_types(self) -> list[str]:
        return sorted({k[1] for k in self._pmfs})

    def pet(self, ttype: str, machine: Machine) -> PMF:
        base = self._pmfs[(ttype, machine.mtype)]
        return base if machine.speed == 1.0 else base.scale(1.0 / machine.speed)

    def mean(self, ttype: str, machine: Machine) -> float:
        return self.pet(ttype, machine).mean()

    def std(self, ttype: str, machine: Machine) -> float:
        return self.pet(ttype, machine).std()

    def sample(self, ttype: str, machine: Machine, rng: np.random.Generator) -> float:
        p = self.pet(ttype, machine).normalize()
        return float(rng.choice(p.times(), p=p.values / p.values.sum()))

    @staticmethod
    def generate(task_types: list[str], machine_types: list[str],
                 rng: np.random.Generator, mean_range=(10, 60), cv: float = 0.3,
                 inconsistent: bool = True) -> "PETMatrix":
        """Random inconsistently-heterogeneous PET matrix (Ch. 5 workloads)."""
        pmfs = {}
        for tt in task_types:
            base = rng.uniform(*mean_range)
            for mt in machine_types:
                mean = base * (rng.uniform(0.5, 2.0) if inconsistent else 1.0)
                pmfs[(tt, mt)] = PMF.from_gamma(mean, cv=cv)
        return PETMatrix(pmfs)
