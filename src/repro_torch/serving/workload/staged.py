"""Staged request DAGs with residual-slack propagation (DESIGN.md §2.11).

A :class:`StagedPool` drives multi-stage tasks (the aggregating-functions
pipelines: e.g. decode → transform → encode) through the front door
**stage by stage**: a stage is submitted only when every prerequisite
stage has completed, at the completion instant, so each stage passes the
existing ``ControlPlane`` admission/merge/prune/map path like any other
arrival.

Deadline semantics — *residual-slack propagation*: a DAG carries one
end-to-end deadline ``D = arrival + slack · critical_path_est``.  Stage
``i`` is admitted with ``deadline = D − tail_est(i)`` where ``tail_est``
is the longest-path estimate of the work that must still run after it.
The deadline is *absolute*, so when earlier stages run late the admission
instant has eaten into exactly this budget — the pruner's
chance-of-success evaluates the stage against the true remaining budget,
and a hopeless tail stage is pruned instead of wasting a machine.

Stage drops abort the DAG (descendants are never admitted); per-DAG
end-to-end on-time is recorded at the final stage's completion.

A copy of ``repro.serving.workload.staged`` for the port, unchanged but for this line.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

from ...core.tasks import Task
from .arrivals import ArrivalProcess, PoissonProcess, mix64, unit_float
from .sessions import _request_cls
from .tenancy import DEFAULT_TENANT, TenantBook

__all__ = ["Stage", "StagedConfig", "StagedPool"]


@dataclass(frozen=True)
class Stage:
    """One node of the DAG template.

    ``after`` names prerequisite stage indices; ``None`` means "the
    previous stage" (linear chain), ``()`` marks a root."""

    op: str = "generate"
    est: float = 20.0        # nominal cost estimate (residual-slack budget)
    n_new: int = 2
    prompt: int = 8          # prompt tokens (emit="request")
    after: tuple | None = None


@dataclass
class StagedConfig:
    dags: int                        # DAG instances to start
    stages: tuple = (Stage(), Stage(), Stage())
    arrival_rate: float = 0.5        # DAG roots per tick (base rate)
    arrivals: ArrivalProcess = field(default_factory=PoissonProcess)
    slack: float = 1.5               # D = arrival + slack * critical path est
    vocab: int = 250
    emit: str = "request"            # "request" | "task"
    horizon: float | None = None
    seed: int = 0


def _resolve_deps(stages) -> list[tuple]:
    deps = []
    for i, st in enumerate(stages):
        if st.after is None:
            deps.append((i - 1,) if i else ())
        else:
            deps.append(tuple(st.after))
    return deps


def _tail_ests(stages, deps) -> list[float]:
    """Longest-path estimate of the work strictly after each stage."""
    succ = [[] for _ in stages]
    for i, ds in enumerate(deps):
        for d in ds:
            succ[d].append(i)
    tail = [0.0] * len(stages)
    for i in range(len(stages) - 1, -1, -1):
        tail[i] = max((stages[c].est + tail[c] for c in succ[i]), default=0.0)
    return tail


class StagedPool:
    """Driver-facing generator with the same interface as ``SessionPool``:
    ``next_time`` / ``pop`` / ``on_complete`` / ``summary``."""

    def __init__(self, cfg: StagedConfig, tenants=None):
        self.cfg = cfg
        self.book = TenantBook(tenants if tenants else [DEFAULT_TENANT])
        self.deps = _resolve_deps(cfg.stages)
        self.tails = _tail_ests(cfg.stages, self.deps)
        # critical path from the roots: max over stages of est + tail,
        # restricted to roots' forward closure == max over all stages of
        # own-est + tail (every stage lies on some root-reachable path)
        self.critical_path = max(
            (s.est + t for s, t in zip(cfg.stages, self.tails)), default=0.0)
        self._rng = np.random.default_rng(cfg.seed)
        self._starts = cfg.arrivals.iter_times(self._rng, cfg.arrival_rate)
        self._n_started = 0
        self._next_start = self._advance_start()
        self._ready: list = []           # (t, uid, stage) admissible stages
        self._inflight: dict = {}        # (uid, stage) -> t_submitted
        self._state: dict = {}           # uid -> {"done": set, "deadline": D,
        #                                          "t0": arrival, "dead": bool}
        self.dags_done = 0
        self.dags_on_time = 0
        self.dags_aborted = 0
        self.peak_active_dags = 0
        self.stage_stats = [
            {"submitted": 0, "completed": 0, "on_time": 0, "dropped": 0,
             "slack_at_admit_sum": 0.0}
            for _ in cfg.stages]

    # -- plumbing -------------------------------------------------------------
    def _advance_start(self):
        if self._n_started >= self.cfg.dags:
            return None
        t = next(self._starts)
        if self.cfg.horizon is not None and t > self.cfg.horizon:
            return None
        return t

    def _tenant(self, uid: int):
        return self.book.pick(unit_float(self.cfg.seed, uid, 0x57A6ED))

    def _item(self, uid: int, stage: int, t: float, deadline: float):
        cfg, st, ten = self.cfg, self.cfg.stages[stage], self._tenant(uid)
        if cfg.emit == "task":
            return Task(ttype=st.op, data_id=f"g{uid}.{stage}", op=st.op,
                        params=(st.n_new, 0.0, 0), arrival=t,
                        deadline=deadline, user=f"u{uid % 8}",
                        priority=ten.priority, tenant=ten.name,
                        session=uid, turn=stage)
        v = cfg.vocab - 1
        prompt = tuple(1 + mix64(cfg.seed, uid, stage, j) % v
                       for j in range(st.prompt))
        return _request_cls()(
            prompt=prompt, op="generate", n_new=st.n_new, deadline=deadline,
            tenant=ten.name, session=uid, turn=stage, priority=ten.priority)

    # -- driver interface -----------------------------------------------------
    def next_time(self) -> float | None:
        t = self._next_start
        if self._ready and (t is None or self._ready[0][0] < t):
            t = self._ready[0][0]
        return t

    def pop(self):
        t = self._next_start
        if self._ready and (t is None or self._ready[0][0] < t):
            t, uid, stage = heapq.heappop(self._ready)
            dag = self._state[uid]
        else:
            uid, stage = self._n_started, self._root_stage()
            self._n_started += 1
            self._next_start = self._advance_start()
            ten = self._tenant(uid)
            dag = {"done": set(), "t0": t, "dead": False,
                   "deadline": t + self.cfg.slack * self.critical_path
                   * ten.slack}
            self._state[uid] = dag
            # every root beyond the first becomes ready at the same instant
            for r, ds in enumerate(self.deps):
                if not ds and r != stage:
                    heapq.heappush(self._ready, (t, uid, r))
        deadline = dag["deadline"] - self.tails[stage]
        self._inflight[(uid, stage)] = t
        n_active = len(self._state)
        if n_active > self.peak_active_dags:
            self.peak_active_dags = n_active
        self.book.note_submit(self._tenant(uid).name)
        ss = self.stage_stats[stage]
        ss["submitted"] += 1
        ss["slack_at_admit_sum"] += deadline - t
        return t, self._item(uid, stage, t, deadline)

    def _root_stage(self) -> int:
        return next(i for i, ds in enumerate(self.deps) if not ds)

    def pending(self) -> bool:
        return self.next_time() is not None

    def in_flight(self) -> int:
        return len(self._inflight)

    # -- control-plane completion hook ---------------------------------------
    def on_complete(self, obj, now: float, outcome: str) -> None:
        uid = getattr(obj, "session", None)
        if uid is None:
            return
        stage = getattr(obj, "turn", 0)
        if self._inflight.pop((uid, stage), None) is None:
            return                        # stale duplicate
        dag = self._state.get(uid)
        if dag is None or dag["dead"]:
            return
        ten = self._tenant(uid)
        ss = self.stage_stats[stage]
        if outcome == "dropped":
            self.book.note_drop(ten.name)
            ss["dropped"] += 1
            dag["dead"] = True            # descendants are never admitted
            self.dags_aborted += 1
            self._retire(uid)
            return
        on_time = now <= getattr(obj, "deadline", float("inf"))
        self.book.note_done(ten.name, now - dag["t0"], on_time)
        ss["completed"] += 1
        if on_time:
            ss["on_time"] += 1
        dag["done"].add(stage)
        if len(dag["done"]) == len(self.cfg.stages):
            self.dags_done += 1
            if now <= dag["deadline"]:
                self.dags_on_time += 1
            self._retire(uid)
            return
        # admit every successor whose prerequisites are now all complete
        for s, ds in enumerate(self.deps):
            if stage in ds and s not in dag["done"] \
                    and all(d in dag["done"] for d in ds):
                heapq.heappush(self._ready, (now, uid, s))

    def _retire(self, uid: int) -> None:
        del self._state[uid]

    def note_hit_depth(self, stage: int, depth: int) -> None:
        """Interface parity with SessionPool (stages share no prefixes)."""

    # -- reporting ------------------------------------------------------------
    def summary(self) -> dict:
        per_stage = []
        for i, ss in enumerate(self.stage_stats):
            n = ss["submitted"]
            per_stage.append({
                "stage": i, "est": self.cfg.stages[i].est,
                "submitted": n, "completed": ss["completed"],
                "on_time": ss["on_time"], "dropped": ss["dropped"],
                "mean_slack_at_admit": (ss["slack_at_admit_sum"] / n)
                if n else 0.0,
            })
        return {
            "mode": "staged_dag", "dags": self._n_started,
            "stages": len(self.cfg.stages),
            "critical_path_est": self.critical_path,
            "dags_done": self.dags_done, "dags_on_time": self.dags_on_time,
            "dags_aborted": self.dags_aborted,
            "peak_active_dags": self.peak_active_dags,
            "per_stage": per_stage, "tenants": self.book.summary(),
        }
