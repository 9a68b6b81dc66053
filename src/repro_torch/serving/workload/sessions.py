"""Closed-loop multi-turn sessions (DESIGN.md §2.11).

A :class:`SessionPool` models a population of users who *wait for the
reply*: each session submits turn 0 when its start instant arrives (drawn
from an :class:`ArrivalProcess`), then — on the completion callback the
control plane fires — thinks for a sampled think time and re-arrives with
the conversation's **grown token prefix** (previous prompt + the model's
reply + the user's follow-up).  Turn *k*'s prompt extends turn *k−1*'s
prompt exactly, which is what exercises ``PrefixKVCache`` the way
production traffic does; per-turn prefix hit depth is recorded by the
driver (``WorkloadDriver(record_hit_depth=True)``).

Determinism and scale:

* Every per-session draw (prompt tokens, tenant tier, think times) is a
  *pure function* of ``(seed, uid, turn)`` via the SplitMix64 stream —
  independent of completion order, so the same seed yields the same
  traffic on the simulator and the live engine (decision-trace
  equivalence survives with sessions ON).
* Nothing is materialized per user up front: session starts stream from
  the arrival process one instant ahead, prompts are regenerated on
  demand and discarded, and per-session state exists only while a session
  is in flight or thinking.  Peak memory is O(concurrently active
  sessions), not O(users) — ``peak_active_sessions`` in the summary is
  the bound the million-user benchmark row asserts.

``emit="request"`` builds engine ``Request`` payloads (token tuples
included); ``emit="task"`` builds payload-free ``Task`` mirrors directly —
the simulator fast path at million-user scale.

A copy of ``repro.serving.workload.sessions`` for the port, unchanged but for this line.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

from ...core.tasks import Task
from .arrivals import (ArrivalProcess, PoissonProcess, mix64, sample_think,
                       unit_float)
from .tenancy import DEFAULT_TENANT, TenantBook

__all__ = ["SessionConfig", "SessionPool"]

_Request = None


def _request_cls():
    # lazy: the engine module imports JAX at module scope, and the
    # simulator-only path (emit="task") must stay importable without it
    global _Request
    if _Request is None:
        from ..engine import Request
        _Request = Request
    return _Request


@dataclass
class SessionConfig:
    users: int                       # total sessions to start
    turns: int = 4                   # conversation length per session
    think: tuple = ("uniform", 2.0, 8.0)   # see arrivals.sample_think
    arrival_rate: float = 1.0        # session starts per tick (base rate)
    arrivals: ArrivalProcess = field(default_factory=PoissonProcess)
    base_prompt: int = 8             # tokens in the opening prompt
    followup: int = 4                # new user tokens per follow-up turn
    n_new: int = 2                   # generated tokens per turn
    deadline: float = 200.0          # per-turn slack past arrival (ticks)
    vocab: int = 250                 # token-id range (< model vocab)
    emit: str = "request"            # "request" | "task" (payload-free sim)
    on_drop: str = "abort"           # abort | continue the session on a drop
    horizon: float | None = None     # stop starting sessions past this time
    seed: int = 0


class SessionPool:
    """Driver-facing generator: ``next_time`` / ``pop`` feed arrivals to the
    front door; ``on_complete`` is the control-plane completion hook that
    wakes sessions."""

    def __init__(self, cfg: SessionConfig, tenants=None):
        self.cfg = cfg
        self.book = TenantBook(tenants if tenants else [DEFAULT_TENANT])
        self._rng = np.random.default_rng(cfg.seed)
        self._starts = cfg.arrivals.iter_times(self._rng, cfg.arrival_rate)
        self._n_started = 0
        self._next_start = self._advance_start()
        self._wake: list = []            # (t, uid, turn) think-time wakeups
        self._inflight: dict = {}        # uid -> (turn, t_submitted)
        self.sessions_done = 0
        self.peak_active_sessions = 0
        self.turn_stats = [
            {"submitted": 0, "completed": 0, "on_time": 0, "dropped": 0,
             "latency_sum": 0.0, "hit_depth_sum": 0, "hit_depth_n": 0}
            for _ in range(cfg.turns)]

    # -- pure per-(uid, turn) draws -------------------------------------------
    def _advance_start(self):
        if self._n_started >= self.cfg.users:
            return None
        t = next(self._starts)
        if self.cfg.horizon is not None and t > self.cfg.horizon:
            return None
        return t

    def _tenant(self, uid: int):
        return self.book.pick(unit_float(self.cfg.seed, uid, 0x7E9A7))

    def prompt(self, uid: int, turn: int) -> tuple:
        """Turn ``turn``'s prompt: the opening prompt grown by (reply +
        follow-up) per completed turn.  ``prompt(uid, k)`` extends
        ``prompt(uid, k-1)`` exactly — the prefix-reuse invariant."""
        cfg = self.cfg
        v = cfg.vocab - 1
        toks = [1 + mix64(cfg.seed, uid, 0, i) % v
                for i in range(cfg.base_prompt)]
        for k in range(1, turn + 1):
            toks.extend(1 + mix64(cfg.seed, uid, k, j) % v
                        for j in range(cfg.n_new + cfg.followup))
        return tuple(toks)

    def _think(self, uid: int, turn: int) -> float:
        s = self.cfg.seed
        return sample_think(self.cfg.think,
                            unit_float(s, uid, turn, 1),
                            unit_float(s, uid, turn, 2))

    def _item(self, uid: int, turn: int, t: float):
        cfg, ten = self.cfg, self._tenant(uid)
        deadline = t + cfg.deadline * ten.slack
        if cfg.emit == "task":
            return Task(ttype="generate", data_id=f"s{uid}.{turn}",
                        op="generate", params=(cfg.n_new, 0.0, 0),
                        arrival=t, deadline=deadline, user=f"u{uid % 8}",
                        priority=ten.priority, tenant=ten.name,
                        session=uid, turn=turn)
        return _request_cls()(
            prompt=self.prompt(uid, turn), op="generate", n_new=cfg.n_new,
            deadline=deadline, tenant=ten.name, session=uid, turn=turn,
            priority=ten.priority)

    # -- driver interface -----------------------------------------------------
    def next_time(self) -> float | None:
        """Earliest pending arrival instant, or None (nothing pending —
        sessions may still be in flight and wake later)."""
        t = self._next_start
        if self._wake and (t is None or self._wake[0][0] < t):
            t = self._wake[0][0]
        return t

    def pop(self):
        """Pop the earliest pending arrival -> ``(t, item)``."""
        t = self._next_start
        if self._wake and (t is None or self._wake[0][0] < t):
            t, uid, turn = heapq.heappop(self._wake)
        else:
            uid, turn = self._n_started, 0
            self._n_started += 1
            self._next_start = self._advance_start()
        self._inflight[uid] = (turn, t)
        n_active = len(self._inflight) + len(self._wake)
        if n_active > self.peak_active_sessions:
            self.peak_active_sessions = n_active
        self.book.note_submit(self._tenant(uid).name)
        self.turn_stats[turn]["submitted"] += 1
        return t, self._item(uid, turn, t)

    def pending(self) -> bool:
        return self.next_time() is not None

    def in_flight(self) -> int:
        return len(self._inflight)

    # -- control-plane completion hook ---------------------------------------
    def on_complete(self, obj, now: float, outcome: str) -> None:
        """Session wakeup: called by the control plane per finished request
        (``obj`` is the request's Task, or the Request itself when served
        at ingest).  Schedules the next turn at ``now + think``."""
        uid = getattr(obj, "session", None)
        if uid is None:
            return                        # not session traffic
        turn = getattr(obj, "turn", 0)
        entry = self._inflight.get(uid)
        if entry is None or entry[0] != turn:
            return                        # stale duplicate (merged compound)
        del self._inflight[uid]
        ten = self._tenant(uid)
        ts = self.turn_stats[turn]
        if outcome == "dropped":
            self.book.note_drop(ten.name)
            ts["dropped"] += 1
            if self.cfg.on_drop == "abort":
                self.sessions_done += 1
                return
        else:
            latency = now - entry[1]
            on_time = now <= getattr(obj, "deadline", float("inf"))
            self.book.note_done(ten.name, latency, on_time)
            ts["completed"] += 1
            ts["latency_sum"] += latency
            if on_time:
                ts["on_time"] += 1
        nxt = turn + 1
        if nxt >= self.cfg.turns:
            self.sessions_done += 1
            return
        heapq.heappush(self._wake, (now + self._think(uid, nxt), uid, nxt))

    def note_hit_depth(self, turn: int, depth: int) -> None:
        """Per-turn prefix hit depth observed by the driver at submit."""
        ts = self.turn_stats[turn]
        ts["hit_depth_sum"] += depth
        ts["hit_depth_n"] += 1

    # -- reporting ------------------------------------------------------------
    def summary(self) -> dict:
        per_turn = []
        for k, ts in enumerate(self.turn_stats):
            done = ts["completed"]
            per_turn.append({
                "turn": k, "submitted": ts["submitted"], "completed": done,
                "on_time": ts["on_time"], "dropped": ts["dropped"],
                "mean_latency": (ts["latency_sum"] / done) if done else 0.0,
                "mean_hit_depth": (ts["hit_depth_sum"] / ts["hit_depth_n"]
                                   if ts["hit_depth_n"] else 0.0),
            })
        return {
            "mode": "closed_loop", "users": self._n_started,
            "turns": self.cfg.turns, "sessions_done": self.sessions_done,
            "peak_active_sessions": self.peak_active_sessions,
            "per_turn": per_turn, "tenants": self.book.summary(),
        }
