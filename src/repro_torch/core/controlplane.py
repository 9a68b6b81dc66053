"""Unified scheduling control plane (Figs. 4.2/5.2/5.5 as *one* loop).

The dissertation's resource-allocation system is a single architecture —
admission control (similarity detection + merge appropriateness + position
finding), a batch queue, a pluggable mapping heuristic with the
probabilistic pruning mechanism, and drop/departure bookkeeping — evaluated
either *analytically* (the discrete-event simulator) or against *live
executions* (the SMSE serving engine).  This module is that architecture,
written once: ``ControlPlane`` owns the event-driven clock (a heapq of
arrival/finish/wake events — no fixed-tick polling anywhere), the batch
queue and every scheduling decision, and is parameterized by a small
``Substrate`` that supplies machines, an execution-time oracle, and the
execute/complete/drop side effects.

Decision parity between substrates is a correctness property (the merging
and pruning literature requires analytical and live evaluations to agree):
``ControlPlane.trace``, when set to a list, records the admission / merge /
map / start / drop / finish decision sequence in substrate-independent form
so tests can assert the simulator and a stub-execution engine behave
identically on the same trace and oracle.
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass

from .appropriateness import MergeGate
from .heuristics import MappingContext, make_heuristic, pick_handoff_machine
from .merging import SimilarityDetector, merge_tasks
from .pruning import Pruner, PruningConfig
from .tasks import Machine, Task
from ..obs.telemetry import NULL

__all__ = ["ControlConfig", "ControlPlane", "Substrate"]


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclass
class ControlConfig:
    """Scheduling policy shared by every substrate."""

    heuristic: str = "FCFS-RR"
    merging: str = "none"               # none|conservative|aggressive|adaptive
    position_finder: str | None = None  # None|"linear"|"log"
    pruning: PruningConfig | None = None
    hard_deadlines: bool = False        # purge/cull tasks past their deadline
    alpha: float = 2.0                  # base worst-case coefficient (Eq. 4.1)
    merge_degree_cap: int = 5           # §3.2.2: little gain beyond 5


# ---------------------------------------------------------------------------
# substrate protocol
# ---------------------------------------------------------------------------

class Substrate:
    """What the control plane needs from its execution environment.

    The simulator implements this with an execution-time oracle and no
    payloads; the serving engine with real compiled JAX executables on
    processing units.  ``machines`` may change between calls (elasticity).
    """

    #: ExecOracle view used for merging/pruning math: any object with
    #: ``mean_std(task, machine)`` and ``pmf(task, machine)``.
    oracle = None

    #: live machine pool — an attribute or property on the concrete
    #: substrate; may change between accesses (elasticity)
    machines: list = ()

    def ingest(self, item, now: float) -> Task | None:
        """Convert an arrival payload into a Task, or serve it without
        scheduling (result cache) and return None."""
        raise NotImplementedError

    def begin_execution(self, task: Task, machine: Machine,
                        now: float) -> float:
        """Run (or start) ``task`` on ``machine``; return its duration in
        control-plane time units."""
        raise NotImplementedError

    def finish_execution(self, task: Task, machine: Machine,
                         now: float) -> int:
        """Completion bookkeeping; return the number of requests that
        missed their deadline (drives the pruner's EWMA toggle)."""
        raise NotImplementedError

    def on_drop(self, task: Task, now: float) -> None:
        """Account every request of a culled/pruned task as dropped."""
        raise NotImplementedError

    # -- optional hooks ------------------------------------------------------
    def before_mapping(self, now: float) -> None:
        """Runs at the top of every mapping event (elasticity lives here)."""

    def merge_viable(self, existing: Task) -> bool:
        """Substrate veto on merging into ``existing`` (engine: its requests
        must still be queued)."""
        return True

    def on_merge(self, existing: Task, arriving: Task, level) -> None:
        """Bookkeeping after ``arriving`` merged into ``existing``."""

    # -- step-level batching hooks (machines with ``max_batch > 1``) ---------
    def join_batch(self, task: Task, machine: Machine, now: float) -> None:
        """Admit ``task``'s sequences into the machine's step batch; they
        start executing at the next scheduling quantum."""
        raise NotImplementedError

    def run_quantum(self, machine: Machine, now: float):
        """Advance the machine's step batch from ``now`` (at most
        ``quantum_steps`` steps, stopping at the first completion).
        Returns ``(t_end, completed_tasks)`` — completions take effect at
        ``t_end`` — or ``(None, [])`` when the batch is empty."""
        raise NotImplementedError

    def evict_from_batch(self, task: Task, machine: Machine,
                         now: float) -> None:
        """Drop ``task``'s sequences from the in-flight batch (pruner
        EVICT); already-costed quantum steps stand."""
        raise NotImplementedError

    # -- prefill/decode disaggregation hooks (DESIGN.md §2.13) ----------------
    def handoff_ready(self, task: Task, machine: Machine) -> bool:
        """True when ``task`` just finished only its prefill phase on a
        prefill-plane machine and must continue decoding elsewhere (the
        substrate clipped its sequence at the prefill→decode boundary)."""
        return False

    def on_handoff(self, task: Task, src_mid: int, dst_mid: int,
                   now: float) -> None:
        """Perform the KV migration src→dst and register the decode
        continuation; ``task`` rejoins ``dst`` through ``join_batch``."""


# ---------------------------------------------------------------------------
# the control plane
# ---------------------------------------------------------------------------

class ControlPlane:
    """One admission/merge/prune/map/execute loop over a ``Substrate``."""

    def __init__(self, substrate: Substrate, cfg: ControlConfig | None = None,
                 now: float = 0.0):
        self.sub = substrate
        self.cfg = cfg or ControlConfig()
        self.now = now
        self.batch: list[Task] = []
        self.heuristic = make_heuristic(self.cfg.heuristic)
        self.detector = SimilarityDetector()
        self.gate = MergeGate(self.cfg.merging, alpha=self.cfg.alpha,
                              position_finder=self.cfg.position_finder)
        self.pruner = (Pruner(substrate.oracle, self.cfg.pruning)
                       if self.cfg.pruning is not None else None)
        self.stats = {"merges": 0, "merge_rejected": 0, "mapping_events": 0,
                      "deferred": 0, "dropped_requests": 0,
                      "deadlock_breaks": 0, "last_completion": 0.0,
                      "mapping_wall_s": 0.0, "pruning_wall_s": 0.0}
        #: set to a list to record the decision sequence (see module doc)
        self.trace: list | None = None
        #: telemetry recorder (repro.obs); NULL is a no-op — decisions never
        #: read it, so attaching a real recorder cannot perturb scheduling
        self.tel = NULL
        #: plane ordinal stamped on every telemetry event (router sets it)
        self.plane_id = 0
        #: optional callable(cp) invoked after every mapping event
        self.after_mapping = None
        #: optional callable(request_task, now, outcome) fired per request
        #: after completion ("done"), result-cache service ("served") or a
        #: drop ("dropped") — the closed-loop workload hook (session wakeup,
        #: staged-DAG re-admission).  Receivers must never schedule into
        #: this plane's event heap directly; re-arrivals go back through
        #: the front door so admission stays a routing decision.
        self.on_complete = None
        #: optional callable(task, machine) -> cached-prefix tokens, wired by
        #: substrates that own a prefix KV cache; surfaces to heuristics as
        #: ``MappingContext.prefix_overlap`` (prefix-cache-aware mapping)
        self.prefix_fn = None
        #: optional callable(task, src_machine, dst_machine) -> modeled KV
        #: transfer cost in virtual ticks, wired by substrates that support
        #: prefill/decode disaggregation (§2.13); prices the handoff delay
        #: and the destination scoring — must be substrate-identical
        self.migrate_cost_fn = None
        self._events: list = []
        self._seq = itertools.count()
        self._epoch: dict[int, int] = {}
        self._quantum_done: dict[int, list] = {}
        self._misses_since_event = 0
        self._arrival_index: dict[int, int] = {}
        self._n_arrivals = 0

    # -- event plumbing -------------------------------------------------------
    def _push(self, t: float, kind: str, payload=None) -> None:
        # arrivals outrank same-instant finish/warm/wake events.  In a
        # closed-trace run this falls out of push order (every arrival is
        # scheduled before the loop starts, so its seq is lower); encoding it
        # in the key keeps the order identical under *streaming* admission,
        # where arrivals are pushed mid-run with late sequence numbers.
        prio = 0 if kind == "arrive" else 1
        heapq.heappush(self._events, (t, prio, next(self._seq), kind, payload))

    def schedule_arrival(self, t: float, item) -> None:
        self._push(t, "arrive", item)

    def wake_at(self, t: float) -> None:
        """Request a mapping event at time ``t`` (elasticity, external
        state changes)."""
        self._push(t, "wake")

    def note_warmup(self, machine: Machine, until: float) -> None:
        """Mark ``machine`` busy warming up until ``until``: estimators see
        a running placeholder, and a wake event fires when it ends."""
        machine.running = Task.warmup_placeholder(self.now)
        machine.run_end = machine.busy_until = until
        self._push(until, "warm", machine.mid)

    def _machine(self, mid: int) -> Machine | None:
        for m in self.sub.machines:
            if m.mid == mid:
                return m
        return None

    def _log(self, *entry) -> None:
        if self.trace is not None:
            self.trace.append(entry)

    def _index(self, task: Task) -> int:
        """Substrate-independent task identity: arrival ordinal."""
        return self._arrival_index.get(task.tid, -1)

    # -- the event loop -------------------------------------------------------
    def run(self, until: float | None = None) -> None:
        """Drain scheduled events (event-driven; no tick polling).

        With ``until=None`` the plane runs to quiescence: if the heap
        empties while the batch queue is non-empty, one final mapping event
        runs; should it make no progress the remaining tasks can never
        execute (virtual time only advances through events), so they are
        dropped and ``deadlock_breaks`` records the anomaly.

        With a horizon, only events *strictly before* ``until`` are
        processed and the batch queue is left waiting for future arrivals
        (streaming mode: the front door advances planes to an admission
        instant before routing).  Strict-ness matters: an arrival scheduled
        *at* ``until`` right after the call is still admitted ahead of
        same-instant completions, exactly as in a closed-trace run.
        """
        while True:
            if not self._events:
                if until is not None or not self.batch:
                    break
                held = len(self.batch)
                self._mapping_event()
                if self._events:
                    continue
                if self.batch and len(self.batch) >= held:
                    self._deadlock_drain()
                if not self._events:
                    break
                continue
            if until is not None and self._events[0][0] >= until:
                break
            t, _, _, kind, payload = heapq.heappop(self._events)
            self.now = max(self.now, t)
            with self.tel.span("cp." + kind):
                self._dispatch(t, kind, payload)

    def _dispatch(self, t: float, kind: str, payload) -> None:
        """Handle one event popped at instant ``t`` (``run``'s loop
        body)."""
        if kind == "arrive":
            # coalesce simultaneous arrivals: the whole burst is admitted
            # (and can merge pairwise) before the mapping event fires
            items = [payload]
            while (self._events and self._events[0][0] == t
                   and self._events[0][3] == "arrive"):
                items.append(heapq.heappop(self._events)[4])
            for item in items:
                task = self.sub.ingest(item, self.now)
                if task is not None:
                    self.submit(task)
                else:
                    # served at ingest (result-cache hit): no scheduling
                    self.tel.event(self.now, "served_at_ingest",
                                   plane=self.plane_id)
                    self.tel.metrics.inc("served_at_ingest")
                    if self.on_complete is not None:
                        self.on_complete(item, self.now, "served")
            self._mapping_event()
        elif kind == "finish":
            mid, epoch = payload
            m = self._machine(mid)
            if m is None or epoch != self._epoch.get(mid):
                return  # stale event (task evicted / machine retired)
            self._handle_finish(m)
            self._mapping_event()
        elif kind == "handoff":
            # the prefill→decode boundary (§2.13): the transfer delay
            # has elapsed — migrate KV, requeue on the decode machine
            self._handle_handoff(*payload)
            self._mapping_event()
        elif kind == "warm":
            m = self._machine(payload)
            if m is not None and m.running is not None \
                    and m.running.is_placeholder:
                m.running = None
            self._mapping_event()
        else:  # wake
            self._mapping_event()

    # -- admission control (Sections 4.1-4.4) ---------------------------------
    def submit(self, task: Task) -> Task | None:
        """Admission for one task: similarity lookup, merge appropriateness,
        position finding, hash-table maintenance.  Returns the compound task
        when the arrival merged, else None (task joined the batch queue)."""
        self._arrival_index[task.tid] = self._n_arrivals
        self._n_arrivals += 1
        if task.queue_rank is None:
            task.queue_rank = task.arrival
        idx = self._index(task)
        self.tel.event(self.now, "arrive", req=idx, plane=self.plane_id,
                       ttype=task.ttype, deadline=round(task.deadline, 9),
                       tenant=task.tenant)
        self.tel.metrics.inc("requests_arrived")
        if self.cfg.merging == "none":
            self.batch.append(task)
            self._log("admit", idx)
            self.tel.event(self.now, "admit", req=idx, plane=self.plane_id)
            return None

        hit = self.detector.find(task)
        merged = None
        level = None
        if hit is not None:
            level, existing = hit
            viable = (existing.status == "queued"
                      and existing.merged_into is None
                      and len(existing.all_requests()) < self.cfg.merge_degree_cap
                      and self.sub.merge_viable(existing))
            if viable:
                decision = self.gate.evaluate(
                    existing, task, level, self.batch, self.sub.machines,
                    lambda t, m: self.sub.oracle.mean_std(t, m), self.now)
                if decision.do_merge:
                    merged = merge_tasks(existing, task, level)
                    self.sub.on_merge(existing, task, level)
                    self.stats["merges"] += 1
                    self._log("merge", self._index(task),
                              self._index(existing), level.label,
                              decision.position)
                    self.tel.event(self.now, "merge", req=self._index(task),
                                   into=self._index(existing),
                                   level=level.label, reason=decision.reason,
                                   position=decision.position,
                                   plane=self.plane_id)
                    self.tel.metrics.inc("merges", level=level.label)
                    if decision.position is not None:
                        self._apply_position(existing, decision.position)
                else:
                    self.stats["merge_rejected"] += 1
                    self._log("merge_rejected", self._index(task),
                              self._index(existing), level.label)
                    self.tel.event(self.now, "merge_rejected",
                                   req=self._index(task),
                                   into=self._index(existing),
                                   level=level.label, reason=decision.reason,
                                   plane=self.plane_id)
                    self.tel.metrics.inc("merge_rejected", level=level.label)
        self.detector.on_arrival(task, hit[1] if hit else None, merged, level)
        if merged is None:
            self.batch.append(task)
            self._log("admit", self._index(task))
            self.tel.event(self.now, "admit", req=self._index(task),
                           plane=self.plane_id)
        return merged

    def _apply_position(self, merged: Task, pos: int) -> None:
        """Re-rank the compound task so FCFS dispatch honours the found
        position among the remaining batch-queue tasks (Section 4.4.5)."""
        rest = sorted((t for t in self.batch if t.tid != merged.tid),
                      key=lambda t: t.queue_rank)
        if not rest:
            return
        if pos <= 0:
            merged.queue_rank = rest[0].queue_rank - 1.0
        elif pos >= len(rest):
            merged.queue_rank = rest[-1].queue_rank + 1.0
        else:
            merged.queue_rank = 0.5 * (rest[pos - 1].queue_rank +
                                       rest[pos].queue_rank)

    # -- mapping event (Fig. 5.2 / Fig. 5.5) ----------------------------------
    def _mapping_event(self) -> None:
        with self.tel.span("cp.map"):
            self._map()

    def _map(self) -> None:
        self.sub.before_mapping(self.now)
        # the overhead clock covers *scheduling* only: elasticity above and
        # machine starts below run substrate code (compiles, model steps)
        t0 = time.perf_counter()
        machines = self.sub.machines
        self.stats["mapping_events"] += 1
        if self.cfg.hard_deadlines:
            self._purge_infeasible()
        if self.pruner is not None:
            # pruner dropping pass over machine queues (Fig. 5.5); its wall
            # time is the mechanism's own overhead (§5.5), attributed apart
            with self.tel.span("cp.prune"):
                tp0 = time.perf_counter()
                dropped = self.pruner.drop_pass(machines, self.now,
                                                self._misses_since_event)
                self.stats["pruning_wall_s"] += time.perf_counter() - tp0
            self._misses_since_event = 0
            for t in dropped:
                self._evict_if_running(t, machines)
                info = self.pruner.drop_info.get(t.tid, {})
                self._drop(t, reason=("evicted_running"
                                      if info.get("evicted") else "pruned"),
                           chance=info.get("chance"),
                           threshold=info.get("threshold"))
        else:
            self._misses_since_event = 0

        # phase-specialized planes (§2.13): fresh sequences start with their
        # prefill, so decode-role machines never take initial mappings —
        # they receive work through the handoff path only.  A fleet without
        # phase roles (every machine "mixed") is untouched.
        map_machines = [m for m in machines if m.phase != "decode"] \
            or machines
        if self.batch and any(m.free_slots > 0 for m in map_machines):
            ctx = MappingContext(oracle=self.sub.oracle, now=self.now,
                                 pruner=self.pruner, prefix_fn=self.prefix_fn)
            if (self.pruner is not None
                    and self.heuristic.name not in ("PAM", "PAMF")):
                # Eq. 5.10 estimator runs every mapping event regardless of
                # the plugged-in heuristic (Fig. 5.5)
                with self.tel.span("cp.prune"):
                    tp0 = time.perf_counter()
                    self.pruner.refresh_defer_threshold(
                        self.batch, machines, ctx.chance, self.now)
                    self.stats["pruning_wall_s"] += time.perf_counter() - tp0
            before_defer = self.pruner.stats["deferred"] if self.pruner else 0
            if self.pruner is not None:
                self.pruner.defer_log.clear()
            mapped = self.heuristic.map_batch(self.batch, map_machines, ctx)
            if self.pruner is not None:
                self.stats["deferred"] += \
                    self.pruner.stats["deferred"] - before_defer
                if self.tel.enabled:
                    for tid, chance, thr in self.pruner.defer_log:
                        self.tel.event(self.now, "defer",
                                       task=self._arrival_index.get(tid, -1),
                                       chance=round(chance, 9),
                                       threshold=round(thr, 9),
                                       plane=self.plane_id)
                        self.tel.metrics.inc("defers")
            mapped_ids = {t.tid for t, _ in mapped}
            if mapped_ids:
                self.batch = [t for t in self.batch if t.tid not in mapped_ids]
                for t, m in mapped:
                    t.status = "mapped"
                    self.detector.on_departure(t)
                    self._log("map", self._index(t), machines.index(m))
                    self.tel.event(self.now, "map", task=self._index(t),
                                   machine=m.mid, plane=self.plane_id)
        dt = time.perf_counter() - t0
        self.stats["mapping_wall_s"] += dt
        self.tel.metrics.observe("mapping_event_wall_s", dt)
        self.tel.metrics.gauge("pruning_wall_s", self.stats["pruning_wall_s"])
        # start idle machines (execution time is the substrate's, not ours)
        for m in machines:
            if m.max_batch > 1:
                self._start_batched(m)
            elif m.running is None and m.queue:
                self._start_next(m)
        if self.after_mapping is not None:
            self.after_mapping(self)

    def _purge_infeasible(self) -> None:
        live, dead = [], []
        for t in self.batch:
            (dead if t.effective_deadline <= self.now else live).append(t)
        for t in dead:
            self.detector.on_departure(t)
            self._drop(t, reason="infeasible")
        self.batch = live

    def _evict_if_running(self, task: Task, machines: list[Machine]) -> None:
        """EVICT-mode drops can name an executing task: free its machine and
        invalidate the in-flight finish event via the epoch counter.  On a
        batched machine only the task's own sequences are dropped — the
        quantum (and its finish event) stands for the co-runners, and the
        steps already walked for the evicted task are honestly sunk cost."""
        for m in machines:
            if m.max_batch > 1:
                if task in m.active:
                    m.active.remove(task)
                    self.sub.evict_from_batch(task, m, self.now)
                    m.running = m.active[0] if m.active else None
            elif m.running is task:
                m.running = None
                m.run_end = m.busy_until = self.now
                self._epoch[m.mid] = self._epoch.get(m.mid, 0) + 1

    def _drop(self, task: Task, reason: str = "dropped",
              chance: float | None = None,
              threshold: float | None = None) -> None:
        task.status = "dropped"
        reqs = task.all_requests()
        n = len(reqs)
        self.sub.on_drop(task, self.now)
        self._misses_since_event += n
        self.stats["dropped_requests"] += n
        self._log("drop", self._index(task))
        if self.tel.enabled:
            for r in reqs:
                self.tel.event(
                    self.now, "drop",
                    req=self._arrival_index.get(r.tid, -1),
                    task=self._index(task), reason=reason,
                    chance=None if chance is None else round(chance, 9),
                    threshold=(None if threshold is None
                               else round(threshold, 9)),
                    plane=self.plane_id, tenant=r.tenant)
                if r.tenant is not None:
                    self.tel.metrics.inc("tenant_dropped", tenant=r.tenant)
            self.tel.metrics.inc("drops", n, reason=reason)
        self._notify_complete(task, "dropped")

    def _deadlock_drain(self) -> None:
        """No future events and an unmappable batch: nothing can ever make
        progress again (see ``run``).  Drop the stragglers — silently
        stranding them would corrupt QoS accounting — and record it."""
        self.stats["deadlock_breaks"] += 1
        for t in list(self.batch):
            self.detector.on_departure(t)
            self._drop(t, reason="deadlock")
        self.batch = []

    # -- machine execution ----------------------------------------------------
    def _tel_start(self, task: Task, m: Machine) -> None:
        self._log("start", self._index(task), self.sub.machines.index(m),
                  round(self.now, 6))
        if self.tel.enabled:
            reqs = task.all_requests()
            self.tel.event(self.now, "exec_start",
                           task=self._index(task), machine=m.mid,
                           plane=self.plane_id, n_requests=len(reqs),
                           wait=round(self.now - task.arrival, 9))
            for r in reqs:
                self.tel.metrics.observe("queue_wait", self.now - r.arrival)

    def _notify_complete(self, task: Task, outcome: str) -> None:
        """Closed-loop workload hook: per-request fan-out of ``on_complete``
        after substrate accounting (see the attribute doc in __init__)."""
        if self.on_complete is not None:
            for r in task.all_requests():
                self.on_complete(r, self.now, outcome)

    def _tel_finish(self, task: Task, m: Machine, missed: int) -> None:
        self._log("finish", self._index(task), round(self.now, 6), missed)
        if self.tel.enabled:
            reqs = task.all_requests()
            self.tel.event(self.now, "exec_end", task=self._index(task),
                           machine=m.mid, plane=self.plane_id,
                           n_requests=len(reqs), missed=missed)
            # per-tenant exec-cost attribution: the measured occupancy span
            # is billed at the machine's cost rate, split over the served
            # requests (a merged compound shares one execution)
            span = self.now - getattr(task, "_exec_start", self.now)
            cost_share = span * m.cost_rate / len(reqs)
            for r in reqs:
                latency = self.now - r.arrival
                slack = r.deadline - self.now
                on_time = slack >= 0
                self.tel.event(self.now, "complete",
                               req=self._arrival_index.get(r.tid, -1),
                               task=self._index(task),
                               latency=round(latency, 9),
                               slack=round(slack, 9), on_time=on_time,
                               plane=self.plane_id, tenant=r.tenant)
                self.tel.metrics.observe("latency", latency)
                self.tel.metrics.observe("slack", slack)
                self.tel.metrics.inc("completed")
                self.tel.metrics.inc("on_time" if on_time else "missed")
                if r.tenant is not None:
                    self.tel.metrics.inc("tenant_completed", tenant=r.tenant)
                    self.tel.metrics.inc(
                        "tenant_on_time" if on_time else "tenant_missed",
                        tenant=r.tenant)
                    self.tel.metrics.observe("tenant_latency", latency,
                                             tenant=r.tenant)
                    self.tel.metrics.inc("tenant_exec_cost", cost_share,
                                         tenant=r.tenant)
            if len(reqs) > 1:
                # measured merge saving: one execution served k requests, so
                # (k-1) duplicate executions of this measured length were
                # avoided — the saving stream the reuse predictor trains on
                start = getattr(task, "_exec_start", self.now)
                saving = (self.now - start) * (len(reqs) - 1)
                self.tel.event(self.now, "merge_saving",
                               task=self._index(task), fanout=len(reqs),
                               saving=round(saving, 9), plane=self.plane_id)
                self.tel.metrics.observe("merge_saving", saving)

    def _start_next(self, m: Machine) -> None:
        if m.running is not None or m.busy_until > self.now:
            return
        while m.queue:
            task = m.queue.pop(0)
            if self.cfg.hard_deadlines and task.effective_deadline <= self.now:
                self._drop(task, reason="expired_at_start")
                continue
            dur = self.sub.begin_execution(task, m, self.now)
            task.status = "running"
            task._exec_start = self.now
            m.running = task
            m.run_end = m.busy_until = self.now + dur
            self._epoch[m.mid] = self._epoch.get(m.mid, 0) + 1
            self._push(m.run_end, "finish", (m.mid, self._epoch[m.mid]))
            self._tel_start(task, m)
            return

    def _handle_finish(self, m: Machine) -> None:
        if m.max_batch > 1:
            self._finish_batched(m)
            return
        task = m.running
        m.running = None
        if task is None:
            return
        missed = self.sub.finish_execution(task, m, self.now)
        self._misses_since_event += missed
        self.stats["last_completion"] = max(self.stats["last_completion"],
                                            self.now)
        self._tel_finish(task, m, missed)
        self._notify_complete(task, "done")
        self._start_next(m)

    # -- step-level batching (machines with ``max_batch > 1``) ---------------
    def _start_batched(self, m: Machine) -> None:
        """Admit queued tasks into the machine's step batch and schedule the
        next quantum.  Admissions only take effect at quantum boundaries —
        mid-quantum (``busy_until > now``) the walker has already costed
        the in-flight steps, so joiners wait at most one quantum."""
        if m.busy_until > self.now or m.mid in self._quantum_done:
            # second clause: the quantum ends exactly *now* but its finish
            # event has not popped yet — starting another would clobber the
            # stashed completions and orphan their tasks
            return
        if m.running is not None and m.running.is_placeholder:
            return
        while m.queue and len(m.active) < m.max_batch:
            task = m.queue.pop(0)
            if self.cfg.hard_deadlines and task.effective_deadline <= self.now:
                self._drop(task, reason="expired_at_start")
                continue
            self.sub.join_batch(task, m, self.now)
            task.status = "running"
            task._exec_start = self.now
            m.active.append(task)
            self._tel_start(task, m)
        if m.active:
            self._schedule_quantum(m)
        else:
            m.running = None
            m.run_end = m.busy_until = self.now

    def _schedule_quantum(self, m: Machine) -> None:
        t_end, completed = self.sub.run_quantum(m, self.now)
        if t_end is None:
            m.running = None
            m.run_end = m.busy_until = self.now
            return
        self._quantum_done[m.mid] = completed
        m.running = m.active[0] if m.active else None
        m.run_end = m.busy_until = t_end
        self._epoch[m.mid] = self._epoch.get(m.mid, 0) + 1
        self._push(t_end, "finish", (m.mid, self._epoch[m.mid]))

    # -- prefill→decode handoff (DESIGN.md §2.13) -----------------------------
    def _pick_handoff_dst(self, task: Task, src: Machine) -> Machine | None:
        ctx = MappingContext(oracle=self.sub.oracle, now=self.now,
                             pruner=self.pruner, prefix_fn=self.prefix_fn)
        return pick_handoff_machine(task, src, self.sub.machines, ctx,
                                    self.migrate_cost_fn)

    def _schedule_handoff(self, task: Task, src: Machine) -> bool:
        """First-class scheduled event at the prefill→decode boundary: pick
        the decode machine (migration cost vs locality vs completion), then
        let the modeled transfer delay elapse before the sequence rejoins.
        False when no decode-capable machine exists (finish in place)."""
        dst = self._pick_handoff_dst(task, src)
        if dst is None:
            return False
        cost = (self.migrate_cost_fn(task, src, dst)
                if self.migrate_cost_fn is not None else 0.0)
        self._log("handoff", self._index(task),
                  self.sub.machines.index(dst), round(cost, 6))
        self.tel.event(self.now, "handoff", task=self._index(task),
                       src=src.mid, dst=dst.mid, cost=round(cost, 9),
                       plane=self.plane_id)
        self.tel.metrics.inc("handoffs")
        self._push(self.now + cost, "handoff", (task, src, dst))
        return True

    def _handle_handoff(self, task: Task, src: Machine, dst: Machine) -> None:
        if dst not in self.sub.machines:
            # retired while the transfer was in flight: re-pick
            dst = self._pick_handoff_dst(task, src)
            if dst is None:
                self._drop(task, reason="handoff_lost")
                return
        self.sub.on_handoff(task, src.mid, dst.mid, self.now)
        task.machine = dst.mid
        task.status = "mapped"
        dst.queue.append(task)

    def _finish_batched(self, m: Machine) -> None:
        """A quantum boundary: account the completions the walker reported
        for this instant; the trailing mapping event re-admits and starts
        the next quantum (``_start_batched`` via the start loop)."""
        m.busy_until = self.now
        for task in self._quantum_done.pop(m.mid, []):
            if task.status == "dropped" or task not in m.active:
                continue  # evicted mid-quantum; already accounted
            m.active.remove(task)
            if self.sub.handoff_ready(task, m) \
                    and self._schedule_handoff(task, m):
                continue    # finishes later, on the decode machine
            missed = self.sub.finish_execution(task, m, self.now)
            self._misses_since_event += missed
            self.stats["last_completion"] = max(
                self.stats["last_completion"], self.now)
            self._tel_finish(task, m, missed)
            self._notify_complete(task, "done")
        m.running = m.active[0] if m.active else None
