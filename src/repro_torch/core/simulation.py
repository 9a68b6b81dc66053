"""Discrete-event simulator for the Chapter 4/5/6 experiments.

The simulator is the *analytical substrate* of the unified scheduling
control plane (``core.controlplane``): admission control, the batch queue,
mapping heuristics and the pruning mechanism all live in ``ControlPlane`` —
shared verbatim with the live SMSE serving engine — while this module
supplies the substrate side: an execution-time oracle instead of compiled
executables, payload-free prefix-cache accounting, and per-request QoS
bookkeeping.  Thousand-task experiments run in milliseconds, and every
scheduling decision is bit-identical to what the engine would take on the
same trace and oracle (asserted in tests/test_controlplane.py).

A copy of ``repro.core.simulation`` for the port, unchanged but for this line.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

from .controlplane import ControlConfig, ControlPlane, Substrate
from .fleet import FleetSpec, kv_block_budget
from .merge_model import VideoExecModel, VideoMeta
from .pmf import PMF
from .pruning import PruningConfig
from .tasks import Machine, PETMatrix, Task

if TYPE_CHECKING:   # core stays importable without the serving package
    from ..serving.autoscale import ElasticityConfig
    from ..serving.batching import StepBatchingConfig

__all__ = ["SimConfig", "SimStats", "Simulator", "PETOracle", "VideoOracle"]


# ---------------------------------------------------------------------------
# Execution oracles
# ---------------------------------------------------------------------------

class PETOracle:
    """Oracle backed by a PET matrix (Chapter 5 workloads).

    ``uncertainty_mult`` widens the *ground truth* spread relative to what
    the estimator believes (the 5SD/10SD experiments of §4.6.5).
    """

    def __init__(self, pet: PETMatrix, uncertainty_mult: float = 1.0, seed: int = 0):
        self.petm = pet
        self.uncertainty = uncertainty_mult
        self._rng = np.random.default_rng(seed)
        self._cache: dict = {}

    def mean_std(self, task: Task, machine: Machine) -> tuple[float, float]:
        key = (task.ttype, machine.mtype, machine.speed)
        if key not in self._cache:
            p = self.petm.pet(task.ttype, machine)
            self._cache[key] = (p.mean(), p.std())
        return self._cache[key]

    def pmf(self, task: Task, machine: Machine) -> PMF:
        return self.petm.pet(task.ttype, machine)

    def sample(self, task: Task, machine: Machine) -> float:
        mu, sd = self.mean_std(task, machine)
        if self.uncertainty == 1.0:
            p = self.petm.pet(task.ttype, machine).normalize()
            v = p.values / p.values.sum()
            return float(self._rng.choice(p.times(), p=v))
        return float(max(1.0, self._rng.normal(mu, sd * self.uncertainty)))


class VideoOracle:
    """Oracle backed by the Chapter-3 video execution model; understands
    merged tasks (compound ops on the same segment)."""

    def __init__(self, exec_model: VideoExecModel, videos: dict[str, VideoMeta],
                 rel_std: float = 0.04, uncertainty_mult: float = 1.0,
                 seed: int = 0):
        self.model = exec_model
        self.videos = videos
        self.rel_std = rel_std
        self.uncertainty = uncertainty_mult
        self._rng = np.random.default_rng(seed)

    def _ops(self, task: Task) -> list[str]:
        return [r.op for r in task.all_requests()]

    def _mean(self, task: Task, machine: Machine) -> float:
        v = self.videos[task.data_id]
        ops = self._ops(task)
        t = (self.model.individual_time(v, ops[0], noisy=False) if len(ops) == 1
             else self.model.merged_time(v, ops, noisy=False))
        return t / machine.speed

    def mean_std(self, task: Task, machine: Machine) -> tuple[float, float]:
        mu = self._mean(task, machine)
        return mu, self.rel_std * mu

    def pmf(self, task: Task, machine: Machine) -> PMF:
        mu, sd = self.mean_std(task, machine)
        return PMF.from_normal(mu, sd)

    def sample(self, task: Task, machine: Machine) -> float:
        mu, sd = self.mean_std(task, machine)
        return float(max(0.05, self._rng.normal(mu, sd * self.uncertainty)))


# ---------------------------------------------------------------------------
# Config & stats
# ---------------------------------------------------------------------------

@dataclass
class SimConfig:
    heuristic: str = "FCFS-RR"
    merging: str = "none"               # none|conservative|aggressive|adaptive
    position_finder: str | None = None  # None|"linear"|"log"
    pruning: PruningConfig | None = None
    hard_deadlines: bool = False        # Ch5: purge late tasks; Ch4: run anyway
    immediate_mode: bool = False
    seed: int = 0
    alpha: float = 2.0                  # base worst-case coefficient (Eq. 4.1)
    merge_degree_cap: int = 5           # §3.2.2: little gain beyond 5
    # TASK-level result cache (the engine's "stream cachine", analytically):
    # an identical request arriving after a completion is served at zero
    # cost.  Off by default — Ch. 4/5 experiments predate it.
    result_cache: bool = False
    # elasticity (DESIGN.md §2.7): the shared autoscale subsystem run
    # analytically — up to ``elasticity.max_extra`` clones of machines[0]
    # are added/retired by the configured scaler policy (queue /
    # success-chance / cost-aware).  None (or max_extra == 0) disables.
    elasticity: "ElasticityConfig | None" = None
    # analytical paged-KV prefix cache (DESIGN.md §2.4): tasks carrying
    # ``tokens`` reuse the cached prefix and pay only the suffix's share of
    # the prefill.  0 blocks = disabled.  The *same* admission/eviction
    # machinery as the live engine runs here, payload-free, so cache-size x
    # workload-skew sweeps don't need JAX.
    prefix_cache_blocks: int = 0
    kv_block_size: int = 16
    prefill_fraction: float = 0.6       # share of exec time that is prefill
    # per-machine KV caches (DESIGN.md §2.8): each machine owns its own
    # ``prefix_cache_blocks``-block cache — the analytical twin of the live
    # engine's per-unit caches, where ``MappingContext.prefix_overlap``
    # discriminates within the pool.  False keeps the pre-fleet shared
    # cache (one pool-wide cache; the machine argument is a no-op), which
    # models a disaggregated KV store and preserves legacy sweeps exactly.
    kv_per_machine: bool = False
    # step-level continuous batching (DESIGN.md §2.10): machines co-run up
    # to ``batching.max_batch`` tasks through the shared ``UnitBatch`` step
    # walker — each task's oracle-sampled duration is split into per-token
    # prefill/decode rates and the fused-step cost model prices every step,
    # so throughput becomes batch-size- and chunk-dependent exactly as in
    # the engine's analytic stub.  None keeps the run-to-completion model.
    # Analytic prefix reuse is bypassed under batching (the chunk walker
    # owns the prefill accounting).
    batching: "StepBatchingConfig | None" = None
    # prefill/decode disaggregation (DESIGN.md §2.13): the KV transfer
    # pricing used for handoff scheduling when the fleet declares phase
    # roles.  None -> TransferCostModel() defaults; must match the engine's
    # for decision-trace equivalence.
    kv_transfer: "object | None" = None

    def control(self) -> ControlConfig:
        return ControlConfig(
            heuristic=self.heuristic, merging=self.merging,
            position_finder=self.position_finder, pruning=self.pruning,
            hard_deadlines=self.hard_deadlines, alpha=self.alpha,
            merge_degree_cap=self.merge_degree_cap)


@dataclass
class SimStats:
    n_requests: int = 0
    on_time: int = 0
    missed: int = 0
    dropped: int = 0
    merges: int = 0
    merge_rejected: int = 0
    makespan: float = 0.0
    busy_time: float = 0.0
    cost: float = 0.0
    energy: float = 0.0
    mapping_events: int = 0
    mapping_wall_s: float = 0.0
    pruning_wall_s: float = 0.0
    deadlock_breaks: int = 0
    result_cache_hits: int = 0
    # autoscale accounting (DESIGN.md §2.7) ------------------------------------
    scale_ups: int = 0
    scale_downs: int = 0
    scale_decisions: int = 0
    machine_seconds: float = 0.0        # integral of pool size over time
    extra_machine_seconds: float = 0.0  # spend above the base pool
    pool_cost: float = 0.0              # per-mtype cost_rate integral
    extra_pool_cost: float = 0.0        # cost integral above the base pool
    warmup_ticks: float = 0.0           # virtual time charged to warm-ups
    per_type: dict = field(default_factory=dict)
    per_user_missrate: dict = field(default_factory=dict)
    deferred: int = 0
    # paged-KV prefix reuse ----------------------------------------------------
    prefix_hits: int = 0
    prefix_tokens_reused: int = 0
    prefix_evictions: int = 0
    prefix_time_saved: float = 0.0

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / max(self.n_requests, 1)

    @property
    def miss_rate(self) -> float:
        total = self.on_time + self.missed + self.dropped
        return (self.missed + self.dropped) / total if total else 0.0

    @property
    def robustness(self) -> float:
        total = self.on_time + self.missed + self.dropped
        return self.on_time / total if total else 0.0

    def fairness_variance(self) -> float:
        """Variance of per-user miss rate (Fig. 6.9 'suffering variation')."""
        rates = [m / max(n, 1) for m, n in self.per_user_missrate.values()]
        return float(np.var(rates)) if rates else 0.0

    def type_fairness_variance(self) -> float:
        """Variance of per-task-type miss rate (§5.7.5 fairness factor)."""
        rates = [miss / max(ok + miss, 1) for ok, miss in self.per_type.values()]
        return float(np.var(rates)) if rates else 0.0


# ---------------------------------------------------------------------------
# Simulator — the oracle-backed substrate
# ---------------------------------------------------------------------------

class Simulator(Substrate):
    def __init__(self, tasks: list[Task], machines, oracle,
                 cfg: SimConfig | None = None):
        self.cfg = cfg or SimConfig()
        self.tasks = sorted(tasks, key=lambda t: t.arrival)
        # ``machines`` may be a FleetSpec (DESIGN.md §2.8): the simulator
        # then builds the exact machines a serving engine on the same spec
        # would run (mids from 1, same mtypes/speeds/cost rates/queues), so
        # trace-equivalence tests share PET keys by construction
        self.fleet = machines if isinstance(machines, FleetSpec) else None
        self.machines = (machines.build_machines()
                         if isinstance(machines, FleetSpec) else machines)
        self.oracle = oracle
        self.stats = SimStats()
        self._tel = None                    # obs.Telemetry once attached
        self.cp = ControlPlane(self, self.cfg.control())
        self._rng = np.random.default_rng(self.cfg.seed)
        self._result_cache: set = set()
        self._base_pool = len(self.machines)
        self._extra_mid = max((m.mid for m in self.machines), default=-1)
        self.scaler = None
        if self.cfg.elasticity is not None and self.cfg.elasticity.max_extra > 0:
            # lazy import: core stays importable without the serving package
            from ..serving.autoscale import PoolScaler
            self.scaler = PoolScaler(self.cfg.elasticity,
                                     _SimMachinePool(self),
                                     len(self.machines))
        self.kvcache = None
        self.kvcaches: dict[int, object] = {}   # mid -> per-machine cache
        self._retired_evictions = 0             # from scaler-retired caches
        self._batches: dict[int, object] = {}   # mid -> UnitBatch walker
        # prefill/decode disaggregation state (DESIGN.md §2.13)
        self._handoff_pending: dict[int, bool] = {}  # tid clipped at boundary
        self._handoff_cont: dict[int, int] = {}      # tid -> tokens remaining
        self._xfer = None
        if self.cfg.batching is not None and self.cfg.batching.max_batch > 1:
            for m in self.machines:
                m.max_batch = self.cfg.batching.max_batch
            # lazy import: core stays importable without the serving package
            from ..serving.kvcache import TransferCostModel
            self._xfer = self.cfg.kv_transfer or TransferCostModel()
            self.cp.migrate_cost_fn = self._migrate_cost
        if self.cfg.prefix_cache_blocks > 0:
            # lazy import: core stays importable without the serving package
            from ..serving.kvcache import CombinedPrefixIndex, PrefixKVCache
            if self.cfg.kv_per_machine:
                # the live engine's per-unit caches, analytically: each
                # machine admits/evicts its own blocks and the locality
                # term discriminates within the pool
                for m in self.machines:
                    self.kvcaches[m.mid] = self._make_kvcache(m)
                self.cp.detector.prefix_index = \
                    CombinedPrefixIndex(self.kvcaches)
            else:
                self.kvcache = self._make_kvcache()
                self.cp.detector.prefix_index = self.kvcache.index
            # prefix-cache-aware mapping, same wiring as the live engine
            self.cp.prefix_fn = self._prefix_locality

    # -- delegation (public surface kept from the pre-control-plane API) -----
    @property
    def now(self) -> float:
        return self.cp.now

    @property
    def batch(self) -> list[Task]:
        return self.cp.batch

    @property
    def detector(self):
        return self.cp.detector

    @property
    def pruner(self):
        return self.cp.pruner

    @property
    def heuristic(self):
        return self.cp.heuristic

    def _make_kvcache(self, machine: Machine | None = None):
        from ..serving.kvcache import PrefixKVCache
        blocks = self.cfg.prefix_cache_blocks
        if machine is not None and self.cfg.kv_per_machine:
            # admission-aware budget: phase role and speed size the pool
            # (mixed @ speed 1 keeps the historical uniform budget)
            blocks = kv_block_budget(blocks, machine.phase, machine.speed)
        return PrefixKVCache(blocks, self.cfg.kv_block_size,
                             clock_fn=lambda: self.now)

    # -- observability ---------------------------------------------------------
    def attach_telemetry(self, tel, plane: int | None = None) -> None:
        """Wire one ``repro.obs.Telemetry`` through every layer of this
        simulator — the analytical mirror of
        ``ServingEngine.attach_telemetry``, so the two substrates emit
        diffable event streams from the same trace.  Recording only."""
        self._tel = tel
        if plane is not None:
            self.cp.plane_id = plane
        self.cp.tel = tel
        if self.cfg.kv_per_machine:
            for mid, cache in self.kvcaches.items():
                cache.tel = tel
                cache.tel_attrs = {"plane": self.cp.plane_id, "machine": mid}
        elif self.kvcache is not None:
            self.kvcache.tel = tel
            self.kvcache.tel_attrs = {"plane": self.cp.plane_id}
        if self.scaler is not None:
            # scope mirrors the engine's unit pool: the sim's machine clones
            # are the analytical twin of processing units
            self.scaler.tel = tel
            self.scaler.scope = "units"

    def _machine_cache(self, machine: Machine):
        """The cache an execution on ``machine`` reads/writes: its own in
        per-machine mode, the shared one otherwise."""
        if self.cfg.kv_per_machine:
            return self.kvcaches.get(machine.mid)
        return self.kvcache

    def _prefix_locality(self, task: Task, machine: Machine) -> int:
        if not self.cfg.kv_per_machine:
            # shared cache: every machine scores the same overlap (the
            # pre-fleet behavior — locality only discriminates across
            # planes, through the router)
            return self.detector.find_prefix_overlap(task.tokens)
        cache = self.kvcaches.get(machine.mid)
        if cache is None or task.tokens is None or len(task.tokens) < 2:
            return 0
        return cache.index.match_len(task.tokens, len(task.tokens) - 1)

    def run(self) -> SimStats:
        """Closed-trace convenience: schedule every constructor task, drain,
        sync stats.  The cluster front door instead streams arrivals into
        ``cp`` directly and reads ``collect_stats()``."""
        for task in self.tasks:
            self.cp.schedule_arrival(task.arrival, task)
        self.cp.run()
        return self.collect_stats()

    def collect_stats(self) -> SimStats:
        """Sync control-plane counters into ``stats`` (idempotent)."""
        c = self.cp.stats
        s = self.stats
        s.makespan = c["last_completion"]
        s.merges = c["merges"]
        s.merge_rejected = c["merge_rejected"]
        s.mapping_events = c["mapping_events"]
        s.mapping_wall_s = c["mapping_wall_s"]
        s.pruning_wall_s = c["pruning_wall_s"]
        s.deferred = c["deferred"]
        s.deadlock_breaks = c["deadlock_breaks"]
        if self.scaler is not None:
            self.scaler.sync(self.cp.now)
            sc = self.scaler.stats
            s.scale_ups = sc["scale_ups"]
            s.scale_downs = sc["scale_downs"]
            s.scale_decisions = sc["scale_decisions"]
            s.machine_seconds = sc["machine_seconds"]
            s.extra_machine_seconds = sc["extra_machine_seconds"]
            s.pool_cost = sc["pool_cost"]
            s.extra_pool_cost = sc["extra_pool_cost"]
            s.warmup_ticks = sc["warmup_ticks"]
        else:
            # fixed pool: the integrals degenerate to pool x makespan,
            # billed per machine type through each machine's cost rate
            s.machine_seconds = len(self.machines) * s.makespan
            s.pool_cost = s.makespan * sum(m.cost_rate
                                           for m in self.machines)
        return s

    # -- Substrate: admission -------------------------------------------------
    def ingest(self, task: Task, now: float) -> Task | None:
        self.stats.n_requests += 1
        if self.cfg.result_cache and task.key_task_level() in self._result_cache:
            task.status = "done"
            task.completion = now
            self.stats.result_cache_hits += 1
            on_time = now <= task.deadline
            self.stats.on_time += 1 if on_time else 0
            self.stats.missed += 0 if on_time else 1
            self._note_outcome(task, on_time)
            return None
        return task

    # -- Substrate: elasticity ------------------------------------------------
    def before_mapping(self, now: float) -> None:
        if self.scaler is not None:
            self.scaler.step_substrate(now, self.cp, self.machines,
                                       self.oracle)

    # -- Substrate: execution -------------------------------------------------
    def begin_execution(self, task: Task, m: Machine, now: float) -> float:
        dur = self.oracle.sample(task, m)
        dur = self._apply_prefix_reuse(task, dur, m)
        self.stats.busy_time += dur
        self.stats.cost += dur * m.cost_rate
        self.stats.energy += dur * m.power
        return dur

    def finish_execution(self, task: Task, m: Machine, now: float) -> int:
        self._finish_prefix_reuse(task, m)
        self._handoff_pending.pop(task.tid, None)   # no-dst fallback path
        self._handoff_cont.pop(task.tid, None)
        missed = 0
        for r in task.all_requests():
            r.status = "done"
            r.completion = now
            on_time = now <= r.deadline
            if on_time:
                self.stats.on_time += 1
                if self.pruner:
                    self.pruner.fairness.note_served(r.ttype)
            else:
                self.stats.missed += 1
                missed += 1
            self._note_outcome(r, on_time)
            if self.cfg.result_cache:
                self._result_cache.add(r.key_task_level())
        return missed

    # -- Substrate: step-level batching (DESIGN.md §2.10) ----------------------
    def _unit_batch(self, m: Machine):
        ub = self._batches.get(m.mid)
        if ub is None:
            # lazy import: core stays importable without the serving package
            from ..serving.batching import UnitBatch

            def on_step(t, dt, plan):
                tel = self.cp.tel
                if tel.enabled:
                    tel.event(t, "batch_step", machine=m.mid,
                              plane=self.cp.plane_id, dt=round(dt, 9),
                              tokens=plan.tokens, decode=len(plan.decode),
                              chunks=len(plan.chunks))
                    tel.metrics.observe("step_ticks", dt)

            ub = self._batches[m.mid] = UnitBatch(self.cfg.batching,
                                                  on_step=on_step)
        return ub

    def join_batch(self, task: Task, m: Machine, now: float) -> None:
        """Admit ``task`` into the machine's step batch: the oracle-sampled
        run-to-completion duration is split into prefill/decode work and
        converted to per-token rates the fused-step cost model prices.
        Work (cost/energy) is charged as in ``begin_execution`` — batching
        compresses wall-clock occupancy, not the work itself."""
        from ..serving.batching import SeqState, task_dims
        cfg = self.cfg.batching
        cont = self._handoff_cont.pop(task.tid, None)
        dur = self.oracle.sample(task, m)
        plen, n_new = task_dims(task, cfg)
        wp = dur * cfg.prefill_fraction
        step = (dur - wp) / max(n_new, 1)
        if cont is not None:
            # decode continuation after a prefill-plane handoff (§2.13):
            # the prefill plane already charged the prefill work plus the
            # boundary token, this plane runs the remaining decode steps
            span = step * cont
            seq = SeqState(task=task, plen=plen, n_new=n_new,
                           prefill_done=plen, decoded=n_new - cont,
                           prefill_rate=wp / plen, decode_step=step)
        elif (m.phase == "prefill" and n_new > 1
              and any(x.phase != "prefill" for x in self.machines)):
            # prefill plane: run to the first token only; the walker
            # completing at the boundary triggers handoff_ready
            self._handoff_pending[task.tid] = True
            span = wp + step
            seq = SeqState(task=task, plen=plen, n_new=1,
                           prefill_rate=wp / plen, decode_step=step)
        else:
            span = dur
            seq = SeqState(task=task, plen=plen, n_new=n_new,
                           prefill_rate=wp / plen, decode_step=step)
        self.stats.busy_time += span
        self.stats.cost += span * m.cost_rate
        self.stats.energy += span * m.power
        self._unit_batch(m).join(seq, now)

    def run_quantum(self, m: Machine, now: float):
        ub = self._batches.get(m.mid)
        if ub is None or ub.empty:
            return None, []
        t_end, completed = ub.run_quantum(now)
        if t_end is None:
            return None, []
        return t_end, [s.task for s in completed]

    def evict_from_batch(self, task: Task, m: Machine, now: float) -> None:
        ub = self._batches.get(m.mid)
        if ub is not None:
            ub.evict(task)

    # -- Substrate: prefill/decode disaggregation (DESIGN.md §2.13) ------------
    def handoff_ready(self, task: Task, machine: Machine) -> bool:
        return task.tid in self._handoff_pending

    def on_handoff(self, task: Task, src_mid: int, dst_mid: int,
                   now: float) -> None:
        from ..serving.batching import task_dims
        self._handoff_pending.pop(task.tid, None)
        _, n_new = task_dims(task, self.cfg.batching)
        self._handoff_cont[task.tid] = n_new - 1
        src = self.kvcaches.get(src_mid)
        dst = self.kvcaches.get(dst_mid)
        if src is not None and dst is not None and task.tokens:
            # analytic payload-free block move, same trie surgery as the
            # live engine's arena-reference migration
            from ..serving.kvcache import migrate
            sm = next(x for x in self.machines if x.mid == src_mid)
            dm = next(x for x in self.machines if x.mid == dst_mid)
            migrate(src, dst, task.tokens, cost_model=self._xfer,
                    src_speed=sm.speed, dst_speed=dm.speed, now=now,
                    src_mid=src_mid, dst_mid=dst_mid, tel=self._tel)

    def _migrate_cost(self, task: Task, src: Machine, dst: Machine) -> float:
        """Modeled KV transfer cost for handoff scheduling.  Computed from
        the task's prompt dims minus the destination's already-resident
        prefix, so the router weighs migration volume against locality.
        Must be substrate-identical: the stub engine and the sim both see
        the same (empty-until-populated) caches and the same dims."""
        from ..serving.batching import task_dims
        plen, _ = task_dims(task, self.cfg.batching)
        bs = self.cfg.kv_block_size
        have = 0
        cache = self.kvcaches.get(dst.mid)
        if cache is not None and task.tokens:
            have = cache.peek(task.tokens) // bs
        n_blocks = max(0, plen // bs - have)
        return self._xfer.cost(n_blocks, bs, src.speed, dst.speed)

    def on_drop(self, task: Task, now: float) -> None:
        for r in task.all_requests():
            r.status = "dropped"
            self.stats.dropped += 1
            self._note_outcome(r, on_time=False)

    def _note_outcome(self, req: Task, on_time: bool) -> None:
        tt = self.stats.per_type.setdefault(req.ttype, [0, 0])
        tt[0 if on_time else 1] += 1
        u = self.stats.per_user_missrate.setdefault(req.user, [0, 0])
        u[1] += 1
        if not on_time:
            u[0] += 1

    # -- analytical paged-KV prefix reuse (DESIGN.md §2.4) ---------------------
    def _apply_prefix_reuse(self, task: Task, dur: float,
                            m: Machine) -> float:
        """Shrink ``dur`` by the prefill share covered by cached KV blocks
        (in per-machine mode, only the executing machine's own blocks —
        the live engine's per-unit semantics).

        Mirrors the live engine's lookup-pin-execute protocol: the matched
        blocks stay pinned until the task finishes, so concurrent evictions
        (other machines inserting) can never free KV this execution reads."""
        cache = self._machine_cache(m)
        if cache is None or not task.tokens:
            return dur
        toks = task.tokens
        hit = cache.lookup(toks, max_tokens=len(toks) - 1)
        task._prefix_hit = hit
        if not hit:
            return dur
        saved = dur * self.cfg.prefill_fraction * hit.n_tokens / len(toks)
        self.stats.prefix_hits += 1
        self.stats.prefix_tokens_reused += hit.n_tokens
        self.stats.prefix_time_saved += saved
        return dur - saved

    def _finish_prefix_reuse(self, task: Task, m: Machine) -> None:
        if m.max_batch > 1:
            return      # batching bypasses analytic prefix reuse (§2.10)
        cache = self._machine_cache(m)
        if cache is None or not task.tokens:
            return
        cache.insert(task.tokens)
        hit = getattr(task, "_prefix_hit", None)
        if hit:
            cache.release(hit)
        caches = (self.kvcaches.values() if self.cfg.kv_per_machine
                  else (self.kvcache,))
        self.stats.prefix_evictions = self._retired_evictions + \
            sum(c.stats["evictions"] for c in caches)


class _SimMachinePool:
    """Autoscale pool adapter over the simulator's machine list: grows
    instantly (payload-free, no warm-up charge) — from the fleet's
    cheapest row when the simulator was built from a :class:`FleetSpec`,
    else by cloning ``machines[0]`` (the pre-fleet behavior) — and retires
    only scaler-added extras, priciest idle one first (the last idle extra
    on a homogeneous pool, exactly the legacy scan)."""

    def __init__(self, sim: Simulator):
        self.sim = sim

    def size(self) -> int:
        return len(self.sim.machines)

    def cost_rate(self) -> float:
        return sum(m.cost_rate for m in self.sim.machines)

    def grow(self, now: float) -> float:
        sim = self.sim
        sim._extra_mid += 1
        if sim.fleet is not None:
            m = sim.fleet.cheapest().build_machine(sim._extra_mid)
        else:
            proto = sim.machines[0]
            m = Machine(mid=sim._extra_mid, mtype=proto.mtype,
                        speed=proto.speed, queue_size=proto.queue_size,
                        cost_rate=proto.cost_rate, power=proto.power)
        if sim.cfg.batching is not None and sim.cfg.batching.max_batch > 1:
            m.max_batch = sim.cfg.batching.max_batch
        sim.machines.append(m)
        if sim.cfg.kv_per_machine and sim.cfg.prefix_cache_blocks > 0:
            cache = sim._make_kvcache(m)
            if sim._tel is not None:
                cache.tel = sim._tel
                cache.tel_attrs = {"plane": sim.cp.plane_id,
                                   "machine": m.mid}
            sim.kvcaches[m.mid] = cache
        return 0.0

    def shrink(self, now: float) -> bool:
        sim = self.sim
        machines = sim.machines
        idle = [i for i in range(sim._base_pool, len(machines))
                if machines[i].running is None and not machines[i].queue
                and machines[i].busy_until <= now]
        if not idle:
            return False
        i = max(idle, key=lambda j: (machines[j].cost_rate, j))
        m = machines.pop(i)
        sim._batches.pop(m.mid, None)
        cache = sim.kvcaches.pop(m.mid, None)
        if cache is not None:
            # retire-migrates-blocks (§2.13): hand the whole trie to the
            # cheapest surviving decode-capable cache instead of dropping
            # it, so warm prefixes survive a scale-down
            heirs = [x for x in machines if x.mid in sim.kvcaches]
            if heirs and len(cache.index):
                from ..serving.kvcache import migrate
                heir = min(heirs, key=lambda x: (x.phase == "prefill",
                                                 x.cost_rate, x.mid))
                migrate(cache, sim.kvcaches[heir.mid],
                        cost_model=sim._xfer, src_speed=m.speed,
                        dst_speed=heir.speed, now=now, src_mid=m.mid,
                        dst_mid=heir.mid, tel=sim._tel)
            sim._retired_evictions += cache.stats["evictions"]
        return True
