"""The port's twin of ``tests/test_controlplane.py``: the shared
admission/merge/prune/map loop of ``repro_torch.core.controlplane`` in
isolation, the simulator features that rode in with it, and the
decision-sequence equivalence between the port's discrete-event simulator
and the port's stub-execution ``ServingEngine`` driving the same trace
through the same oracle.

Every engine and simulator runs on ``device="cpu"``.  Each case of
``TestDecisionEquivalence`` that yields a ``ControlPlane.trace`` also runs
JAX's ``repro.core.simulation.Simulator`` on the same tasks, fleet, oracle
and seed, and holds the port's traces to it exactly.  The reference's
``test_same_trace_same_oracle_same_decisions`` (three configurations on
its 5-prompt trace) is held by the ``*-5prompts`` cases of
``tests/test_torch_cluster.py::TestSimulator``: the port's simulator
against JAX's, and the port's stub engine against the port's
simulator.
"""

import numpy as np

from repro_torch.core.controlplane import (ControlConfig, ControlPlane,
                                           Substrate)
from repro_torch.core.pmf import DropMode
from repro_torch.core.pruning import PruningConfig
from repro_torch.core.simulation import PETOracle, SimConfig, Simulator
from repro_torch.core.tasks import Machine, Task
from repro_torch.serving.autoscale import ElasticityConfig
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine
from torch_jax_side import JAX, MSD_PRUNING, PORT

CPU = "cpu"


def _pet(seed=0, mean_range=(10, 20)):
    return PORT.pet(seed=seed, mean_range=mean_range)


def _mk_task(data="d0", op="generate", params=(), arrival=0.0,
             deadline=1000.0, ttype="generate"):
    return Task(ttype=ttype, data_id=data, op=op, params=params,
                arrival=arrival, deadline=deadline)


# ---------------------------------------------------------------------------
# a minimal oracle-backed substrate for isolation tests
# ---------------------------------------------------------------------------

class TinySubstrate(Substrate):
    def __init__(self, machines, oracle):
        self.machines = machines
        self.oracle = oracle
        self.completed = []
        self.dropped = []
        self.begun = 0

    def ingest(self, task, now):
        return task

    def begin_execution(self, task, machine, now):
        self.begun += 1
        return self.oracle.sample(task, machine)

    def finish_execution(self, task, machine, now):
        missed = sum(1 for r in task.all_requests() if now > r.deadline)
        self.completed.extend(task.all_requests())
        return missed

    def on_drop(self, task, now):
        self.dropped.extend(task.all_requests())


def _plane(cfg=None, n_machines=2, oracle_seed=0, **cfg_kw):
    oracle = PETOracle(_pet(), seed=oracle_seed)
    sub = TinySubstrate([Machine(mid=i, mtype="m0", queue_size=3)
                         for i in range(n_machines)], oracle)
    cp = ControlPlane(sub, cfg or ControlConfig(**cfg_kw))
    return cp, sub


class TestControlPlaneLoop:
    def test_event_driven_execution_drains_everything(self):
        cp, sub = _plane(heuristic="FCFS-RR")
        for i in range(6):
            cp.schedule_arrival(float(i),
                                _mk_task(data=f"d{i}", arrival=float(i)))
        cp.run()
        assert len(sub.completed) == 6 and sub.begun == 6
        assert cp.stats["last_completion"] > 0.0
        assert not cp.batch and not cp._events
        # event-driven: bounded by arrivals + finishes (+ the final sweep),
        # not by the span of virtual time
        assert cp.stats["mapping_events"] <= 2 * 6 + 2

    def test_sparse_trace_has_no_idle_polling(self):
        """A trace with a huge idle gap costs O(events), not O(gap)."""
        cp, sub = _plane(heuristic="FCFS-RR")
        cp.schedule_arrival(0.0, _mk_task(data="a", arrival=0.0))
        cp.schedule_arrival(1e9, _mk_task(data="b", arrival=1e9,
                                          deadline=2e9))
        cp.run()
        assert len(sub.completed) == 2
        assert cp.stats["mapping_events"] <= 6
        assert cp.now >= 1e9

    def test_task_level_merge_single_execution(self):
        cp, sub = _plane(merging="conservative", n_machines=1)
        # identical (data, op, params) arriving together: TASK-level merge
        cp.schedule_arrival(0.0, _mk_task())
        cp.schedule_arrival(0.0, _mk_task())
        cp.run()
        assert cp.stats["merges"] == 1
        assert sub.begun == 1
        assert len(sub.completed) == 2   # compound fans out to both

    def test_merge_degree_cap_respected(self):
        cp, sub = _plane(merging="aggressive", merge_degree_cap=3,
                         n_machines=1)
        for _ in range(6):
            cp.schedule_arrival(0.0, _mk_task())
        cp.run()
        # cap 3 -> compounds of at most 3 requests -> 2 executions
        assert sub.begun == 2
        assert cp.stats["merges"] == 4

    def test_hard_deadline_culling_counts_drops(self):
        cp, sub = _plane(hard_deadlines=True, n_machines=1)
        cp.schedule_arrival(5.0, _mk_task(data="dead", arrival=5.0,
                                          deadline=4.0))
        cp.schedule_arrival(5.0, _mk_task(data="live", arrival=5.0,
                                          deadline=1e6))
        cp.run()
        assert [t.data_id for t in sub.dropped] == ["dead"]
        assert len(sub.completed) == 1

    def test_warmup_placeholder_blocks_dispatch(self):
        cp, sub = _plane(n_machines=1)
        m = sub.machines[0]
        cp.note_warmup(m, 50.0)
        cp.schedule_arrival(0.0, _mk_task(arrival=0.0))
        cp.run()
        assert len(sub.completed) == 1
        # execution could only start after the warm-up boundary
        assert cp.stats["last_completion"] > 50.0
        assert m.running is None

    def test_deadlock_drain_surfaces_stranded_tasks(self):
        # a defer-always pruner with no dropping and no deadline purge:
        # nothing ever maps, no events remain -> the control plane must
        # drop the stragglers and record the anomaly instead of stranding
        cfg = ControlConfig(
            heuristic="MSD",
            pruning=PruningConfig(initial_defer_threshold=0.95,
                                  min_defer_threshold=0.95,
                                  max_defer_threshold=0.95,
                                  drop_enabled=False),
            hard_deadlines=False)
        cp, sub = _plane(cfg=cfg, n_machines=1)
        cp.schedule_arrival(0.0, _mk_task(deadline=1.0))   # hopeless task
        cp.run()
        assert cp.stats["deadlock_breaks"] == 1
        assert len(sub.dropped) == 1 and not cp.batch

    def test_merge_rejected_accounting(self):
        # conservative merging with an overloaded single machine: at least
        # one DATA_OP merge attempt must be evaluated and rejected
        cp, sub = _plane(merging="conservative", n_machines=1)
        for i in range(8):
            cp.schedule_arrival(0.0, _mk_task(params=(i,), deadline=25.0))
        cp.run()
        assert cp.stats["merges"] + cp.stats["merge_rejected"] > 0
        assert len(sub.completed) + len(sub.dropped) == 8


# ---------------------------------------------------------------------------
# simulator-side features that rode in with the shared plane
# ---------------------------------------------------------------------------

def _sim_tasks(n, seed=0, deadline=300.0, span=40.0, n_data=4):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = float(rng.uniform(0, span))
        out.append(Task(ttype="generate", data_id=f"d{i % n_data}",
                        op="generate", params=(), arrival=t,
                        deadline=t + deadline, user=f"u{i % 4}"))
    return out


class TestSimulatorNewFeatures:
    def test_result_cache_serves_repeats(self):
        tasks = [_mk_task(data="hot", arrival=float(5 * i), deadline=1e6)
                 for i in range(6)]
        sim = Simulator(tasks, [Machine(mid=0, mtype="m0")],
                        PETOracle(_pet()),
                        SimConfig(result_cache=True), device=CPU)
        st = sim.run()
        assert st.result_cache_hits > 0
        assert st.on_time == st.n_requests == 6

    def test_elastic_pool_scales_up_and_down(self):
        tasks = _sim_tasks(60, span=5.0, deadline=1e6)
        sim = Simulator(tasks, [Machine(mid=0, mtype="m0", queue_size=2)],
                        PETOracle(_pet()),
                        SimConfig(elasticity=ElasticityConfig(
                            max_extra=3, scale_up_queue=6,
                            scale_down_queue=1)), device=CPU)
        st = sim.run()
        assert st.scale_ups > 0
        assert st.on_time + st.missed + st.dropped == 60
        assert len(sim.machines) <= 1 + 3
        assert st.machine_seconds > 0.0
        assert st.extra_machine_seconds > 0.0

    def test_engine_only_alpha_now_configurable(self):
        # the conservative gate at a relaxed alpha merges at least as often
        tight = Simulator(_sim_tasks(80, span=10.0, deadline=40.0),
                          [Machine(mid=0, mtype="m0")], PETOracle(_pet()),
                          SimConfig(merging="conservative", alpha=2.0),
                          device=CPU).run()
        loose = Simulator(_sim_tasks(80, span=10.0, deadline=40.0),
                          [Machine(mid=0, mtype="m0")], PETOracle(_pet()),
                          SimConfig(merging="conservative", alpha=-2.0),
                          device=CPU).run()
        assert loose.merges >= tight.merges
        assert tight.merges + tight.merge_rejected > 0


# ---------------------------------------------------------------------------
# simulator <-> stub-execution engine decision equivalence, held to JAX
# ---------------------------------------------------------------------------

def _runs(cfg_kw, trace_kw, n_units):
    """The port's stub engine, the port's simulator and JAX's simulator on
    the reference's PET draws and trace: three (trace, stats)."""
    eng = PORT.stub_engine(n_units=n_units, **cfg_kw)
    stats = eng.run(PORT.request_trace(**trace_kw))
    sims = [side.simulate(side.request_trace(**trace_kw), fleet=n_units,
                          **cfg_kw) for side in (PORT, JAX)]
    return [(eng.cp.trace, stats)] + [(sim.cp.trace, st) for sim, st in sims]


class TestDecisionEquivalence:
    def test_equivalence_holds_on_drop_heavy_trace(self):
        """QoS parity must survive a trace where pruning actually drops:
        'missed' counts late *executions* on both substrates, 'dropped'
        is its own bucket (an engine/simulator divergence this guards)."""
        cfg_kw = dict(heuristic="MSD", merging="conservative",
                      position_finder=None, pruning=MSD_PRUNING)
        trace_kw = dict(n=40, seed=1, deadline=20.0, rate=2.0)
        (eng_trace, stats), (sim_trace, st), (jax_trace, jst) = \
            _runs(cfg_kw, trace_kw, n_units=1)

        assert stats["dropped"] > 0          # the drop path really ran
        assert sim_trace == eng_trace == jax_trace
        assert (st.on_time, st.missed, st.dropped) == \
            (stats["on_time"], stats["missed"], stats["dropped"]) == \
            (jst.on_time, jst.missed, jst.dropped)

    def test_evicted_running_task_fully_accounted(self):
        """EVICT-mode pruning can kill an *executing* task; its requests
        (already in flight) must still be accounted as dropped and the
        stale completion event discarded."""
        pet = _pet(seed=2, mean_range=(30, 60))
        eng = ServingEngine(None, None, EngineConfig(
            n_units=1, elasticity=None, result_cache=False,
            prefix_cache=False, heuristic="EDF", merging="none",
            pruning=PruningConfig(drop_mode=DropMode.EVICT_DROP,
                                  drop_running=True, lam=1.0, toggle_on=1.0,
                                  base_drop_threshold=0.05)),
            stub_oracle=PETOracle(pet, seed=4), device=CPU)
        n = 8
        trace = [(4.0 * i, Request(prompt=(1, 2, 3, i), op="generate",
                                   n_new=2, deadline=4.0 * i + 10.0))
                 for i in range(n)]
        stats = eng.run(trace)
        assert stats["completed"] + stats["dropped"] == n
        assert not eng._inflight and not eng.requests

    def test_equivalence_trace_is_nontrivial(self):
        """The merging configurations of the equivalence cases must
        actually merge somewhere, otherwise their assertion is vacuous."""
        cfg_kw = dict(heuristic="FCFS-RR", merging="aggressive")
        trace_kw = dict(n=40, seed=1)
        (eng_trace, stats), _, (jax_trace, _) = \
            _runs(cfg_kw, trace_kw, n_units=1)
        assert stats["merges"] > 0
        assert any(e[0] == "merge" for e in eng_trace)
        assert eng_trace == jax_trace
