"""The port's twin of ``tests/test_autoscale.py`` (DESIGN.md §2.7), on
``device="cpu"``, against the JAX package.

Every case of the JAX file runs against the port: the SCALER_POLICIES
registry, the ``queue`` policy against the pre-subsystem inline
hysteresis, simulator against stub engine with success-chance and
cost-aware autoscaling on, the success-chance signal, the cost-aware
gates, machine-seconds accounting and Router plane-count autoscaling.

Where a case yields a decision trace, the port's is also held against
JAX's on the same inputs.  With ``use_kernel=False`` both packages run the
same ``chance_of_success`` and the traces are equal exactly.  With the
kernel on, the port's ``pmf_conv`` keeps the edge term
``pet[0] * pct(dl - pet_off)`` that JAX's ``batched_success`` drops, so
there the port's simulator is held to the port's stub engine, and the
port's kernel path to ``chance_of_success`` within 1e-6.

The last class holds the signal to the device its caller chose, on every
owner of a ``PoolScaler``: the simulator, the Router's plane scaler (each
plane scored on its own substrate's device) and the flight-record replay;
with no device it is CUDA, which raises on a host without a card.
"""

import types

import numpy as np
import pytest
import torch

from repro.core.fleet import FleetSpec as JaxFleetSpec
from repro.core.simulation import PETOracle as JaxPETOracle
from repro.core.simulation import SimConfig as JaxSimConfig
from repro.core.simulation import Simulator as JaxSimulator
from repro.core.tasks import Machine as JaxMachine
from repro.core.tasks import PETMatrix as JaxPETMatrix
from repro.core.tasks import Task as JaxTask
from repro.obs.replay import decision_sequence as jax_decision_sequence
from repro.obs.replay import replay_record as jax_replay_record
from repro.serving.autoscale import SCALER_POLICIES as JAX_SCALER_POLICIES
from repro.serving.autoscale import ElasticityConfig as JaxElasticityConfig
from repro.serving.autoscale import batch_chances as jax_batch_chances
from repro.serving.autoscale.policies import \
    CostAwareScaler as JaxCostAwareScaler
from repro.serving.autoscale.signals import ScaleSignals as JaxScaleSignals
from repro.serving.cluster import Router as JaxRouter
from repro.serving.cluster import \
    make_engine_plane_factory as jax_engine_plane_factory
from repro.serving.cluster import make_engine_planes as jax_engine_planes
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.core.fleet import FleetSpec
from repro_torch.core.simulation import PETOracle, SimConfig, Simulator
from repro_torch.core.tasks import Machine, PETMatrix, Task
from repro_torch.obs import FlightRecorder
from repro_torch.obs.replay import decision_sequence, replay_record
from repro_torch.serving import cluster as cluster_mod
from repro_torch.serving.autoscale import (SCALER_POLICIES, ElasticityConfig,
                                           ScaleSignals, batch_chances,
                                           make_scaler_policy)
from repro_torch.serving.autoscale.policies import CostAwareScaler
from repro_torch.serving.cluster import (Router, make_engine_plane_factory,
                                         make_engine_planes)
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

CPU = "cpu"

#: each package's classes, so one helper builds either side's run
JAX = types.SimpleNamespace(
    PETMatrix=JaxPETMatrix, PETOracle=JaxPETOracle, Task=JaxTask,
    Machine=JaxMachine,
    Simulator=JaxSimulator, SimConfig=JaxSimConfig, FleetSpec=JaxFleetSpec,
    ElasticityConfig=JaxElasticityConfig, EngineConfig=JaxEngineConfig,
    Request=JaxRequest, ServingEngine=JaxServingEngine, Router=JaxRouter,
    planes=jax_engine_planes, factory=jax_engine_plane_factory, dev={})
PORT = types.SimpleNamespace(
    PETMatrix=PETMatrix, PETOracle=PETOracle, Task=Task, Machine=Machine,
    Simulator=Simulator, SimConfig=SimConfig, FleetSpec=FleetSpec,
    ElasticityConfig=ElasticityConfig, EngineConfig=EngineConfig,
    Request=Request, ServingEngine=ServingEngine, Router=Router,
    planes=make_engine_planes, factory=make_engine_plane_factory,
    dev={"device": CPU})


def _pet(seed=0, mean_range=(10, 20), pkg=PORT):
    rng = np.random.default_rng(seed)
    return pkg.PETMatrix.generate(["generate"], ["m0"], rng,
                                  mean_range=mean_range)


def _sim_tasks(n, seed=0, deadline=300.0, span=40.0, pkg=PORT):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = float(rng.uniform(0, span))
        out.append(pkg.Task(ttype="generate", data_id=f"d{i}", op="generate",
                            params=(), arrival=t, deadline=t + deadline,
                            user=f"u{i % 4}"))
    return out


def _request_trace(n=40, seed=0, deadline=80.0, rate=0.5, pkg=PORT):
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for i in range(n):
        out.append((t, pkg.Request(
            prompt=tuple(rng.integers(1, 1000, size=8).tolist()),
            op="generate", n_new=int(rng.integers(1, 4)),
            deadline=t + deadline)))
        t += float(rng.exponential(1.0 / rate))
    return out


def _mirror_tasks(trace):
    return [r.to_task(t, i) for i, (t, r) in enumerate(trace)]


def _sim_counts(st):
    return (st.scale_ups, st.scale_downs, st.scale_decisions, st.on_time,
            st.missed, st.dropped, st.machine_seconds,
            st.extra_machine_seconds)


def _engine_counts(stats):
    return tuple(stats[k] for k in (
        "scale_ups", "scale_downs", "scale_decisions", "on_time", "missed",
        "dropped", "machine_seconds", "extra_machine_seconds"))


def _traced(sub, run):
    """Run a substrate with its control-plane trace on; (trace, result)."""
    sub.cp.trace = []
    out = run()
    return sub.cp.trace, out


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class TestRegistry:
    def test_all_policies_registered(self):
        assert {"queue", "success-chance", "cost-aware"} <= \
            set(SCALER_POLICIES)
        assert set(SCALER_POLICIES) == set(JAX_SCALER_POLICIES)

    def test_unknown_policy_raises(self):
        with pytest.raises(KeyError, match="unknown scaler policy"):
            make_scaler_policy("nope", ElasticityConfig())

    def test_case_insensitive_like_heuristics(self):
        p = make_scaler_policy("QUEUE", ElasticityConfig())
        assert p.name == "queue"

    def test_bad_policy_surfaces_at_construction(self):
        with pytest.raises(KeyError):
            Simulator(_sim_tasks(2), [Machine(mid=0, mtype="m0")],
                      PETOracle(_pet()),
                      SimConfig(elasticity=ElasticityConfig(
                          policy="typo", max_extra=1)), device=CPU)


# ---------------------------------------------------------------------------
# queue policy == pre-subsystem inline hysteresis (decision traces)
# ---------------------------------------------------------------------------

class _LegacySim(Simulator):
    """Verbatim replica of the pre-subsystem Simulator.before_mapping."""

    LEGACY = dict(elastic_pool=3, scale_up_queue=6, scale_down_queue=1)

    def before_mapping(self, now):
        qlen = len(self.cp.batch)
        if (qlen >= self.LEGACY["scale_up_queue"]
                and len(self.machines)
                < self._base_pool + self.LEGACY["elastic_pool"]):
            proto = self.machines[0]
            self._extra_mid += 1
            self.machines.append(Machine(
                mid=self._extra_mid, mtype=proto.mtype, speed=proto.speed,
                queue_size=proto.queue_size, cost_rate=proto.cost_rate,
                power=proto.power))
            self.stats.scale_ups += 1
        elif (qlen <= self.LEGACY["scale_down_queue"]
              and len(self.machines) > self._base_pool):
            for i in range(len(self.machines) - 1, self._base_pool - 1, -1):
                m = self.machines[i]
                if m.running is None and not m.queue and m.busy_until <= now:
                    self.machines.pop(i)
                    self.stats.scale_downs += 1
                    break


class _LegacyEngine(ServingEngine):
    """Verbatim replica of the pre-subsystem engine before_mapping (queue
    hysteresis + 100-tick cooldown + count floor)."""

    LEGACY = dict(max_units=3, scale_up_queue=6, scale_down_queue=1)

    def before_mapping(self, now):
        if now < getattr(self, "_legacy_cooldown", 0.0):
            return
        qlen = len(self.batch)
        if qlen >= self.LEGACY["scale_up_queue"] and \
                len(self.units) < self.LEGACY["max_units"]:
            self._add_unit()
            self.stats["scale_ups"] += 1
            self._legacy_cooldown = now + 100.0
        elif qlen <= self.LEGACY["scale_down_queue"] and \
                len(self.units) > self.cfg.n_units:
            for i in range(len(self.units) - 1, -1, -1):
                m = self.units[i].machine
                if not m.queue and m.running is None and m.busy_until <= now:
                    self.units.pop(i)
                    self.stats["scale_downs"] += 1
                    self._legacy_cooldown = now + 100.0
                    break


def _queue_sim(pkg):
    return pkg.Simulator(
        _sim_tasks(60, seed=1, span=5.0, deadline=1e6, pkg=pkg),
        [pkg.Machine(mid=0, mtype="m0", queue_size=2)],
        pkg.PETOracle(_pet(seed=2, pkg=pkg), seed=3),
        pkg.SimConfig(heuristic="FCFS-RR", merging="none",
                      elasticity=pkg.ElasticityConfig(
                          policy="queue", max_extra=3, scale_up_queue=6,
                          scale_down_queue=1)), **pkg.dev)


class TestQueuePolicyLegacyEquivalence:
    def test_simulator_trace_identical_to_legacy_inline(self):
        pet = _pet(seed=2)
        kw = dict(heuristic="FCFS-RR", merging="none")
        tasks = _sim_tasks(60, seed=1, span=5.0, deadline=1e6)

        legacy = _LegacySim(
            [Task(**{f.name: getattr(t, f.name)
                     for f in t.__dataclass_fields__.values()
                     if f.name in ("ttype", "data_id", "op", "params",
                                   "arrival", "deadline", "user")})
             for t in tasks],
            [Machine(mid=0, mtype="m0", queue_size=2)],
            PETOracle(pet, seed=3), SimConfig(**kw), device=CPU)
        legacy.cp.trace = []
        lst = legacy.run()

        new = _queue_sim(PORT)
        new.cp.trace = []
        nst = new.run()

        assert lst.scale_ups > 0 and lst.scale_downs > 0  # non-vacuous
        assert new.cp.trace == legacy.cp.trace
        assert (nst.scale_ups, nst.scale_downs) == \
            (lst.scale_ups, lst.scale_downs)
        assert (nst.on_time, nst.missed, nst.dropped) == \
            (lst.on_time, lst.missed, lst.dropped)
        # the JAX simulator on the same draws takes the same decisions
        jax_sim = _queue_sim(JAX)
        trace, jst = _traced(jax_sim, jax_sim.run)
        assert new.cp.trace == trace
        assert _sim_counts(nst) == _sim_counts(jst)

    def test_engine_trace_identical_to_legacy_inline(self):
        pet = _pet(seed=2)
        trace = _request_trace(n=50, seed=4, deadline=200.0, rate=1.5)
        kw = dict(heuristic="EDF", merging="none", result_cache=False,
                  prefix_cache=False, n_units=1)

        legacy = _LegacyEngine(None, None, EngineConfig(elasticity=None, **kw),
                               stub_oracle=PETOracle(pet, seed=9), device=CPU)
        legacy.cp.trace = []
        lst = legacy.run(trace)

        def queue_engine(pkg):
            return pkg.ServingEngine(None, None, pkg.EngineConfig(
                elasticity=pkg.ElasticityConfig(
                    policy="queue", max_extra=2, scale_up_queue=6,
                    scale_down_queue=1, cooldown=100.0), **kw),
                stub_oracle=pkg.PETOracle(_pet(seed=2, pkg=pkg), seed=9),
                **pkg.dev)

        new = queue_engine(PORT)
        new.cp.trace = []
        nst = new.run(trace)

        assert lst["scale_ups"] > 0                        # non-vacuous
        assert new.cp.trace == legacy.cp.trace
        assert (nst["scale_ups"], nst["scale_downs"]) == \
            (lst["scale_ups"], lst["scale_downs"])
        assert (nst["on_time"], nst["missed"], nst["dropped"]) == \
            (lst["on_time"], lst["missed"], lst["dropped"])
        jax_eng = queue_engine(JAX)
        jtrace, jst = _traced(jax_eng, lambda: jax_eng.run(_request_trace(
            n=50, seed=4, deadline=200.0, rate=1.5, pkg=JAX)))
        assert new.cp.trace == jtrace
        assert _engine_counts(nst) == _engine_counts(jst)

    def test_disabled_matches_fixed_pool(self):
        """elasticity=None and max_extra=0 both mean: no scaler, identical
        decisions to a fixed pool — and the JAX engine's."""
        traces = []
        for pkg in (PORT, JAX):
            for elasticity in (None, pkg.ElasticityConfig(max_extra=0)):
                eng = pkg.ServingEngine(None, None, pkg.EngineConfig(
                    n_units=2, heuristic="EDF", merging="none",
                    result_cache=False, prefix_cache=False,
                    elasticity=elasticity),
                    stub_oracle=pkg.PETOracle(_pet(seed=5, pkg=pkg), seed=1),
                    **pkg.dev)
                assert eng.scaler is None
                eng.cp.trace = []
                eng.run(_request_trace(n=30, seed=2, pkg=pkg))
                traces.append(eng.cp.trace)
        assert traces[0] == traces[1] == traces[2] == traces[3]


# ---------------------------------------------------------------------------
# cross-substrate equivalence with autoscaling ON
# ---------------------------------------------------------------------------

def _cross_substrate(pkg, policy, use_kernel=True):
    """The stub engine and the simulator on the same trace and fleet:
    ((engine trace, engine stats), (simulator trace, simulator stats))."""
    pet = _pet(seed=3, mean_range=(8, 16), pkg=pkg)
    trace = _request_trace(n=40, seed=1, deadline=60.0, rate=1.0, pkg=pkg)
    el = pkg.ElasticityConfig(policy=policy, max_extra=2, scale_up_queue=6,
                              scale_down_queue=1, low_chance=0.6,
                              use_kernel=use_kernel)
    eng = pkg.ServingEngine(None, None, pkg.EngineConfig(
        n_units=1, heuristic="EDF", merging="none", result_cache=False,
        prefix_cache=False, elasticity=el),
        stub_oracle=pkg.PETOracle(pet, seed=11), **pkg.dev)
    sim = pkg.Simulator(
        _mirror_tasks(trace),
        pkg.FleetSpec.homogeneous(1),   # the stub engine's machines exactly
        pkg.PETOracle(pet, seed=11),
        pkg.SimConfig(heuristic="EDF", merging="none", elasticity=el),
        **pkg.dev)
    return (_traced(eng, lambda: eng.run(trace)), _traced(sim, sim.run))


class TestCrossSubstrateEquivalence:
    # as in the JAX file, the legacy ``queue`` hysteresis is not here: its
    # engine and simulator shrink semantics differ by design (see
    # TestQueuePolicyLegacyEquivalence)
    @pytest.mark.parametrize("policy", ["success-chance", "cost-aware"])
    def test_sim_and_stub_engine_scale_identically(self, policy):
        """The port's simulator on ``device="cpu"`` takes its stub engine's
        decisions through the kernel path (``pmf_conv``'s plain version):
        2 scale-ups, 2 scale-downs, 31 on time, 288.0 machine-seconds."""
        (etrace, stats), (strace, st) = _cross_substrate(PORT, policy)

        assert stats["scale_ups"] > 0                      # non-vacuous
        assert strace == etrace
        assert (st.scale_ups, st.scale_downs) == \
            (stats["scale_ups"], stats["scale_downs"])
        assert (st.on_time, st.missed, st.dropped) == \
            (stats["on_time"], stats["missed"], stats["dropped"])
        assert st.machine_seconds == pytest.approx(stats["machine_seconds"])
        assert (st.scale_ups, st.scale_downs, st.on_time,
                st.machine_seconds) == (2, 2, 31, 288.0)

    @pytest.mark.parametrize("policy", ["success-chance", "cost-aware"])
    def test_port_and_jax_scale_identically_without_the_kernel(self, policy):
        """With ``use_kernel=False`` both packages score through the same
        ``chance_of_success``: all four traces are one, exactly."""
        (pe, pes), (ps, pss) = _cross_substrate(PORT, policy, False)
        (je, jes), (js, jss) = _cross_substrate(JAX, policy, False)
        assert pss.scale_ups > 0 and pss.scale_downs > 0   # non-vacuous
        assert ps == pe == js == je
        assert _sim_counts(pss) == _sim_counts(jss)
        assert _engine_counts(pes) == _engine_counts(jes)


# ---------------------------------------------------------------------------
# the success-chance signal
# ---------------------------------------------------------------------------

def _signal_batch(pkg=PORT):
    return [pkg.Task(ttype="generate", data_id=f"d{i}", op="generate",
                     arrival=0.0, deadline=30.0 + 15.0 * i)
            for i in range(6)]


class TestSignals:
    def test_kernel_and_numpy_paths_agree(self):
        """The port's kernel path keeps the edge term, so it stands for
        ``chance_of_success`` within 1e-6 (JAX's bar is 1e-5); the NumPy
        paths of both packages are equal exactly."""
        pet = _pet(seed=7)
        oracle = PETOracle(pet, seed=0)
        machines = [Machine(mid=0, mtype="m0", queue_size=4)]
        batch = _signal_batch()
        kernel = batch_chances(batch, machines, oracle, 0.0, use_kernel=True,
                               device=CPU)
        numpy_ = batch_chances(batch, machines, oracle, 0.0, use_kernel=False)
        assert kernel.shape == numpy_.shape == (6,)
        np.testing.assert_allclose(kernel, numpy_, atol=1e-6, rtol=0)
        jax_numpy = jax_batch_chances(
            _signal_batch(JAX), machines, JaxPETOracle(_pet(seed=7, pkg=JAX),
                                                       seed=0),
            0.0, use_kernel=False)
        np.testing.assert_array_equal(numpy_, jax_numpy)

    def test_depth_alone_does_not_degrade_loose_deadlines(self):
        """A deep queue of slack-deadline work keeps a high aggregate
        chance; the same queue with tight deadlines collapses it — the
        separation queue-depth scaling cannot express."""
        pet = _pet(seed=7)
        oracle = PETOracle(pet, seed=0)
        machines = [Machine(mid=0, mtype="m0", queue_size=4)]
        loose = [Task(ttype="generate", data_id=f"l{i}", op="generate",
                      arrival=0.0, deadline=5000.0) for i in range(12)]
        tight = [Task(ttype="generate", data_id=f"t{i}", op="generate",
                      arrival=0.0, deadline=25.0) for i in range(12)]
        c_loose = batch_chances(loose, machines, oracle, 0.0,
                                device=CPU).mean()
        c_tight = batch_chances(tight, machines, oracle, 0.0,
                                device=CPU).mean()
        assert c_loose > 0.95
        assert c_tight < 0.4

    def test_infinite_deadlines_score_one(self):
        oracle = PETOracle(_pet(), seed=0)
        machines = [Machine(mid=0, mtype="m0")]
        batch = [Task(ttype="generate", data_id="x", op="generate")]
        assert batch_chances(batch, machines, oracle, 0.0,
                             device=CPU).tolist() == [1.0]

    def test_empty_batch_signal(self):
        sig = ScaleSignals(0.0, 0)
        assert sig.chance() == 1.0
        assert sig.at_risk(0.5) == 0

    def test_signal_caps_scored_tasks(self):
        oracle = PETOracle(_pet(), seed=0)
        machines = [Machine(mid=0, mtype="m0")]
        batch = [Task(ttype="generate", data_id=f"d{i}", op="generate",
                      deadline=100.0) for i in range(40)]
        out = batch_chances(batch, machines, oracle, 0.0, signal_tasks=8,
                            device=CPU)
        assert out.shape == (8,)


# ---------------------------------------------------------------------------
# cost-aware gates
# ---------------------------------------------------------------------------

class TestCostAware:
    @staticmethod
    def _sig(qlen, at_risk, extra_ms, signals=ScaleSignals):
        chances = np.concatenate([np.zeros(at_risk),
                                  np.ones(max(qlen - at_risk, 0))])
        return signals(0.0, qlen, chances_fn=lambda: chances,
                       extra_machine_seconds=extra_ms)

    def _both(self, cfg_kw, sigs):
        """Each package's ``CostAwareScaler`` over the same signals: the
        port's decisions, held equal to JAX's."""
        ours = CostAwareScaler(ElasticityConfig(**cfg_kw))
        theirs = JaxCostAwareScaler(JaxElasticityConfig(**cfg_kw))
        got = [ours.decide(self._sig(*s)) for s in sigs]
        assert got == [theirs.decide(self._sig(*s, signals=JaxScaleSignals))
                       for s in sigs]
        return got

    def test_budget_gates_scale_up(self):
        got = self._both(dict(policy="cost-aware",
                              budget_machine_seconds=100.0,
                              pressure_lam=1.0, pressure_on=1.0),
                         [(8, 8, 0.0), (8, 8, 100.0)])
        assert got == [1, -1]                   # in budget, then burned

    def test_zero_budget_never_scales_up(self):
        got = self._both(dict(policy="cost-aware", budget_machine_seconds=0.0,
                              pressure_lam=1.0, pressure_on=1.0),
                         [(10, 10, 0.0)] * 5)
        assert all(d == -1 for d in got)

    def test_schmitt_trigger_does_not_chatter(self):
        """At-risk counts oscillating across the on-level (above the 20%-
        separated off-level) must hold one engaged stretch, not flap."""
        decisions = self._both(
            dict(policy="cost-aware", pressure_lam=0.5, pressure_on=2.0,
                 scale_down_queue=0),
            [(6, r, 0.0) for r in (3, 3, 1, 3, 1, 3, 1)])
        # engages on the second observation and never releases mid-noise
        assert decisions[0] == 0
        assert all(d == 1 for d in decisions[1:])

    def test_budget_respected_end_to_end(self):
        def run(pkg, use_kernel):
            eng = pkg.ServingEngine(None, None, pkg.EngineConfig(
                n_units=1, heuristic="EDF", merging="none",
                result_cache=False, prefix_cache=False,
                elasticity=pkg.ElasticityConfig(
                    policy="cost-aware", max_extra=3,
                    budget_machine_seconds=150.0, low_chance=0.6,
                    use_kernel=use_kernel)),
                stub_oracle=pkg.PETOracle(
                    _pet(seed=3, mean_range=(8, 16), pkg=pkg), seed=11),
                **pkg.dev)
            return _traced(eng, lambda: eng.run(_request_trace(
                n=60, seed=1, deadline=40.0, rate=2.0, pkg=pkg)))

        _, stats = run(PORT, True)
        assert stats["scale_ups"] > 0
        # one in-flight extra can overshoot by at most its own residency
        # since the last decision; the budget is enforced at decisions
        assert stats["extra_machine_seconds"] <= 150.0 + 3 * 60.0
        (ours, ostats), (theirs, tstats) = run(PORT, False), run(JAX, False)
        assert ostats["scale_ups"] > 0 and ours == theirs
        assert _engine_counts(ostats) == _engine_counts(tstats)


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

class TestAccounting:
    @staticmethod
    def _never_triggered(pkg):
        return pkg.Simulator(
            _sim_tasks(20, seed=2, deadline=1e6, pkg=pkg),
            [pkg.Machine(mid=0, mtype="m0"), pkg.Machine(mid=1, mtype="m0")],
            pkg.PETOracle(_pet(seed=5, pkg=pkg), seed=1),
            pkg.SimConfig(elasticity=pkg.ElasticityConfig(
                policy="queue", max_extra=2, scale_up_queue=10 ** 9,
                scale_down_queue=-1)), **pkg.dev)

    def test_machine_seconds_is_pool_integral(self):
        """With scaling enabled but never triggered, machine-seconds must
        equal base_pool x makespan exactly."""
        sim = self._never_triggered(PORT)
        st = sim.run()
        assert st.scale_ups == 0 and st.scale_downs == 0
        assert st.machine_seconds == pytest.approx(2.0 * st.makespan)
        assert st.extra_machine_seconds == 0.0
        jst = self._never_triggered(JAX).run()
        assert _sim_counts(st) == _sim_counts(jst)
        assert st.makespan == jst.makespan

    def test_fixed_pool_still_reports_machine_seconds(self):
        """Scaling disabled is not zero cost: the integral degenerates to
        pool x makespan (consumers need no special case)."""
        pet = _pet(seed=5)
        sim = Simulator(_sim_tasks(10, seed=2, deadline=1e6),
                        [Machine(mid=0, mtype="m0")],
                        PETOracle(pet, seed=1), SimConfig())
        st = sim.run()
        assert st.machine_seconds == pytest.approx(st.makespan)
        eng = ServingEngine(None, None, EngineConfig(
            n_units=2, elasticity=None, heuristic="EDF", merging="none",
            result_cache=False, prefix_cache=False),
            stub_oracle=PETOracle(pet, seed=1), device=CPU)
        stats = eng.run(_request_trace(n=8, seed=0))
        assert stats["machine_seconds"] == \
            pytest.approx(2.0 * eng.cp.stats["last_completion"])

    def test_scaled_run_accounts_extras(self):
        sim = Simulator(
            _sim_tasks(60, seed=1, span=5.0, deadline=1e6),
            [Machine(mid=0, mtype="m0", queue_size=2)],
            PETOracle(_pet(seed=5), seed=3),
            SimConfig(elasticity=ElasticityConfig(
                policy="queue", max_extra=3, scale_up_queue=6,
                scale_down_queue=1)), device=CPU)
        st = sim.run()
        assert st.scale_ups > 0
        assert 0.0 < st.extra_machine_seconds < st.machine_seconds
        assert st.machine_seconds > st.makespan          # >1 unit at times
        assert st.scale_decisions > 0


# ---------------------------------------------------------------------------
# Router plane-count autoscaling
# ---------------------------------------------------------------------------

def _stub_plane_router(pet=None, policy="success-chance", max_extra=3,
                       cooldown=30.0, pkg=PORT, device=CPU, **el_kw):
    pet = _pet(seed=3, pkg=pkg) if pet is None else pet
    dev = {} if pkg is JAX else {"device": device}
    ecfg = pkg.EngineConfig(n_units=1, elasticity=None, result_cache=False,
                            prefix_cache=False, heuristic="EDF",
                            merging="none")
    planes = pkg.planes(None, None, ecfg, 1,
                        stub_oracles=[pkg.PETOracle(pet, seed=11)], **dev)
    factory = pkg.factory(
        None, None, ecfg,
        stub_oracle_fn=lambda pid: pkg.PETOracle(pet, seed=11 + pid), **dev)
    return pkg.Router(planes, policy="least-loaded",
                      autoscale=pkg.ElasticityConfig(policy=policy,
                                                     max_extra=max_extra,
                                                     cooldown=cooldown,
                                                     **el_kw),
                      plane_factory=factory)


def _overload(router, n=80, pkg=PORT):
    """The JAX file's sustained overload: n requests, mean gap 4 ticks."""
    t, rng = 0.0, np.random.default_rng(9)
    for i in range(n):
        router.submit(pkg.Request(prompt=(i, 2, 3), op="generate", n_new=2,
                                  deadline=t + 80.0), t)
        t += float(rng.exponential(4.0))


class TestPlaneAutoscale:
    def test_requires_factory(self):
        with pytest.raises(ValueError, match="plane_factory"):
            Router([Simulator([], [Machine(mid=0, mtype="m0")],
                              PETOracle(_pet()), device=CPU)],
                   autoscale=ElasticityConfig(max_extra=1))

    def test_sustained_overload_adds_and_retires_planes(self):
        router = _stub_plane_router(low_chance=0.5)
        assert router.plane_scaler.device == torch.device(CPU)
        _overload(router)
        stats = router.drain()
        auto = stats["router"]["autoscale"]
        assert auto["plane_scale_ups"] > 0
        assert auto["plane_scale_downs"] > 0
        assert len(router.retired) == auto["plane_scale_downs"]
        # retired planes' work still aggregates: nothing vanishes
        assert stats["n_requests"] == 80
        assert stats["on_time"] + stats["missed"] + stats["dropped"] == 80
        assert sum(stats["router"]["routed"].values()) == 80
        assert len(stats["router"]["routed"]) == \
            1 + auto["plane_scale_ups"]
        assert auto["plane_seconds"] > 0.0

    def test_base_planes_never_retired(self):
        def run(pkg):
            router = _stub_plane_router(policy="queue", max_extra=2,
                                        scale_up_queue=4,
                                        scale_down_queue=10 ** 6, pkg=pkg)
            # scale_down_queue huge: the policy always votes -1 when idle,
            # so shrink pressure is constant — yet base planes must survive
            for i in range(30):
                router.submit(pkg.Request(prompt=(i,), op="generate",
                                          n_new=1, deadline=1e9), i * 50.0)
            return router, router.drain()

        router, stats = run(PORT)
        assert {p.pid for p in router.planes} >= {0}
        assert all(p.pid != 0 for p in router.retired)
        jrouter, jstats = run(JAX)
        assert router.decisions == jrouter.decisions
        assert stats["router"]["autoscale"] == jstats["router"]["autoscale"]

    def test_new_planes_visible_to_routing_and_lookup(self):
        router = _stub_plane_router(low_chance=0.5)
        _overload(router, n=60)
        assert len(router.planes) > 1                 # grew mid-stream
        # the shared view tracks the live plane list object
        assert router.shared.planes is router.planes
        routed_new = sum(n for pid, n in router.stats["routed"].items()
                         if pid not in router._base_pids)
        assert routed_new > 0
        router.drain()

    def test_port_and_jax_planes_identical_without_the_kernel(self):
        """The overload with ``use_kernel=False`` on both packages: the
        same routing decisions and the same plane accounting, exactly."""
        runs = []
        for pkg in (PORT, JAX):
            router = _stub_plane_router(low_chance=0.5, use_kernel=False,
                                        pet=_pet(seed=3, pkg=pkg), pkg=pkg)
            _overload(router, pkg=pkg)
            runs.append((router.decisions,
                         router.drain()["router"]["autoscale"]))
        (ours, oauto), (theirs, tauto) = runs
        assert oauto["plane_scale_ups"] > 0 and oauto["plane_scale_downs"] > 0
        assert ours == theirs and oauto == tauto


# ---------------------------------------------------------------------------
# the signal on the caller's device, on every owner of a PoolScaler
# ---------------------------------------------------------------------------

def _record(n=30):
    """A stub engine's flight record (no elasticity), as the launcher's
    ``--record-out`` writes one."""
    rec = FlightRecorder(capacity=1 << 14)
    trace = _request_trace(n=n, seed=1, deadline=60.0, rate=1.0)
    for t, item in trace:
        rec.note_arrival(t, item)
    eng = ServingEngine(None, None, EngineConfig(
        n_units=1, heuristic="EDF", merging="none", result_cache=False,
        prefix_cache=False, elasticity=None),
        stub_oracle=PETOracle(_pet(seed=3, mean_range=(8, 16)), seed=11),
        device=CPU)
    eng.attach_telemetry(rec)
    stats = eng.run(trace)
    rec.note_machines(eng.machines)
    rec.note_engine_config(eng.cfg)
    rec.note_stats(stats)
    return rec.to_artifact()


def _no_device_owner(owner: str):
    """A success-chance owner built with no device: a simulator, or a
    Router whose planes (simulators) carry none."""
    pet = _pet(seed=3, mean_range=(8, 16))
    el = ElasticityConfig(policy="success-chance", max_extra=2,
                          low_chance=0.6)
    if owner == "simulator":
        sim = Simulator(_mirror_tasks(_request_trace(
            n=40, seed=1, deadline=60.0, rate=1.0)),
            FleetSpec.homogeneous(1), PETOracle(pet, seed=11),
            SimConfig(heuristic="EDF", merging="none", elasticity=el))
        assert sim.device is None and sim.scaler.device is None
        return sim.run

    def plane(pid):
        return Simulator([], FleetSpec.homogeneous(1),
                         PETOracle(pet, seed=11 + pid),
                         SimConfig(heuristic="EDF", merging="none"))
    router = Router([plane(0)], autoscale=el, plane_factory=plane)
    assert router.plane_scaler.device is None
    return lambda: _overload(router)


class TestSignalDevice:
    def test_simulator_runs_on_the_callers_device(self):
        """``Simulator(..., device="cpu")`` hands the device to its scaler,
        which scores every decision on the host."""
        (_, stats), (_, st) = _cross_substrate(PORT, "success-chance")
        assert st.scale_decisions == stats["scale_decisions"] > 0
        sim = Simulator([], FleetSpec.homogeneous(1), PETOracle(_pet()),
                        SimConfig(elasticity=ElasticityConfig(
                            policy="success-chance", max_extra=1)),
                        device=CPU)
        assert sim.device == sim.scaler.device == torch.device(CPU)

    def test_router_scores_each_plane_on_its_own_device(self, monkeypatch):
        """A Router over an engine plane and a simulator plane: each plane's
        queue is scored on its substrate's device, and the plane scaler
        reports plane 0's."""
        seen = []

        def spy(batch, machines, oracle, now, **kw):
            seen.append((id(oracle), kw["device"]))
            return batch_chances(batch, machines, oracle, now, **kw)

        monkeypatch.setattr(cluster_mod, "batch_chances", spy)
        pet = _pet(seed=3)
        ecfg = EngineConfig(n_units=1, elasticity=None, result_cache=False,
                            prefix_cache=False, heuristic="EDF",
                            merging="none")
        eng = ServingEngine(None, None, ecfg,
                            stub_oracle=PETOracle(pet, seed=11), device=CPU)
        sim = Simulator([], FleetSpec.homogeneous(1), PETOracle(pet, seed=12),
                        SimConfig(heuristic="EDF", merging="none"),
                        device=CPU)
        router = Router([eng, sim], policy="least-loaded",
                        autoscale=ElasticityConfig(
                            policy="success-chance", max_extra=2,
                            cooldown=30.0, low_chance=0.5),
                        plane_factory=make_engine_plane_factory(
                            None, None, ecfg, device=CPU,
                            stub_oracle_fn=lambda pid: PETOracle(
                                pet, seed=11 + pid)))
        assert router.plane_scaler.device == eng.device
        _overload(router)
        router.drain()
        by_plane = {id(p.sub.oracle): p.sub.device
                    for p in router.planes + router.retired}
        assert {o for o, _ in seen} >= {id(eng.oracle), id(sim.oracle)}
        assert all(dev == by_plane[o] == torch.device(CPU)
                   for o, dev in seen)

    def test_cpu_router_adds_and_retires_planes(self):
        """A stub-plane Router on ``"cpu"`` with plane autoscaling scores
        its planes on the host and grows and shrinks."""
        router = _stub_plane_router(low_chance=0.5, device=CPU)
        _overload(router)
        auto = router.drain()["router"]["autoscale"]
        assert auto["plane_scale_ups"] > 0 and auto["plane_scale_downs"] > 0
        assert all(p.sub.device == torch.device(CPU)
                   for p in router.planes + router.retired)

    def test_replay_runs_on_the_callers_device(self):
        """``replay_record(..., device="cpu", elasticity=...)`` replays under
        a success-chance scaler on the host; without the kernel its
        decisions are the JAX replay's."""
        record = _record()
        plain, _ = replay_record(record, oracle=PETOracle(
            _pet(seed=3, mean_range=(8, 16)), seed=11))
        assert plain.scaler is None           # the record's own default
        el_kw = dict(policy="success-chance", max_extra=2, low_chance=0.6,
                     scale_up_queue=6, scale_down_queue=1)
        oracle = PETOracle(_pet(seed=3, mean_range=(8, 16)), seed=11)
        sim, tel = replay_record(record, oracle=oracle, device=CPU,
                                 elasticity=ElasticityConfig(**el_kw))
        assert sim.scaler.device == torch.device(CPU)
        assert sim.stats.scale_decisions > 0 and sim.stats.scale_ups > 0
        ours = replay_record(record, oracle=PETOracle(
            _pet(seed=3, mean_range=(8, 16)), seed=11), device=CPU,
            elasticity=ElasticityConfig(use_kernel=False, **el_kw))
        theirs = jax_replay_record(record, oracle=JaxPETOracle(
            _pet(seed=3, mean_range=(8, 16), pkg=JAX), seed=11),
            elasticity=JaxElasticityConfig(use_kernel=False, **el_kw))
        assert _sim_counts(ours[0].stats) == _sim_counts(theirs[0].stats)
        assert decision_sequence(ours[1].events) == \
            jax_decision_sequence(theirs[1].events)

    @pytest.mark.parametrize("owner", ["simulator", "router"])
    def test_no_device_means_cuda(self, owner):
        """With no device the signal goes to CUDA: on a host without a card
        the first scored decision raises, and nothing falls back to the
        host."""
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device exists")
        run = _no_device_owner(owner)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
