"""The port's twin of ``tests/test_fleet.py`` (DESIGN.md §2.8), on
``device="cpu"``, against the JAX package:

* the FleetSpec catalog: parse/serialize roundtrip, validation, expansion,
  machine construction;
* homogeneous-fleet regression — an engine/simulator built from
  ``FleetSpec.homogeneous(n)`` takes decision traces identical to the
  legacy ``n_units``/explicit-machine construction;
* hetero sim <-> stub-engine decision + cost equivalence from one shared
  FleetSpec (same PET keys by construction);
* per-unit backend dispatch (``backend=stub`` rows with no model);
* the cost-aware mapping heuristics (MEC, MCMD);
* cheapest-first scale-up / priciest-first retirement by the port's
  ``_EngineUnitPool`` and the per-mtype cost integrals (pool_cost, plane
  billing);
* per-machine KV caches in the simulator (hit attribution + the per-unit
  ``MappingContext.prefix_overlap`` discrimination);
* the Eq. 4.3 OSL pressure signal as an ElasticityConfig-selectable
  alternative to the chance convolution.

Every engine and simulator runs on ``device="cpu"``.  The cases of
``TestHomogeneousRegression``, ``TestHeteroEquivalence`` and
``test_end_to_end_scaling_on_both_substrates`` also run JAX's
``repro.core.simulation.Simulator`` on the same tasks, fleet, oracle and
seed and hold the port's ``ControlPlane.trace`` to it exactly.
"""

import numpy as np
import pytest

from repro_torch.core.fleet import DEFAULT_MTYPE, FleetSpec, MachineSpec
from repro_torch.core.heuristics import (HEURISTICS, MappingContext,
                                         make_heuristic)
from repro_torch.core.simulation import PETOracle, SimConfig, Simulator
from repro_torch.core.tasks import Machine, Task
from repro_torch.serving.autoscale import ElasticityConfig, ScaleSignals
from repro_torch.serving.autoscale.policies import (CostAwareScaler,
                                                    SuccessChanceScaler)
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine
from repro_torch.serving.engine import _EngineUnitPool
from torch_jax_side import JAX, PORT

CPU = "cpu"


def _pet(seed=0, mtypes=("m0",), mean_range=(10, 20), inconsistent=True,
         side=PORT):
    return side.pet(seed=seed, mtypes=mtypes, mean_range=mean_range,
                    inconsistent=inconsistent)


def _request_trace(side=PORT, deadline=200.0, **kw):
    return side.request_trace(deadline=deadline, **kw)


def _jax_sim(trace_kw, fleet, pet_kw, oracle_seed, **sim_kw):
    """JAX's simulator on the reference's draws: (trace, stats).  ``fleet``
    is a FleetSpec text (or an int for ``homogeneous(n)``); ``elasticity``
    in ``sim_kw`` is a dict of ElasticityConfig fields."""
    sim, st = JAX.simulate(_request_trace(JAX, **trace_kw), fleet,
                           pet=_pet(side=JAX, **pet_kw),
                           oracle_seed=oracle_seed, **sim_kw)
    return sim.cp.trace, st


# ---------------------------------------------------------------------------
# the catalog
# ---------------------------------------------------------------------------

class TestFleetSpec:
    def test_parse_serialize_roundtrip(self):
        text = "tpu:4:1:1:auto:4,cpu:4:0.25:0.2:auto:4"
        fleet = FleetSpec.parse(text)
        assert fleet.serialize() == text
        assert FleetSpec.parse(fleet.serialize()) == fleet

    def test_parse_defaults_and_optional_fields(self):
        fleet = FleetSpec.parse("fast:2,slow:1:0.5:0.25:stub:8")
        fast, slow = fleet.specs
        assert (fast.count, fast.speed, fast.cost_rate, fast.backend,
                fast.queue_size) == (2, 1.0, 1.0, "auto", 4)
        assert (slow.count, slow.speed, slow.cost_rate, slow.backend,
                slow.queue_size) == (1, 0.5, 0.25, "stub", 8)

    def test_parse_errors(self):
        with pytest.raises(ValueError, match="bad fleet row"):
            FleetSpec.parse("solo")
        with pytest.raises(ValueError, match="unknown backend"):
            FleetSpec.parse("a:1:1:1:warp")
        with pytest.raises(ValueError, match="count"):
            FleetSpec.parse("a:0")
        with pytest.raises(ValueError, match="mtype"):
            FleetSpec.parse(":2")
        with pytest.raises(ValueError, match="at least one"):
            FleetSpec(())

    def test_homogeneous_default_reproduces_todays_pool(self):
        fleet = FleetSpec.homogeneous(3)
        assert fleet.total == 3 and fleet.is_homogeneous
        machines = fleet.build_machines()
        assert [m.mid for m in machines] == [1, 2, 3]
        for m in machines:
            assert (m.mtype, m.speed, m.queue_size, m.cost_rate) == \
                (DEFAULT_MTYPE, 1.0, 4, 1.0)

    def test_expand_and_views(self):
        fleet = FleetSpec.parse("a:2:1:1.0,b:1:0.5:0.25")
        assert fleet.total == 3
        assert [s.mtype for s in fleet.expand()] == ["a", "a", "b"]
        assert all(s.count == 1 for s in fleet.expand())
        assert fleet.mtypes == ["a", "b"]
        assert not fleet.is_homogeneous
        assert fleet.cheapest().mtype == "b"
        assert fleet.cost_rate_total() == pytest.approx(2.25)

    def test_cheapest_tie_breaks_by_declaration_order(self):
        fleet = FleetSpec.parse("x:1:1:0.5,y:1:1:0.5")
        assert fleet.cheapest().mtype == "x"

    def test_build_machines_carries_every_field(self):
        fleet = FleetSpec((MachineSpec(mtype="z", count=1, speed=0.5,
                                       cost_rate=0.1, queue_size=7,
                                       power=0.3),))
        (m,) = fleet.build_machines(start_mid=5)
        assert (m.mid, m.mtype, m.speed, m.cost_rate, m.queue_size,
                m.power) == (5, "z", 0.5, 0.1, 7, 0.3)

    def test_power_survives_the_roundtrip(self):
        fleet = FleetSpec((MachineSpec(mtype="z", power=3.0),))
        assert fleet.serialize().endswith(":3")
        again = FleetSpec.parse(fleet.serialize())
        assert again == fleet and again.specs[0].power == 3.0
        assert FleetSpec.parse("z:1:1:1:auto:4:0.5").specs[0].power == 0.5


# ---------------------------------------------------------------------------
# homogeneous-fleet regression: fleet path == legacy construction
# ---------------------------------------------------------------------------

EQUIV_POLICIES = [
    dict(heuristic="EDF", merging="adaptive"),
    dict(heuristic="FCFS-RR", merging="aggressive"),
    dict(heuristic="MCT", merging="none"),
]


class TestHomogeneousRegression:
    @pytest.mark.parametrize("kw", EQUIV_POLICIES,
                             ids=[k["heuristic"] for k in EQUIV_POLICIES])
    def test_engine_fleet_matches_legacy_n_units(self, kw):
        """EngineConfig(fleet=homogeneous(n)) must take decision traces
        bitwise-identical to EngineConfig(n_units=n) — the pre-refactor
        construction, kept as the default — and JAX's simulator's on the
        same fleet."""
        pet = _pet(seed=3, mean_range=(8, 16))
        traces = []
        for fleet in (None, FleetSpec.homogeneous(2)):
            eng = ServingEngine(None, None, EngineConfig(
                n_units=2, fleet=fleet, elasticity=None,
                result_cache=False, prefix_cache=False, **kw),
                stub_oracle=PETOracle(pet, seed=11), device=CPU)
            eng.cp.trace = []
            stats = eng.run(_request_trace(n=40, seed=1))
            traces.append((eng.cp.trace, stats["on_time"], stats["missed"],
                           stats["dropped"], stats["cost"]))
        assert traces[0] == traces[1]
        jax_trace, _ = _jax_sim(dict(n=40, seed=1), 2,
                                dict(seed=3, mean_range=(8, 16)), 11, **kw)
        assert traces[0][0] == jax_trace

    def test_sim_fleet_matches_legacy_machines(self):
        pet = _pet(seed=3, mean_range=(8, 16))
        results = []
        for machines in ([Machine(mid=1, mtype=DEFAULT_MTYPE, queue_size=4),
                          Machine(mid=2, mtype=DEFAULT_MTYPE, queue_size=4)],
                         FleetSpec.homogeneous(2)):
            sim = Simulator(PORT.mirror_tasks(_request_trace(n=40, seed=1)),
                            machines, PETOracle(pet, seed=11),
                            SimConfig(heuristic="EDF", merging="adaptive"),
                            device=CPU)
            sim.cp.trace = []
            st = sim.run()
            results.append((sim.cp.trace, st.on_time, st.missed, st.dropped,
                            st.cost))
        assert results[0] == results[1]
        jax_trace, jst = _jax_sim(dict(n=40, seed=1), 2,
                                  dict(seed=3, mean_range=(8, 16)), 11,
                                  heuristic="EDF", merging="adaptive")
        assert results[0] == (jax_trace, jst.on_time, jst.missed,
                              jst.dropped, jst.cost)

    def test_engine_fleet_overrides_n_units(self):
        pet = _pet()
        eng = ServingEngine(None, None, EngineConfig(
            n_units=7, fleet=FleetSpec.homogeneous(2), elasticity=None,
            result_cache=False, prefix_cache=False),
            stub_oracle=PETOracle(pet, seed=1), device=CPU)
        assert len(eng.units) == 2


# ---------------------------------------------------------------------------
# heterogeneous sim <-> stub-engine equivalence (one FleetSpec, both sides)
# ---------------------------------------------------------------------------

MIXED_TEXT = "fast:2:1.0:1.0,slow:2:0.5:0.25"
MIXED = FleetSpec.parse(MIXED_TEXT)


class TestHeteroEquivalence:
    @pytest.mark.parametrize("heuristic", ["EDF", "MCT", "MCMD"])
    def test_same_fleet_same_decisions_and_cost(self, heuristic):
        """A mixed fast/slow fleet built from one FleetSpec: the stub
        engine and the simulator must take identical decision traces and
        report identical per-mtype execution cost, and JAX's simulator
        the same trace."""
        pet_kw = dict(seed=3, mtypes=("fast", "slow"), mean_range=(8, 16),
                      inconsistent=False)
        pet = _pet(**pet_kw)
        trace = _request_trace(n=40, seed=1, deadline=250.0)

        eng = ServingEngine(None, None, EngineConfig(
            fleet=MIXED, heuristic=heuristic, merging="adaptive",
            elasticity=None, result_cache=False, prefix_cache=False),
            stub_oracle=PETOracle(pet, seed=11), device=CPU)
        eng.cp.trace = []
        stats = eng.run(trace)

        sim = Simulator(PORT.mirror_tasks(trace), MIXED,
                        PETOracle(pet, seed=11),
                        SimConfig(heuristic=heuristic, merging="adaptive"),
                        device=CPU)
        sim.cp.trace = []
        st = sim.run()

        jax_trace, jst = _jax_sim(dict(n=40, seed=1, deadline=250.0),
                                  MIXED_TEXT, pet_kw, 11,
                                  heuristic=heuristic, merging="adaptive")

        assert sim.cp.trace == eng.cp.trace == jax_trace
        assert (st.on_time, st.missed, st.dropped) == \
            (stats["on_time"], stats["missed"], stats["dropped"]) == \
            (jst.on_time, jst.missed, jst.dropped)
        assert st.cost == pytest.approx(stats["cost"])
        assert st.pool_cost == pytest.approx(stats["pool_cost"])
        assert (st.cost, st.pool_cost) == (jst.cost, jst.pool_cost)
        # the mixed fleet was actually exercised: both mtypes ran work
        used = {e[2] for e in eng.cp.trace if e[0] == "start"}
        assert {0, 1} & used and {2, 3} & used

    def test_engine_machines_mirror_fleet(self):
        pet = _pet(mtypes=("fast", "slow"))
        eng = ServingEngine(None, None, EngineConfig(
            fleet=MIXED, elasticity=None, result_cache=False,
            prefix_cache=False), stub_oracle=PETOracle(pet, seed=1),
            device=CPU)
        spec_rows = MIXED.expand()
        assert len(eng.machines) == len(spec_rows) == 4
        for m, s in zip(eng.machines, spec_rows):
            assert (m.mtype, m.speed, m.cost_rate, m.queue_size) == \
                (s.mtype, s.speed, s.cost_rate, s.queue_size)
        # same mids/fields as the simulator's build by construction
        sim_machines = MIXED.build_machines()
        assert [(m.mid, m.mtype, m.speed) for m in eng.machines] == \
            [(m.mid, m.mtype, m.speed) for m in sim_machines]


# ---------------------------------------------------------------------------
# per-unit backend dispatch
# ---------------------------------------------------------------------------

class TestBackendDispatch:
    def test_stub_backend_rows_need_no_jax_in_live_mode(self):
        """A live engine whose fleet rows are all ``backend=stub`` builds
        remote-endpoint stand-ins (no JAX, no model): durations come from the
        TimeEstimator oracle's ``sample`` and cost is accounted."""
        fleet = FleetSpec.parse("remote:2:1.0:0.1:stub")
        eng = ServingEngine(None, None, EngineConfig(
            fleet=fleet, elasticity=None, result_cache=False,
            prefix_cache=False, merging="none"), device=CPU)
        assert [u.kind for u in eng.units] == ["stub", "stub"]
        stats = eng.run(_request_trace(n=12, seed=0, deadline=1e9))
        assert stats["completed"] == 12
        assert stats["executions"] > 0
        assert stats["cost"] > 0.0
        # busy time can never exceed pool residency: at rate 0.1/tick the
        # execution cost is bounded by 0.1 x the machine-seconds integral
        assert stats["cost"] <= 0.1 * stats["machine_seconds"] + 1e-9
        assert stats["pool_cost"] == pytest.approx(
            0.1 * stats["machine_seconds"])

    def test_stub_backend_results_barred_from_result_cache(self):
        """Stub-backed units return no token payload; a repeat of the same
        request must re-execute, never be served an empty cached answer."""
        fleet = FleetSpec.parse("remote:1:1.0:0.1:stub")
        eng = ServingEngine(None, None, EngineConfig(
            fleet=fleet, elasticity=None, result_cache=True,
            prefix_cache=False, merging="none"), device=CPU)
        r1 = Request(prompt=(1, 2, 3, 4), n_new=2, deadline=1e9)
        eng.run([(0.0, r1)])
        r2 = Request(prompt=(1, 2, 3, 4), n_new=2, deadline=1e9)
        eng.run([(eng.clock, r2)])
        assert eng.stats["cache_hits"] == 0
        assert eng.stats["executions"] == 2

    def test_stub_engine_mode_overrides_backends(self):
        """stub_oracle engines are stub end-to-end regardless of catalog
        backends (the pre-fleet stub-execution mode, unchanged)."""
        pet = _pet(mtypes=("fast", "slow"))
        eng = ServingEngine(None, None, EngineConfig(
            fleet=MIXED, elasticity=None, result_cache=False,
            prefix_cache=False), stub_oracle=PETOracle(pet, seed=1),
            device=CPU)
        assert all(u.kind == "stub" for u in eng.units)


# ---------------------------------------------------------------------------
# cost-aware mapping heuristics
# ---------------------------------------------------------------------------

class _FixedOracle:
    """Deterministic oracle: mu ticks scaled by machine speed only."""

    def __init__(self, mu=10.0):
        self.mu = mu

    def mean_std(self, task, machine):
        return self.mu / machine.speed, 0.0


def _mk_task(deadline=1e6, **kw):
    kw.setdefault("ttype", "generate")
    kw.setdefault("data_id", "d")
    kw.setdefault("op", "generate")
    return Task(deadline=deadline, **kw)


class TestCostAwareHeuristics:
    def test_registered_like_the_rest(self):
        assert {"MEC", "MCMD"} <= set(HEURISTICS)
        assert make_heuristic("mec").name == "MEC"
        assert make_heuristic("MCMD").name == "MCMD"

    def test_mec_picks_cheapest_execution(self):
        fast = Machine(mid=0, cost_rate=1.0)
        cheap = Machine(mid=1, cost_rate=0.25)
        ctx = MappingContext(oracle=_FixedOracle())
        task = _mk_task()
        mapped = make_heuristic("MEC").map_batch([task], [fast, cheap], ctx)
        assert mapped == [(task, cheap)]
        assert ctx.exec_cost(task, cheap) < ctx.exec_cost(task, fast)

    def test_mec_cost_normalizes_speed(self):
        """A slow machine whose rate drops faster than its speed still
        wins: 10/0.5 ticks x 0.25 = 5 < 10 x 1.0."""
        fast = Machine(mid=0, speed=1.0, cost_rate=1.0)
        slow = Machine(mid=1, speed=0.5, cost_rate=0.25)
        ctx = MappingContext(oracle=_FixedOracle())
        task = _mk_task()
        assert make_heuristic("MEC").map_batch(
            [task], [fast, slow], ctx) == [(task, slow)]

    def test_mcmd_prefers_cheap_when_deadline_allows(self):
        fast = Machine(mid=0, speed=1.0, cost_rate=1.0)
        slow = Machine(mid=1, speed=0.5, cost_rate=0.25)
        ctx = MappingContext(oracle=_FixedOracle())        # 10 vs 20 ticks
        task = _mk_task(deadline=100.0)
        assert make_heuristic("MCMD").map_batch(
            [task], [fast, slow], ctx) == [(task, slow)]

    def test_mcmd_pays_for_speed_when_deadline_requires(self):
        fast = Machine(mid=0, speed=1.0, cost_rate=1.0)
        slow = Machine(mid=1, speed=0.5, cost_rate=0.25)
        ctx = MappingContext(oracle=_FixedOracle())
        task = _mk_task(deadline=15.0)      # 10 <= 15 < 20: only fast fits
        assert make_heuristic("MCMD").map_batch(
            [task], [fast, slow], ctx) == [(task, fast)]

    def test_mcmd_falls_back_to_earliest_completion(self):
        """No machine meets the deadline: QoS degrades before cost — the
        earliest completion wins, not the cheapest."""
        fast = Machine(mid=0, speed=1.0, cost_rate=1.0)
        slow = Machine(mid=1, speed=0.5, cost_rate=0.25)
        ctx = MappingContext(oracle=_FixedOracle())
        task = _mk_task(deadline=5.0)       # hopeless on both
        assert make_heuristic("MCMD").map_batch(
            [task], [fast, slow], ctx) == [(task, fast)]

    def test_mcmd_accounts_queue_buildup(self):
        """Greedy assignment sees its own queue: once the cheap machine's
        expected completion slips past the deadline, overflow goes to the
        fast one."""
        fast = Machine(mid=0, speed=1.0, cost_rate=1.0, queue_size=8)
        slow = Machine(mid=1, speed=0.5, cost_rate=0.25, queue_size=8)
        ctx = MappingContext(oracle=_FixedOracle())
        tasks = [_mk_task(data_id=f"d{i}", deadline=45.0) for i in range(4)]
        mapped = dict(
            (t.data_id, m.mid)
            for t, m in make_heuristic("MCMD").map_batch(
                tasks, [fast, slow], ctx))
        # 20-tick jobs on slow: two fit under 45; the rest must go fast
        assert [mapped[f"d{i}"] for i in range(4)] == [1, 1, 0, 0]


# ---------------------------------------------------------------------------
# cheapest-first scale-up / priciest-first retirement + cost integrals
# ---------------------------------------------------------------------------

class TestFleetElasticity:
    def test_sim_grows_cheapest_fleet_row(self):
        pet = _pet(mtypes=("fast", "slow"), inconsistent=False)
        fleet = FleetSpec.parse("fast:1:1.0:1.0,slow:1:0.5:0.25")
        tasks = PORT.mirror_tasks(_request_trace(n=60, seed=2, rate=2.0,
                                                 deadline=1e6))
        sim = Simulator(tasks, fleet, PETOracle(pet, seed=3),
                        SimConfig(heuristic="EDF", merging="none",
                                  elasticity=ElasticityConfig(
                                      policy="queue", max_extra=2,
                                      scale_up_queue=6, scale_down_queue=1)),
                        device=CPU)
        st = sim.run()
        assert st.scale_ups > 0
        # every scaler-added machine is the cheapest catalog row
        extras = [m for m in sim.machines if m.mid > 2]
        assert all(m.mtype == "slow" and m.cost_rate == 0.25
                   for m in extras)
        # per-mtype billing: extras bill at 0.25, never the homogeneous 1.0
        assert st.extra_pool_cost == pytest.approx(
            0.25 * st.extra_machine_seconds)

    def test_engine_retires_priciest_idle_unit(self):
        pet = _pet(mtypes=("exp", "cheap"), inconsistent=False)
        fleet = FleetSpec.parse("cheap:1:1.0:0.1,exp:1:1.0:1.0,"
                                "cheap:1:1.0:0.1")
        eng = ServingEngine(None, None, EngineConfig(
            fleet=fleet, elasticity=None, result_cache=False,
            prefix_cache=False), stub_oracle=PETOracle(pet, seed=1),
            device=CPU)
        pool = _EngineUnitPool(eng)
        assert pool.cost_rate() == pytest.approx(1.2)
        assert pool.shrink(0.0)             # all idle: priciest goes first
        assert [u.machine.mtype for u in eng.units] == ["cheap", "cheap"]

    def test_fixed_pool_cost_is_rate_times_makespan(self):
        pet = _pet(mtypes=("fast", "slow"), inconsistent=False)
        sim = Simulator(
            PORT.mirror_tasks(_request_trace(n=10, seed=0, deadline=1e6)),
            MIXED, PETOracle(pet, seed=1), SimConfig(), device=CPU)
        st = sim.run()
        assert st.pool_cost == pytest.approx(
            MIXED.cost_rate_total() * st.makespan)
        assert st.pool_cost < st.machine_seconds   # cheap rows bill < 1.0

    def test_plane_pool_bills_base_fleet_not_unit_churn(self):
        """The Router's plane scaler bills each live plane at its *base*
        fleet rate: a plane's own unit-level scaler already accounts its
        extra units, so unit churn must not leak into the plane budget."""
        from repro_torch.serving.cluster import Plane, Router, _PlanePool
        pet = _pet()
        fleet = FleetSpec.parse("m0:2:1.0:0.5")
        eng = ServingEngine(None, None, EngineConfig(
            fleet=fleet, elasticity=None, result_cache=False,
            prefix_cache=False), stub_oracle=PETOracle(pet, seed=1),
            device=CPU)
        router = Router([Plane(eng, pid=0)])
        pool = _PlanePool(router, factory=lambda pid: None)
        assert pool.cost_rate() == pytest.approx(1.0)
        eng._add_unit()                     # unit-level growth
        assert len(eng.units) == 3
        assert pool.cost_rate() == pytest.approx(1.0)   # unchanged

    def test_cost_budget_gates_scale_up(self):
        cfg = ElasticityConfig(policy="cost-aware", budget_cost=50.0,
                               pressure_lam=1.0, pressure_on=1.0)
        pol = CostAwareScaler(cfg)
        risky = np.zeros(8)
        sig_in = ScaleSignals(0.0, 8, chances_fn=lambda: risky,
                              extra_cost=0.0)
        assert pol.decide(sig_in) == 1              # in budget
        sig_out = ScaleSignals(0.0, 8, chances_fn=lambda: risky,
                               extra_cost=50.0)
        assert pol.decide(sig_out) == -1            # burned: drain


# ---------------------------------------------------------------------------
# per-machine KV caches in the simulator
# ---------------------------------------------------------------------------

class TestPerMachineKVCaches:
    def _prefix_tasks(self, n=10, gap=40.0):
        sys_prompt = tuple(range(1, 33))
        rng = np.random.default_rng(0)
        out = []
        for i in range(n):
            toks = sys_prompt + tuple(rng.integers(100, 200,
                                                   size=8).tolist())
            out.append(Task(ttype="generate", data_id=f"d{i}",
                            op="generate", arrival=i * gap,
                            deadline=i * gap + 500.0, tokens=toks))
        return out

    def test_hits_attributed_to_the_caching_machine(self):
        """Shared-prefix tasks follow the blocks: after the first
        execution caches the prefix on one machine, the per-unit locality
        term steers every later task there — hits land on that machine's
        cache and nowhere else."""
        pet = _pet(seed=1, mean_range=(15, 25))
        sim = Simulator(self._prefix_tasks(), FleetSpec.homogeneous(2),
                        PETOracle(pet, seed=3),
                        SimConfig(heuristic="EDF", prefix_cache_blocks=64,
                                  kv_block_size=16, kv_per_machine=True),
                        device=CPU)
        st = sim.run()
        assert st.prefix_hits == 9              # all but the cold first
        per_cache = sorted(c.stats["hits"] for c in sim.kvcaches.values())
        assert per_cache == [0, 9]              # one owner, zero strays
        assert st.on_time == 10

    def test_locality_term_discriminates_between_machines(self):
        pet = _pet(seed=1)
        sim = Simulator([], FleetSpec.homogeneous(2), PETOracle(pet, seed=3),
                        SimConfig(heuristic="EDF", prefix_cache_blocks=64,
                                  kv_block_size=16, kv_per_machine=True),
                        device=CPU)
        toks = tuple(range(1, 33))
        m1, m2 = sim.machines
        sim.kvcaches[m1.mid].insert(toks)
        probe = Task(ttype="generate", data_id="p", op="generate",
                     tokens=toks + (99, 98))
        assert sim._prefix_locality(probe, m1) == 32
        assert sim._prefix_locality(probe, m2) == 0
        # the engine-wide PREFIX admission score is the best across units
        assert sim.detector.find_prefix_overlap(probe.tokens) == 32

    def test_shared_mode_unchanged_by_default(self):
        pet = _pet(seed=1)
        sim = Simulator([], FleetSpec.homogeneous(2), PETOracle(pet, seed=3),
                        SimConfig(prefix_cache_blocks=16), device=CPU)
        assert sim.kvcache is not None and not sim.kvcaches
        assert not sim.cfg.kv_per_machine


# ---------------------------------------------------------------------------
# the Eq. 4.3 OSL pressure signal
# ---------------------------------------------------------------------------

class TestOSLPressureSignal:
    def test_signal_default_is_zero(self):
        assert ScaleSignals(0.0, 3).osl() == 0.0

    def test_success_chance_policy_reads_osl_when_selected(self):
        cfg = ElasticityConfig(policy="success-chance",
                               pressure_signal="osl", osl_up=0.25,
                               osl_down=0.05, scale_down_queue=2)
        pol = SuccessChanceScaler(cfg)
        hot = ScaleSignals(0.0, 6, osl_fn=lambda: 0.9)
        cool = ScaleSignals(0.0, 1, osl_fn=lambda: 0.0)
        mid = ScaleSignals(0.0, 6, osl_fn=lambda: 0.1)
        assert pol.decide(hot) == 1
        assert pol.decide(cool) == -1
        assert pol.decide(mid) == 0
        # selecting OSL must never pay for the chance convolution
        boom = ScaleSignals(0.0, 6, chances_fn=lambda: 1 / 0,
                            osl_fn=lambda: 0.9)
        assert pol.decide(boom) == 1

    def test_chance_default_ignores_osl(self):
        cfg = ElasticityConfig(policy="success-chance")
        pol = SuccessChanceScaler(cfg)
        sig = ScaleSignals(0.0, 6, chances_fn=lambda: np.full(6, 0.2),
                           osl_fn=lambda: 1 / 0)
        assert pol.decide(sig) == 1         # low chance, OSL never touched

    def test_cost_aware_osl_pressure_through_schmitt(self):
        cfg = ElasticityConfig(policy="cost-aware", pressure_signal="osl",
                               pressure_lam=1.0, pressure_on=0.3,
                               scale_down_queue=0)
        pol = CostAwareScaler(cfg)
        assert pol.decide(ScaleSignals(0.0, 4, osl_fn=lambda: 0.5)) == 1
        assert pol.decide(ScaleSignals(0.0, 4, osl_fn=lambda: 0.0)) == 0

    def test_end_to_end_scaling_on_both_substrates(self):
        """An overloaded pool under OSL pressure scales up on the engine
        and the simulator alike (substrate-independent wiring), and the
        port's simulator takes JAX's simulator's decisions."""
        pet = _pet(seed=3, mean_range=(8, 16))
        el_kw = dict(policy="success-chance", pressure_signal="osl",
                     max_extra=2, cooldown=10.0, osl_up=0.1, osl_down=0.01)
        el = ElasticityConfig(**el_kw)
        trace_kw = dict(n=40, seed=1, deadline=60.0, rate=1.0)
        trace = _request_trace(**trace_kw)
        eng = ServingEngine(None, None, EngineConfig(
            n_units=1, heuristic="EDF", merging="none", result_cache=False,
            prefix_cache=False, elasticity=el),
            stub_oracle=PETOracle(pet, seed=11), device=CPU)
        stats = eng.run(trace)
        sim = Simulator(PORT.mirror_tasks(trace), FleetSpec.homogeneous(1),
                        PETOracle(pet, seed=11),
                        SimConfig(heuristic="EDF", merging="none",
                                  elasticity=el), device=CPU)
        sim.cp.trace = []
        st = sim.run()
        assert stats["scale_ups"] > 0 and st.scale_ups > 0
        assert stats["machine_seconds"] > 0 and st.machine_seconds > 0
        jax_trace, jst = _jax_sim(trace_kw, 1, dict(seed=3,
                                                    mean_range=(8, 16)), 11,
                                  heuristic="EDF", merging="none",
                                  elasticity=el_kw)
        assert sim.cp.trace == jax_trace
        assert (st.scale_ups, st.scale_downs, st.machine_seconds) == \
            (jst.scale_ups, jst.scale_downs, jst.machine_seconds)
