"""The port's twin of ``tests/test_core_scheduling.py``: merging,
appropriateness, pruning, heuristics and the end-to-end simulator
(Chapters 4-5 behaviour) of ``repro_torch.core``.

Each case runs its body on the port and on the reference's ``repro.core``
with the same inputs (``torch_jax_side.both``): the same merge levels and
matches, toggle states and alpha, success chances, defer thresholds and
drops, heuristic mappings, and simulator stats and decision traces on
both, before it checks the reference's invariants on the port's.  Every
simulator runs on ``device="cpu"``; PAM and PAMF keep the reference's
``"require pruner"`` skip in ``test_all_heuristics_map_without_pruner``."""

import copy

import numpy as np
import pytest

from torch_jax_side import JAX, PORT, both


def _mk_task(side, ttype="t0", data="d0", op="op0", params=("p0",),
             arrival=0.0, deadline=100.0):
    return side.Task(ttype=ttype, data_id=data, op=op, params=params,
                     arrival=arrival, deadline=deadline)


def _at(tasks, task):
    """The position of ``task`` in ``tasks`` by identity (task ids differ
    between the packages)."""
    return next(i for i, t in enumerate(tasks) if t is task)


# ---------------------------------------------------------------------------
# similarity detection (Section 4.3 / Fig. 4.3)
# ---------------------------------------------------------------------------

class TestSimilarityDetector:
    def test_levels_priority(self):
        def run(s):
            det = s.SimilarityDetector()
            det.on_arrival(_mk_task(s), None, None, None)
            return [
                det.find(_mk_task(s))[0],                 # identical
                det.find(_mk_task(s, params=("p1",)))[0],  # data+op
                det.find(_mk_task(s, op="op1"))[0],       # data only
                det.find(_mk_task(s, data="other"))]      # no match

        task, data_op, data_only, none = both(run)
        assert task is PORT.MergeLevel.TASK
        assert data_op is PORT.MergeLevel.DATA_OP
        assert data_only is PORT.MergeLevel.DATA_ONLY
        assert none is None

    def test_rule3_redirect_to_newest(self):
        def run(s):
            det = s.SimilarityDetector()
            a = _mk_task(s)
            det.on_arrival(a, None, None, None)
            b = _mk_task(s, params=("p1",))
            hit = det.find(b)
            det.on_arrival(b, hit[1], None, None)   # matched but NOT merged
            c = _mk_task(s, params=("p2",))
            return hit[1] is a, det.find(c)[1] is b

        # redirected to newest
        assert both(run) == (True, True)

    def test_departure_removes_entries(self):
        def run(s):
            det = s.SimilarityDetector()
            a = _mk_task(s)
            det.on_arrival(a, None, None, None)
            det.on_departure(a)
            return det.find(_mk_task(s)), len(det)

        assert both(run) == (None, 0)

    def test_merged_task_reachable_through_child_keys(self):
        def run(s):
            det = s.SimilarityDetector()
            a = _mk_task(s)
            det.on_arrival(a, None, None, None)
            b = _mk_task(s, params=("p1",))
            hit = det.find(b)
            merged = s.merge_tasks(hit[1], b, s.MergeLevel.DATA_OP)
            det.on_arrival(b, hit[1], merged, s.MergeLevel.DATA_OP)
            found = det.find(_mk_task(s, params=("p1",)))  # identical to b
            return found is not None and found[1] is a, found[0]

        reachable, _ = both(run)
        assert reachable                  # the compound task


class TestMergeTasks:
    def test_merge_keeps_earliest_deadline(self):
        def run(s):
            a = _mk_task(s, deadline=50)
            b = _mk_task(s, params=("p1",), deadline=30)
            m = s.merge_tasks(a, b, s.MergeLevel.DATA_OP)
            return (m.tid == a.tid, m.effective_deadline,
                    b.merged_into == a.tid, len(m.all_requests()))

        assert both(run) == (True, 30, True, 2)

    def test_self_merge_rejected(self):
        for side in (PORT, JAX):
            a = _mk_task(side)
            with pytest.raises(ValueError):
                side.merge_tasks(a, a, side.MergeLevel.TASK)


# ---------------------------------------------------------------------------
# oversubscription machinery
# ---------------------------------------------------------------------------

class TestToggle:
    def test_schmitt_hysteresis(self):
        def run(s):
            t = s.DropToggle(lam=1.0, on_level=2.0)  # lam=1: d == misses
            return [t.observe(m) for m in (1, 3, 1.7, 1.0, 1.9)]

        # engage at >= 2, stay engaged (off at <= 1.6), disengage, and
        # need >= 2.0 again
        assert both(run) == [False, True, True, False, False]

    def test_adaptive_alpha_range(self):
        assert both(lambda s: [s.adaptive_alpha(o) for o in
                               (0.0, 1.0, 0.5, 9.9)]) == [2.0, -2.0, 0.0,
                                                          -2.0]


# ---------------------------------------------------------------------------
# pruner behaviour
# ---------------------------------------------------------------------------

def _small_system(side, seed=0):
    rng = np.random.default_rng(seed)
    pet = side.PETMatrix.generate(["t0", "t1"], ["m0", "m1"], rng,
                                  mean_range=(8, 20))
    machines = [side.Machine(mid=0, mtype="m0", queue_size=3),
                side.Machine(mid=1, mtype="m1", queue_size=3)]
    return pet, machines


class TestPruner:
    def test_drop_pass_only_when_engaged(self):
        def run(s):
            pet, machines = _small_system(s)
            pruner = s.Pruner(s.PETOracle(pet),
                              s.PruningConfig(toggle_on=5.0, lam=1.0))
            # hopeless task: deadline already essentially passed
            doomed = _mk_task(s, deadline=1.0)
            machines[0].queue.append(doomed)
            calm = pruner.drop_pass(machines, now=0.0, misses_since_last=0)
            dropped = pruner.drop_pass(machines, now=0.0,
                                       misses_since_last=10)
            return (len(calm), [t is doomed for t in dropped],
                    len(machines[0].queue))

        calm, dropped, left = both(run)
        assert calm == 0
        assert any(dropped)
        assert left == 0

    def test_high_chance_tasks_survive(self):
        def run(s):
            pet, machines = _small_system(s)
            pruner = s.Pruner(s.PETOracle(pet),
                              s.PruningConfig(lam=1.0, toggle_on=1.0))
            safe = _mk_task(s, deadline=10_000.0)
            machines[0].queue.append(safe)
            dropped = pruner.drop_pass(machines, now=0.0,
                                       misses_since_last=10)
            return len(dropped), [t is safe for t in machines[0].queue]

        assert both(run) == (0, [True])

    def test_chance_cache_consistency(self):
        def run(s):
            pet, machines = _small_system(s)
            pruner = s.Pruner(s.PETOracle(pet), s.PruningConfig())
            t = _mk_task(s, deadline=60.0)
            p1 = pruner.success_chance(t, machines[0], 0.0)
            p2 = pruner.success_chance(t, machines[0], 0.0)   # cached
            machines[0].queue.append(_mk_task(s, deadline=200.0))
            p3 = pruner.success_chance(t, machines[0], 0.0)   # queue changed
            return p1, p2, p3

        p1, p2, p3 = both(run)
        assert p1 == p2
        assert p3 <= p1 + 1e-12

    def test_defer_threshold_dynamics(self):
        def run(s):
            pet, machines = _small_system(s)
            pruner = s.Pruner(s.PETOracle(pet),
                              s.PruningConfig(initial_defer_threshold=0.5,
                                              theta=0.1, dynamic_defer=True))
            # empty batch + free slots -> Delta < 1 -> threshold decreases
            v = pruner.update_defer_threshold([], machines, {}, now=0.0)
            # oversubscribed with zero-competency batch -> decrease again
            batch = [_mk_task(s, deadline=5.0) for _ in range(20)]
            v2 = pruner.update_defer_threshold(
                batch, machines, {t.tid: 0.0 for t in batch}, 0.0)
            return v, v2

        v, v2 = both(run)
        assert v == pytest.approx(0.4)
        assert v2 < v

    def test_fairness_concession(self):
        def run(s):
            pet, _ = _small_system(s)
            pruner = s.Pruner(s.PETOracle(pet),
                              s.PruningConfig(fairness_factor=1.0))
            for _ in range(20):
                pruner.fairness.note_pruned("t0")
            return (pruner.fairness.concession("t0"),
                    pruner.fairness.concession("t1"))

        c0, c1 = both(run)
        assert c0 < c1


# ---------------------------------------------------------------------------
# heuristics
# ---------------------------------------------------------------------------

class TestHeuristics:
    @pytest.mark.parametrize("name", sorted(PORT.HEURISTICS))
    def test_all_heuristics_map_without_pruner(self, name):
        if name in ("PAM", "PAMF"):
            pytest.skip("require pruner")

        def run(s):
            pet, machines = _small_system(s)
            batch = [_mk_task(s, ttype=f"t{i % 2}", data=f"d{i}",
                              deadline=200 + i) for i in range(8)]
            ctx = s.MappingContext(oracle=s.PETOracle(pet))
            mapped = s.make_heuristic(name).map_batch(batch, machines, ctx)
            return [(_at(batch, t), m.mid, any(q is t for q in m.queue))
                    for t, m in mapped]

        mapped = both(run)
        assert 1 <= len(mapped) <= 6   # 2 machines x 3 slots
        assert all(queued for _, _, queued in mapped)

    def test_pam_prefers_feasible(self):
        def run(s):
            pet, machines = _small_system(s)
            oracle = s.PETOracle(pet)
            pruner = s.Pruner(oracle,
                              s.PruningConfig(initial_defer_threshold=0.3))
            batch = [_mk_task(s, data="dx", deadline=2.0),      # doomed
                     _mk_task(s, data="dy", deadline=500.0)]    # fine
            ctx = s.MappingContext(oracle=oracle, pruner=pruner)
            mapped = s.make_heuristic("PAM").map_batch(batch, machines, ctx)
            return [(_at(batch, t), m.mid) for t, m in mapped]

        picked = [i for i, _ in both(run)]
        assert 1 in picked and 0 not in picked

    def test_mct_balances_load(self):
        def run(s):
            pet, machines = _small_system(s)
            batch = [_mk_task(s, data=f"d{i}", deadline=10_000)
                     for i in range(4)]
            ctx = s.MappingContext(oracle=s.PETOracle(pet))
            s.make_heuristic("MCT").map_batch(batch, machines, ctx)
            return [[_at(batch, t) for t in m.queue] for m in machines]

        assert all(len(q) >= 1 for q in both(run))

    def test_registry_error_path_names_options(self):
        """The unknown-name message must quote the input and list the
        registered heuristics (mirrored for the router-policy registry in
        tests/test_cluster.py)."""
        for side in (PORT, JAX):
            with pytest.raises(KeyError, match=r"unknown heuristic 'nope'"):
                side.make_heuristic("nope")
            with pytest.raises(KeyError) as exc:
                side.make_heuristic("nope")
            for name in side.HEURISTICS:
                assert name in str(exc.value)
        assert sorted(PORT.HEURISTICS) == sorted(JAX.HEURISTICS)

    def test_registry_lookup_is_case_insensitive(self):
        assert both(lambda s: [s.make_heuristic("edf").name,
                               s.make_heuristic("pamf").name]) == \
            ["EDF", "PAMF"]


# ---------------------------------------------------------------------------
# end-to-end simulator behaviour
# ---------------------------------------------------------------------------

def _traced(sim):
    """Run ``sim`` recording its decisions: (stats, trace)."""
    sim.cp.trace = []
    return sim.run(), sim.cp.trace


def _run_video(merging, n=500, pf=None, seed=3):
    """The video-streaming run on both packages: the port's stats, held
    equal to the reference's with the decision trace."""
    def run(s):
        wl = s.video_streaming_workload(n, span=250.0, seed=seed)
        machines = [s.Machine(mid=i, queue_size=4) for i in range(8)]
        oracle = s.VideoOracle(wl.exec_model, wl.videos, seed=seed)
        return _traced(s.Simulator(
            [copy.copy(t) for t in wl.tasks], machines, oracle,
            s.SimConfig(heuristic="FCFS-RR", merging=merging,
                        position_finder=pf, seed=seed), **s.dev))

    return both(run)[0]


class TestSimulatorMerging:
    def test_merging_reduces_makespan(self):
        base = _run_video("none")
        merged = _run_video("aggressive")
        assert merged.merges > 0
        assert merged.makespan < base.makespan
        # every request is accounted for exactly once
        assert (merged.on_time + merged.missed + merged.dropped
                == merged.n_requests)

    def test_conservative_rejects_some(self):
        st = _run_video("conservative")
        assert st.merges > 0

    def test_adaptive_runs(self):
        st = _run_video("adaptive")
        assert st.merges > 0

    def test_position_finder_runs(self):
        # aggressive + Pfind: merging always happens, the finder only places
        # the compound task (§4.6.4); conservative + Pfind may legitimately
        # cancel every merge at extreme oversubscription.
        st = _run_video("aggressive", n=500, pf="linear")
        st_log = _run_video("aggressive", n=500, pf="log")
        assert st.merges > 0 and st_log.merges > 0


def _run_spiky(n, span, wl_seed, **cfg_kw):
    """A spiky-workload run on both packages, hard deadlines on: the
    port's stats, held equal to the reference's with the decision
    trace."""
    def run(s):
        wl = s.spiky_hc_workload(n, span=span, seed=wl_seed)
        return _traced(s.Simulator(
            [copy.copy(t) for t in wl.tasks],
            [copy.deepcopy(m) for m in wl.machines],
            s.PETOracle(wl.pet, seed=2),
            s.SimConfig(hard_deadlines=True, seed=1,
                        **s.config(cfg_kw)), **s.dev))

    return both(run)[0]


class TestSimulatorPruning:
    def test_pruning_improves_overloaded_msd(self):
        base = _run_spiky(500, 300.0, 5, heuristic="MSD", pruning=None)
        pruned = _run_spiky(500, 300.0, 5, heuristic="MSD",
                            pruning=dict(initial_defer_threshold=0.3))
        assert pruned.robustness > base.robustness

    def test_accounting_exact(self):
        st = _run_spiky(300, 200.0, 9, heuristic="MM", pruning={})
        assert st.on_time + st.missed + st.dropped == st.n_requests == 300
