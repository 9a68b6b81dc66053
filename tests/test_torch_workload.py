"""The port's Chapter 4/5 workload generators (``repro_torch.core.workload``
over ``repro_torch.serving.workload.generators``) against the JAX package's.

* Both generators are draw-for-draw equal: every task's id (relative to
  the first), type, operation, parameters, user, arrival, deadline and
  video/segment, the video table, the PET matrix and the machines — exact
  equality, since both run the same numpy draws.
* The twins of ``tests/test_workload.py::TestGenerators``.
* ``examples/quickstart.py``'s two demos, at reduced task counts, give
  equal ``SimStats`` (wall-clock fields aside) in both packages.
* The twins of ``tests/test_workload.py::TestLiveEnginePrefixReuse``: a
  live engine on ``device="cpu"`` behind a ``Router`` serves closed-loop
  multi-turn sessions whose per-turn prefix hit depth grows, above a
  single-shot baseline that never hits.
"""

import copy
import dataclasses

import pytest
import torch

from repro.core.pruning import PruningConfig as JaxPruningConfig
from repro.core.simulation import PETOracle as JaxPETOracle
from repro.core.simulation import SimConfig as JaxSimConfig
from repro.core.simulation import Simulator as JaxSimulator
from repro.core.simulation import VideoOracle as JaxVideoOracle
from repro.core.tasks import Machine as JaxMachine
from repro.core.workload import spiky_hc_workload as jax_spiky_hc
from repro.core.workload import video_streaming_workload as jax_video
from repro_torch.core.pruning import PruningConfig
from repro_torch.core.simulation import (PETOracle, SimConfig, Simulator,
                                         VideoOracle)
from repro_torch.core.tasks import Machine
from repro_torch.core.workload import (spiky_hc_workload,
                                       video_streaming_workload)
from repro_torch.configs.registry import get_arch
from repro_torch.models import transformer as T
from repro_torch.serving.batching import StepBatchingConfig
from repro_torch.serving.cluster import Plane, Router
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.workload import (SessionConfig, SessionPool,
                                          WorkloadDriver, generators)


def _tasks(wl):
    t0 = wl.tasks[0].tid
    return [(t.tid - t0, t.ttype, t.data_id, t.op, t.params, t.user,
             t.arrival, t.deadline, t.priority, t.tokens) for t in wl.tasks]


def _machines(wl):
    return [dataclasses.astuple(m) for m in wl.machines]


def _pet(pet):
    return {k: (p.offset, p.values.tolist())
            for k, p in sorted(pet._pmfs.items())}


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_video_workload_draw_for_draw(seed):
    ours, ref = video_streaming_workload(90, seed=seed), jax_video(90,
                                                                   seed=seed)
    assert _tasks(ours) == _tasks(ref)
    assert {k: dataclasses.astuple(v) for k, v in ours.videos.items()} == \
        {k: dataclasses.astuple(v) for k, v in ref.videos.items()}
    assert ours.span == ref.span
    v = next(iter(ours.videos))
    for op in ("bitrate", "hevc"):
        for noisy in (False, True):       # the noise draws too
            assert ours.exec_model.individual_time(ours.videos[v], op,
                                                   noisy=noisy) == \
                ref.exec_model.individual_time(ref.videos[v], op,
                                               noisy=noisy)


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (11, {}), (5, {"homogeneous": True}),
    (2, {"n_task_types": 5, "n_machines": 6, "cv": 0.5})])
def test_hc_workload_draw_for_draw(seed, kw):
    ours = spiky_hc_workload(70, span=300.0, seed=seed, **kw)
    ref = jax_spiky_hc(70, span=300.0, seed=seed, **kw)
    assert _tasks(ours) == _tasks(ref)
    assert _pet(ours.pet) == _pet(ref.pet)
    assert _machines(ours) == _machines(ref)
    assert ours.span == ref.span


def test_wrappers_reach_the_generators():
    a = video_streaming_workload(20, seed=1)
    b = generators.build_video_streaming_workload(20, seed=1)
    assert [t.key_task_level() for t in a.tasks] == \
        [t.key_task_level() for t in b.tasks]
    a = spiky_hc_workload(20, seed=1)
    b = generators.build_spiky_hc_workload(20, seed=1)
    assert [(t.ttype, t.arrival) for t in a.tasks] == \
        [(t.ttype, t.arrival) for t in b.tasks]


class TestGenerators:
    def test_video_workload_deterministic(self):
        w1 = video_streaming_workload(80, seed=3)
        w2 = video_streaming_workload(80, seed=3)
        assert [t.arrival for t in w1.tasks] == [t.arrival for t in w2.tasks]
        assert [t.key_task_level() for t in w1.tasks] == \
            [t.key_task_level() for t in w2.tasks]
        assert len(w1.tasks) == 80 and w1.span == 600.0

    def test_hc_workload_deterministic(self):
        w1 = spiky_hc_workload(60, seed=11)
        w2 = spiky_hc_workload(60, seed=11)
        assert [t.arrival for t in w1.tasks] == [t.arrival for t in w2.tasks]
        assert [(t.ttype, t.deadline) for t in w1.tasks] == \
            [(t.ttype, t.deadline) for t in w2.tasks]
        assert [t.arrival for t in w1.tasks] == \
            sorted(t.arrival for t in w1.tasks)
        assert len(w1.machines) == 8


def _stats(s):
    return {k: v for k, v in dataclasses.asdict(s).items() if "wall" not in k}


@pytest.mark.parametrize("prune", [False, True], ids=["msd", "msd-p"])
def test_quickstart_pruning_demo_equal(prune):
    """quickstart's Ch. 5 demo at 150 tasks (it runs 600)."""
    out = []
    for wlf, PO, SC, Sim, PC in (
            (jax_spiky_hc, JaxPETOracle, JaxSimConfig, JaxSimulator,
             JaxPruningConfig),
            (spiky_hc_workload, PETOracle, SimConfig, Simulator,
             PruningConfig)):
        wl = wlf(150, span=75.0, seed=5)
        cfg = PC(initial_defer_threshold=0.3, base_drop_threshold=0.25,
                 rho=0.1) if prune else None
        sim = Sim([copy.copy(t) for t in wl.tasks],
                  [copy.deepcopy(m) for m in wl.machines],
                  PO(wl.pet, seed=6),
                  SC(heuristic="MSD", pruning=cfg, hard_deadlines=True,
                     seed=1))
        out.append(_stats(sim.run()))
    assert out[0] == out[1]
    assert out[0]["n_requests"] == 150


@pytest.mark.parametrize("merging", ["none", "adaptive"])
def test_quickstart_merging_demo_equal(merging):
    """quickstart's Ch. 4 demo at 200 tasks (it runs 1000)."""
    out = []
    for wlf, M, VO, SC, Sim in (
            (jax_video, JaxMachine, JaxVideoOracle, JaxSimConfig,
             JaxSimulator),
            (video_streaming_workload, Machine, VideoOracle, SimConfig,
             Simulator)):
        wl = wlf(200, span=70.0, seed=7)
        sim = Sim([copy.copy(t) for t in wl.tasks],
                  [M(mid=i, queue_size=4) for i in range(8)],
                  VO(wl.exec_model, wl.videos, seed=3),
                  SC(heuristic="FCFS-RR", merging=merging, seed=1))
        out.append(_stats(sim.run()))
    assert out[0] == out[1]
    if merging == "adaptive":
        assert out[0]["merges"] > 0


# ---------------------------------------------------------------------------
# prefix-reuse acceptance on the live engine (tiny model, on the CPU)
# ---------------------------------------------------------------------------

class TestLiveEnginePrefixReuse:
    @pytest.fixture(scope="class")
    def model(self):
        cfg = get_arch("smollm-360m").reduced().scaled(
            n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
            vocab=256, head_dim=32, remat=False)
        return cfg, T.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")

    def _run(self, model, users, turns, prefix_cache=True, batching=None,
             items=None):
        cfg, params = model
        eng = ServingEngine(cfg, params, EngineConfig(
            n_units=1, elasticity=None, result_cache=False,
            prefix_cache=prefix_cache, heuristic="EDF", merging="none",
            max_len=64, kv_block_size=4, batching=batching), device="cpu")
        router = Router([Plane(eng, pid=0)], policy="round-robin",
                        shared_detector=False)
        pool = SessionPool(SessionConfig(
            users=users, turns=turns, arrival_rate=0.2,
            think=("uniform", 5.0, 10.0), deadline=500.0, vocab=250,
            seed=7))
        if items is not None:
            pop = pool.pop

            def recorded_pop():
                t, item = pop()
                items[(item.session, item.turn)] = item
                return t, item

            pool.pop = recorded_pop
        stats = WorkloadDriver(router, pool, record_hit_depth=True).run()
        return stats, pool.summary()

    def test_turn_hit_depth_monotone_and_positive(self, model):
        """Turn k's prefix hit depth >= turn k-1's, strictly positive once
        the cache is warm: each turn re-arrives with the grown prefix and
        finds the previous turn's KV blocks."""
        stats, s = self._run(model, users=3, turns=4)
        assert s["sessions_done"] == 3
        depths = [r["mean_hit_depth"] for r in s["per_turn"]]
        assert depths[0] == 0.0                  # cold start
        assert all(b >= a for a, b in zip(depths, depths[1:]))
        assert depths[-1] > 0.0
        assert stats["prefix_hits"] > 0
        assert stats["prefix_tokens_reused"] > 0

    def test_multi_turn_beats_single_shot_baseline(self, model):
        """The closed-loop multi-turn hit rate is strictly above the
        single-shot baseline's (the same arrival volume, turns=1: prompts
        never repeat, so the prefix cache cannot help)."""
        multi, _ = self._run(model, users=3, turns=3)
        single, _ = self._run(model, users=9, turns=1)
        multi_rate = multi["prefix_hits"] / max(1, multi["executions"])
        single_rate = single["prefix_hits"] / max(1, single["executions"])
        assert multi_rate > single_rate
        assert single["prefix_hits"] == 0

    def test_batched_sessions_keep_tokens_with_the_cache_off(self, model):
        """Under continuous batching, the same sessions with the prefix
        cache off give the same greedy tokens turn by turn (phase 4d (b)
        of ``chip_smoke.py`` at full width on the card)."""
        runs = []
        for prefix_cache in (True, False):
            items = {}
            stats, s = self._run(
                model, users=3, turns=4, prefix_cache=prefix_cache,
                batching=StepBatchingConfig(max_batch=4,
                                            step_token_budget=16),
                items=items)
            assert s["sessions_done"] == 3 and len(items) == 12
            assert all(r.status == "done" and len(r.tokens) == 2
                       for r in items.values())
            runs.append((stats, {k: r.tokens for k, r in items.items()}))
        (on, toks_on), (off, toks_off) = runs
        assert on["prefix_hits"] > 0 and off["prefix_hits"] == 0
        assert on["prefill_tokens"] < off["prefill_tokens"]
        assert toks_on == toks_off
