"""The port's Chapter 4/5 workload generators (``repro_torch.core.workload``
over ``repro_torch.serving.workload.generators``) against the JAX package's.

* Both generators are draw-for-draw equal: every task's id (relative to
  the first), type, operation, parameters, user, arrival, deadline and
  video/segment, the video table, the PET matrix and the machines — exact
  equality, since both run the same numpy draws.
* The twins of ``tests/test_workload.py::TestGenerators``.
* ``examples/quickstart.py``'s two demos, at reduced task counts, give
  equal ``SimStats`` (wall-clock fields aside) in both packages.
"""

import copy
import dataclasses

import pytest

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
from repro_torch.serving.workload import generators


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
