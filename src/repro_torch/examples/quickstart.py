"""Quickstart: the paper's two mechanisms in 60 seconds.

    PYTHONPATH=src python -m repro_torch.examples.quickstart

The port of ``examples/quickstart.py``, on the port's copies of ``core/``:

1. Builds an oversubscribed heterogeneous workload.
2. Schedules it with a plain Min-Min mapper, then with the probabilistic
   pruning mechanism plugged in (dropping + deferring, Ch. 5).
3. Replays a video-style workload with task merging (Ch. 4) and shows the
   makespan/cost saving.
"""

import copy

import numpy as np

from ..core.pruning import PruningConfig
from ..core.simulation import PETOracle, SimConfig, Simulator, VideoOracle
from ..core.tasks import Machine
from ..core.workload import spiky_hc_workload, video_streaming_workload


def pruning_demo():
    print("=== probabilistic task pruning (Ch. 5) ===")
    wl = spiky_hc_workload(600, span=300.0, seed=5)
    for label, prune in (
            ("MSD (no pruning)   ", None),
            ("MSD-P (drop+defer) ",
             PruningConfig(initial_defer_threshold=0.3,
                           base_drop_threshold=0.25, rho=0.1))):
        sim = Simulator([copy.copy(t) for t in wl.tasks],
                        [copy.deepcopy(m) for m in wl.machines],
                        PETOracle(wl.pet, seed=6),
                        SimConfig(heuristic="MSD", pruning=prune,
                                  hard_deadlines=True, seed=1))
        s = sim.run()
        print(f"  {label} on-time: {s.on_time}/{s.n_requests} "
              f"(robustness {s.robustness:.2f}), "
              f"cost/on-time-task {s.cost / max(s.on_time, 1):.1f}")


def merging_demo():
    print("=== computational reuse via task merging (Ch. 4) ===")
    for label, merging in (("no merging", "none"), ("adaptive  ", "adaptive")):
        wl = video_streaming_workload(1000, span=350.0, seed=7)
        machines = [Machine(mid=i, queue_size=4) for i in range(8)]
        sim = Simulator([copy.copy(t) for t in wl.tasks], machines,
                        VideoOracle(wl.exec_model, wl.videos, seed=3),
                        SimConfig(heuristic="FCFS-RR", merging=merging,
                                  seed=1))
        s = sim.run()
        print(f"  {label}  makespan {s.makespan:7.1f}s  "
              f"miss-rate {100 * s.miss_rate:4.1f}%  merges {s.merges}")


if __name__ == "__main__":
    np.random.seed(0)
    pruning_demo()
    merging_demo()
