"""Adaptive behaviour under an oversubscription wave (Ch. 4 §4.5 + Ch. 5).

Replays an arrival wave that ramps from idle to 4x capacity and back while
printing the engine-side signals: the OSL-driven merge aggressiveness
(alpha), the EWMA drop toggle, and the dynamic deferring threshold.

    PYTHONPATH=src python -m repro_torch.examples.oversubscription_demo

The port of ``examples/oversubscription_demo.py``, on the port's copies of
``core/``.
"""

import copy

from ..core.oversubscription import adaptive_alpha
from ..core.pruning import PruningConfig
from ..core.simulation import PETOracle, SimConfig, Simulator
from ..core.workload import spiky_hc_workload


class InstrumentedSim(Simulator):
    """Samples the control-plane signals after every 40th mapping event
    (the ``after_mapping`` observer hook — no loop subclassing needed)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.trace = []
        self.cp.after_mapping = self._observe

    def _observe(self, cp):
        if cp.pruner is not None and cp.stats["mapping_events"] % 40 == 0:
            self.trace.append({
                "t": round(cp.now, 1),
                "queue": len(cp.batch),
                "ewma_misses": round(cp.pruner.toggle.d, 2),
                "dropping": cp.pruner.toggle.engaged,
                "defer_thr": round(cp.pruner.defer_threshold, 2),
            })


def main():
    wl = spiky_hc_workload(800, span=300.0, seed=5)
    sim = InstrumentedSim(
        [copy.copy(t) for t in wl.tasks],
        [copy.deepcopy(m) for m in wl.machines],
        PETOracle(wl.pet, seed=6),
        SimConfig(heuristic="PAM",
                  pruning=PruningConfig(dynamic_defer=True, theta=0.1,
                                        max_defer_threshold=0.6,
                                        base_drop_threshold=0.25, rho=0.1),
                  hard_deadlines=True, seed=1))
    stats = sim.run()
    print(f"{'t':>7} {'queue':>6} {'EWMA misses':>12} {'dropping':>9} "
          f"{'defer thr':>10}")
    for row in sim.trace:
        print(f"{row['t']:7.1f} {row['queue']:6d} {row['ewma_misses']:12.2f} "
              f"{str(row['dropping']):>9} {row['defer_thr']:10.2f}")
    print(f"\non-time {stats.on_time}/{stats.n_requests} "
          f"(dropped {stats.dropped}, deferr-events {stats.deferred})")
    print(f"example adaptive alpha at OSL 0 / 0.25 / 0.5 / 1.0: "
          f"{[adaptive_alpha(x) for x in (0.0, 0.25, 0.5, 1.0)]}")


if __name__ == "__main__":
    main()
