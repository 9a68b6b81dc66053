"""The PoolScaler driver: policy decisions applied to a concrete pool.

One driver serves all three elasticity levels: the serving engine's
processing units, the simulator's machine clones, and the Router's planes
each expose a tiny pool adapter (size / grow / shrink) and call
``step(now, signals)`` from their scaling seam (``Substrate.
before_mapping`` for substrates, ``Router.submit`` for the plane pool).
The driver owns what every level shares: the base-pool floor and
``max_extra`` ceiling, the cooldown, and per-decision accounting —
``scale_ups``/``scale_downs``, the machine-seconds integral (total and
above-base), and warm-up charges — surfaced uniformly through each
owner's ``collect_stats()``.
"""

from __future__ import annotations

from typing import Protocol

from .config import ElasticityConfig
from .policies import make_scaler_policy
from .signals import ScaleSignals, substrate_signals
from ...obs.telemetry import NULL

__all__ = ["MachinePool", "PoolScaler"]


class MachinePool(Protocol):
    """What the driver needs from a concrete pool."""

    def size(self) -> int: ...

    def grow(self, now: float) -> float | None:
        """Add one unit; return its warm-up charge in virtual ticks
        (0.0 for instant starts), or None when the pool cannot grow."""

    def shrink(self, now: float) -> bool:
        """Retire one idle unit (never lose queued work); False when no
        unit is currently retirable."""

    # optional: summed per-machine cost rate of the live pool.  Pools that
    # omit it are billed homogeneously (rate == size, the pre-fleet model).
    # def cost_rate(self) -> float: ...


class PoolScaler:
    def __init__(self, cfg: ElasticityConfig, pool: MachinePool,
                 base_units: int):
        self.cfg = cfg
        self.pool = pool
        self.base = base_units
        self.policy = make_scaler_policy(cfg.policy, cfg)
        self.stats = {"scale_ups": 0, "scale_downs": 0,
                      "scale_decisions": 0, "machine_seconds": 0.0,
                      "extra_machine_seconds": 0.0, "pool_cost": 0.0,
                      "extra_pool_cost": 0.0, "warmup_ticks": 0.0}
        self._last = 0.0
        self._cooldown_until = 0.0
        #: telemetry recorder + the pool level it reports as ("units",
        #: "machines", "planes"); pure recording, never read back
        self.tel = NULL
        self.scope = "units"
        #: optional SLO burn signal (obs.slo.SLOMonitor.pressure via
        #: ``attach_slo``); surfaced to policies as ``sig.slo_burn()``
        self.slo_fn = None
        #: torch device of the batched ``pmf_conv`` success-chance launch;
        #: set by the owner (engine, simulator or Router) to its own device
        #: (None resolves to CUDA)
        self.device = None
        #: the base pool's summed cost rate, captured before any scaling:
        #: spend above it is what the cost budgets gate
        self._base_rate = self._pool_rate()

    def _pool_rate(self) -> float:
        fn = getattr(self.pool, "cost_rate", None)
        return float(fn()) if fn is not None else float(self.pool.size())

    # -- cost accounting ------------------------------------------------------
    def sync(self, now: float) -> None:
        """Advance the machine-seconds and cost integrals to ``now``
        (idempotent).  Cost is billed per machine type: the pool reports
        its summed ``cost_rate`` (Fig. 5.19's per-machine rate), so a
        cheap extra unit burns budget slower than an expensive one — the
        pre-fleet model (rate == unit count) is the homogeneous special
        case."""
        dt = now - self._last
        if dt <= 0.0:
            return
        n = self.pool.size()
        rate = self._pool_rate()
        self.stats["machine_seconds"] += n * dt
        self.stats["extra_machine_seconds"] += max(n - self.base, 0) * dt
        self.stats["pool_cost"] += rate * dt
        self.stats["extra_pool_cost"] += max(rate - self._base_rate, 0.0) * dt
        self._last = now

    @property
    def extra_machine_seconds(self) -> float:
        return self.stats["extra_machine_seconds"]

    @property
    def extra_pool_cost(self) -> float:
        return self.stats["extra_pool_cost"]

    # -- the decision step ----------------------------------------------------
    def step(self, now: float, sig: ScaleSignals) -> int:
        """Evaluate one scaling decision; returns the action taken
        (-1 retired a unit, 0 held, +1 added one)."""
        self.sync(now)
        # the signal snapshot may have been built before the sync: refresh
        # the spend so the cost-aware budget gates see the integrals *as of
        # now*, not as of the previous decision
        sig.extra_machine_seconds = self.extra_machine_seconds
        sig.extra_cost = self.extra_pool_cost
        # a stateful policy's EWMA (cost-aware) observes every decision
        # point — it must keep decaying/charging through cooldown windows,
        # which only suppress *actions*; a stateless policy's verdict would
        # be discarded, so skip its (possibly kernel-launching) evaluation
        in_cooldown = now < self._cooldown_until
        if in_cooldown and not self.policy.stateful:
            return 0
        act = self.policy.decide(sig)
        self.stats["scale_decisions"] += 1
        if in_cooldown:
            return 0
        if act > 0 and self.pool.size() < self.base + self.cfg.max_extra:
            charge = self.pool.grow(now)
            if charge is not None:
                self.stats["scale_ups"] += 1
                self.stats["warmup_ticks"] += charge
                self._cooldown_until = now + self.cfg.cooldown
                self.tel.event(now, "scale_up", scope=self.scope,
                               size=self.pool.size(), warmup=charge)
                self.tel.metrics.inc("scale_ups", scope=self.scope)
                return 1
        elif act < 0 and self.pool.size() > self.base:
            if self.pool.shrink(now):
                self.stats["scale_downs"] += 1
                self._cooldown_until = now + self.cfg.cooldown
                self.tel.event(now, "scale_down", scope=self.scope,
                               size=self.pool.size())
                self.tel.metrics.inc("scale_downs", scope=self.scope)
                return -1
        return 0

    def attach_slo(self, monitor) -> None:
        """Subscribe this pool to a per-tenant SLO burn-rate monitor
        (``obs.slo.SLOMonitor``): its ``pressure()`` rides into every
        ``ScaleSignals`` snapshot as ``slo_burn()``, which the cost-aware
        policy folds into its Schmitt-trigger pressure."""
        self.slo_fn = monitor.pressure

    def step_substrate(self, now: float, cp, machines, oracle) -> int:
        """``step`` with signals built from a control-plane substrate —
        the one-liner engines and simulators call from ``before_mapping``."""
        return self.step(now, substrate_signals(self, cp, machines, oracle,
                                                now))
