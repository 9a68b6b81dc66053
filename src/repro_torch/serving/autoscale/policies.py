"""Scaler policies, registered like ``HEURISTICS``/``ROUTER_POLICIES``.

A policy maps one ``ScaleSignals`` snapshot to a decision in {-1, 0, +1}
(retire one unit / hold / add one unit); the ``PoolScaler`` driver owns
bounds, cooldown and accounting, so a decision the pool cannot honour
(ceiling hit, no idle unit to retire) is simply a hold.

* ``queue``          — the legacy queue-length hysteresis, kept verbatim so
  pre-subsystem decision traces reproduce exactly (equivalence-tested).
* ``success-chance`` — Ch. 5: scale up when the batch's aggregate chance of
  success degrades, scale down when it is comfortably high and the queue
  has drained.  Queue depth alone never triggers spend.
* ``cost-aware``     — success-chance pressure fed through the Eq. 5.11
  EWMA + Schmitt trigger (``core.oversubscription.DropToggle``), gated by
  an explicit machine-seconds budget: noisy pressure cannot chatter the
  pool, and once the extra-capacity budget is burned the pool only drains.
"""

from __future__ import annotations

from ...core.oversubscription import DropToggle
from .config import ElasticityConfig
from .signals import ScaleSignals

__all__ = ["ScalerPolicy", "QueueScaler", "SuccessChanceScaler",
           "CostAwareScaler", "SCALER_POLICIES", "make_scaler_policy"]


class ScalerPolicy:
    name = "base"
    #: stateful policies must observe *every* decision point (their EWMA
    #: keeps decaying/charging through cooldown windows); stateless ones
    #: are skipped during cooldown — their verdict would be discarded
    stateful = False

    def __init__(self, cfg: ElasticityConfig):
        self.cfg = cfg

    def decide(self, sig: ScaleSignals) -> int:
        """-1 retire one unit, 0 hold, +1 add one unit."""
        raise NotImplementedError


class QueueScaler(ScalerPolicy):
    """Legacy hysteresis: up while the batch queue is long, down when it
    falls to the low-water mark."""
    name = "queue"

    def decide(self, sig: ScaleSignals) -> int:
        if sig.qlen >= self.cfg.scale_up_queue:
            return 1
        if sig.qlen <= self.cfg.scale_down_queue:
            return -1
        return 0


class SuccessChanceScaler(ScalerPolicy):
    """Scale on degrading batch success chance, not on queue depth.

    ``pressure_signal="osl"`` (ElasticityConfig) swaps the Ch. 5 chance
    convolution for the Eq. 4.3 oversubscription level over the machine
    queues: deadline-miss *severity* as the pressure — no PMF math on the
    decision path, reacting to work already mapped rather than queued."""
    name = "success-chance"

    def decide(self, sig: ScaleSignals) -> int:
        if sig.qlen == 0:
            return -1                       # idle: drain extras
        if self.cfg.pressure_signal == "osl":
            o = sig.osl()
            if o >= self.cfg.osl_up:
                return 1
            if o <= self.cfg.osl_down and \
                    sig.qlen <= self.cfg.scale_down_queue:
                return -1
            return 0
        p = sig.chance()
        if p <= self.cfg.low_chance:
            return 1
        if p >= self.cfg.high_chance and sig.qlen <= self.cfg.scale_down_queue:
            return -1
        return 0


class CostAwareScaler(ScalerPolicy):
    """Success-chance pressure through a Schmitt trigger, on a budget.

    The at-risk counter (queued tasks whose chance <= ``low_chance``; with
    ``pressure_signal="osl"``, the Eq. 4.3 severity itself) is
    EWMA-smoothed exactly like the pruner's miss counter (Eq. 5.11); the
    20%-separation Schmitt trigger keeps a noisy boundary workload from
    flapping units up and down.  ``budget_machine_seconds`` bounds the
    *extra* (above-base) machine-seconds this scaler may ever spend, and
    ``budget_cost`` bounds the per-mtype-billed extra cost (Fig. 5.19 —
    cheap extras burn it slower): over either budget, scale-ups stop and
    the extras drain as they fall idle.
    """
    name = "cost-aware"
    stateful = True

    def __init__(self, cfg: ElasticityConfig):
        super().__init__(cfg)
        self.toggle = DropToggle(lam=cfg.pressure_lam,
                                 on_level=cfg.pressure_on, use_schmitt=True)

    def decide(self, sig: ScaleSignals) -> int:
        pressure = (sig.osl() if self.cfg.pressure_signal == "osl"
                    else sig.at_risk(self.cfg.low_chance))
        # subscribed SLO burn (obs.slo) rides on top of the local pressure:
        # a tenant burning its error budget at the alert threshold
        # contributes a full engage level even when this pool's own queue
        # looks healthy (burn pressure is fleet-wide, normalized to 1.0 at
        # the alert threshold).  Reads 0.0 when no monitor is attached.
        burn = sig.slo_burn()
        if burn > 0.0:
            pressure += self.cfg.slo_weight * self.cfg.pressure_on * burn
        engaged = self.toggle.observe(pressure)
        over_budget = (sig.extra_machine_seconds
                       >= self.cfg.budget_machine_seconds
                       or sig.extra_cost >= self.cfg.budget_cost)
        if over_budget:
            return -1
        if engaged:
            return 1
        if sig.qlen <= self.cfg.scale_down_queue:
            return -1
        return 0


SCALER_POLICIES = {p.name: p for p in
                   [QueueScaler, SuccessChanceScaler, CostAwareScaler]}


def make_scaler_policy(name: str, cfg: ElasticityConfig) -> ScalerPolicy:
    key = name.lower()
    if key not in SCALER_POLICIES:
        raise KeyError(f"unknown scaler policy {name!r}; "
                       f"have {sorted(SCALER_POLICIES)}")
    return SCALER_POLICIES[key](cfg)
