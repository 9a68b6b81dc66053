"""The one elasticity knob-set shared by engines, simulators and the Router.

Before this subsystem the engine (``EngineConfig``) and the simulator
(``SimConfig``) carried duplicated ``scale_up_queue``/``scale_down_queue``
field pairs feeding two divergent inline hysteresis loops; the Router had
no elasticity at all.  ``ElasticityConfig`` is the deduplicated
configuration: pool headroom, the policy name (a ``SCALER_POLICIES`` key),
the legacy queue thresholds, the Ch. 5 success-chance thresholds and the
cost-aware machine-seconds budget — consumed uniformly by every level.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ElasticityConfig"]


@dataclass
class ElasticityConfig:
    """Elasticity of one machine pool (or of the Router's plane pool).

    The *base pool* is whatever the owner starts with (``EngineConfig.
    n_units`` units, the simulator's constructor machines, the Router's
    constructor planes); the scaler may add up to ``max_extra`` units above
    it and never retires below it.  ``max_extra == 0`` disables scaling
    (the pool stays fixed, decisions are never evaluated).
    """

    policy: str = "queue"          # SCALER_POLICIES key
    max_extra: int = 0             # units above the base pool (0 = disabled)
    cooldown: float = 0.0          # virtual ticks between scale actions
    # -- legacy queue-length hysteresis (policy "queue"; also the
    #    drained-queue gate of the probabilistic policies) -------------------
    scale_up_queue: int = 12       # batch-queue length to add a unit
    scale_down_queue: int = 2      # batch-queue length to retire one
    # -- success-chance signal (policies "success-chance"/"cost-aware") ------
    low_chance: float = 0.5        # scale up when aggregate chance <= this
    high_chance: float = 0.9       # scale down when >= this (queue drained)
    signal_tasks: int = 32         # cap on batch tasks scored per decision
    signal_grid: int = 64          # PMF grid length for the batched kernel
    use_kernel: bool = True        # batched pmf_conv (the CUDA kernel on the card)
    # -- pressure-signal selection -------------------------------------------
    # what the probabilistic policies react to: "chance" (the Ch. 5
    # batched chance-of-success) or "osl" (Eq. 4.3 oversubscription level
    # over the machine queues — deadline-miss *severity*, no convolution)
    pressure_signal: str = "chance"
    osl_up: float = 0.25           # scale up when OSL >= this
    osl_down: float = 0.05         # scale down when <= this (queue drained)
    # -- cost model (policy "cost-aware") ------------------------------------
    # budget of *extra* machine-seconds (above the base pool) the scaler may
    # spend over the run; once burned, scale-ups stop and extras drain
    budget_machine_seconds: float = float("inf")
    # budget of extra *cost* (per-mtype cost_rate integral above the base
    # pool, Fig. 5.19) — on a heterogeneous fleet a cheap extra unit burns
    # this slower than an expensive one
    budget_cost: float = float("inf")
    pressure_lam: float = 0.3      # EWMA weight of the pressure counter
    pressure_on: float = 2.0       # Schmitt-trigger engage level (Eq. 5.11);
    #                                tune down (~osl_up) with "osl" pressure
    # -- SLO burn subscription (obs.slo, DESIGN.md §2.12) --------------------
    # weight of the per-tenant SLO burn signal added to the cost-aware
    # pressure when a monitor is attached (``PoolScaler.attach_slo``);
    # the signal reads 0.0 when none is, so existing traces are untouched.
    # Scaled by ``pressure_on`` so a tenant at its alert threshold
    # (burn pressure 1.0) engages the trigger by itself at weight 1.0.
    slo_weight: float = 1.0
