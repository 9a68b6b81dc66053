"""Closed-loop workload subsystem (DESIGN.md §2.11).

Substrate-independent traffic generation that *drives* the Router's
streaming ``submit/step/drain`` API instead of handing it a closed trace:

* :mod:`arrivals` — seeded :class:`ArrivalProcess` intensities (Poisson,
  diurnal two-peak, bursty spike-on-base) with O(1)-memory streaming
  generation; the Chapter 4/5 trace generators are re-hosted on top
  (:mod:`generators`, back-compat wrappers in ``repro.core.workload``).
* :mod:`sessions` — :class:`SessionPool`: per-user closed-loop multi-turn
  sessions with think times; every completion wakes the session and the
  next turn re-arrives with the conversation's grown token prefix.
* :mod:`staged` — :class:`StagedPool`: multi-stage request DAGs admitted
  stage-by-stage with residual-slack deadline propagation.
* :mod:`tenancy` — :class:`TenantSpec` SLO tiers (share/slack/priority)
  with per-tenant on-time/latency accounting.
* :mod:`driver` — :class:`WorkloadDriver`: the event-driven pump that
  interleaves generator arrivals with plane events on the virtual clock.

A copy of ``repro.serving.workload`` for the port, unchanged but for this
line; the trace generators (``generators``) are not copied.
"""

from .arrivals import (ArrivalProcess, BurstyProcess, DiurnalProcess,
                       PoissonProcess, SpikeSchedule, mix64, sample_think,
                       unit_float)
from .driver import WorkloadDriver
from .sessions import SessionConfig, SessionPool
from .staged import Stage, StagedConfig, StagedPool
from .tenancy import DEFAULT_TENANT, TenantBook, TenantSpec, parse_tenants

__all__ = [
    "ArrivalProcess", "PoissonProcess", "DiurnalProcess", "BurstyProcess",
    "SpikeSchedule", "mix64", "unit_float", "sample_think",
    "TenantSpec", "TenantBook", "DEFAULT_TENANT", "parse_tenants",
    "SessionConfig", "SessionPool",
    "Stage", "StagedConfig", "StagedPool",
    "WorkloadDriver",
]
