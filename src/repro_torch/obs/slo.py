"""Per-tenant SLO error-budget burn-rate monitors (DESIGN.md §2.12).

Each tenant tier (``serving.workload.TenantSpec``) carries an *on-time
objective*; its error budget is ``1 - objective``.  :class:`SLOMonitor`
watches the per-tenant lifecycle counters the control plane already emits
into the shared metrics registry (``tenant_completed`` / ``tenant_missed``
/ ``tenant_dropped``, DESIGN.md §2.11) and computes the classic
multi-window burn rate: over each trailing window the observed error rate
divided by the budget.  A burn of 1.0 spends the budget exactly at the
sustainable rate; an alert fires only when *every* configured window
burns above ``burn_threshold`` (the short window proves the problem is
live, the long window proves it is not a blip).

On alert the monitor emits an ``slo_alert`` telemetry event (schema 3,
``obs.schema.validate_slo_alert``), bumps ``slo_alerts{tenant=...}`` and
keeps ``slo_burn{tenant=...}`` gauges fresh.  ``pressure()`` exposes the
fleet-wide burn (max over tenants, normalized by the threshold) as a lazy
signal the autoscaler's cost-aware policy subscribes to via
``PoolScaler.attach_slo`` -> ``ScaleSignals.slo_burn()`` — detached, the
signal reads 0.0 and every existing decision trace is untouched.

The monitor only *reads* counters and *writes* events/gauges — nothing on
the decision path consults it unless explicitly subscribed, so attaching
one is zero-perturbation by the same argument as the recorder.

A copy of ``repro.obs.slo`` for the port, unchanged but for this line
and a cross-reference to DESIGN.md in place of a change number.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["SLOConfig", "SLOMonitor"]


@dataclass
class SLOConfig:
    objective: float = 0.95            # default on-time objective
    objectives: dict = field(default_factory=dict)  # per-tenant overrides
    windows: tuple = (60.0, 300.0)     # trailing windows, virtual time
    burn_threshold: float = 2.0        # alert when every window burns past
    min_requests: int = 5              # per window; below = not enough data
    cooldown: float = 60.0             # per-tenant re-alert spacing
    max_burn: float = 100.0            # cap (empty budgets would blow up)


class SLOMonitor:
    """Multi-window per-tenant burn-rate monitor over a Telemetry bus."""

    def __init__(self, tenants, tel, cfg: SLOConfig | None = None):
        self.cfg = cfg or SLOConfig()
        self.tel = tel
        self.tenants = [t if isinstance(t, str) else t.name for t in tenants]
        self._specs = {t.name: t for t in tenants
                       if not isinstance(t, str)}
        self._samples: list[tuple] = []    # (t, {tenant: counter 4-tuple})
        self._burn: dict[str, float] = {}
        self._last_alert: dict[str, float] = {}
        self.alerts: list[dict] = []

    def objective_for(self, tenant: str) -> float:
        return float(self.cfg.objectives.get(tenant, self.cfg.objective))

    def _counts(self) -> dict:
        m = self.tel.metrics
        return {t: (m.counter_value("tenant_completed", tenant=t),
                    m.counter_value("tenant_on_time", tenant=t),
                    m.counter_value("tenant_missed", tenant=t),
                    m.counter_value("tenant_dropped", tenant=t))
                for t in self.tenants}

    def _window_burn(self, now: float, tenant: str, window: float,
                     cur: tuple) -> float | None:
        """Burn over [now - window, now]; None = not enough data."""
        # baseline = newest sample at or before the window start; a run
        # younger than the window measures "since start", which is exact
        base = (0, 0, 0, 0)
        for t, counts in self._samples:
            if t > now - window:
                break
            base = counts.get(tenant, (0, 0, 0, 0))
        d_completed = cur[0] - base[0]
        d_missed = cur[2] - base[2]
        d_dropped = cur[3] - base[3]
        total = d_completed + d_dropped
        if total < self.cfg.min_requests:
            return None
        err = (d_missed + d_dropped) / total
        budget = max(1.0 - self.objective_for(tenant), 1e-3)
        return min(err / budget, self.cfg.max_burn)

    def step(self, now: float) -> list[dict]:
        """Sample counters, update burns, fire due alerts.  Returns the
        alerts fired at this step (also appended to ``self.alerts``)."""
        cur = self._counts()
        fired = []
        for tenant in self.tenants:
            burns = [self._window_burn(now, tenant, w, cur[tenant])
                     for w in self.cfg.windows]
            # multi-window AND: undetermined windows veto the alert
            alertable = [b for b in burns if b is not None]
            effective = (min(alertable)
                         if len(alertable) == len(self.cfg.windows) else 0.0)
            self._burn[tenant] = effective
            self.tel.metrics.gauge("slo_burn", round(effective, 6),
                                   tenant=tenant)
            if effective >= self.cfg.burn_threshold:
                last = self._last_alert.get(tenant)
                if last is None or now - last >= self.cfg.cooldown:
                    self._last_alert[tenant] = now
                    objective = self.objective_for(tenant)
                    err = effective * max(1.0 - objective, 1e-3)
                    alert = {"t": round(now, 9), "tenant": tenant,
                             "burn": round(effective, 6),
                             "objective": objective,
                             "error_rate": round(min(err, 1.0), 6),
                             "window": max(self.cfg.windows)}
                    fired.append(alert)
                    self.alerts.append(alert)
                    self.tel.event(now, "slo_alert", tenant=tenant,
                                   burn=alert["burn"],
                                   objective=objective,
                                   error_rate=alert["error_rate"],
                                   window=alert["window"])
                    self.tel.metrics.inc("slo_alerts", tenant=tenant)
        self._samples.append((now, cur))
        horizon = now - max(self.cfg.windows)
        while len(self._samples) > 1 and self._samples[1][0] <= horizon:
            self._samples.pop(0)
        return fired

    # -- subscriptions --------------------------------------------------------
    def pressure(self) -> float:
        """Fleet-wide burn signal for the autoscaler: max per-tenant burn
        over the full multi-window AND, normalized so 1.0 = alerting."""
        if not self._burn:
            return 0.0
        return max(self._burn.values()) / max(self.cfg.burn_threshold, 1e-9)

    def attach(self, substrate) -> None:
        """Step the monitor after every mapping event of a substrate's
        control plane (chains any existing ``after_mapping`` hook)."""
        cp = getattr(substrate, "cp", substrate)
        prev = cp.after_mapping

        def hook(cp_):
            if prev is not None:
                prev(cp_)
            self.step(cp_.now)

        cp.after_mapping = hook

    def summary(self) -> dict:
        per_alerts: dict[str, int] = {}
        for a in self.alerts:
            per_alerts[a["tenant"]] = per_alerts.get(a["tenant"], 0) + 1
        return {t: {"objective": self.objective_for(t),
                    "burn": round(self._burn.get(t, 0.0), 6),
                    "alerts": per_alerts.get(t, 0)}
                for t in self.tenants}
