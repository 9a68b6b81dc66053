"""Tenant SLO tiers and per-tenant QoS accounting (DESIGN.md §2.11).

A :class:`TenantSpec` is one service tier: a relative arrival ``share``, a
``slack`` multiplier on the workload's base deadline allowance, and a
``priority`` that rides into ``Task.priority``.  The workload pools stamp
the tier name on every Request/Task (``tenant=``), the control plane turns
it into an observability label (lifecycle events + ``tenant_*`` metrics —
see ``ControlPlane._tel_finish``), and the :class:`TenantBook` keeps the
generator-side ledger: submitted / completed / on-time / dropped / latency
per tier, summarized into the benchmark and CLI outputs.

A copy of ``repro.serving.workload.tenancy`` for the port, unchanged but for this line.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["TenantSpec", "TenantBook", "DEFAULT_TENANT", "parse_tenants"]


@dataclass(frozen=True)
class TenantSpec:
    name: str
    share: float = 1.0      # relative arrival share (normalized over tiers)
    slack: float = 1.0      # multiplier on the workload's base deadline slack
    priority: int = 0       # rides into Task.priority


DEFAULT_TENANT = TenantSpec("default")


def parse_tenants(spec: str) -> list[TenantSpec]:
    """Parse ``name[:share[:slack[:priority]]],...`` (the ``--tenants`` CLI
    flag), e.g. ``gold:0.3:0.5:1,free:0.7:1.0:0``."""
    out = []
    for part in spec.split(","):
        f = part.strip().split(":")
        if not f or not f[0]:
            raise ValueError(f"empty tenant entry in {spec!r}")
        out.append(TenantSpec(
            name=f[0],
            share=float(f[1]) if len(f) > 1 else 1.0,
            slack=float(f[2]) if len(f) > 2 else 1.0,
            priority=int(f[3]) if len(f) > 3 else 0))
    return out


class TenantBook:
    """Per-tenant ledger filled from completion callbacks.

    ``pick(u)`` maps a uniform draw to a tier by arrival share — a pure
    function of the draw, so tier assignment is deterministic per session
    regardless of completion order.
    """

    def __init__(self, tenants):
        self.tenants = list(tenants) or [DEFAULT_TENANT]
        total = sum(t.share for t in self.tenants)
        if total <= 0:
            raise ValueError("tenant shares must sum to > 0")
        acc, self._cum = 0.0, []
        for t in self.tenants:
            acc += t.share / total
            self._cum.append(acc)
        self.acct = {t.name: {"submitted": 0, "completed": 0, "on_time": 0,
                              "dropped": 0, "latency_sum": 0.0}
                     for t in self.tenants}

    def pick(self, u: float) -> TenantSpec:
        for t, edge in zip(self.tenants, self._cum):
            if u < edge:
                return t
        return self.tenants[-1]

    # -- ledger ---------------------------------------------------------------
    def note_submit(self, name: str) -> None:
        self.acct[name]["submitted"] += 1

    def note_done(self, name: str, latency: float, on_time: bool) -> None:
        a = self.acct[name]
        a["completed"] += 1
        a["latency_sum"] += latency
        if on_time:
            a["on_time"] += 1

    def note_drop(self, name: str) -> None:
        self.acct[name]["dropped"] += 1

    def summary(self) -> dict:
        out = {}
        for t in self.tenants:
            a = self.acct[t.name]
            done = a["completed"]
            out[t.name] = {
                "share": t.share, "slack": t.slack, "priority": t.priority,
                "submitted": a["submitted"], "completed": done,
                "on_time": a["on_time"], "dropped": a["dropped"],
                "on_time_rate": (a["on_time"] / done) if done else 0.0,
                "mean_latency": (a["latency_sum"] / done) if done else 0.0,
            }
        return out
