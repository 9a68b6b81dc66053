"""Telemetry-fitted execution oracles (DESIGN.md §2.12).

``fit_oracle`` turns one flight-record artifact (``obs.recorder``) into a
:class:`FittedOracle` — the measured counterpart of the dissertation's
analytical PET matrix.  Two estimation layers:

  * **Span fits** — per ``(task type, machine type)`` mean/std of the
    recorded ``exec_start``/``exec_end`` spans, normalized to speed-1.0
    machine units (span × recorded machine speed), so the fit transfers
    across a heterogeneous fleet exactly the way ``PETOracle`` divides by
    ``machine.speed``.
  * **Rate fallback** — when a (ttype, mtype) pair was never executed in
    the recording, price it from the latest ``TimeEstimator`` EWMA
    snapshot's calibrated per-token rates (prompt tokens × prefill rate +
    decoded tokens × decode rate), the same cold formula the live engine
    uses.

The oracle implements the ``ExecOracle`` protocol (``mean_std`` / ``pmf`` /
``sample``) and deliberately keys on nothing but task *content* (ttype,
prompt length) and machine *type* — no per-substrate state — so installing
it into ``Simulator(...)`` and ``ServingEngine(stub_oracle=...)`` yields
identical decisions on identical traces.  Module scope is stdlib-only;
``pmf()`` lazy-imports the numpy PMF machinery.

A copy of ``repro.obs.fit`` for the port, unchanged but for this line.
"""

from __future__ import annotations

import random
from statistics import fmean, pstdev

__all__ = ["FittedOracle", "fit_oracle", "fit_table"]


class FittedOracle:
    """ExecOracle fitted from recorded telemetry (see module docstring)."""

    def __init__(self, table: dict, prefill_rate: float = 5.0 / 64.0,
                 decode_rate: float = 20.0 / 64.0, rel_std: float = 0.15,
                 default_plen: int = 64, default_n_new: int = 8,
                 seed: int = 0):
        self.table = dict(table)          # (ttype, mtype) -> (mean, std, n)
        self.prefill_rate = prefill_rate
        self.decode_rate = decode_rate
        self.rel_std = rel_std
        self.default_plen = default_plen
        self.default_n_new = default_n_new
        self._rng = random.Random(seed)
        self._cache: dict = {}

    def _base(self, task, machine) -> tuple[float, float]:
        """(mean, std) at machine speed 1.0, content-keyed only."""
        row = self.table.get((task.ttype, machine.mtype))
        if row is not None:
            mu, sd = row[0], row[1]
        else:
            plen = len(task.tokens) if task.tokens else self.default_plen
            mu = (plen * self.prefill_rate
                  + self.default_n_new * self.decode_rate)
            sd = self.rel_std * mu
        # floors keep the PMF machinery sane without drowning tightly
        # fitted spans: a near-deterministic measured stage must replay
        # near-deterministically, or queueing overlap inflates the drift
        return max(mu, 1.0), max(sd, 0.05)

    # -- ExecOracle protocol --------------------------------------------------
    def mean_std(self, task, machine) -> tuple[float, float]:
        key = (task.ttype, machine.mtype, machine.speed,
               len(task.tokens) if task.tokens else None)
        hit = self._cache.get(key)
        if hit is None:
            mu, sd = self._base(task, machine)
            hit = (mu / machine.speed, sd / machine.speed)
            self._cache[key] = hit
        return hit

    def pmf(self, task, machine):
        from ..core.pmf import PMF
        mu, sd = self.mean_std(task, machine)
        return PMF.from_normal(mu, sd)

    def sample(self, task, machine) -> float:
        mu, sd = self.mean_std(task, machine)
        return max(0.5, self._rng.gauss(mu, sd))

    def summary(self) -> dict:
        """Fit table in JSON-friendly form (benchmark/report food)."""
        return {f"{tt}@{mt}": {"mean": round(mu, 4), "std": round(sd, 4),
                               "count": n}
                for (tt, mt), (mu, sd, n) in sorted(self.table.items())}


def fit_table(record: dict) -> dict:
    """Per-(ttype, mtype) span fits from a flight record's event stream."""
    machines = {m["mid"]: m for m in record.get("machines", [])}
    ttype_of: dict = {}
    open_spans: dict = {}
    samples: dict = {}
    for ev in record.get("events", []):
        kind = ev.get("kind")
        if kind == "arrive" and "req" in ev:
            ttype_of[ev["req"]] = ev.get("ttype", "generate")
        elif kind == "exec_start":
            open_spans[(ev.get("machine"), ev.get("task"))] = ev["t"]
        elif kind == "exec_end":
            key = (ev.get("machine"), ev.get("task"))
            t0 = open_spans.pop(key, None)
            if t0 is None:
                continue
            m = machines.get(key[0], {})
            span = (ev["t"] - t0) * m.get("speed", 1.0)
            tt = ttype_of.get(key[1], "generate")
            samples.setdefault((tt, m.get("mtype", "m0")), []).append(span)
    return {k: (fmean(v), pstdev(v) if len(v) > 1 else 0.0, len(v))
            for k, v in samples.items() if v}


def fit_oracle(record: dict, seed: int = 0) -> FittedOracle:
    """Fit a :class:`FittedOracle` from one flight-record artifact."""
    table = fit_table(record)
    kw: dict = {"seed": seed}
    snaps = record.get("estimator_snapshots") or []
    if snaps:
        est = snaps[-1].get("estimator", {})
        kw["prefill_rate"] = float(est.get("prefill_rate", 5.0 / 64.0))
        kw["decode_rate"] = float(est.get("decode_rate", 20.0 / 64.0))
        kw["rel_std"] = float(est.get("rel_std", 0.15))
    arrivals = record.get("arrivals") or []
    n_new = [a["n_new"] for a in arrivals
             if a.get("type") == "request" and "n_new" in a]
    plens = [len(a["prompt"]) for a in arrivals
             if a.get("type") == "request" and a.get("prompt")]
    if n_new:
        kw["default_n_new"] = max(1, round(fmean(n_new)))
    if plens:
        kw["default_plen"] = max(1, round(fmean(plens)))
    return FittedOracle(table, **kw)
