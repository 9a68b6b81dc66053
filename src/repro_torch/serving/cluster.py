"""Front-door Cluster/Router API — multi-plane serving (DESIGN.md §2.6).

The dissertation's front door load-balances many users across workers; the
reuse literature places the *admission point* — not the worker — where
merge/reuse decisions belong.  This module is that front door for the
repo's unified control plane: a :class:`Router` owning N *planes* (each a
``ControlPlane`` over a live engine, a stub-execution engine, or the
discrete-event simulator — mixed kinds allowed) behind a **streaming
session API**:

    router.submit(req, t)   # route one arrival (admission instant t)
    router.step(until)      # advance every plane's event loop
    stats = router.drain()  # run to quiescence, aggregate per-plane stats

``Router.run(trace)`` survives as a thin closed-trace wrapper — a 1-plane
router reproduces the bare ``ServingEngine.run`` admission/merge/map/drop/
finish decision sequence *exactly* (asserted in tests/test_cluster.py), so
every router policy is testable against a single-plane oracle run.

Routing consults a **shared cross-plane similarity view**
(:class:`CrossPlaneLookup`): one lookup over every plane's
``SimilarityDetector`` (identity levels: TASK / DATA_OP / DATA_ONLY) and
prefix-cache trie (PREFIX level), so duplicate or prefix-overlapping
requests can be steered to the plane already holding the merge target or
the cached KV blocks.  Policies are pluggable objects registered like the
mapping heuristics (``ROUTER_POLICIES`` / ``make_router_policy``); the
locality score they consume is the *same* ``find_prefix_overlap`` term the
per-plane heuristics score through ``MappingContext.prefix_overlap`` — one
scoring API at both levels.

No model code at module scope: simulator-only clusters import this without
the serving engine's PyTorch model machinery.

A copy of ``repro.serving.cluster`` for the port.  The two engine-plane
builders take a ``device`` (CUDA unless ``"cpu"`` is passed) and hand it
to every ``ServingEngine`` they build; nothing else changes.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from ..core.oversubscription import oversubscription_level
from ..core.simulation import Simulator
from ..core.tasks import Task
from ..obs.telemetry import NULL
from .autoscale import (ElasticityConfig, PoolScaler, ScaleSignals,
                        batch_chances)

__all__ = ["Plane", "Router", "RouterPolicy", "RoutingContext",
           "CrossPlaneLookup", "ROUTER_POLICIES", "make_router_policy",
           "make_engine_planes", "make_engine_plane_factory"]


# ---------------------------------------------------------------------------
# payload adaptation
# ---------------------------------------------------------------------------

def _probe(item, t: float) -> Task:
    """A throwaway Task carrying ``item``'s similarity keys, for read-only
    lookups against plane detectors (never enters any queue).  Non-Task
    payloads provide ``to_task`` (``Request`` does) — the same builder
    engine admission uses, so probe keys can never drift from engine keys."""
    if isinstance(item, Task):
        return item
    return item.to_task(t, 0)


# ---------------------------------------------------------------------------
# planes
# ---------------------------------------------------------------------------

class Plane:
    """One scheduling domain behind the front door: the control plane plus
    the substrate it drives (live engine, stub engine, or simulator)."""

    def __init__(self, substrate, pid: int = 0, name: str | None = None):
        self.sub = substrate
        self.pid = pid
        self.name = name or f"plane{pid}"
        self._ordinal = 0            # arrivals adapted into Tasks so far

    @property
    def cp(self):
        return self.sub.cp

    @property
    def detector(self):
        return self.sub.cp.detector

    @property
    def now(self) -> float:
        return self.sub.cp.now

    # -- routing signals ------------------------------------------------------
    def load(self) -> int:
        """Outstanding work: batch queue + unit queues + running tasks."""
        n = len(self.cp.batch)
        for m in self.sub.machines:
            n += len(m.queue)
            if m.running is not None and not m.running.is_placeholder:
                n += 1
        return n

    def idle(self) -> bool:
        """No outstanding work *and* no pending events — ``load`` alone
        cannot see a scheduled-but-not-yet-ingested arrival (same-instant
        submits sit in the event heap until the plane advances past them),
        and retiring such a plane would strand the request."""
        return self.load() == 0 and not self.cp._events

    @property
    def phase(self) -> str:
        """The plane's disaggregation role (DESIGN.md §2.13): ``prefill``
        or ``decode`` when every machine declares that one phase, else
        ``mixed`` — a phase-specialized plane advertises itself to the
        router and the observability layer through this field."""
        phases = {m.phase for m in self.sub.machines}
        return phases.pop() if len(phases) == 1 else "mixed"

    @property
    def disaggregated(self) -> bool:
        """True when this plane splits phase roles across its machines."""
        return any(m.phase != "mixed" for m in self.sub.machines)

    def prefix_overlap(self, tokens) -> int:
        """Cached-prefix tokens this plane already holds for ``tokens`` —
        the same score per-plane heuristics read via
        ``MappingContext.prefix_overlap``."""
        return self.detector.find_prefix_overlap(tokens)

    def find_similar(self, probe: Task):
        """Identity-level similarity hit in this plane's detector."""
        return self.detector.find(probe)

    # -- ingress --------------------------------------------------------------
    def adapt(self, item, t: float):
        """Convert a front-door payload into what this plane's substrate
        ingests: engines take Requests verbatim; the simulator takes the
        payload-free Task mirror of a Request (mixed-kind clusters)."""
        if isinstance(self.sub, Simulator):
            if isinstance(item, Task):
                return item
            self._ordinal += 1
            return item.to_task(t, self._ordinal - 1)
        if isinstance(item, Task):
            raise TypeError("engine planes serve Requests, not bare Tasks")
        return item

    # -- egress ---------------------------------------------------------------
    def stats_dict(self) -> dict:
        """Substrate stats normalized to a flat numeric dict.

        The two substrate vocabularies are bridged so mixed-kind clusters
        aggregate correctly: every plane reports both ``completed`` (engine
        vocabulary; for the simulator on_time + missed — tasks that *ran*)
        and ``n_requests`` (simulator vocabulary; for the engine
        completed + dropped — everything ingested)."""
        s = self.sub.collect_stats()
        if isinstance(s, dict):
            d = dict(s)
            d.setdefault("n_requests", d["completed"] + d["dropped"])
            return d
        d = dataclasses.asdict(s)       # SimStats
        d = {k: v for k, v in d.items() if isinstance(v, (int, float))}
        d.setdefault("completed", d["on_time"] + d["missed"])
        return d


# ---------------------------------------------------------------------------
# shared cross-plane similarity view
# ---------------------------------------------------------------------------

class CrossPlaneLookup:
    """The shared detector the router consults: one similarity lookup over
    every plane's hash tables and prefix trie.

    Reading the planes' own (accurately maintained) detectors instead of
    keeping a second table means affinity can never go stale: a hit names a
    task that is *live and queued* in that plane right now, and a prefix
    score counts blocks *currently resident* in that plane's cache."""

    def __init__(self, planes: list[Plane]):
        self.planes = planes

    def find(self, probe: Task):
        """Best identity-level hit across planes: ``(level, task, plane)``
        or None.  Ties on level go to the lowest plane id (pid-
        deterministic, like the prefix tie-break — not construction
        order)."""
        best = None
        for p in self.planes:
            hit = p.find_similar(probe)
            if hit is not None and (best is None or hit[0] > best[0]
                                    or (hit[0] == best[0]
                                        and p.pid < best[2].pid)):
                best = (hit[0], hit[1], p)
        return best

    def prefix_overlap(self, tokens) -> dict[int, int]:
        """Per-plane cached-prefix score for ``tokens`` (pid -> tokens)."""
        return {p.pid: p.prefix_overlap(tokens) for p in self.planes}


# ---------------------------------------------------------------------------
# router policies (registered like core.heuristics.HEURISTICS)
# ---------------------------------------------------------------------------

class RoutingContext:
    """What a policy may consult for one arrival.  The cross-plane lookups
    are lazy and memoized: policies that never read ``similar``/``prefix``
    (round-robin, least-loaded) cost no detector walks on the admission
    hot path."""

    _UNSET = object()

    def __init__(self, probe: Task, now: float, shared=None):
        self.probe = probe          # similarity keys + tokens of the arrival
        self.now = now
        self._shared = shared       # CrossPlaneLookup | None
        self._similar = self._UNSET
        self._prefix = self._UNSET

    @property
    def similar(self):
        """(level, task, plane) from the shared view, or None."""
        if self._similar is self._UNSET:
            self._similar = (None if self._shared is None
                             else self._shared.find(self.probe))
        return self._similar

    @property
    def prefix(self) -> dict:
        """pid -> cached-prefix tokens, {} without a shared view/tokens."""
        if self._prefix is self._UNSET:
            self._prefix = (
                self._shared.prefix_overlap(self.probe.tokens)
                if self._shared is not None and self.probe.tokens else {})
        return self._prefix


class RouterPolicy:
    name = "base"

    def choose(self, planes: list[Plane],
               ctx: RoutingContext) -> tuple[Plane, str]:
        """Pick a plane for the arrival; return (plane, reason-tag)."""
        raise NotImplementedError


def _least_loaded(planes: list[Plane]) -> Plane:
    return min(planes, key=lambda p: (p.load(), p.pid))


class RoundRobinRouter(RouterPolicy):
    name = "round-robin"

    def __init__(self):
        self._rr = itertools.count()

    def choose(self, planes, ctx):
        return planes[next(self._rr) % len(planes)], "rr"


class LeastLoadedRouter(RouterPolicy):
    name = "least-loaded"

    def choose(self, planes, ctx):
        return _least_loaded(planes), "load"


class AffinityRouter(RouterPolicy):
    """Locality-first: the plane already holding a live merge target
    (identity levels — merge-aware load balancing) or, failing that, the
    deepest cached prefix for the prompt; least-loaded as the fallback.

    Pure locality-first *herds*: once one plane caches the hot prefixes,
    every overlapping request follows them there and the other planes sit
    idle (visible as a lopsided routed-spread in the router benchmark).
    Herding is often right for merge targets — routing away forfeits a
    whole execution — but prefix reuse only saves part of a prefill, so
    ``spill`` bounds the imbalance: when the affinity target's load
    exceeds the least-loaded plane's by more than ``spill`` tasks, the
    arrival spills to the least-loaded plane instead.  ``spill=None``
    (the registry default) keeps pure locality-first."""
    name = "affinity"

    def __init__(self, min_prefix_tokens: int = 1,
                 spill: int | None = None):
        self.min_prefix = min_prefix_tokens
        self.spill = spill

    def _follow(self, plane: Plane, planes: list[Plane]) -> bool:
        if self.spill is None:
            return True
        return plane.load() - _least_loaded(planes).load() <= self.spill

    def choose(self, planes, ctx):
        if ctx.similar is not None:
            level, _task, plane = ctx.similar
            if self._follow(plane, planes):
                return plane, f"affinity:{level.label}"
        if ctx.prefix:
            pid, n = max(ctx.prefix.items(), key=lambda kv: (kv[1], -kv[0]))
            if n >= self.min_prefix:
                plane = next(p for p in planes if p.pid == pid)
                if self._follow(plane, planes):
                    return plane, "affinity:prefix"
        return _least_loaded(planes), "load"


ROUTER_POLICIES = {p.name: p for p in
                   [RoundRobinRouter, LeastLoadedRouter, AffinityRouter]}


def make_router_policy(name: str) -> RouterPolicy:
    key = name.lower()
    if key not in ROUTER_POLICIES:
        raise KeyError(f"unknown router policy {name!r}; "
                       f"have {sorted(ROUTER_POLICIES)}")
    return ROUTER_POLICIES[key]()


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------

class Router:
    """Streaming front door over N planes.

    ``submit`` first advances every plane to the admission instant (events
    strictly before ``t`` — see ``ControlPlane.run``), so routing signals
    (load, live merge targets, cache residency) are current, then routes and
    schedules the arrival.  With one plane this reproduces the bare engine's
    decision sequence exactly: event order is (time, arrival-before-other,
    push-order), all three of which are submission-order-invariant.

    With ``autoscale=ElasticityConfig(...)`` + a ``plane_factory`` the
    front door also runs *plane-count* elasticity (DESIGN.md §2.7): the
    same ``SCALER_POLICIES`` decide from the cross-plane aggregate success
    chance whether to add a whole plane (warm-started through the factory)
    or retire an idle scaler-added one; decisions are evaluated per
    submission, and the accounting (``plane_scale_ups`` etc.) rides in
    ``collect_stats()['router']['autoscale']``.
    """

    def __init__(self, planes, policy="least-loaded", shared_detector=True,
                 autoscale: ElasticityConfig | None = None,
                 plane_factory=None, telemetry=None):
        self.planes = [p if isinstance(p, Plane) else Plane(p, pid=i)
                       for i, p in enumerate(planes)]
        if len({p.pid for p in self.planes}) != len(self.planes):
            raise ValueError("plane ids must be unique")
        #: one obs.Telemetry shared by the router and every plane, so the
        #: cluster's whole timeline lands in a single exportable stream
        self.tel = NULL
        self.policy = (policy if isinstance(policy, RouterPolicy)
                       else make_router_policy(policy))
        self.shared = CrossPlaneLookup(self.planes) if shared_detector \
            else None
        #: routing decision trace: (t, pid, reason) — testable against a
        #: single-plane oracle just like ControlPlane.trace
        self.decisions: list[tuple] = []
        #: closed-loop workload driver (serving.workload), wired through
        #: ``attach_workload``: completions wake sessions, drain pumps the
        #: generator dry instead of assuming a finite pre-known trace
        self.workload = None
        self.stats = {"submitted": 0, "affinity_hits": 0,
                      "prefix_affinity": 0,
                      "routed": {p.pid: 0 for p in self.planes}}
        # -- plane-count autoscaling (DESIGN.md §2.7, level 2) ----------------
        #: planes retired by the scaler; kept for stats aggregation
        self.retired: list[Plane] = []
        self._base_pids = {p.pid for p in self.planes}
        self.plane_scaler = None
        if autoscale is not None and autoscale.max_extra > 0:
            if plane_factory is None:
                raise ValueError("plane-count autoscaling needs a "
                                 "plane_factory(pid) -> substrate | Plane")
            self.plane_scaler = PoolScaler(
                autoscale, _PlanePool(self, plane_factory), len(self.planes))
            # each plane is scored on its own device (``_plane_signals``);
            # the scaler reports the base plane's
            self.plane_scaler.device = self.planes[0].sub.device
        if telemetry is not None:
            self.attach_telemetry(telemetry)

    def attach_telemetry(self, tel) -> None:
        """Wire ``tel`` through the router, every plane and the plane
        scaler; mid-run too, and ``obs.NULL`` detaches it.  Recording
        only: no decision reads it."""
        self.tel = tel
        for p in self.planes:
            self._attach_plane_telemetry(p)
        if self.plane_scaler is not None:
            self.plane_scaler.tel = tel
            self.plane_scaler.scope = "planes"

    def _attach_plane_telemetry(self, plane: Plane) -> None:
        """Wire the router's recorder through one plane — via the
        substrate's own ``attach_telemetry`` (engine/simulator) when it has
        one, else directly onto its control plane."""
        attach = getattr(plane.sub, "attach_telemetry", None)
        if attach is not None:
            attach(self.tel, plane=plane.pid)
        else:
            plane.cp.tel = self.tel
            plane.cp.plane_id = plane.pid

    # -- streaming session API ------------------------------------------------
    def submit(self, item, t: float) -> Plane:
        """Route one arrival at admission instant ``t`` (the planes are
        first advanced to ``t`` so routing signals — load, live merge
        targets, cache residency — are current); returns the chosen
        plane."""
        with self.tel.span("router.submit"):
            self.step(t)
            if self.plane_scaler is not None:
                self.plane_scaler.step(t, self._plane_signals(t))
            ctx = RoutingContext(_probe(item, t), t, shared=self.shared)
            plane, reason = self.policy.choose(self.planes, ctx)
            plane.cp.schedule_arrival(t, plane.adapt(item, t))
            self.stats["submitted"] += 1
            self.stats["routed"][plane.pid] += 1
            if reason.startswith("affinity:"):
                self.stats["affinity_hits"] += 1
                if reason == "affinity:prefix":
                    self.stats["prefix_affinity"] += 1
            self.decisions.append((round(t, 6), plane.pid, reason))
            self.tel.event(t, "route", plane=plane.pid, reason=reason)
            self.tel.metrics.inc("routed", plane=str(plane.pid))
        return plane

    def step(self, until: float) -> None:
        """Advance every plane's event loop to (strictly before) ``until``."""
        with self.tel.span("router.step"):
            for p in self.planes:
                p.cp.run(until=until)

    def next_event_time(self) -> float | None:
        """Earliest scheduled event instant across the planes, or None —
        the closed-loop driver paces its pump off this so generator
        arrivals and plane events interleave in virtual-time order."""
        ts = [p.cp._events[0][0] for p in self.planes if p.cp._events]
        return min(ts) if ts else None

    def attach_workload(self, driver) -> None:
        """Register a closed-loop workload driver: its completion callback
        is wired through every plane's control plane (session wakeup /
        staged re-admission), including planes the plane scaler adds
        later, and ``drain`` gains mid-stream semantics (see below)."""
        self.workload = driver
        for p in self.planes:
            p.cp.on_complete = driver.on_complete

    def drain(self) -> dict:
        """Run every plane to quiescence and aggregate statistics.

        With a closed-loop generator attached, per-plane quiescence is not
        the end of the story: completions processed during the final run
        wake sessions whose next turns are pending in the *generator's*
        heap, not in any plane's.  The loop alternates quiescence with
        pumping those arrivals back through the front door until the
        generator is exhausted — which is guaranteed: sessions have
        bounded turns, DAGs bounded stages, and new starts stop at the
        user cap / horizon — so drain terminates cleanly instead of
        spinning on an always-refilling arrival heap."""
        while True:
            for p in self.planes + self.retired:
                p.cp.run()
            if self.workload is None or not self.workload.pump(self):
                break
        return self.collect_stats()

    # -- plane-count autoscaling ----------------------------------------------
    def _plane_signals(self, now: float) -> ScaleSignals:
        """Cross-plane aggregate for the plane scaler: total queued work,
        the concatenated per-plane success-chance arrays (every plane scored
        with its own machines, oracle and — when attached — pruner, on its
        substrate's device), and the machine-queue-weighted mean of
        per-plane Eq. 4.3 OSLs."""
        cfg = self.plane_scaler.cfg

        def chances():
            arrs = [batch_chances(p.cp.batch, p.sub.machines, p.sub.oracle,
                                  p.now, pruner=p.cp.pruner,
                                  signal_tasks=cfg.signal_tasks,
                                  grid=cfg.signal_grid,
                                  use_kernel=cfg.use_kernel,
                                  device=p.sub.device)
                    for p in self.planes]
            arrs = [a for a in arrs if a.size]
            return np.concatenate(arrs) if arrs else np.zeros(0)

        def osl():
            total, n = 0.0, 0
            for p in self.planes:
                queued = sum(len(m.queue) for m in p.sub.machines)
                if queued:
                    total += queued * oversubscription_level(
                        p.sub.machines, p.sub.oracle.mean_std, p.now)
                    n += queued
            return total / n if n else 0.0

        return ScaleSignals(
            now, sum(len(p.cp.batch) for p in self.planes),
            chances_fn=chances, osl_fn=osl,
            extra_machine_seconds=self.plane_scaler.extra_machine_seconds,
            extra_cost=self.plane_scaler.extra_pool_cost)

    # -- closed-trace compatibility -------------------------------------------
    def run(self, trace) -> dict:
        """Thin wrapper over submit/drain for ``[(t, item), ...]`` traces —
        the pre-router ``ServingEngine.run`` entry point.  Arrivals are
        sorted by time first (stable, so same-instant order is preserved):
        the bare engine's event heap reorders an out-of-order trace, while
        streaming admission has already advanced the planes past an earlier
        timestamp by the time a late-submitted arrival shows up."""
        for t, item in sorted(trace, key=lambda x: x[0]):
            self.submit(item, t)
        return self.drain()

    # -- statistics -----------------------------------------------------------
    #: plane stats that aggregate by max, not sum (clock-like quantities:
    #: planes run concurrently, so the cluster finishes when the last does)
    _MAX_KEYS = frozenset({"makespan", "last_completion"})

    def collect_stats(self) -> dict:
        """Aggregate numeric stats across planes — active *and* retired, so
        work done on a scaler-retired plane never vanishes (sums; clock-like
        keys by max); per-plane dicts under ``planes`` and routing counters
        under ``router``."""
        per_plane, agg = [], {}
        for p in self.planes + self.retired:
            d = p.stats_dict()
            per_plane.append({"plane": p.pid, "name": p.name, **d})
            for k, v in d.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    agg[k] = (max(agg.get(k, 0), v) if k in self._MAX_KEYS
                              else agg.get(k, 0) + v)
        agg["planes"] = per_plane
        agg["router"] = {
            "policy": self.policy.name,
            "shared_detector": self.shared is not None,
            "submitted": self.stats["submitted"],
            "affinity_hits": self.stats["affinity_hits"],
            "prefix_affinity": self.stats["prefix_affinity"],
            "routed": {str(pid): n
                       for pid, n in sorted(self.stats["routed"].items())},
        }
        if self.plane_scaler is not None:
            self.plane_scaler.sync(max((p.now for p in self.planes),
                                       default=0.0))
            sc = self.plane_scaler.stats
            agg["router"]["autoscale"] = {
                "policy": self.plane_scaler.cfg.policy,
                "plane_scale_ups": sc["scale_ups"],
                "plane_scale_downs": sc["scale_downs"],
                "scale_decisions": sc["scale_decisions"],
                "plane_seconds": sc["machine_seconds"],
                "extra_plane_seconds": sc["extra_machine_seconds"],
                "plane_cost": sc["pool_cost"],
                "extra_plane_cost": sc["extra_pool_cost"],
            }
        if self.tel.enabled:
            # router-level aggregation: one metrics snapshot over every
            # plane (they all share the router's recorder)
            agg["telemetry"] = {"metrics": self.tel.metrics.snapshot(),
                                "events": len(self.tel.events)}
        return agg


# ---------------------------------------------------------------------------
# plane-pool adapter (whole-plane elasticity behind the PoolScaler driver)
# ---------------------------------------------------------------------------

class _PlanePool:
    """Autoscale pool adapter over the Router's plane list.

    ``grow`` asks the factory for a fresh substrate (engine factories
    warm-start it from an existing plane's step functions — the
    warm-container ladder) and registers it with the live routing state:
    appending to ``Router.planes`` is enough because the shared
    ``CrossPlaneLookup`` views that same list.  ``shrink`` retires only
    scaler-added planes (never the constructor's base planes) that are
    fully idle, moving them to ``Router.retired`` so their stats survive
    aggregation.
    """

    def __init__(self, router: "Router", factory):
        self.router = router
        self.factory = factory

    def size(self) -> int:
        return len(self.router.planes)

    def cost_rate(self) -> float:
        """Per-mtype billing across the cluster: the summed *base-fleet*
        cost rate of every live plane (a plane of cheap units is cheaper
        to keep than a plane of fast ones).  Deliberately not the live
        machine list: a plane's own unit-level scaler already bills its
        extra units in that engine's ``extra_pool_cost``, so counting the
        live pool here would double-bill unit churn against the plane
        budget (and spuriously gate plane scale-ups)."""
        total = 0.0
        for p in self.router.planes:
            fleet = getattr(p.sub, "fleet", None)
            if fleet is not None:
                total += fleet.cost_rate_total()
            else:
                total += sum(m.cost_rate for m in p.sub.machines)
        return total

    def grow(self, now: float) -> float:
        r = self.router
        pid = 1 + max(p.pid for p in r.planes + r.retired)
        plane = self.factory(pid)
        if not isinstance(plane, Plane):
            plane = Plane(plane, pid=pid)
        elif plane.pid != pid:
            raise ValueError(f"plane_factory must use the given pid {pid}, "
                             f"got {plane.pid}")
        r.planes.append(plane)
        r.stats["routed"].setdefault(plane.pid, 0)
        if r.tel.enabled:
            r._attach_plane_telemetry(plane)
        if r.workload is not None:
            plane.cp.on_complete = r.workload.on_complete
        return 0.0

    def shrink(self, now: float) -> bool:
        r = self.router
        for i in range(len(r.planes) - 1, -1, -1):
            p = r.planes[i]
            if p.pid in r._base_pids or not p.idle():
                continue
            r.planes.pop(i)
            r.retired.append(p)
            return True
        return False


# ---------------------------------------------------------------------------
# plane builders
# ---------------------------------------------------------------------------

def make_engine_planes(model_cfg, params, cfg, n_planes: int,
                       stub_oracles=None, device=None) -> list[Plane]:
    """N ``ServingEngine`` planes.  Live engines after the first warm-start
    from plane 0's step functions (the serverless warm-container ladder,
    extended across planes); stub engines take one oracle each from
    ``stub_oracles``.  A heterogeneous ``cfg.fleet`` (DESIGN.md §2.8)
    rides into every plane verbatim: each plane runs the same catalog of
    machine types, speeds, cost rates and backends.  Every engine runs on
    ``device`` (CUDA unless ``"cpu"`` is passed), the device of
    ``params``, so the shared step functions only ever see its tensors."""
    from .engine import ServingEngine   # lazy: keep this module model-free
    planes, warm = [], None
    for i in range(n_planes):
        oracle = stub_oracles[i] if stub_oracles is not None else None
        eng = ServingEngine(model_cfg, params, cfg, stub_oracle=oracle,
                            warm_fns=None if oracle is not None else warm,
                            device=device)
        if oracle is None:
            warm = eng.warm_fns
        planes.append(Plane(eng, pid=i))
    return planes


def make_engine_plane_factory(model_cfg, params, cfg, warm_fns=None,
                              stub_oracle_fn=None, device=None):
    """``plane_factory`` for ``Router(autoscale=...)`` over engine planes:
    live engines warm-start from ``warm_fns`` (pass plane 0's
    ``ServingEngine.warm_fns``), stub engines draw one oracle per pid from
    ``stub_oracle_fn``.  Every engine runs on ``device`` (CUDA unless
    ``"cpu"`` is passed)."""
    from .engine import ServingEngine   # lazy: keep this module model-free

    def factory(pid: int):
        oracle = stub_oracle_fn(pid) if stub_oracle_fn is not None else None
        return ServingEngine(model_cfg, params, cfg, stub_oracle=oracle,
                             warm_fns=None if oracle is not None else warm_fns,
                             device=device)
    return factory
