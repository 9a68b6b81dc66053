"""Serving launcher: the cluster front door over a synthetic request trace.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --requests 100 --merging adaptive --pruning --heuristic EDF \
        --planes 2 --router affinity --autoscale success-chance

The port of ``repro.launch.serve``: every flag of the JAX launcher, the
same reduced 2-layer model (random weights from a seeded
``torch.Generator``) and the same JSON summary, plus ``--device`` (CUDA
by default; ``--device cpu`` runs the kernels' plain versions on the
host).  ``--arch`` takes any registered id (``configs.registry.ARCHS``):
moe, hybrid and xLSTM units prefill each prompt at its own length and
serve one task at a time (step batching refuses them, as the JAX unit
runner does), and enc-dec units refuse to start, since a request carries
no encoder frames.

``--planes N`` shards the engine into N planes behind a ``Router``
(``--router`` picks the policy); the JSON summary carries the aggregate,
per-plane stats (hits, merges, drops, deadlock_breaks) and the routing
counters.  ``--planes 1`` reproduces the bare engine exactly.

``--autoscale POLICY`` picks the elasticity policy (``SCALER_POLICIES``:
queue / success-chance / cost-aware) threaded through to every engine's
unit pool (``--max-extra-units`` headroom) and — with ``--extra-planes N``
— to the Router's plane pool (new planes warm-start from plane 0's
step functions).  The autoscale decision counters (scale_ups,
scale_downs, machine_seconds, warmup_ticks, plane_scale_*) ride in the
JSON summary.

``--max-batch N`` (with ``--step-token-budget B``) turns on step-level
continuous batching inside every unit (DESIGN.md §2.10); the knobs are
echoed back under ``batching`` in the JSON summary.

``--fleet tpu:4:1.0:1.0,cpu:4:0.25:0.2`` builds every engine on a
heterogeneous machine catalog (DESIGN.md §2.8: mtype, count, speed,
per-machine cost rate, optional backend kind and queue size) instead of
``--units`` identical units; cost-aware mapping (``--heuristic MCMD``)
and the per-mtype-billed cost counters (cost, pool_cost) ride in the
JSON summary.

``--workload closed_loop:<users>:<think>`` replaces the open-loop trace
with the closed-loop session generator (DESIGN.md §2.11): each user is a
multi-turn conversation whose next turn re-arrives after a think time,
with the grown token prefix exercising the prefix KV cache.
``--tenants gold:1:0.5:1,free:3`` splits users over SLO tiers
(name:share:slack:priority); per-tenant and per-turn counters ride under
``workload`` in the JSON summary (telemetry schema 2).  With tenants set,
a per-tenant SLO burn-rate monitor (DESIGN.md §2.12) runs online,
subscribes every engine's autoscaler to its burn signal, and its summary
rides under ``telemetry.slo``.

``--record-out FILE`` swaps the telemetry recorder for a flight recorder
(DESIGN.md §2.12): the bounded event ring, every arrival payload,
periodic ``TimeEstimator`` EWMA snapshots and the kernel-profiler
compile/execute split are serialized into one replayable artifact —
the port's ``obs.fit.fit_oracle`` turns it into a measured oracle and
its ``obs.replay.drift_report`` re-drives it through the simulator.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs.registry import get_arch
from ..device import resolve_device
from ..core.fleet import FleetSpec
from ..core.pruning import PruningConfig
from ..models import transformer as T
from ..obs import (SCHEMA_VERSION, FlightRecorder, KernelProfiler,
                   SLOMonitor, Telemetry, install, write_chrome_trace,
                   write_jsonl, write_metrics)
from ..serving.autoscale import SCALER_POLICIES, ElasticityConfig
from ..serving.batching import StepBatchingConfig
from ..serving.cluster import (ROUTER_POLICIES, Router,
                               make_engine_plane_factory, make_engine_planes)
from ..serving.engine import TICKS_PER_SEC, EngineConfig, Request


def synth_trace(n: int, vocab: int, n_prompts: int = 8, rate: float = 0.2,
                deadline: float = 400.0, seed: int = 0):
    rng = np.random.default_rng(seed)
    prompts = [tuple(rng.integers(1, vocab, size=12).tolist())
               for _ in range(n_prompts)]
    trace, t = [], 0.0
    for _ in range(n):
        trace.append((t, Request(
            prompt=prompts[int(rng.integers(0, n_prompts))], op="generate",
            n_new=4, temperature=float(rng.choice([0.0, 0.0, 0.7])),
            seed=int(rng.integers(0, 3)), deadline=t + deadline)))
        t += float(rng.exponential(1.0 / rate))
    return trace


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--units", type=int, default=2)
    ap.add_argument("--fleet", default=None,
                    help="heterogeneous fleet catalog per engine, "
                         "mtype:count[:speed[:cost_rate[:backend"
                         "[:queue_size]]]] rows comma-separated "
                         "(e.g. tpu:4:1.0:1.0,cpu:4:0.25:0.2); "
                         "overrides --units")
    ap.add_argument("--heuristic", default="EDF")
    ap.add_argument("--merging", default="adaptive",
                    choices=["none", "conservative", "aggressive", "adaptive"])
    ap.add_argument("--pruning", action="store_true")
    ap.add_argument("--rate", type=float, default=0.2)
    ap.add_argument("--deadline", type=float, default=400.0)
    ap.add_argument("--max-batch", type=int, default=1,
                    help=">1 turns on step-level continuous batching "
                         "inside every unit (DESIGN.md §2.10): up to this "
                         "many sequences share each engine step")
    ap.add_argument("--step-token-budget", type=int, default=64,
                    help="token budget per engine step (decodes first, "
                         "remaining budget goes to prefill chunks); only "
                         "meaningful with --max-batch > 1")
    ap.add_argument("--planes", type=int, default=1,
                    help="scheduling planes behind the front-door router")
    ap.add_argument("--router", default="least-loaded",
                    choices=sorted(ROUTER_POLICIES))
    ap.add_argument("--autoscale", default="queue",
                    choices=sorted(SCALER_POLICIES),
                    help="elasticity policy for unit pools (and the plane "
                         "pool with --extra-planes)")
    ap.add_argument("--max-extra-units", type=int, default=2,
                    help="per-engine unit-pool headroom (0 disables)")
    ap.add_argument("--extra-planes", type=int, default=0,
                    help="plane-pool headroom for router autoscaling "
                         "(0 disables)")
    ap.add_argument("--workload", default=None,
                    help="closed_loop:<users>[:<think>] switches from the "
                         "open-loop trace to the closed-loop session "
                         "generator (DESIGN.md §2.11): <users> multi-turn "
                         "sessions with mean think time <think> seconds "
                         "between turns")
    ap.add_argument("--turns", type=int, default=4,
                    help="turns per closed-loop session")
    ap.add_argument("--tenants", default=None,
                    help="SLO tiers name[:share[:slack[:priority]]] "
                         "comma-separated (e.g. gold:1:0.5:1,free:3); "
                         "closed-loop users are split over tiers and the "
                         "summary carries per-tenant accounting")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON (Perfetto-"
                         "viewable: one track per machine/plane) here")
    ap.add_argument("--metrics-out", default=None,
                    help="write a metrics snapshot here (.prom/.txt gets "
                         "Prometheus text, anything else JSON)")
    ap.add_argument("--events-out", default=None,
                    help="write the raw telemetry event log as JSONL here")
    ap.add_argument("--record-out", default=None,
                    help="write a replayable flight-record artifact here "
                         "(bounded event ring + arrivals + estimator "
                         "snapshots + kernel profile; DESIGN.md §2.12), "
                         "for repro_torch.obs.fit_oracle and "
                         "repro_torch.obs.drift_report")
    ap.add_argument("--record-capacity", type=int, default=65536,
                    help="flight-recorder ring size in events")
    ap.add_argument("--device", default="cuda",
                    help="torch device the planes run on (cuda, or cpu "
                         "for the kernels' plain versions on the host)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced().scaled(n_layers=2, remat=False)
    params = T.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    fleet = FleetSpec.parse(args.fleet) if args.fleet else None
    ecfg = EngineConfig(
        n_units=args.units, fleet=fleet,
        heuristic=args.heuristic, merging=args.merging,
        pruning=PruningConfig(initial_defer_threshold=0.15,
                              base_drop_threshold=0.1)
        if args.pruning else None,
        elasticity=ElasticityConfig(policy=args.autoscale,
                                    max_extra=args.max_extra_units,
                                    cooldown=100.0),
        batching=StepBatchingConfig(
            max_batch=args.max_batch,
            step_token_budget=args.step_token_budget)
        if args.max_batch > 1 else None,
        max_len=64)
    planes = make_engine_planes(cfg, params, ecfg, args.planes,
                                device=device)
    autoscale = plane_factory = None
    if args.extra_planes > 0:
        autoscale = ElasticityConfig(policy=args.autoscale,
                                     max_extra=args.extra_planes,
                                     cooldown=100.0)
        plane_factory = make_engine_plane_factory(
            cfg, params, ecfg, warm_fns=planes[0].sub.warm_fns,
            device=device)
    # telemetry rides on every run: the engine's tick clock stamps ``t``
    # and perf_counter stamps ``wall`` (the tick+wall clock pair).  With
    # --record-out the recorder is a flight recorder — same Telemetry
    # surface, so nothing downstream changes (zero perturbation)
    recorder = None
    if args.record_out:
        tel = recorder = FlightRecorder(capacity=args.record_capacity,
                                        wall_clock=time.perf_counter,
                                        snapshot_interval=200.0)
        recorder.watch_estimator(planes[0].sub.estimator)
        recorder.note_engine_config(ecfg)
        recorder.meta.update({"arch": args.arch, "planes": args.planes,
                              "time_scale": float(TICKS_PER_SEC)})
        profiler = KernelProfiler(metrics=tel.metrics)
        install(profiler)
        recorder.use_profiler(profiler)
    else:
        tel = Telemetry(wall_clock=time.perf_counter)
    router = Router(planes, policy=args.router, autoscale=autoscale,
                    plane_factory=plane_factory, telemetry=tel)
    if recorder is not None:
        # capture every arrival payload at the front door (replay input)
        _submit = router.submit

        def submit(item, t):
            recorder.note_arrival(t, item)
            return _submit(item, t)

        router.submit = submit
    slo = None
    if args.tenants:
        from ..serving.workload import parse_tenants as _pt
        slo = SLOMonitor(_pt(args.tenants), tel)
        slo.attach(planes[0].sub)
        for plane in planes:
            scaler = getattr(plane.sub, "scaler", None)
            if scaler is not None:
                scaler.attach_slo(slo)
    workload = None
    if args.workload:
        from ..serving.workload import (SessionConfig, SessionPool,
                                        WorkloadDriver, parse_tenants)
        parts = args.workload.split(":")
        if parts[0] != "closed_loop":
            raise SystemExit(f"unknown --workload kind {parts[0]!r}")
        users = int(parts[1]) if len(parts) > 1 else 8
        think = float(parts[2]) if len(parts) > 2 else 4.0
        tenants = parse_tenants(args.tenants) if args.tenants else None
        pool = SessionPool(SessionConfig(
            users=users, turns=args.turns, think=("exp", think),
            arrival_rate=args.rate, deadline=args.deadline,
            vocab=min(cfg.vocab, 250), emit="request"), tenants=tenants)
        driver = WorkloadDriver(router, pool, record_hit_depth=True)
        stats = driver.run()
        workload = pool.summary()
        stats["workload"] = workload
    else:
        trace = synth_trace(args.requests, cfg.vocab, rate=args.rate,
                            deadline=args.deadline)
        stats = router.run(trace)
    if fleet is not None:
        stats["fleet"] = fleet.serialize()
    stats["batching"] = ({"max_batch": args.max_batch,
                          "step_token_budget": args.step_token_budget}
                         if args.max_batch > 1 else None)
    # stable consolidated summary (legacy top-level keys kept for one
    # release — see tests/test_cli.py back-compat assertions)
    stats["telemetry"] = {
        "schema": SCHEMA_VERSION,
        "counters": {k: stats.get(k, 0) for k in (
            "completed", "on_time", "missed", "dropped", "merges",
            "merge_rejected", "deferred", "cache_hits", "deadlock_breaks",
            "scale_ups", "scale_downs")},
        "wall": {"mapping_wall_s": stats.get("mapping_wall_s", 0.0),
                 "pruning_wall_s": stats.get("pruning_wall_s", 0.0)},
        "metrics": tel.metrics.snapshot(),
        "workload": workload,
    }
    if slo is not None:
        stats["telemetry"]["slo"] = slo.summary()
    if recorder is not None:
        now = max((p.cp.now for p in planes), default=0.0)
        recorder.snapshot_estimator(now, planes[0].sub.estimator)
        recorder.note_machines([m for p in planes for m in p.sub.machines])
        recorder.note_stats(stats)
        recorder.save(args.record_out)
        stats["telemetry"]["record_out"] = args.record_out
    if args.trace_out:
        write_chrome_trace(tel.events, args.trace_out,
                           us_per_unit=1e6 / TICKS_PER_SEC)
        stats["telemetry"]["trace_out"] = args.trace_out
    if args.metrics_out:
        write_metrics(tel.metrics, args.metrics_out)
        stats["telemetry"]["metrics_out"] = args.metrics_out
    if args.events_out:
        write_jsonl(tel.events, args.events_out)
        stats["telemetry"]["events_out"] = args.events_out
    print(json.dumps(stats, indent=2))


if __name__ == "__main__":
    main()
