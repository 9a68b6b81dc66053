"""End-to-end serving example: the cluster front door over SMSE planes —
streaming admission, cross-plane routing, merging, pruning, elasticity and
both caches live.

    PYTHONPATH=src python -m repro_torch.examples.serve_smse \
        [--requests 80] [--planes 2] [--device cuda]

The port of ``examples/serve_smse.py``.  Requests are real generations on
a reduced smollm-family model (random weights from a seeded
``torch.Generator``) on the card, streamed through ``Router.submit`` one
arrival at a time (the serverless front door).  Shared-system-prompt
traffic shows the two reuse tiers: the affinity policy routes
prefix-overlapping requests to the plane whose paged KV cache already
holds their blocks (cross-plane locality), and within a plane merged
requests share one batched prefill+decode execution.  Each task runs one
at a time (no step batching): a prefill, then decode steps through the
decode-attention and RMSNorm kernels.  The autoscaler is the queue-length
policy, so the success-chance kernel (``pmf_conv``) is not on this path.

``--device`` is CUDA by default and raises without a card; ``--device
cpu`` runs the kernels' plain versions on the host.  On the card the last
line is the kernels' launch counts.  ``submitted`` counts the requests
handed to ``Router.submit``, ``requests`` those the drained planes
account for (completed or dropped).  The statistics rest partly on
measured wall time (``Router`` and the engines tick with it), so two runs
need not print the same numbers.
"""

import argparse
import json
import time
from collections import Counter

import numpy as np
import torch

from .. import kernels
from ..configs.registry import get_arch
from ..core.pruning import PruningConfig
from ..device import resolve_device
from ..models import transformer as T
from ..obs import Telemetry, write_chrome_trace, write_metrics
from ..serving.autoscale import ElasticityConfig
from ..serving.cluster import Router, make_engine_planes
from ..serving.engine import TICKS_PER_SEC, EngineConfig, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=80)
    ap.add_argument("--planes", type=int, default=2)
    ap.add_argument("--router", default="affinity")
    ap.add_argument("--merging", default="adaptive")
    ap.add_argument("--no-pruning", action="store_true")
    ap.add_argument("--trace-out", default=None,
                    help="write a Perfetto-viewable Chrome trace JSON here")
    ap.add_argument("--metrics-out", default=None,
                    help="write a metrics snapshot here (.prom/.txt -> "
                         "Prometheus text, else JSON)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the planes run on (cuda, or cpu "
                         "for the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch("smollm-360m").reduced().scaled(n_layers=2, remat=False)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    ecfg = EngineConfig(
        n_units=2, elasticity=ElasticityConfig(max_extra=2, cooldown=100.0),
        heuristic="EDF", merging=args.merging,
        pruning=None if args.no_pruning else PruningConfig(
            initial_defer_threshold=0.1, base_drop_threshold=0.05),
        max_len=64, batch_buckets=(1, 2, 4, 8))
    tel = None
    if args.trace_out or args.metrics_out:
        tel = Telemetry(wall_clock=time.perf_counter)
    router = Router(make_engine_planes(cfg, params, ecfg, args.planes,
                                       device=device),
                    policy=args.router, telemetry=tel)

    rng = np.random.default_rng(0)
    # shared-system-prompt traffic: a few hot >=32-token system prompts with
    # distinct user suffixes — the paged KV prefix cache (DESIGN.md §2.4)
    # prefills only the suffix after the first request per system prompt,
    # and the router keeps each system prompt's traffic on the plane that
    # cached it (DESIGN.md §2.6)
    sys_prompts = [tuple(rng.integers(1, cfg.vocab, size=32).tolist())
                   for _ in range(4)]
    kernels.reset_launch_counts()
    t, submitted = 0.0, 0
    for _ in range(args.requests):
        prompt = sys_prompts[int(rng.integers(0, len(sys_prompts)))] + \
            tuple(rng.integers(1, cfg.vocab, size=6).tolist())
        router.submit(Request(
            prompt=prompt,
            n_new=4, temperature=float(rng.choice([0.0, 0.0, 0.7])),
            seed=int(rng.integers(0, 3)), deadline=t + 400), t)
        submitted += 1
        t += float(rng.exponential(5))
    stats = router.drain()
    counts = kernels.launch_counts()

    total = stats["completed"] + stats["dropped"]
    print(f"device             {device}")
    print(f"planes             {args.planes} (policy {args.router})")
    print(f"submitted          {submitted}")
    print(f"requests           {total}")
    print(f"on-time            {stats['on_time']} "
          f"({100 * stats['on_time'] / total:.0f}%)")
    print(f"completed          {stats['completed']}")
    print(f"model executions   {stats['executions']} "
          f"(reuse saved {total - stats['executions'] - stats['dropped']} "
          f"executions)")
    print(f"merges             {stats['merges']}")
    print(f"result-cache hits  {stats['cache_hits']}")
    print(f"prefix-cache hits  {stats['prefix_hits']} "
          f"({stats['prefix_tokens_reused']} tokens reused; "
          f"{stats['prefill_tokens']} prefilled)")
    print(f"dropped (pruned)   {stats['dropped']}")
    print(f"cold/warm starts   {stats['cold_starts']}/"
          f"{stats.get('warm_starts', 0)}")
    print(f"scale up/down      {stats['scale_ups']}/{stats['scale_downs']}")

    print("\ncross-plane routing decisions")
    reasons = Counter(d[2] for d in router.decisions)
    for reason, n in reasons.most_common():
        print(f"  {reason:<18} {n}")
    print(f"  routed per plane   {stats['router']['routed']}")
    for p in stats["planes"]:
        print(f"  {p['name']}: prefix hits {p.get('prefix_hits', 0)}, "
              f"merges {p.get('merges', 0)}, "
              f"executions {p.get('executions', 0)}, "
              f"dropped {p.get('dropped', 0)}")

    if tel is not None:
        if args.trace_out:
            write_chrome_trace(tel.events, args.trace_out,
                               us_per_unit=1e6 / TICKS_PER_SEC)
            print(f"\ntrace written      {args.trace_out} "
                  f"({len(tel.events)} events; open in ui.perfetto.dev)")
        if args.metrics_out:
            write_metrics(tel.metrics, args.metrics_out)
            print(f"metrics written    {args.metrics_out}")
    if device.type == "cuda":
        print(f"kernel launches    {json.dumps(counts)}")


if __name__ == "__main__":
    main()
