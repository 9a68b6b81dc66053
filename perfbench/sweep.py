"""The rate sweep of an open-loop cell, on the card.

    python3 perfbench/sweep.py --workload <cell> --rates 2,3,4 \\
        --seed <n> --seconds 30 --out chiprun_out/<file>.jsonl

Runs the cell once at each offered rate (requests a second), as the
benchmark runs it, and writes one JSON line a rate: requests due and
answered in the window, dropped, those still unanswered at the window's
close and at its middle (a backlog that grows over the window is a rate
above the knee), latency quantiles, the on-time share under the mix's
deadline constants, and each request's prompt and output length with
its latency, from which the deadline constants are fixed.  The rate and
the constants then go into the mix file as data.
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def outstanding(records, t):
    return sum(r["due"] <= t and (r["done"] is None or r["done"] > t)
               for r in records)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    import gc

    import torch

    from perfbench import bench, stats
    base = bench.Cell(bench.load_json(ROOT / "BENCHMARK.json"), args.workload)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for rate in (float(r) for r in args.rates.split(",")):
        cell = copy.copy(base)
        cell.mix = dict(base.mix, rate_per_s=rate)
        t0 = time.perf_counter()
        res = bench.run_cell(cell, args.seed, args.seconds, False, "cuda",
                             t0, keep=True)
        keep = res.pop("_keep")
        rec, w0, w1 = keep["records"], keep["w0"], keep["w1"]
        lat = stats.latencies_ms(rec, w0, w1)
        due = stats.due_in(rec, w0, w1)
        line = {"rate": rate, "due": len(due),
                "answered": len(stats.completed_in(rec, w0, w1)),
                "dropped": sum(r["outcome"] == "dropped" for r in due),
                "outstanding_mid": outstanding(rec, 0.5 * (w0 + w1)),
                "outstanding_end": outstanding(rec, w1),
                "p50_ms": stats.percentile(lat, 50) if lat else None,
                "p90_ms": stats.percentile(lat, 90) if lat else None,
                "p95_ms": stats.percentile(lat, 95) if lat else None,
                "on_time_share": stats.on_time_share(rec, w0, w1)
                if due else None,
                "correct": res["correct"], "metrics": res["metrics"],
                "requests": [[r["prompt"], r["n_new"], r["outcome"],
                              None if r["done"] is None
                              else (r["done"] - r["due"]) * 1e3]
                             for r in due]}
        with out.open("a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps({k: v for k, v in line.items()
                          if k != "requests"}), flush=True)
        del keep, res
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
