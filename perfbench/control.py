"""Readings that set a cell's correctness limit, on the card.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,... \\
        --control-seeds 11,12,13 --seconds 10 --out chiprun_out/<file>.jsonl

For each seed it makes one run of the cell as the benchmark does (the
same set-up, traffic, timed path and sample; a window of ``--seconds``)
and writes one JSON line: the program's widest logit gap (the number the
check compares) and each judged request's gap.  For the control seeds it
also reads the control: the plain reference computed with every
projection's operands rounded to float8 e4m3, the precision below the
configuration's bf16, put in the program's place on the same prompts and
tokens; its widest gap is that of the tokens it puts first, judged by
the float32 reference.  The benchmark's own runs do not run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    import torch

    from perfbench import bench
    cell = bench.Cell(bench.load_json(ROOT / "BENCHMARK.json"), args.workload)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = bench.run_cell(cell, seed, args.seconds, False, "cuda", t0,
                             keep=True)
        keep = res.pop("_keep")
        line = {"workload": cell.name, "seed": seed,
                "program_gap": res["checks"]["max_logit_gap"]["value"],
                "gaps": keep["gaps"], "correct": res["correct"],
                "judged": [[len(p), len(t)] for p, t in keep["items"]],
                "metrics": res["metrics"], "device": res["device"]}
        if seed in ctl and keep["items"]:
            t1 = time.perf_counter()
            cg, _ = bench.logit_gaps(cell.reference, cell.conf,
                                     keep["params"], keep["items"],
                                     quant="fp8", judge=keep["ref_logits"])
            line["control_gap"] = max(cg)
            line["control_gaps"] = cg
            line["control_s"] = time.perf_counter() - t1
        line["wall_s"] = time.perf_counter() - t0
        with out.open("a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps({k: v for k, v in line.items()
                          if k not in ("gaps", "control_gaps", "judged")}),
              flush=True)
        del keep, res
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    main()
