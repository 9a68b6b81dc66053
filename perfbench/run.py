"""Run one cell of the benchmark of the PyTorch/CUDA port ``repro_torch``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cells, their metrics and bounds are in
``BENCHMARK.json``; what each cell runs is found by name under
``perfbench/`` (see ``perfbench/bench.py``).  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` (and with ``--trace 1``
``breakdown``), and last ``checks``: each number the correctness check
compared, beside its limit.  The same numbers are the last lines of
standard error.  Without a CUDA card, with fewer cards than the cell asks
for, or with JAX or the JAX package loaded after the window, the run
exits with a code other than 0 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def fail(code: int, msg: str):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(2, f"the program under test, {ROOT / 'src' / 'repro_torch'}, "
                "is not in this checkout")
    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / "build" / "perfbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(cache / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from perfbench import bench
    cell = bench.Cell(bench.load_json(ROOT / "BENCHMARK.json"), args.workload)

    import torch
    if not torch.cuda.is_available():
        fail(2, "no CUDA card: the benchmark measures the port on the card")
    if torch.cuda.device_count() < cell.chips:
        fail(2, f"the cell asks for {cell.chips} cards, "
                f"{torch.cuda.device_count()} present")
    out = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START)
    bad = bench.forbidden_modules()
    if bad:
        fail(3, "modules of JAX or the JAX package were loaded: "
                + ", ".join(bad))
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
