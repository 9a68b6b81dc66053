#!/usr/bin/env python3
"""Phase 4d of ``chip_smoke.py`` (the disaggregated prefill→decode handoff
and the closed-loop sessions, smollm-360m at full width) on the port of
several trees, each in a fresh process on the same card:

    python3 tools/handoff_trees.py build/parent .

A tree is a directory holding ``src/repro_torch`` (unpack another commit
with ``git archive <commit> src | tar -x -C build/parent``).  Each run
builds that tree's kernels, makes the weights from seed 0 and runs this
checkout's ``chip_smoke.handoff_phase`` on that tree's package, printing
the phase's lines, then one JSON line: ``{"tree": ..., "held": true}``,
or ``"held": false`` with the failed check's message.  Needs one CUDA
card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(tree: str) -> dict:
    # the tree's package first: chip_smoke keeps an imported repro_torch
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, f"{tree}/src")
    import repro_torch
    import torch
    import chip_smoke
    from repro_torch.bridge import init_params
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.build import library
    if not torch.cuda.is_available():
        raise SystemExit("handoff_trees: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    library()
    cfg = get_arch("smollm-360m")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    try:
        chip_smoke.handoff_phase(cfg, params, smi)
    except AssertionError as e:
        return {"tree": tree, "package": repro_torch.__file__,
                "held": False, "failed": str(e)}
    return {"tree": tree, "package": repro_torch.__file__, "held": True}


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in argv:
        res = subprocess.run([sys.executable, __file__, "--one", tree])
        rc = rc or res.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
