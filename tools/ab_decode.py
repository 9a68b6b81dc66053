#!/usr/bin/env python3
"""Decode-step wall of the port in several trees, each in a fresh process
on the same card, in the order given (parent, change, change, parent):

    python3 tools/ab_decode.py build/parent . . build/parent

A tree is a directory holding ``src/repro_torch`` (unpack another commit
with ``git archive <commit> src | tar -x -C build/parent``).  Each run
times smollm-360m at full width (random init, seed 0): the one-at-a-time
step (``decode_fn``, B=1, 38-57 keys in a 64-position cache) and the
batched paged step (``paged_decode_fn``, B=8, 38-57 keys a sequence), 60
steps each after 5 warm-up steps, every step ending in
``torch.cuda.synchronize``; it prints one JSON line with the median and
quartiles in ms.  Needs one CUDA card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

STEPS, WARM = 60, 5


def _timed(one) -> dict:
    import torch
    for i in range(WARM):
        one(i)
    torch.cuda.synchronize()
    walls = []
    for i in range(STEPS):
        t0 = time.perf_counter()
        one(i)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    q = statistics.quantiles(walls, n=4)
    return {"median_ms": statistics.median(walls), "q1": q[0], "q3": q[2]}


def measure(tree: str) -> dict:
    sys.path.insert(0, f"{tree}/src")
    import torch
    from repro_torch.bridge import init_params
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as T
    if not torch.cuda.is_available():
        raise SystemExit("ab_decode: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("smollm-360m")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    cache = T.init_cache(cfg, 1, 64, "cuda")
    tok = torch.zeros((1,), dtype=torch.long, device="cuda")
    step = T.decode_fn(cfg)

    def contiguous(i):
        cache["len"].fill_(38 + i % 20)
        step(params, cache, tok)
    ps, mp, b = 16, 64, 8
    pages = T.init_paged_cache(cfg, b * mp + 1, ps, "cuda")
    tabs = (torch.arange(b * mp, device="cuda", dtype=torch.int32)
            + 1).reshape(b, mp)
    lens = torch.full((b,), 38, dtype=torch.int32, device="cuda")
    toks = torch.zeros((b,), dtype=torch.long, device="cuda")
    pstep = T.paged_decode_fn(cfg)

    def paged(i):
        pstep(params, pages["kp"], pages["vp"], tabs, lens + i % 20, toks)
    with torch.no_grad():
        return {"tree": tree, "contiguous_b1": _timed(contiguous),
                "paged_b8": _timed(paged)}


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    for tree in argv:
        res = subprocess.run([sys.executable, __file__, "--one", tree],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise SystemExit(f"{tree}: exited {res.returncode}\n"
                             f"{res.stderr[-2000:]}")
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
