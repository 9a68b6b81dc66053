"""Hillclimb driver, the twin of ``repro.launch.perf``: traces the three
chosen cells under a sequence of hypothesis-driven variants and records
the roofline terms of each (``dryrun.lower_cell`` on the fake production
mesh).

    PYTHONPATH=src python -m repro_torch.launch.perf --cell xlstm \
        [--out f.jsonl] [--variant chunk64]

Cells and variant ladders are the JAX package's ``CELLS``; each variant
also records the roofline with the fused regions (flash attention, SSD
and mLSTM scans) costed at their boundary bytes (``fused_credit``).
"""

from __future__ import annotations

import argparse
import json

from ..configs.base import XLSTMConfig
from .dryrun import lower_cell

CELLS = {
    # worst roofline fraction: sequential mLSTM scan (C-state HBM
    # roundtrip per token)
    "xlstm": {
        "arch": "xlstm-125m", "shape": "train_4k",
        "variants": [
            ("baseline_scan", {}),
            ("chunk64", {"xlstm": XLSTMConfig(chunk=64)}),
            ("chunk128", {"xlstm": XLSTMConfig(chunk=128)}),
            ("chunk256", {"xlstm": XLSTMConfig(chunk=256)}),
        ],
        "fsdp": [True, True, True, True],
    },
    # most collective-bound in the JAX package: the KV cache's sequence
    # sharded over 'model' (flash-decode parallelism), with and without
    # FSDP parameters
    "decode": {
        "arch": "llama3-8b", "shape": "decode_32k",
        "variants": [
            ("kv_seq_sharded_fsdp", {}),
            ("kv_seq_sharded_tp_only", {}),
        ],
        "fsdp": [True, False],
    },
    # most representative of the paper's technique (merged-request shared
    # prefill): a block-shape sweep, then the fused-region credit
    "prefill": {
        "arch": "llama3-8b", "shape": "prefill_32k",
        "variants": [
            ("baseline", {}),
            ("tp_only_params", {}),
            ("blocks_1k_2k", {"q_block": 1024, "kv_block": 2048}),
            ("blocks_2k_4k", {"q_block": 2048, "kv_block": 4096}),
        ],
        "fsdp": [True, False, False, False],
    },
}


def run_cell(name: str, out: str | None, variant: str | None = None):
    spec = CELLS[name]
    rows = []
    for (tag, overrides), fsdp in zip(spec["variants"], spec["fsdp"]):
        if variant is not None and tag != variant:
            continue
        print(f"=== perf {name}:{tag} ===", flush=True)
        res = lower_cell(spec["arch"], spec["shape"], multi_pod=False,
                         fsdp=fsdp, verbose=False, overrides=overrides,
                         fused_credit=True)
        res["variant"] = tag
        res["cell"] = name
        rows.append(res)
        rl = res.get("roofline", {})
        rf = res.get("roofline_fused", {})
        print(json.dumps({
            "variant": tag, "status": res["status"],
            "t_compute": rl.get("t_compute_s"),
            "t_memory": rl.get("t_memory_s"),
            "t_collective": rl.get("t_collective_s"),
            "bottleneck": rl.get("bottleneck"),
            "mfu": rl.get("mfu_roofline"),
            "fused_t_memory": rf.get("t_memory_s"),
            "fused_mfu": rf.get("mfu_roofline"),
        }, indent=2), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(res) + "\n")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=sorted(CELLS) + ["all"], default="all")
    ap.add_argument("--variant", default=None,
                    help="run only this variant of the cell (one process "
                         "a variant runs a ladder in parallel)")
    ap.add_argument("--out", default="results/perf_torch.jsonl")
    args = ap.parse_args(argv)
    cells = sorted(CELLS) if args.cell == "all" else [args.cell]
    if args.variant is not None and not any(
            t == args.variant for c in cells for t, _ in CELLS[c]["variants"]):
        ap.error(f"no variant {args.variant!r} in {cells}")
    try:
        for c in cells:
            run_cell(c, args.out, args.variant)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
