#!/usr/bin/env python3
"""The dot products of the JAX package's dry-run of one cell, grouped by
shape, each multiplied by the trip counts of the loops around it (the
FLOPs ``repro.parallel.hlo_cost`` sums into ``flops_per_chip``):

    DRYRUN_DEVICES=8 DRYRUN_MESH=4,2 PYTHONPATH=src JAX_PLATFORMS=cpu \\
        python tools/hlo_dots.py xlstm-125m train_4k [--top 25]

One line a group, most FLOPs first: total FLOPs, count, FLOPs a dot, the
loop trip counts around it (``/w4096``: inside a 4,096-trip loop), and
the result and operand shapes.  Then the sum, and last the cell's
``flops_per_chip``, which it equals.  Reads the compiled HLO of
``repro.launch.dryrun.lower_cell`` on the forced host devices.
"""

from __future__ import annotations

import argparse
import collections
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    os.environ.setdefault("DRYRUN_DEVICES", "8")
    from repro.launch import dryrun as D       # sets XLA_FLAGS first
    from repro.parallel import hlo_cost as H

    saved = {}
    analyze = D.RL.analyze

    def keep(compiled, **kw):
        saved["hlo"] = kw["hlo_text"]
        return analyze(compiled, **kw)
    D.RL.analyze = keep
    row = D.lower_cell(args.arch, args.shape, False, verbose=False)
    comps, entry = H.parse_module(saved["hlo"])
    groups = collections.Counter()

    def walk(name, mult, loops):
        comp = comps[name]
        for ins in comp.instrs:
            if ins.opcode == "dot":
                shapes = ([d for _, d in ins.result], [
                    [d for _, d in comp.symbols.get(o) or []]
                    for o in ins.operand_names])
                groups[(str(shapes), H._dot_flops(comp, ins), loops)] += mult
            if ins.opcode == "while":
                trips = ins.trip if ins.trip is not None else \
                    H._trip_count(comps, ins.attrs.get("condition"))
                walk(ins.attrs.get("body"), mult * trips,
                     f"{loops}/w{trips}")
            elif ins.opcode in ("fusion", "call"):
                for k in ("calls", "to_apply"):
                    if ins.attrs.get(k) in comps:
                        walk(ins.attrs[k], mult, loops)
            for b in ins.branches:
                if b in comps:
                    walk(b, mult, loops)
    walk(entry, 1, "")
    total = 0.0
    ranked = sorted(groups.items(), key=lambda kv: -kv[0][1] * kv[1])
    for i, ((shapes, flops, loops), n) in enumerate(ranked):
        total += n * flops
        if i < args.top:
            print(f"{n * flops:.4e} {n:7d} x {flops:.4e} {loops or '-'} "
                  f"{shapes}")
    print(f"sum {total:.6e}")
    print(f"flops_per_chip {row['roofline']['flops_per_chip']:.6e}")


if __name__ == "__main__":
    main()
