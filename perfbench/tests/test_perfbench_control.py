"""The control of each served cell's check, at a size a test run holds:
the plain reference with every projection's operands rounded to float8
e4m3 (the precision below the configuration's bf16), put in the
program's place on the prompts and tokens a sound run served, comes out
not correct against the cell's limit, while the program comes out
correct.  On the card, at the cells' own sizes, ``perfbench/control.py``
reads the same two numbers (PERF.md gives the readings)."""

import time

import pytest

from perfbench import bench
from tiny import tiny_cell


@pytest.mark.parametrize("name", ["yi9b.longdoc.backlog",
                                  "smollm.shared_docs.backlog",
                                  "smollm.docqa.paced"])
@pytest.mark.parametrize("seed", [2**31 + 21, 2**31 + 22, 2**31 + 23])
def test_control_fails_where_the_program_passes(name, seed):
    cell, conf = tiny_cell(name)
    out = bench.run_cell(cell, seed, 1.5, False, "cpu", time.perf_counter(),
                         conf=conf, keep=True)
    keep = out.pop("_keep")
    limit = cell.settings["check"]["limit"]
    assert out["correct"] and max(keep["gaps"]) <= limit
    ctl, _ = bench.logit_gaps(cell.reference, conf, keep["params"],
                              keep["items"], quant="fp8",
                              judge=keep["ref_logits"])
    assert max(ctl) > limit
