"""No module that a run of the harness loads has the top-level name of JAX,
jaxlib, Flax or the JAX package ``repro`` (compared whole: ``repro_torch``
is the program under test).  A whole run of a cell, cut to CPU size, is
made in a fresh process, and its ``sys.modules`` is read after it."""

import json
import subprocess
import sys

from perfbench import bench

CODE = """
import json, sys, time
sys.path[:0] = [{root!r}, {root!r} + '/src', {tests!r}]
from perfbench import bench
from tiny import tiny_cell
cell, conf = tiny_cell('smollm.shared_docs.backlog')
out = bench.run_cell(cell, 77, 1.0, True, 'cpu', time.perf_counter(),
                     conf=conf)
print(json.dumps({{'tops': sorted({{m.split('.')[0] for m in sys.modules}}),
                  'forbidden': bench.forbidden_modules(),
                  'correct': out['correct']}}))
"""


def test_a_run_loads_no_jax():
    code = CODE.format(root=str(bench.ROOT),
                       tests=str(bench.PB / "tests"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "repro"} & set(out["tops"])
    assert "repro_torch" in out["tops"] and "perfbench" in out["tops"]
    assert out["correct"] is True


def test_forbidden_names_compare_whole():
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_x"] = sys
        sys.modules["jaxfoo"] = sys
        assert "repro" not in bench.forbidden_modules()
        assert "jax" not in bench.forbidden_modules()
        sys.modules["repro.thing"] = sys
        assert "repro" in bench.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
