"""The correctness check of a run, driven whole on the CPU at a size a
test holds (``tiny.py``), with the harness's look for a card skipped: a
sound run comes out correct, and a run whose timed path is broken
underneath comes out not correct, once for each fault a served cell can
have (a decode step that returns its state unchanged, half of each batch
left out, a token altered where it is produced)."""

import time

import pytest

from perfbench import bench
from tiny import tiny_cell

CELLS = ("yi9b.longdoc.backlog", "smollm.shared_docs.backlog",
         "smollm.docqa.paced", "smollm.longdoc.backlog")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, trace):
    cell, conf = tiny_cell(name)
    out = bench.run_cell(cell, 2**31 + 11, 1.5, trace, "cpu",
                         time.perf_counter(), conf=conf)
    assert out["correct"], out["checks"]
    assert out["checks"]["judged_requests"]["value"] >= 1
    assert list(out)[-1] == "checks"
    want = cell.per_layer if trace else cell.end_to_end
    # on the CPU the readers of the card's trace and peaks find nothing
    card = {"mfu", "device_idle_share", "paged_decode_attention_roofline"}
    assert set(out["metrics"]) == {m["name"] for m in want} - card


@pytest.mark.parametrize("fault", ["stale_state", "half_batch",
                                   "token_altered"])
@pytest.mark.parametrize("name", ["smollm.longdoc.backlog",
                                  "yi9b.longdoc.backlog",
                                  "smollm.shared_docs.backlog"])
def test_broken_timed_path_is_not_correct(name, fault):
    cell, conf = tiny_cell(name)
    out = bench.run_cell(cell, 2**31 + 13, 1.5, False, "cpu",
                         time.perf_counter(), conf=conf, fault=fault)
    assert not out["correct"], out["checks"]
