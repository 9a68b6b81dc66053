"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files and entries are found by name, with no edit to a file that is
there."""

import json
import shutil

from perfbench import bench
from perfbench.traffic import Traffic


def test_new_files_are_found_by_name(tmp_path):
    base = tmp_path / "perfbench"
    shutil.copytree(bench.PB, base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(base): p.read_bytes()
              for p in base.rglob("*") if p.is_file()}
    conf = bench.load_json(base / "configs" / "smollm-360m.json")
    conf["name"] = "smollm-wide"
    (base / "configs" / "smollm-wide.json").write_text(json.dumps(conf))
    mix = bench.load_json(base / "traffic" / "longdoc.json")
    mix["prompt"]["median"] = 512
    (base / "traffic" / "shortdoc.json").write_text(json.dumps(mix))
    cellset = bench.load_json(base / "cells" / "smollm.longdoc.backlog.json")
    (base / "cells" / "smollm-wide.shortdoc.backlog.json").write_text(
        json.dumps(cellset))
    (base / "metrics" / "answered_count.py").write_text(
        "def read(ctx):\n    return len(ctx['records'])\n")
    b = bench.load_json(bench.ROOT / "BENCHMARK.json")
    b["configs"].append({"name": "smollm-wide", "source": "x",
                         "file": "perfbench/configs/smollm-wide.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "smollm-wide.shortdoc.backlog",
                           "config": "smollm-wide", "traffic": "shortdoc",
                           "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "answered_count", "unit": "requests",
                           "better": "higher", "source": "host_clock",
                           "layer": "front door", "moves": "tokens_per_s",
                           "workloads": ["smollm-wide.shortdoc.backlog"]})
    for m in b["end_to_end"] + b["per_layer"]:
        if "smollm.longdoc.backlog" in m.get("workloads", []):
            m["workloads"].append("smollm-wide.shortdoc.backlog")
    cell = bench.Cell(b, "smollm-wide.shortdoc.backlog", base=base)
    assert cell.conf["name"] == "smollm-wide"
    assert cell.mix["prompt"]["median"] == 512
    assert "answered_count" in cell.readers and "mfu" in cell.readers
    assert cell.readers["answered_count"].read({"records": [1, 2]}) == 2
    assert {m["name"] for m in cell.end_to_end} == {"tokens_per_s",
                                                    "setup_s"}
    t = Traffic(cell.mix, 1, cell.conf["vocab_size"])
    assert len(t.spec(0).prompt) <= mix["prompt"]["max"]
    after = {p.relative_to(base): p.read_bytes()
             for p in base.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
