"""BENCHMARK.json against the benchmark's contract: names and units of
the allowed characters, every file it names present, every cell with
set-up time, another end-to-end metric and a per-layer metric, each
per-layer metric listed only where its end-to-end metric is reported,
and a run length that fits the check's time with 24 cells."""

import re

from perfbench import bench

B = bench.load_json(bench.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 \
        and "\n" not in s and "\t" not in s


def test_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "perfbench/run.py"]
    assert all(PATH.match(p) and ".." not in p for p in B["paths"])
    assert len((bench.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    metrics = B["end_to_end"] + B["per_layer"]
    names = [x["name"] for x in B["configs"] + B["workloads"] + metrics]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in metrics)) == len(metrics)
    assert len(set(x["name"] for x in B["workloads"])) == len(B["workloads"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert one_line(w["why"]) and w["chips"] in (1, 4)
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for m in B["per_layer"]:
        assert one_line(m["layer"])


def test_end_to_end_bounds():
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in B["end_to_end"])


def test_every_cell_reports_what_it_must():
    for w in B["workloads"]:
        cell = bench.Cell(B, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


def test_every_named_file_is_under_paths():
    for c in B["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        conf = bench.load_json(bench.ROOT / c["file"])
        assert conf["name"] == c["name"]
        for k in c["reduced"]:
            assert conf[k] != conf["published"][k]
        assert set(conf["published"]) == set(c["reduced"])
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}


def test_run_length_fits_the_check():
    r = B["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert 2 + 14 * 24 * (r + 60) + 24 * 2 * 90 + 1200 <= 43200 or \
        (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200
