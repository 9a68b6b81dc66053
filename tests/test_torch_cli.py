"""Subprocess twins of ``tests/test_cli.py``'s serve cases for the port's
launcher, ``python -m repro_torch.launch.serve``, run with ``--device
cpu``.  Each checks the JSON summary's keys and counters as the JAX test
does; the flight-record artifact of ``--record-out`` is checked against
the port's copy of the schema.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.obs import (SCHEMA_VERSION, validate_chrome_trace,
                             validate_flight_record,
                             validate_metrics_snapshot,
                             validate_telemetry_summary)

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
ENV = dict(os.environ, PYTHONPATH=SRC)


def _serve(args, timeout=900, device="cpu"):
    dev = [] if device is None else ["--device", device]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve"] + args + dev,
        capture_output=True, text=True, env=ENV, timeout=timeout)
    assert out.returncode == 0, (out.stdout[-1500:], out.stderr[-1500:])
    return out.stdout


def test_serve_cli():
    stats = json.loads(_serve(["--requests", "12", "--units", "1",
                               "--merging", "adaptive", "--pruning",
                               "--rate", "0.5"]))
    assert stats["completed"] > 0
    assert stats["completed"] + stats["dropped"] == 12
    assert stats["batching"] is None


def test_serve_cli_batching():
    out = _serve(["--requests", "10", "--units", "1", "--rate", "0.5",
                  "--max-batch", "4", "--step-token-budget", "32"])
    # the batching knobs are echoed back in the JSON summary
    assert '"max_batch": 4' in out and '"step_token_budget": 32' in out
    assert json.loads(out)["completed"] > 0


def test_serve_cli_autoscale():
    out = _serve(["--requests", "10", "--units", "1", "--rate", "0.5",
                  "--autoscale", "success-chance", "--max-extra-units", "1"])
    # the autoscale decision counters ride in the JSON summary
    assert '"scale_ups"' in out and '"machine_seconds"' in out
    assert '"warmup_ticks"' in out


def test_serve_cli_fleet():
    out = _serve(["--requests", "8", "--rate", "0.5",
                  "--fleet", "tpu:1:1.0:1.0,cpu:1:0.5:0.25",
                  "--heuristic", "MCMD", "--max-extra-units", "0"])
    # the fleet spec and the per-mtype cost counters ride in the summary
    assert '"fleet": "tpu:1:1:1:auto:4,cpu:1:0.5:0.25:auto:4"' in out
    assert '"cost"' in out and '"pool_cost"' in out


def test_serve_cli_multiplane():
    stats = json.loads(_serve(["--requests", "10", "--units", "1",
                               "--planes", "2", "--router", "affinity",
                               "--rate", "0.5"]))
    assert stats["completed"] > 0
    # per-plane stats + routing counters ride in the JSON summary
    assert [p["plane"] for p in stats["planes"]] == [0, 1]
    assert stats["router"]["policy"] == "affinity"
    assert stats["router"]["submitted"] == 10
    assert "deadlock_breaks" in stats


def test_serve_cli_telemetry_out(tmp_path):
    """--trace-out/--metrics-out/--events-out artifacts validate, and the
    JSON summary carries the consolidated ``telemetry`` key beside the
    legacy top-level counters."""
    trace = tmp_path / "trace.json"
    metrics = tmp_path / "metrics.json"
    events = tmp_path / "events.jsonl"
    stats = json.loads(_serve([
        "--requests", "10", "--units", "1", "--merging", "adaptive",
        "--pruning", "--rate", "0.5", "--trace-out", str(trace),
        "--metrics-out", str(metrics), "--events-out", str(events)]))
    tel = stats["telemetry"]
    assert tel["schema"] == SCHEMA_VERSION
    for k, v in tel["counters"].items():
        assert stats.get(k, 0) == v, k
    assert tel["wall"]["mapping_wall_s"] == stats["mapping_wall_s"]
    assert tel["wall"]["pruning_wall_s"] == stats["pruning_wall_s"]
    validate_metrics_snapshot(tel["metrics"])
    validate_chrome_trace(json.loads(trace.read_text()))
    validate_metrics_snapshot(json.loads(metrics.read_text()))
    ev = [json.loads(line) for line in events.read_text().splitlines()]
    assert ev and all("t" in e and "kind" in e for e in ev)


def test_serve_cli_closed_loop():
    """--workload closed_loop drives the port's Router with multi-turn
    sessions; per-turn and per-tenant counters ride in the summary."""
    stats = json.loads(_serve(["--workload", "closed_loop:6:2", "--turns",
                               "3", "--tenants", "gold:1:0.5:1,free:3",
                               "--units", "1", "--rate", "0.5"]))
    wl = stats["workload"]
    assert wl["mode"] == "closed_loop"
    assert wl["sessions_done"] == 6
    turns = wl["per_turn"]
    assert [r["turn"] for r in turns] == [0, 1, 2]
    assert all(r["submitted"] == 6 for r in turns)
    assert sum(r["completed"] for r in turns) == stats["completed"]
    tenants = wl["tenants"]
    assert set(tenants) == {"gold", "free"}
    assert sum(t["submitted"] for t in tenants.values()) == 18
    for t in tenants.values():
        assert 0.0 <= t["on_time_rate"] <= 1.0
    assert stats["telemetry"]["workload"] == wl
    validate_telemetry_summary(stats["telemetry"])
    assert "slo" in stats["telemetry"]
    counters = stats["telemetry"]["metrics"]["counters"]
    assert any(k.startswith("tenant_completed{") for k in counters)


def test_serve_cli_record_out(tmp_path):
    """--record-out writes one flight record that passes the schema check
    and carries the arrivals and the kernel profile."""
    rec_p = tmp_path / "run.record.json"
    stats = json.loads(_serve(["--requests", "8", "--units", "1",
                               "--rate", "0.5", "--record-out",
                               str(rec_p)]))
    assert stats["telemetry"]["record_out"] == str(rec_p)
    rec = json.loads(rec_p.read_text())
    validate_flight_record(rec)
    assert len(rec["arrivals"]) == 8
    assert rec["kernel"]["launches"] > 0


def test_serve_cli_defaults_to_cuda():
    """Without ``--device`` the launcher runs on CUDA and fails on a host
    without a card instead of quietly serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--requests",
         "2"], capture_output=True, text=True, env=ENV, timeout=300)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert '"completed"' not in out.stdout
