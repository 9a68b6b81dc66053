"""The command exits with a code other than 0 and prints no result where
it cannot measure: on a host without a CUDA card, and in a directory
that holds only BENCHMARK.json and the benchmark's own files."""

import shutil
import subprocess
import sys

import pytest

from perfbench import bench


def run(cwd):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "smollm.longdoc.backlog", "--seed", str(2**31 + 5), "--seconds",
         "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=120)


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")


def test_no_card_no_result(no_card):
    res = run(bench.ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.PB, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = run(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""
