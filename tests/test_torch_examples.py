"""The port's examples (``repro_torch.examples``) as subprocesses, on the
CPU.

* ``quickstart`` and ``oversubscription_demo`` print exactly what the
  JAX package's ``examples/`` scripts print: both run the simulator on
  the same seeds over their own copies of ``core/``.
* ``serve_smse --device cpu --requests 12`` accounts for every request
  (completed + dropped == 12).  Its statistics rest partly on measured
  wall time, so they are not held to the JAX example's.
* ``train_100m --device cpu --steps 3`` logs a finite loss and
  checkpoints; a second run to step 5 resumes from step 3.
* Without a card, both model examples refuse their default CUDA device.
"""

import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="2")


def _port(name, *args):
    return subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", *args],
        capture_output=True, text=True, env=ENV, timeout=600, cwd=ROOT)


@pytest.mark.parametrize("name", ["quickstart", "oversubscription_demo"])
def test_prints_what_the_jax_example_prints(name):
    jax_run = subprocess.Popen([sys.executable, f"examples/{name}.py"],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True, env=ENV, cwd=ROOT)
    port = _port(name)
    out, err = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, err[-2000:]
    assert port.returncode == 0, port.stderr[-2000:]
    assert out.strip()
    assert port.stdout == out


def test_serve_smse_accounts_for_every_request():
    res = _port("serve_smse", "--device", "cpu", "--requests", "12")
    assert res.returncode == 0, res.stderr[-2000:]
    field = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^(submitted|requests|completed|dropped \(pruned\))\s+(\d+)",
        res.stdout, re.M)}
    assert field["submitted"] == field["requests"] == 12
    assert field["completed"] + field["dropped (pruned)"] == 12
    assert "routed per plane" in res.stdout


def test_train_100m_trains_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = _port("train_100m", "--device", "cpu", "--steps", "3",
                  "--ckpt-dir", ckpt)
    assert first.returncode == 0, first.stderr[-2000:]
    losses = [float(x) for x in re.findall(r"loss (\S+)  lr", first.stdout)]
    assert losses and all(math.isfinite(x) for x in losses)
    assert "finished at step 3" in first.stdout
    assert "resuming" not in first.stdout
    second = _port("train_100m", "--device", "cpu", "--steps", "5",
                   "--ckpt-dir", ckpt)
    assert second.returncode == 0, second.stderr[-2000:]
    assert "resuming from the checkpoint at step 3" in second.stdout
    assert "finished at step 5" in second.stdout


@pytest.mark.parametrize("name", ["serve_smse", "train_100m"])
def test_model_examples_refuse_without_a_card(name, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    res = _port(name, "--steps", "1") if name == "train_100m" else \
        _port(name, "--requests", "1")
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
