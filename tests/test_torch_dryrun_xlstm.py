"""The xLSTM cells of the port's dry-run (``launch/dryrun.py``), on the CPU.

* On the reduced xLSTM config and a fake (4, 2) mesh, a train step
  traced at one and two units (a prefill at two and three) with its
  scans cut to two trip counts (``OpCounter(trips=k)``) and combined
  bilinearly equals, field for field, the full step traced once at a
  third depth over the whole sequence: dot FLOPs, bytes, fused bytes,
  collectives by kind, count and group, dot calls and kernel credits;
  also under an mLSTM ``chunk``.
* ``ctx.logsigmoid`` is ``F.logsigmoid`` bit for bit on plain tensors; on
  a DTensor its forward and its gradient equal the plain ones on the
  rank's shard (DTensor has no sharding rule for the backward).
* Only the xLSTM family is extrapolated over a trip count: a family with
  attention is refused.
* ``python -m repro_torch.launch.dryrun --arch xlstm-125m --shape
  train_4k`` on the (4, 2) mesh exits 0 with an ``ok`` row.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ShapeConfig, XLSTMConfig
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import op_cost

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def fake_mesh_4x2():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def _fields(cost: op_cost.OpCost) -> dict:
    return {f: getattr(cost, f) for f in (
        "flops", "bytes_accessed", "bytes_fused", "collective_bytes",
        "collectives", "collective_counts", "collective_groups", "dot_calls",
        "kernels")}


# (kind, mLSTM chunk, S): the reduced config, a global batch of 8 (2 rows
# a rank); a train step is traced at one and two units (two and four
# blocks) and held at three, a prefill at two and three and held at four
@pytest.mark.parametrize("kind,chunk,seq", [("train", 0, 32),
                                            ("prefill", 0, 32),
                                            ("train", 8, 32)])
def test_extrapolation_equals_full_trace(fake_mesh_4x2, kind, chunk, seq):
    first = 2 if kind == "prefill" else 1
    cfg = get_arch("xlstm-125m").reduced().scaled(
        n_layers=2 * (first + 2), xlstm=XLSTMConfig(chunk=chunk))
    shape = ShapeConfig("t", seq, 8, kind)
    got = dryrun.cell_cost(cfg, shape, fake_mesh_4x2)
    assert got["traced_units"] == [{"layers": first},
                                   {"layers": first + 1}]
    assert got["traced_trips"] == list(dryrun.SCAN_TRIPS) == [2, 3]
    assert "not traced" in got["memory"]["error"]
    full = dryrun.cell_cost(cfg, shape, fake_mesh_4x2, extrapolate=False)
    assert full["traced_units"] == [{"layers": first + 2}]
    assert "traced_trips" not in full
    want = _fields(full["cost"])
    assert want["flops"] > 0 and want["collective_bytes"] > 0
    assert _fields(got["cost"]) == want
    assert got["memory"]["argument_bytes"] == full["memory"]["argument_bytes"]


def test_trips_cut_scans_only_while_counting():
    """Under a counter made with ``trips=k`` a scan runs k steps and fills
    the rest with copies of step k's output; elsewhere (with a counter
    that cuts nothing, too) it is the plain loop."""
    xs = torch.arange(24.0).reshape(2, 6, 2)

    def step(c, x):
        return c + x, c + x
    ys, c = op_cost.scan(step, torch.zeros(2, 2), xs)
    assert torch.equal(ys, torch.cumsum(xs, dim=1)) and torch.equal(
        c, xs.sum(1))
    (ys_c, c_c), _ = op_cost.count(op_cost.scan, step, torch.zeros(2, 2),
                                   xs)
    assert torch.equal(ys_c, ys) and torch.equal(c_c, c)
    with op_cost.OpCounter(trips=3):
        ys3, c3 = op_cost.scan(step, torch.zeros(2, 2), xs)
    assert torch.equal(ys3[:, :3], ys[:, :3])
    assert torch.equal(ys3[:, 3:], ys[:, 2:3].expand(2, 3, 2))
    assert torch.equal(c3, ys[:, 2])
    with pytest.raises(ValueError):
        op_cost.OpCounter(trips=1)


def test_logsigmoid_plain_is_f_logsigmoid():
    x = torch.randn(64, 33, generator=torch.Generator().manual_seed(0)) * 30
    assert torch.equal(pctx.logsigmoid(x), F.logsigmoid(x))
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    g = torch.randn_like(x)
    ga, = torch.autograd.grad(pctx.logsigmoid(a), a, g)
    gb, = torch.autograd.grad(F.logsigmoid(b), b, g)
    assert torch.equal(ga, gb)


def test_logsigmoid_on_a_dtensor(fake_mesh_4x2):
    """Rank 0's shard of a DTensor batch-sharded over 'data': the forward
    and the gradient through ``ctx.logsigmoid`` equal the plain ones on
    that shard bit for bit (the backward has no DTensor rule)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = fake_mesh_4x2
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(8, 5, generator=gen) * 30
    g = torch.randn(8, 5, generator=gen)
    pl = [Shard(0), Replicate()]
    mine, gmine = x[:2], g[:2]                 # rank 0's rows
    pctx.configure(mesh)
    try:
        xd = DTensor.from_local(mine.clone(), mesh, pl,
                                run_check=False).requires_grad_()
        gd = DTensor.from_local(gmine, mesh, pl, run_check=False)
        y = pctx.logsigmoid(xd)
        assert isinstance(y, DTensor) and tuple(y.placements) == tuple(pl)
        dx, = torch.autograd.grad(y, xd, gd)
        with torch.no_grad():
            y_ng = pctx.logsigmoid(xd)         # DTensor's forward rule
    finally:
        pctx.disable()
    plain = mine.clone().requires_grad_()
    want = F.logsigmoid(plain)
    dwant, = torch.autograd.grad(want, plain, gmine)
    assert torch.equal(y.to_local(), want.detach())
    assert torch.equal(dx.to_local(), dwant)
    torch.testing.assert_close(y_ng.to_local(), want.detach(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-2.7b",
                                  "deepseek-moe-16b"])
def test_attention_families_refuse_trip_extrapolation(arch):
    with pytest.raises(ValueError, match="full length"):
        dryrun.scan_trips(get_arch(arch))
    assert dryrun.scan_trips(get_arch("xlstm-125m")) == (2, 3)


def test_dryrun_cli_xlstm_train_4k(tmp_path):
    env = dict(os.environ, DRYRUN_DEVICES="8", DRYRUN_MESH="4,2",
               PYTHONPATH=str(ROOT / "src"))
    out = tmp_path / "rows.jsonl"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-125m", "--shape", "train_4k", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=900, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    row = json.loads(out.read_text())
    assert row["status"] == "ok" and row["chips"] == 8
    assert row["traced_units"] == [{"layers": 1}, {"layers": 2}]
    assert row["traced_trips"] == [2, 3]
    rl = row["roofline"]
    assert rl["flops_per_chip"] > 0 and rl["bytes_per_chip"] > 0
    assert rl["collective_counts"]["all-reduce"] > 0
    assert row["memory"]["argument_bytes"] > 0
