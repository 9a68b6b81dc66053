"""The port's op counter and roofline (``parallel/{op_cost,roofline}``) and
the dry-run launcher, on the CPU.

* The hand counts of ``tests/test_roofline_analysis.py``: a matmul, causal
  full and flash attention, remat'd layers under a gradient, nested loops.
* Per rank: on a fake (4, 2) mesh, rank 0's count of a sharded product is
  its local share (19,660,800), not the global product's 157,286,400
  (what ``FlopCounterMode`` reports), and a redistribution is counted as
  an all-gather of its group's size.
* On reduced dense, moe, hybrid and xLSTM configs, the port's dot FLOPs
  of a prefill and a decode step equal ``repro.parallel.hlo_cost``'s
  count of the JAX compiled function exactly; a train step's differ by
  the pinned amounts the test names.
* Kernel credits and fused regions; the roofline's terms with the H100
  constants and the link a group crosses.
* The dry-run's depth extrapolation: for dense, moe, hybrid, enc-dec and
  xLSTM steps on a fake (4, 2) mesh, the count from
  one and two units of each stack (a prefill's from two and three)
  equals a full trace at a third depth, field for field.
* ``tools/hlo_dots.py``'s dots of a JAX dry-run cell sum to its
  ``flops_per_chip``.
* The dry-run CLI on a (4, 2) mesh of the fake backend, the twins of
  ``tests/test_cli.py``'s and ``tests/test_parallel.py``'s dry-run tests.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import transformer as JT
from repro.parallel.hlo_cost import analyze_text
from repro_torch.configs.registry import get_arch
from repro_torch.models import transformer as T
from repro_torch.models.layers import flash_attention, full_attention
from repro_torch.parallel import op_cost
from repro_torch.parallel import roofline as RL

ROOT = Path(__file__).resolve().parents[1]


class TestFlopCounting:
    def test_matmul_exact(self):
        a, b = torch.randn(256, 512), torch.randn(512, 128)
        _, cost = op_cost.count(torch.matmul, a, b)
        assert cost.flops == 2 * 256 * 512 * 128
        assert cost.bytes_accessed == 4 * (256 * 512 + 512 * 128 + 256 * 128)

    def test_full_attention_exact(self):
        q = torch.randn(2, 128, 4, 32)
        _, cost = op_cost.count(full_attention, q, q, q, True)
        assert cost.flops == 2 * 2 * (2 * 128 * 128 * 4 * 32)

    def test_flash_loops_counted(self):
        q = torch.randn(2, 128, 4, 32)
        with torch.no_grad():
            _, cost = op_cost.count(flash_attention, q, q, q, True, 32, 32)
        assert cost.flops == 2 * 2 * (2 * 128 * 128 * 4 * 32)
        # the flash region costs its boundary bytes in the fused count
        assert cost.bytes_fused < cost.bytes_accessed / 4

    def test_remat_layers_under_grad(self):
        from torch.utils.checkpoint import checkpoint
        x = torch.randn(64, 128)
        ws = torch.randn(4, 128, 128, requires_grad=True)

        def loss():
            h = x
            for w in ws.unbind(0):
                h = checkpoint(lambda h, w: torch.tanh(h @ w), h, w,
                               use_reentrant=False)
            h.sum().backward()
        _, cost = op_cost.count(loss)
        # each layer: forward, recomputed forward, dW; dh for layers 1-3
        # (x needs no gradient)
        assert cost.flops == 2 * 64 * 128 * 128 * (4 * 3 + 3)

    def test_nested_loops(self):
        x, w = torch.randn(128, 128), torch.randn(128, 128)

        def f(c):
            for _ in range(5):
                for _ in range(3):
                    c = c @ w
            return c
        assert op_cost.count(f, x)[1].flops == 2 * 128 ** 3 * 15


@pytest.fixture
def fake_mesh_4x2():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def test_rank_count_is_the_local_share(fake_mesh_4x2):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode
    mesh = fake_mesh_4x2
    x = distribute_tensor(torch.empty(32, 960, device="meta"), mesh,
                          [Shard(0), Replicate()])
    w = distribute_tensor(torch.empty(960, 2560, device="meta"), mesh,
                          [Replicate(), Shard(1)])
    y, cost = op_cost.count(torch.matmul, x, w)
    assert y.to_local().shape == (8, 1280)
    assert cost.flops == 2 * 8 * 960 * 1280 == 19_660_800
    assert cost.collective_bytes == 0
    with FlopCounterMode(display=False) as fc:
        torch.matmul(x, w)
    assert fc.get_total_flops() == 157_286_400          # the global product
    # gathering the model-sharded columns: one all-gather over 2 ranks
    _, cost = op_cost.count(lambda: y.redistribute(mesh,
                                                   [Shard(0), Replicate()]))
    assert cost.collective_counts == {"all-gather": 1}
    assert cost.collectives["all-gather"] == 8 * 2560 * 4
    assert cost.collective_groups == {2: 8 * 2560 * 4}


# (arch, kind) -> the port's dot FLOPs minus the JAX HLO count, at B=2,
# S=16 of the reduced configs.  Prefill and decode run the same products.
# A train step differs where the programs differ:
#  * the port recomputes every loss chunk's logits product in the backward
#    (each chunk is checkpointed); XLA keeps them: 2 x B x S x d x V;
#  * a checkpointed layer recomputes its whole forward, also its last
#    products, whose results the backward never reads (deepseek-moe's MoE
#    combine einsum, 655,360, and shared experts' down projection,
#    1,048,576); XLA's remat drops them as dead code, and turns a
#    2,560-FLOP sliver of the routing into a dot where PyTorch multiplies;
#  * the backward of the SSD scan's three-operand einsums contracts in
#    another order: a 65,536-FLOP product where XLA has a 4,096-FLOP one,
#    once per Mamba2 layer (zamba2: 6);
#  * xLSTM (2 pairs, 4 heads of 64 in the mLSTM, d 128 in the sLSTM):
#    the backward of the mLSTM step's q.C product computes its C
#    gradient as an outer-product bmm, and of the q.n product two rank-1
#    bmms, which XLA computes elementwise (XLSTM_OUTER: per pair and
#    step, 2 x B x H x hd x hd and 2 x 2 x B x H x hd); and the sLSTM's
#    first step has no h gradient to form (its state is a constant zero),
#    where the scan body of XLA computes one every step (XLSTM_H0: per
#    pair, 2 x B x d x d).
LOGITS = 2 * 2 * 16 * 128 * 512
XLSTM_OUTER = 2 * 16 * (2 * 2 * 4 * 64 * 64 + 2 * 2 * 2 * 4 * 64)
XLSTM_H0 = 2 * (2 * 2 * 128 * 128)
FLOP_DIFF = {
    ("smollm-360m", "prefill"): 0, ("smollm-360m", "decode"): 0,
    ("smollm-360m", "train"): LOGITS,
    ("deepseek-moe-16b", "prefill"): 0, ("deepseek-moe-16b", "decode"): 0,
    ("deepseek-moe-16b", "train"): LOGITS + 655_360 + 1_048_576 - 2_560,
    ("zamba2-2.7b", "prefill"): 0, ("zamba2-2.7b", "decode"): 0,
    ("zamba2-2.7b", "train"): LOGITS + 6 * (65_536 - 4_096),
    ("xlstm-125m", "prefill"): 0, ("xlstm-125m", "decode"): 0,
    ("xlstm-125m", "train"): LOGITS + XLSTM_OUTER - XLSTM_H0,
}
B, S, MAXLEN = 2, 16, 24


def _requires_grad(tree):
    if isinstance(tree, dict):
        return {k: _requires_grad(v) for k, v in tree.items()}
    return tree.requires_grad_()


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-moe-16b",
                                  "zamba2-2.7b", "xlstm-125m"])
def test_dot_flops_equal_jax_hlo(arch):
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    assert (cfg.d_model, cfg.vocab) == (128, 512)
    jp = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    i32 = jax.ShapeDtypeStruct((B, S), jnp.int32)
    toks = torch.zeros((B, S), dtype=torch.long)

    def hlo(fn, *args):
        return analyze_text(jax.jit(fn).lower(*args).compile()
                            .as_text()).flops

    got = {}
    with torch.no_grad():
        (_, cache), cost = op_cost.count(T.prefill_fn(cfg), params,
                                         {"tokens": toks}, MAXLEN)
        got["prefill"] = (cost.flops, hlo(
            lambda p, b: JT.prefill_fn(jcfg)(p, b, MAXLEN), jp,
            {"tokens": i32}))
        _, cost = op_cost.count(T.decode_fn(cfg), params, cache,
                                torch.zeros((B,), dtype=torch.long))
        jc = jax.eval_shape(lambda: JT.init_cache(jcfg, B, MAXLEN))
        got["decode"] = (cost.flops, hlo(
            JT.decode_fn(jcfg), jp, jc, jax.ShapeDtypeStruct((B,), jnp.int32)))
    params = _requires_grad(params)

    def train():
        T.loss_fn(cfg)(params, {"tokens": toks, "labels": toks}).backward()
    _, cost = op_cost.count(train)
    got["train"] = (cost.flops, hlo(jax.value_and_grad(JT.loss_fn(jcfg)), jp,
                                    {"tokens": i32, "labels": i32}))
    for kind, (port, jax_flops) in got.items():
        assert port - jax_flops == FLOP_DIFF[(arch, kind)], (kind, port,
                                                            jax_flops)


def test_kernel_credits_and_regions():
    assert not op_cost.active()
    op_cost.credit("rmsnorm", (torch.zeros(4, 8),), torch.zeros(4, 8))
    op_cost.record_collective("all-reduce", 64, 2)    # nothing counts

    def step():
        x = torch.zeros(4, 8)
        op_cost.credit("rmsnorm", (x, torch.zeros(8)), x)
        op_cost.credit("decode_attention", (), (), flops=10.0, nbytes=100)
        op_cost.record_collective("all-reduce", 64, 16)
        return op_cost.region("scan", lambda a: (a + 1) * 2, x)
    _, cost = op_cost.count(step)
    assert cost.kernels["rmsnorm"] == {"launches": 1,
                                       "bytes": 4 * (32 + 8 + 32),
                                       "flops": 0.0}
    assert cost.kernels["decode_attention"]["flops"] == 10.0
    assert cost.flops == 10.0
    # the two zeros write 160 bytes; the region's two ops read and write
    # 128 bytes each; fused, the region is its input and output once
    assert cost.bytes_accessed == 4 * 72 + 100 + 160 + 4 * 128
    assert cost.bytes_fused == 4 * 72 + 100 + 160 + 2 * 128
    assert cost.collective_groups == {16: 64}


def test_affine_extrapolation():
    a = op_cost.OpCost(flops=10.0, collectives={"all-gather": 4.0},
                       kernels={"rmsnorm": {"launches": 3, "bytes": 6.0,
                                            "flops": 0.0}})
    b = op_cost.OpCost(flops=16.0, collectives={"all-gather": 6.0},
                       kernels={"rmsnorm": {"launches": 5, "bytes": 10.0,
                                            "flops": 0.0}})
    c = op_cost.affine([(1.0, a), (31.0, b), (-31.0, a)])   # 32 layers
    assert c.flops == 10 + 31 * 6
    assert c.collectives["all-gather"] == 4 + 31 * 2
    assert c.kernels["rmsnorm"]["launches"] == 3 + 31 * 2


# each family at its reduced widths, a global batch of 8 (2 rows a rank)
# and 32 positions: traced at one and two units of each stack (a prefill
# at two and three) and held at a third depth (the xLSTM train and
# prefill steps, whose scans are also cut, are
# ``test_torch_dryrun_xlstm.py``'s)
@pytest.mark.parametrize("arch,kind", [
    ("smollm-360m", "train"), ("smollm-360m", "prefill"),
    ("smollm-360m", "decode"), ("deepseek-moe-16b", "prefill"),
    ("zamba2-2.7b", "train"), ("zamba2-2.7b", "prefill"),
    ("zamba2-2.7b", "decode"), ("seamless-m4t-medium", "train"),
    ("seamless-m4t-medium", "prefill"), ("xlstm-125m", "decode")])
def test_depth_extrapolation_equals_full_trace(fake_mesh_4x2, arch, kind):
    """The dry-run's extrapolated count equals the whole step traced once
    at that depth, field for field (dot FLOPs, bytes, fused bytes,
    collectives by kind, count and group, dot calls, kernel credits)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    first = 2 if kind == "prefill" else 1
    cfg = get_arch(arch).reduced()
    deep = {}
    for _, _, fields in dryrun._stacks(cfg):
        deep.update(fields(first + 2))
    cfg = cfg.scaled(**deep)
    names = [n for n, _, _ in dryrun._stacks(cfg)]
    shape = ShapeConfig("t", 32, 8, kind)
    got = dryrun.cell_cost(cfg, shape, fake_mesh_4x2)
    assert got["traced_units"][0] == {n: first for n in names}
    assert len(got["traced_units"]) == 1 + len(names)
    full = dryrun.cell_cost(cfg, shape, fake_mesh_4x2, extrapolate=False)
    assert full["traced_units"] == [{n: first + 2 for n in names}]

    def fields(cost):
        return {f: getattr(cost, f) for f in (
            "flops", "bytes_accessed", "bytes_fused", "collective_bytes",
            "collectives", "collective_counts", "collective_groups",
            "dot_calls", "kernels")}
    want = fields(full["cost"])
    assert want["flops"] > 0 and want["bytes_accessed"] > 0
    assert fields(got["cost"]) == want
    assert got["memory"]["argument_bytes"] == \
        full["memory"]["argument_bytes"]


class TestRooflineModel:
    def test_terms_and_bottleneck(self):
        r = RL.Roofline(flops=989e12, bytes_accessed=3.35e12 * 2,
                        collective_bytes=450e9 * 0.5 + 50e9 * 0.25,
                        collectives={}, collective_counts={},
                        collective_groups={8: 450e9 * 0.5,
                                           16: 50e9 * 0.25},
                        model_flops_total=989e12 * 256, chips=256)
        assert r.t_compute == pytest.approx(1.0)
        assert r.t_memory == pytest.approx(2.0)
        assert r.t_collective == pytest.approx(0.75)
        assert r.bottleneck == "memory"
        assert r.step_time == pytest.approx(2.0)
        assert r.mfu_roofline == pytest.approx(0.5)
        assert r.useful_flops_ratio == pytest.approx(1.0)
        keys = set(r.to_dict())
        assert {"flops_per_chip", "bytes_per_chip", "t_compute_s",
                "t_memory_s", "t_collective_s", "bottleneck",
                "roofline_step_time_s", "mfu_roofline", "chips"} <= keys

    def test_links(self):
        assert RL.link_bw(8) == RL.NVLINK_BW == 450e9
        assert RL.link_bw(16) == RL.IB_BW == 50e9
        assert (RL.PEAK_FLOPS, RL.HBM_BW) == (989e12, 3.35e12)


@pytest.mark.parametrize("arch", ["xlstm-125m", "smollm-360m"])
def test_dryrun_cli_tiny_decode(arch, tmp_path):
    env = dict(os.environ, DRYRUN_DEVICES="8", DRYRUN_MESH="4,2",
               PYTHONPATH=str(ROOT / "src"))
    out = tmp_path / "rows.jsonl"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", "decode_32k", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "roofline" in res.stdout
    import json
    row = json.loads(out.read_text())
    assert row["status"] == "ok" and row["chips"] == 8
    assert row["roofline"]["flops_per_chip"] > 0
    assert row["memory"]["argument_bytes"] > 0


def test_hlo_dots_sums_to_the_jax_dryrun_flops():
    """``tools/hlo_dots.py`` (the JAX dry-run's dots by shape, each times
    the trip counts of its loops) sums to the cell's ``flops_per_chip``."""
    env = dict(os.environ, DRYRUN_DEVICES="8", DRYRUN_MESH="4,2",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "hlo_dots.py"), "xlstm-125m",
         "decode_32k", "--top", "3"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-2].startswith("sum ") and \
        lines[-1].startswith("flops_per_chip ")
    total, want = float(lines[-2].split()[1]), float(lines[-1].split()[1])
    assert total > 0 and total == want
    assert any("/w" in ln for ln in lines[:-2])   # a dot inside the scan


def test_perf_cells_equal_jax():
    """``launch/perf.py``'s cells and variant ladders are the JAX
    package's (compared in a subprocess: the JAX module sets
    ``XLA_FLAGS`` when imported)."""
    code = (
        "import json\n"
        "from repro.launch.perf import CELLS as J\n"
        "from repro_torch.launch.perf import CELLS as P\n"
        "def norm(c):\n"
        "    return {k: [c[k]['arch'], c[k]['shape'], c[k]['fsdp'],\n"
        "                [(t, repr(o)) for t, o in c[k]['variants']]]\n"
        "            for k in c}\n"
        "assert norm(J) == norm(P), (norm(J), norm(P))\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               DRYRUN_DEVICES="1", JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "ok"
