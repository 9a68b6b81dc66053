"""The Mamba2 scan on each rank's (batch, head) shards (``ctx.per_shard_bh``).

GSPMD partitions JAX's ``lax.scan`` over a carry sharded on batch and
heads: each chip runs its own rows and heads, with no collective inside
the scan.  The port's dry-run does the same through ``ctx.per_shard_bh``,
whose body is plain tensors (DTensor of torch 2.11 refuses the scan's
einsums on DTensors at the dry-run's placements, and cumsum's backward).

* In an 8-rank ``gloo`` world on a (4, 2) mesh (``torch_dist_worker.
  run_ssm``): the Mamba2 block over 9 steps (the chunked scan, chunks of
  4, the last padded), then one decode step from the state it leaves,
  with the activations batch-sharded over 'data': both outputs, the
  states and the gradients of the input and every weight equal the plain
  block's on the whole batch within 1e-5; the states keep their (batch,
  head) split, and each rank holds its own 2 rows and 2 heads.
* In the same world, the weights placed as the dry-run places them
  (``param_specs``, FSDP on): in_proj's 132 columns split 66 / 66 over
  'model', an edge that falls 2 columns into B's block, as zamba2-2.7b's
  20,560 columns split 10,280 / 10,280 fall 40 into B's.  The block runs
  on each rank's shards of the batch and of d_inner
  (``ctx.split_channels``, one all-to-all each way, and
  ``ctx.per_shard_channels``, one all-reduce of the mean square each
  way): both outputs, the states and the gradients of the input and
  every weight equal the plain block's within 1e-5 in f32, not exactly
  (the mean square and the products over FSDP shards sum in another
  order), and each weight's gradient keeps the weight's placements.
* In the same world, ``ctx.embedding`` of batch-sharded ids in a table
  whose rows are split over 'model', then ``ctx.matmul`` by a whole
  weight: the output and the gradients of the table and the weight equal
  the plain lookup's (1e-5).  A whole operand's gradient is a partial sum
  over the mesh dims that split the output (the ranks' rows), summed
  where the operand is read back.
* On a fake (4, 2) mesh, the inputs placed as the dry-run places them:
  the forward of the scan and of the step runs no collective, and rank 0
  counts the FLOPs of the plain scan on its (2 rows, 2 heads) shard.
* With the context off, the helper is the function itself.

No JAX here: the block's parity with JAX is held by
``tests/test_torch_family_modules.py``.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_worker as W
from repro_torch.models import ssm
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import op_cost


@pytest.fixture(scope="module")
def ssm_gloo_results(tmp_path_factory):
    """Every rank's results from one 8-rank ``gloo`` world (spawned)."""
    import torch.multiprocessing as mp
    root = tmp_path_factory.mktemp("gloo_ssm")
    ctx = mp.spawn(W.run_ssm, args=(8, str(root), str(root)), nprocs=8,
                   join=False)
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo world did not finish in 600 s")
    return [dict(np.load(root / f"ssm_rank{r}.npz")) for r in range(8)]


@pytest.fixture(scope="module")
def plain_block():
    x, gy, g1, gs = (torch.from_numpy(a) for a in W.mamba2_inputs())
    return {k: v.detach().numpy() for k, v in W.mamba2_block(
        x, gy, g1, gs, W.mamba2_params()).items()}


@pytest.mark.parametrize("rank", range(8))
def test_block_on_each_ranks_shards_equals_the_plain_block(
        ssm_gloo_results, plain_block, rank):
    res = ssm_gloo_results[rank]
    assert set(plain_block) >= {"y", "y1", "state1", "dx", "din_proj",
                                "da_log", "dout_proj"}
    for k, v in plain_block.items():
        np.testing.assert_allclose(res[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{k} rank {rank}")
    for k in ("state", "state1"):
        assert list(res[f"{k}_placements"]) in (
            ["S(0)", "S(1)"], ["Shard(dim=0)", "Shard(dim=1)"]), k
    # rank r is (data r // 2, model r % 2): rows 2 (r // 2) .., heads
    # 2 (r % 2) ..
    lo, h0 = 2 * (rank // 2), 2 * (rank % 2)
    np.testing.assert_allclose(res["state_local"],
                               plain_block["state"][lo:lo + 2, h0:h0 + 2],
                               rtol=1e-5, atol=1e-5)


def test_a_shard_edge_falls_inside_b():
    """in_proj's columns (z, x, B, C, dt) at the test's widths: the
    'model' split's edge lies inside B's block, not at a part's edge."""
    cfg = W.ssm_cfg()
    d_inner = cfg.expand * W.MD
    sizes = [d_inner, d_inner, cfg.n_ssm_heads * cfg.state_dim,
             cfg.n_ssm_heads * cfg.state_dim, cfg.n_ssm_heads]
    edge, starts = sum(sizes) // 2, np.cumsum([0] + sizes)
    assert (edge, starts[2], starts[3]) == (66, 64, 96)


@pytest.mark.parametrize("rank", range(8))
def test_block_on_the_dry_runs_placements_equals_the_plain_block(
        ssm_gloo_results, plain_block, rank):
    res = ssm_gloo_results[rank]
    for k, v in plain_block.items():
        np.testing.assert_allclose(res[f"spec_{k}"], v, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{k} rank {rank}")
    want = {"din_proj": ["S(0)", "S(1)"], "dconv_w": ["R", "S(1)"],
            "dnorm_scale": ["R", "S(0)"], "dout_proj": ["S(1)", "S(0)"],
            "da_log": ["R", "R"], "ddt_bias": ["R", "R"],
            "dd_skip": ["R", "R"]}
    for k, pl in want.items():
        got = [str(p).replace("Shard(dim=", "S(").replace("Replicate()", "R")
               for p in res[f"spec_{k}_placements"]]
        assert got == pl, k


@pytest.mark.parametrize("rank", range(8))
def test_whole_operands_take_every_ranks_gradient(ssm_gloo_results, rank):
    ids, table, w, g = (torch.from_numpy(a) for a in W.lookup_inputs())
    want = W.lookup(ids, table, w, g)
    res = ssm_gloo_results[rank]
    for k, v in want.items():
        np.testing.assert_allclose(res[k], v.detach().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{k} rank {rank}")


@pytest.fixture
def fake_mesh_4x2():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    pctx.configure(mesh)
    yield mesh
    pctx.disable()
    dist.destroy_process_group()


B, H, HD, N, CK = 8, 4, 16, 8, 4


def _scan_inputs(s: int):
    g = torch.Generator().manual_seed(5)
    dt = torch.nn.functional.softplus(torch.randn((B, s, H), generator=g))
    return [torch.randn((B, H, HD, N), generator=g),
            torch.randn((B, s, H, HD), generator=g).bfloat16(),
            torch.randn((B, s, H, N), generator=g),
            torch.randn((B, s, H, N), generator=g), dt,
            torch.exp(-0.5 * dt)]


@pytest.mark.parametrize("s", [1, 9])
def test_the_scan_runs_no_collective_on_the_dry_runs_placements(
        fake_mesh_4x2, s):
    """The state's heads over 'model', xh's too; B, C, dt and the decay
    whole on 'model' (cut to the rank's heads in place); every batch over
    'data'.  The forward runs rank 0's shard as a plain scan."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, dp, rep = fake_mesh_4x2, Shard(0), Replicate()
    ins = _scan_inputs(s)
    heads = [Shard(1), Shard(2), rep, rep, rep, rep]
    args = []
    for t, h in zip(ins, heads):
        local = t.tensor_split(4, 0)[0]
        if h.is_shard():
            local = local.tensor_split(2, h.dim)[0]
        args.append(DTensor.from_local(local.contiguous(), mesh, (dp, h),
                                       run_check=False, shape=t.shape,
                                       stride=t.stride()))
    with op_cost.OpCounter() as counter:
        y, st = pctx.per_shard_bh(ssm._scan, *args, CK)
    got = counter.cost
    assert got.collective_bytes == 0 and not got.collective_counts
    assert tuple(y.shape) == (B, s, H, HD)
    assert tuple(st.shape) == (B, H, HD, N)
    assert tuple(y.placements) == (dp, Shard(2))
    assert tuple(st.placements) == (dp, Shard(1))
    shard = [ins[0][:2, :2]] + [t[:2, :, :2] for t in ins[1:]]
    pctx.disable()
    try:
        with op_cost.OpCounter() as counter:
            ssm._scan(*shard, CK)
    finally:
        pctx.configure(mesh)
    assert got.flops == counter.cost.flops > 0


def test_context_off_is_the_function():
    pctx.disable()
    calls = []
    out = pctx.per_shard_bh(lambda *a: calls.append(a) or ("y", "st"),
                            "state", "xh", 4)
    assert out == ("y", "st") and calls == [("state", "xh", 4)]
