"""The collectives of one Mamba2 block on a mesh, against a hand count.

Eager DTensor picks each gradient's layout itself, and torch 2.11 and 2.13
pick differently: left to it, the block's backward all-gathered f32
gradients over 'model' on one version and reduce-scattered them on the
other.  The port pins every layout instead (``ctx.split_channels``,
``ctx.per_shard_channels``): on a fake (4, 2) mesh ('data' x 'model'),
with the weights placed by ``param_specs`` (FSDP on) and the input
batch-sharded over 'data', rank 0's collectives by kind, bytes and group
are exactly these (f32; B_rank = B / 4 rows; F = 2 d_inner + 2 H·N + H
in_proj columns, F / 2 a 'model' rank):

* in_proj: its FSDP shard gathered over 'data' (D·F/2 numbers); in the
  backward its gradient reduce-scattered back (D/4·F/2), and the input's
  gradient, a partial sum over 'model', all-reduced (B_rank·S·D);
* the split of in_proj's output into z, x, B, C and dt, each on its own
  'model' split: one all-to-all of the rank's B_rank·S·F/2 numbers each
  way;
* the gated RMSNorm's mean square: one all-reduce over 'model' of
  B_rank·S numbers each way;
* the weights used on each rank's channels: conv_w's and norm_scale's
  gradients all-reduced over 'data' (cw·d_inner/2, d_inner/2); a_log's,
  dt_bias's and d_skip's, whole weights cut to the rank's heads, over
  'data' and over 'model' (H each);
* out_proj: its FSDP shard gathered over 'data' (d_inner/2·D), its
  partial sum over 'model' all-reduced where it is made (B_rank·S·D), and
  its gradient reduce-scattered over 'data' (d_inner/2·D/4).

A decode step (S = 1, the state and conv state placed by
``cache_specs``) runs the forward's collectives alone.  No JAX here.
"""

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import SSMConfig
from repro_torch.models import layers, ssm
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import op_cost
from repro_torch.parallel.sharding import param_specs, to_placements

B, D = 8, 16
CFG = SSMConfig(state_dim=8, expand=2, conv_width=4, n_ssm_heads=4, chunk=4)
D_INNER, H, N, CW = 2 * D, 4, 8, 4
F = 2 * D_INNER + 2 * H * N + H


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


def _placed(mesh, t, placements):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(torch.empty(t.shape, dtype=torch.float32,
                                         device="meta"), mesh, placements)


def _block(mesh, s: int):
    """The block's weights placed by ``param_specs`` and its input (and,
    at S = 1, its state and conv state placed by ``cache_specs``), all
    meta f32 DTensors."""
    from torch.distributed.tensor import Replicate, Shard
    init = layers.ParamInit(torch.Generator().manual_seed(0), "cpu")
    params = ssm.mamba2_init(init, D, CFG)
    specs = param_specs(params, fsdp=True, mesh=mesh)

    def place(v, spec):
        if isinstance(v, dict):
            return {k: place(v[k], spec[k]) for k in v}
        return _placed(mesh, v, to_placements(spec, mesh)).requires_grad_(
            s > 1)
    p = place(params, specs)
    x = _placed(mesh, torch.empty(B, s, D), (Shard(0), Replicate()))
    if s > 1:
        return p, x.requires_grad_(), None, None
    return p, x, _placed(mesh, torch.empty(B, H, D_INNER // H, N),
                         (Shard(0), Shard(1))), \
        _placed(mesh, torch.empty(B, CW - 1, D_INNER), (Shard(0), Shard(2)))


def _count(mesh, s: int) -> op_cost.OpCost:
    """Rank 0's count of one block (forward and backward where S > 1),
    after one uncounted run (DTensor's first call of an op at a shape may
    run extra ops)."""
    from torch.distributed.tensor.experimental import implicit_replication

    def run():
        p, x, state, conv = _block(mesh, s)
        with torch.set_grad_enabled(s > 1):
            y, _, _ = ssm.mamba2_apply(p, x, CFG, state=state,
                                       conv_state=conv)
            if s > 1:
                y.sum().backward()
    with implicit_replication():
        run()
        with op_cost.OpCounter() as counter:
            run()
    return counter.cost


def test_a_shard_edge_falls_inside_b():
    """F = 132 columns split 66 / 66 over 'model': the edge lies 2
    columns into B's block (64..96), as zamba2-2.7b's 20,560 split 10,280
    / 10,280 lie 40 into B's."""
    assert F // 2 - 2 * D_INNER == 2 and F // 2 < 2 * D_INNER + H * N


@pytest.mark.parametrize("s", [8, 1])
def test_the_blocks_collectives_are_the_hand_count(fake_mesh_4x2, s):
    b_rank, f4 = B // 4, 4
    fwd = {
        # (kind, group size): bytes, one entry a collective
        ("all-gather", 4): [D * F // 2 * f4, D_INNER // 2 * D * f4],
        ("all-to-all", 2): [b_rank * s * F // 2 * f4],
        ("all-reduce", 2): [b_rank * s * f4, b_rank * s * D * f4],
    }
    bwd = {
        ("all-to-all", 2): [b_rank * s * F // 2 * f4],
        ("all-reduce", 2): [b_rank * s * f4, b_rank * s * D * f4]
        + [H * f4] * 3,
        ("all-reduce", 4): [CW * D_INNER // 2 * f4, D_INNER // 2 * f4]
        + [H * f4] * 3,
        ("reduce-scatter", 4): [D // 4 * F // 2 * f4,
                                D_INNER // 2 * D // 4 * f4],
    }
    want = {k: list(v) for k, v in fwd.items()}
    if s > 1:
        for k, v in bwd.items():
            want.setdefault(k, []).extend(v)
    kinds, counts, groups = {}, {}, {}
    for (kind, group), sizes in want.items():
        kinds[kind] = kinds.get(kind, 0) + sum(sizes)
        counts[kind] = counts.get(kind, 0) + len(sizes)
        groups[group] = groups.get(group, 0) + sum(sizes)
    got = _count(fake_mesh_4x2, s)
    assert got.collectives == kinds
    assert got.collective_counts == counts
    assert got.collective_groups == groups
    assert got.collective_bytes == sum(kinds.values())
