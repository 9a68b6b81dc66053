"""The MoE layer's expert work on a mesh: split over the ranks, none skipped.

JAX's dry-run of deepseek-moe-16b ``decode_32k`` on a (4, 2) mesh counts
about 3x the port's FLOPs a chip (6.976071e11 against 2.364895e11):
``tools/hlo_dots.py`` shows that GSPMD runs the three expert einsums for
all 64 experts, every capacity slot and the full d and f on every chip.
The port's ``ctx.einsum`` splits them instead: the expert dim over
'model' (expert parallelism) and the contracted d (or f) over 'data',
where the weights' FSDP shard lies, each rank summing partial sums.  So
the port's count is lower because the work is split 8 ways, not because
any of it is skipped.

* On a fake (4, 2) mesh, a reduced deepseek-moe layer at decode (one
  group, G = 1, which ``shard_batch_seq`` cannot split over 'data'), the
  weights placed by ``param_specs`` (FSDP on): rank 0's FLOPs in the
  expert einsums (the ``experts`` region) times 8 equal the one-device
  count of the same einsums, 3 x 2·E·G·C·D·F.
* The gated product's partial sums over 'data' are summed where they are
  made, onto ``shard_experts``' placement (one all-reduce each): the
  layer runs no reduce-scatter, whatever DTensor's version would pick.

No JAX here.
"""

import math

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_arch
from repro_torch.models import layers, moe
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import op_cost
from repro_torch.parallel.sharding import param_specs, to_placements

B = 16                    # decode tokens: one group of the reduced config's 32


@pytest.fixture
def fake_mesh_4x2():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    yield mesh
    pctx.disable()
    dist.destroy_process_group()


def _layer():
    cfg = get_arch("deepseek-moe-16b").reduced()
    init = layers.ParamInit(torch.Generator().manual_seed(0), "cpu")
    return cfg, {"moe": moe.moe_init(init, cfg.d_model, cfg.moe)}


def _expert_flops(cfg, p, x) -> tuple[float, op_cost.OpCost]:
    with torch.no_grad(), op_cost.OpCounter() as counter:
        moe.moe_apply(p["moe"], x, cfg.moe)
    return counter.cost.region_flops["experts"], counter.cost


def test_the_ranks_together_do_every_experts_work(fake_mesh_4x2):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    cfg, params = _layer()
    m = cfg.moe
    e, d, f = m.n_experts, cfg.d_model, m.d_ff_expert
    sg = min(m.group_size, B)
    g, cap = B // sg, int(math.ceil(m.top_k * sg / e * m.capacity_factor))
    assert g == 1
    whole = 3 * 2 * e * g * cap * d * f
    x = torch.randn((B, 1, d), generator=torch.Generator().manual_seed(1),
                    dtype=params["moe"]["w_gate"].dtype)
    one_device, _ = _expert_flops(cfg, params, x)
    assert one_device == whole

    mesh = fake_mesh_4x2
    specs = param_specs(params, fsdp=True, mesh=mesh)

    def place(v, spec):
        if isinstance(v, dict):
            return {k: place(v[k], spec[k]) for k in v}
        return distribute_tensor(v.to("meta"), mesh, to_placements(spec,
                                                                   mesh))
    p = place(params, specs)
    assert tuple(p["moe"]["w_gate"].placements) == (Shard(1), Shard(0))
    xd = distribute_tensor(x.to("meta"), mesh, (Shard(0), Replicate()))
    pctx.configure(mesh)
    with implicit_replication():
        _expert_flops(cfg, p, xd)           # DTensor's first calls
        rank0, cost = _expert_flops(cfg, p, xd)
    assert rank0 * 8 == whole
    assert "reduce-scatter" not in cost.collectives
    assert cost.collective_counts["all-reduce"] >= 2
