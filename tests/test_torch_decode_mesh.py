"""Decode attention and the KV-cache write on each rank's sequence shard
(``ctx.decode_on_seq_shards``, ``ctx.write_rows``).

``cache_specs`` shards a decode's KV cache along its sequence: every
model shard reads its slice of the context and the softmax is combined
across the shards, as GSPMD partitions JAX's decode attention, so the
bytes a rank moves do not depend on the cache's length.  The port's
dry-run does the same through ``ctx``: each rank keeps f32 partials (max,
sum, output) over its slice and the partials are combined over the mesh
dims that split the sequence.

* In an 8-rank ``gloo`` world on a (4, 2) mesh (``torch_dist_worker.
  run_decode``), on both of ``cache_specs``' placements (batch over
  'data' and sequence over 'model'; long context, the sequence over both
  and the batch whole): ``decode_attention_plain`` on DTensors equals the
  plain function on whole tensors in f32 within 1e-5, with lengths that
  leave some ranks no attended key and with a window across the shard
  edges; ``write_rows`` equals plain indexing exactly, at positions on
  both sides of every edge.
* On a fake (4, 2) mesh: the dry-run's decode step (``cell_cost``)
  counts the same collective bytes at two cache lengths, for a dense, a
  hybrid and an enc-dec arch and for long context; the combine moves
  B·H·(hd + 2) f32 numbers a rank; ``write_rows`` of a value on the
  cache's batch split moves no collective and touches only the written
  rows.

No JAX here: the plain function's parity with JAX is held by
``tests/test_torch_window.py`` and the family tests.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_worker as W
from repro_torch.models.layers import decode_attention_plain
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import op_cost


@pytest.fixture(scope="module")
def decode_gloo_results(tmp_path_factory):
    """Every rank's results from one 8-rank ``gloo`` world (spawned)."""
    import torch.multiprocessing as mp
    root = tmp_path_factory.mktemp("gloo_decode")
    ctx = mp.spawn(W.run_decode, args=(8, str(root), str(root)), nprocs=8,
                   join=False)
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo world did not finish in 600 s")
    return [dict(np.load(root / f"decode_rank{r}.npz")) for r in range(8)]


def _short(placements) -> list[str]:
    """Placements as torch 2.13 prints them (2.11: ``Shard(dim=0)``,
    ``Replicate()``)."""
    return [str(p).replace("Shard(dim=", "S(").replace("Replicate()", "R")
            for p in placements]


def _plain_inputs():
    q, k, v, new, lengths = (torch.from_numpy(a) for a in W.decode_inputs())
    return q, k, v, new, lengths


@pytest.mark.parametrize("placement", [n for n, _ in W.DECODE_PLACEMENTS])
@pytest.mark.parametrize("window", W.DECODE_WINDOWS)
@pytest.mark.parametrize("rank", range(8))
def test_attention_on_sequence_shards_equals_the_plain_function(
        decode_gloo_results, placement, window, rank):
    q, k, v, _, lengths = _plain_inputs()
    pctx.disable()
    want = decode_attention_plain(q, k, v, lengths, window=window).numpy()
    assert np.isfinite(want).all()
    res = decode_gloo_results[rank]
    np.testing.assert_allclose(res[f"{placement}_w{window}"], want,
                               rtol=1e-5, atol=1e-5)
    # the output keeps the cache's batch split
    assert _short(res[f"{placement}_w{window}_placements"]) == (
        ["S(0)", "R"] if placement == "batch" else ["R", "R"])


def test_some_ranks_hold_no_attended_key():
    """The lengths leave a rank of each placement with no key to attend
    to (a row of length <= 8 on 'model' rank 1; with the window, a row
    whose keys all lie past 8 on 'model' rank 0)."""
    lengths = np.array(W.DECODE_LENGTHS)
    edge = W.DS // 2
    assert (lengths <= edge).any()
    assert ((lengths - max(W.DECODE_WINDOWS)) >= edge).any()


@pytest.mark.parametrize("placement", [n for n, _ in W.DECODE_PLACEMENTS])
@pytest.mark.parametrize("rank", range(8))
def test_write_rows_on_each_shard_equals_plain_indexing(
        decode_gloo_results, placement, rank):
    _, k, _, new, lengths = _plain_inputs()
    rows = torch.arange(W.DB)
    res = decode_gloo_results[rank]
    for tag, pos in (("last", lengths - 1), ("next", lengths % W.DS)):
        k[rows, pos] = new
        np.testing.assert_array_equal(res[f"{placement}_write_{tag}"],
                                      k.numpy(), err_msg=tag)
    dims = dict(W.DECODE_PLACEMENTS)[placement]
    assert _short(res[f"{placement}_cache_placements"]) == [
        f"S({d})" for d in dims]


@pytest.fixture
def fake_mesh_4x2():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    pctx.disable()
    dist.destroy_process_group()


@pytest.mark.parametrize("arch,batch", [
    ("smollm-360m", 128), ("zamba2-2.7b", 128),
    ("seamless-m4t-medium", 128), ("zamba2-2.7b", 1)])
def test_decode_collectives_do_not_grow_with_the_cache(fake_mesh_4x2, arch,
                                                       batch):
    """A decode step's collective bytes at cache lengths 8192 and 16384
    are equal (batch 1 is long context: the sequence over both axes),
    while its FLOPs grow with the keys read."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun
    costs = [dryrun.cell_cost(get_arch(arch), ShapeConfig(
        "d", s, batch, "decode"), fake_mesh_4x2)["cost"]
        for s in (8192, 16384)]
    assert costs[0].collective_bytes == costs[1].collective_bytes > 0
    assert costs[0].collective_counts == costs[1].collective_counts
    assert costs[1].flops > costs[0].flops


B, S, HKV, H, HD = 128, 1024, 4, 8, 16


def _placed(mesh, shape, placements, dtype=torch.bfloat16):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(torch.empty(shape, dtype=dtype, device="meta"),
                             mesh, placements)


@pytest.mark.parametrize("long", [False, True])
def test_the_combine_moves_b_h_hd_plus_2_numbers(fake_mesh_4x2, long):
    """The softmax combine over the sequence's mesh dims: one max of
    B_rank·H and one sum of B_rank·H·(hd + 1) f32 numbers on each mesh
    dim that splits S, for a query already on the cache's batch split."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = fake_mesh_4x2
    pctx.configure(mesh)
    cache_pl = (Shard(1), Shard(1)) if long else (Shard(0), Shard(1))
    rows = (Replicate(),) * 2 if long else (Shard(0), Replicate())
    q = _placed(mesh, (B, H, HD), rows)
    kc, vc = (_placed(mesh, (B, S, HKV, HD), cache_pl) for _ in "kv")
    ln = _placed(mesh, (B,), rows, torch.int64)
    with op_cost.OpCounter() as counter:
        out = pctx.decode_on_seq_shards(q, kc, vc, ln, window=8)
    got = counter.cost
    b_rank = B if long else B // 4
    per_dim = 4 * b_rank * H * (HD + 2)
    assert got.collectives == {"all-reduce": per_dim * (2 if long else 1)}
    assert tuple(out.shape) == (B, H, HD) and tuple(out.placements) == rows


@pytest.mark.parametrize("long", [False, True])
def test_write_rows_moves_no_collective(fake_mesh_4x2, long):
    """On the dry-run's cache placements, with the value on the cache's
    batch split (as smollm-360m's decode step gives it: its 5 kv heads
    stay whole over 'model'), the write runs no collective and moves only
    the written rows, not the cache."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = fake_mesh_4x2
    pctx.configure(mesh)
    cache_pl = (Shard(1), Shard(1)) if long else (Shard(0), Shard(1))
    rows = (Replicate(),) * 2 if long else (Shard(0), Replicate())
    kc = _placed(mesh, (B, S, HKV, HD), cache_pl)
    pos = _placed(mesh, (B,), rows, torch.int64)
    new = _placed(mesh, (B, HKV, HD), rows)
    with op_cost.OpCounter() as counter:
        pctx.write_rows(kc, torch.arange(B), pos, new)
    got = counter.cost
    assert got.collective_bytes == 0 and not got.collective_counts
    assert 0 < got.bytes_accessed < op_cost.tensor_bytes(kc) / 4


def test_context_off_is_the_plain_function():
    """Off the context the write is plain indexing and the attention the
    plain formula, whatever the tensors."""
    pctx.disable()
    q, k, v, new, lengths = _plain_inputs()
    rows = torch.arange(W.DB)
    want = k.clone()
    want[rows, lengths - 1] = new
    pctx.write_rows(k, rows, lengths - 1, new)
    assert torch.equal(k, want)
    s = torch.einsum("bkgd,bskd->bkgs", q.reshape(W.DB, W.DKV, -1, W.DHD),
                     k) / np.sqrt(W.DHD)
    mask = torch.arange(W.DS)[None, :] < lengths[:, None]
    p = torch.softmax(s.masked_fill(~mask[:, None, None], float("-inf")), -1)
    plain = torch.einsum("bkgs,bskd->bkgd", p, v).reshape(W.DB, W.DH, W.DHD)
    torch.testing.assert_close(decode_attention_plain(q, k, v, lengths),
                               plain, rtol=1e-6, atol=1e-6)
