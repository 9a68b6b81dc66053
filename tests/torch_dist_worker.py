"""One rank of ``tests/test_torch_parallel.py``'s ``gloo`` world: the
port's int8 compressed all-reduce and GPipe pipeline over a 4-rank group,
the xLSTM blocks' scans on each rank's batch rows (``ctx.per_shard_rows``)
under a (4, 2) mesh, and a checkpoint saved under that mesh and restored
under a (2, 2) one.  ``torch.multiprocessing.spawn`` runs ``run`` once
per rank; ranks 0-3 write what the test compares to ``out_dir``.

``run_ssm`` is one rank of ``tests/test_torch_ssm_mesh.py``'s world under
a (4, 2) mesh: the Mamba2 block on each rank's shards of the batch and of
d_inner (``ctx.split_channels``, ``ctx.per_shard_channels``), with the
weights replicated and with the weights placed as the dry-run places
them, and the gradients of a vocab-parallel embedding table and a whole
weight (``ctx.embedding``, ``ctx.matmul``).

``run_decode`` is one rank of ``tests/test_torch_decode_mesh.py``'s world
under a (4, 2) mesh: decode attention on each rank's slice of a
sequence-sharded KV cache (``ctx.decode_on_seq_shards``) and the cache
write on each rank's shard (``ctx.write_rows``), on both placements
``cache_specs`` gives.  No JAX here."""

import os

import numpy as np
import torch
import torch.distributed as dist

COMP_SHAPE = (64, 32)
S, M, MB, D = 4, 6, 2, 16


def replicated_grads():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=COMP_SHAPE).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32)}


def rank_grads(rank: int):
    rng = np.random.default_rng(100 + rank)
    return {"w": rng.normal(size=COMP_SHAPE).astype(np.float32) * (1 + rank)}


def pipeline_inputs():
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(S, D, D)) / np.sqrt(D)).astype(np.float32)
    xs = rng.normal(size=(M, MB, D)).astype(np.float32)
    return ws, xs


def elastic_leaves():
    return {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
            "e": (np.arange(8 * 6, dtype=np.float32).reshape(8, 6) / 7)}


XB, XS, XD, XH = 8, 6, 16, 2      # the xLSTM blocks' batch, length, width


def xlstm_inputs():
    rng = np.random.default_rng(3)
    return tuple(rng.normal(size=(XB, XS, XD)).astype(np.float32)
                 for _ in range(2))


def xlstm_params():
    from repro_torch.models import layers, xlstm
    init = layers.ParamInit(torch.Generator().manual_seed(0), "cpu")
    return {"slstm": xlstm.slstm_init(init, XD, XH),
            "mlstm": xlstm.mlstm_init(init, XD, XH)}


def xlstm_blocks(x, g, params, place=lambda t: t):
    """The sLSTM and mLSTM blocks (per token, and in chunks of 4) on
    ``x``, each weight in f32 and placed by ``place``: every block's
    output and the gradients of ``(output * g).sum()`` with respect to
    ``x`` and each weight, by name."""
    from repro_torch.models import xlstm
    blocks = {"slstm": ("slstm", lambda p, x: xlstm.slstm_apply(p, x)[0]),
              "mlstm": ("mlstm", lambda p, x: xlstm.mlstm_apply(p, x, XH)[0]),
              "mlstm_c4": ("mlstm", lambda p, x: xlstm.mlstm_apply(
                  p, x, XH, chunk=4)[0])}
    out = {}
    for name, (kind, fn) in blocks.items():
        p = {k: place(v.float()).requires_grad_()
             for k, v in params[kind].items()}
        xx = place(x.clone()).requires_grad_()
        y = fn(p, xx)
        (y * place(g)).sum().backward()
        out[f"{name}_y"] = y
        out[f"{name}_dx"] = xx.grad
        out.update({f"{name}_d{k}": v.grad for k, v in p.items()})
    return out


# the Mamba2 block: batch, length (a scan over MS - 1 steps in chunks of
# 4, the last one padded, then one decode step), width
MB, MS, MD = 8, 10, 16


def ssm_cfg():
    from repro_torch.configs.base import SSMConfig
    return SSMConfig(state_dim=8, expand=2, conv_width=4, n_ssm_heads=4,
                     chunk=4)


def mamba2_inputs():
    """x, and the cotangents of the scan's output, the step's output and
    the final state."""
    rng = np.random.default_rng(4)
    return (rng.normal(size=(MB, MS, MD)).astype(np.float32),
            rng.normal(size=(MB, MS - 1, MD)).astype(np.float32),
            rng.normal(size=(MB, 1, MD)).astype(np.float32),
            rng.normal(size=(MB, 4, 8, 8)).astype(np.float32))


def mamba2_params():
    from repro_torch.models import layers, ssm
    init = layers.ParamInit(torch.Generator().manual_seed(1), "cpu")
    return ssm.mamba2_init(init, MD, ssm_cfg())


def mamba2_block(x, gy, g1, gs, params, place=lambda t: t,
                 place_param=None):
    """The Mamba2 block over ``x``'s first ``MS - 1`` steps (the chunked
    scan), then one decode step (S = 1) from the state and conv state it
    leaves, each weight in f32 and placed by ``place_param(path, w)``
    (``place(w)`` if None): both outputs, the final state, and the
    gradients of their products with the cotangents with respect to ``x``
    and each weight, by name."""
    from repro_torch.models import ssm
    cfg = ssm_cfg()
    put = place_param or (lambda path, t: place(t))
    p = {k: ({"w": put((k, "w"), v["w"].float()).requires_grad_()}
             if isinstance(v, dict) else put((k,), v.float()).requires_grad_())
         for k, v in params.items()}
    xx = place(x.clone()).requires_grad_()
    y, st, conv = ssm.mamba2_apply(p, xx[:, :-1], cfg)
    y1, st1, _ = ssm.mamba2_apply(p, xx[:, -1:], cfg, state=st,
                                  conv_state=conv)
    ((y * place(gy)).sum() + (y1 * place(g1)).sum()
     + (st1 * place(gs)).sum()).backward()
    out = {"y": y, "y1": y1, "state": st, "state1": st1, "dx": xx.grad}
    out.update({f"d{k}": (v["w"] if isinstance(v, dict) else v).grad
                for k, v in p.items()})
    return out


EV, ED = 16, 4                    # the embedding's vocabulary and width


def lookup_inputs():
    """Ids (MB, 6), the table (EV, ED), a weight (ED, 3) and the
    cotangent of the (MB, 6, 3) output."""
    rng = np.random.default_rng(6)
    return (rng.integers(0, EV, size=(MB, 6)),
            rng.normal(size=(EV, ED)).astype(np.float32),
            rng.normal(size=(ED, 3)).astype(np.float32),
            rng.normal(size=(MB, 6, 3)).astype(np.float32))


def lookup(ids, table, w, g, place_ids=lambda t: t, place_table=lambda t: t,
           place_w=lambda t: t):
    """``ctx.matmul(ctx.embedding(table, ids), w)`` and the gradients of
    its product with ``g`` with respect to the table and the weight."""
    from repro_torch.parallel import ctx as pctx
    tb = place_table(table).requires_grad_()
    ww = place_w(w).requires_grad_()
    y = pctx.matmul(pctx.embedding(tb, place_ids(ids)), ww)
    (y * place_ids(g)).sum().backward()
    return {"lookup_y": y, "dtable": tb.grad, "dw": ww.grad}


def run_ssm(rank: int, world: int, store_dir: str, out_dir: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.parallel import ctx as pctx
    from repro_torch.parallel.sharding import param_specs, to_placements

    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))
        # activations batch-sharded over 'data' (the dry-run's), the
        # weights replicated; a plain tensor the block makes counts as
        # replicated, as in the dry-run
        rows = (Shard(0), Replicate())
        pctx.configure(mesh)
        try:
            with implicit_replication():
                got = mamba2_block(
                    *(torch.from_numpy(a) for a in mamba2_inputs()),
                    mamba2_params(), lambda t: (
                        t if isinstance(t, DTensor) else distribute_tensor(
                            t, mesh, rows if t.shape[0] == MB
                            else (Replicate(), Replicate()))))
            # the weights as the dry-run places them (``param_specs``,
            # FSDP on): in_proj's 132 columns split 66 / 66 over 'model',
            # an edge 2 columns into B's 32 (z 32, x 32, B 32, C 32, dt 4)
            specs = param_specs(mamba2_params(), fsdp=True, mesh=mesh)

            def by_spec(path, t):
                spec = specs
                for k in path:
                    spec = spec[k]
                return distribute_tensor(t, mesh, to_placements(spec, mesh))
            placed = mamba2_block(
                *(torch.from_numpy(a) for a in mamba2_inputs()),
                mamba2_params(), lambda t: (
                    t if isinstance(t, DTensor) else distribute_tensor(
                        t, mesh, rows if t.shape[0] == MB
                        else (Replicate(), Replicate()))), by_spec)
            got.update({f"spec_{k}": v for k, v in placed.items()})
            # the ids batch-sharded over 'data', the table's rows over
            # 'model' (vocab-parallel), the weight whole
            ids, table, w, g = (torch.from_numpy(a) for a in lookup_inputs())
            got.update(lookup(
                ids, table, w, g,
                lambda t: distribute_tensor(t, mesh, rows),
                lambda t: distribute_tensor(t, mesh, (Replicate(), Shard(0))),
                lambda t: distribute_tensor(t, mesh,
                                            (Replicate(), Replicate()))))
        finally:
            pctx.disable()
        out = {}
        for k, v in got.items():
            out[k] = v.detach().full_tensor().numpy()
            out[f"{k}_placements"] = np.array([str(p) for p in v.placements])
        out["state_local"] = got["state"].detach().to_local().numpy()
        np.savez(os.path.join(out_dir, f"ssm_rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


# the decode attention's batch, cache length, kv heads, query heads, head
# dim; lengths with keys on one side of a shard edge only (S splits 8 / 8
# over 'model', 2 a rank over both axes), and windows: none, and 5, which
# cuts across the edges
DB, DS, DKV, DH, DHD = 8, 16, 2, 4, 8
DECODE_LENGTHS = (1, 3, 8, 9, 16, 5, 12, 2)
DECODE_WINDOWS = (0, 5)
#: (name, the cache dim that 'data' and 'model' shard): normal decode (B
#: over 'data', S over 'model'), long context (S over both, B whole)
DECODE_PLACEMENTS = (("batch", (0, 1)), ("long", (1, 1)))


def decode_inputs():
    """q (DB, DH, DHD), k and v caches (DB, DS, DKV, DHD), the values a
    write puts at each row's position (DB, DKV, DHD) and the lengths."""
    rng = np.random.default_rng(7)
    q, k, v, new = (rng.normal(size=shape).astype(np.float32) for shape in (
        (DB, DH, DHD), (DB, DS, DKV, DHD), (DB, DS, DKV, DHD),
        (DB, DKV, DHD)))
    return q, k, v, new, np.array(DECODE_LENGTHS, dtype=np.int64)


def run_decode(rank: int, world: int, store_dir: str, out_dir: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models.layers import decode_attention_plain
    from repro_torch.parallel import ctx as pctx

    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))
        q, k, v, new, lengths = (torch.from_numpy(a) for a in decode_inputs())
        out = {}
        pctx.configure(mesh)
        try:
            for name, dims in DECODE_PLACEMENTS:
                pl = tuple(Shard(d) for d in dims)
                rows = tuple(Shard(0) if p.is_shard(0) else Replicate()
                             for p in pl)
                # the query's heads over 'model', as the dry-run's arrive
                q_pl = (rows[0], Shard(1))
                kc, vc = (distribute_tensor(t, mesh, pl) for t in (k, v))
                for w in DECODE_WINDOWS:
                    got = decode_attention_plain(
                        distribute_tensor(q, mesh, q_pl), kc, vc,
                        distribute_tensor(lengths, mesh, rows), window=w)
                    out[f"{name}_w{w}"] = got.full_tensor().numpy()
                    out[f"{name}_w{w}_placements"] = np.array(
                        [str(p) for p in got.placements])
                # each row's write lands at its last key, then at the
                # next decode step's slot (a full row's wraps to 0): both
                # sides of every shard edge are written
                for tag, pos in (("last", lengths - 1),
                                 ("next", lengths % DS)):
                    pctx.write_rows(kc, torch.arange(DB),
                                    distribute_tensor(pos, mesh, rows),
                                    distribute_tensor(new, mesh, rows))
                    out[f"{name}_write_{tag}"] = kc.full_tensor().numpy()
                out[f"{name}_cache_placements"] = np.array(
                    [str(p) for p in kc.placements])
        finally:
            pctx.disable()
        np.savez(os.path.join(out_dir, f"decode_rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _tensors(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def run(rank: int, world: int, store_dir: str, out_dir: str) -> None:
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.parallel import ctx as pctx
    from repro_torch.parallel.compression import compressed_psum_grads
    from repro_torch.parallel.pipeline import pipeline_apply

    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        sub = dist.new_group(list(range(4)))
        out = {}
        if rank < 4:
            g = _tensors(replicated_grads())
            r = {k: torch.zeros_like(v) for k, v in g.items()}
            mean, res = compressed_psum_grads(g, r, sub)
            out.update({f"rep_mean_{k}": v.numpy() for k, v in mean.items()})
            out.update({f"rep_res_{k}": v.numpy() for k, v in res.items()})
            g = _tensors(rank_grads(rank))
            mean, _ = compressed_psum_grads(
                g, {k: torch.zeros_like(v) for k, v in g.items()}, sub)
            out["diff_mean_w"] = mean["w"].numpy()

            ws, xs = pipeline_inputs()
            got = pipeline_apply(lambda w, x: torch.tanh(x @ w),
                                 torch.from_numpy(ws), torch.from_numpy(xs),
                                 sub)
            out["pipeline"] = got.numpy()

        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))
        # the xLSTM blocks with x batch-sharded over 'data', the weights
        # replicated: each rank's outputs and the weights' gradients
        rows = (Shard(0), Replicate())
        x, g = (torch.from_numpy(a) for a in xlstm_inputs())
        pctx.configure(mesh)
        try:
            got = xlstm_blocks(x, g, xlstm_params(), lambda t: (
                t if isinstance(t, DTensor) else distribute_tensor(
                    t, mesh, rows if t.shape[0] == XB and t.dim() == 3
                    else (Replicate(), Replicate()))))
        finally:
            pctx.disable()
        for k, v in got.items():
            out[f"xlstm_{k}"] = v.detach().full_tensor().numpy()
            out[f"xlstm_{k}_placements"] = np.array(
                [str(p) for p in v.placements])
        out["xlstm_slstm_y_local"] = got["slstm_y"].detach().to_local().numpy()

        # elastic: saved under (4, 2), restored under (2, 2) on ranks 0-3
        pl = (Shard(0), Shard(1))
        tree = {k: distribute_tensor(v, mesh, pl, src_data_rank=None)
                for k, v in _tensors(elastic_leaves()).items()}
        tree["e"] = tree["e"].to(torch.bfloat16)
        cm = CheckpointManager(os.path.join(out_dir, "ckpt"))
        cm.save(1, tree)
        dist.barrier()
        small = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                           mesh_dim_names=("data", "model"))
        if rank < 4:
            like = {"w": torch.zeros(8, 8),
                    "e": torch.zeros(8, 6, dtype=torch.bfloat16)}
            got, manifest = cm.restore(
                like, shardings={k: (small, pl) for k in like})
            out["manifest_step"] = np.array(manifest["step"])
            for k, v in got.items():
                local = v.to_local()
                out[f"local_{k}"] = (local.float().numpy() if k == "w" else
                                     local.view(torch.int16).numpy())
                out[f"placements_{k}"] = np.array(
                    [str(p) for p in v.placements])
            np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
