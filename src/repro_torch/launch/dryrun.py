"""Multi-pod dry-run, the twin of ``repro.launch.dryrun``: one step of
every (arch x shape x mesh) cell traced for one rank of the production
mesh, with no device and no allocation; records the rank's argument and
peak memory and its roofline terms.

The JAX package lowers and compiles each cell on 512 forced host devices.
Here the ``fake`` process-group backend stands in for the mesh: this
process is rank 0 of a world of the mesh's size, whose collectives move
nothing.  Parameters, optimizer state, batch and cache are DTensors of
``meta`` tensors placed by ``parallel.sharding``'s rules, and the step —
``loss_fn``, its backward and ``opt_update``; the prefill; or one decode
step — runs eagerly on them with ``parallel.ctx`` on, under
``parallel.op_cost``, which counts rank 0's local ops and collectives.
Every count is extrapolated from one and two units of each layer stack
(a prefill's from two and three), each run once uncounted first; an
xLSTM train or prefill step's recurrences (``op_cost.scan``) are
also cut to 2 and 3 steps, and the count evaluated at the sequence's
length (``cell_cost``).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k --multipod
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.jsonl
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape decode_32k --seq-len 16384

``DRYRUN_MESH`` ("4,2" / "2,2,2") replaces the production mesh with a
small one (testing); ``DRYRUN_DEVICES`` caps the world size (default 512).
A cell whose step reaches an op DTensor has no sharding rule for is an
``error`` row with the reason.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch

from ..configs.base import SHAPES, shape_applicable
from ..configs.registry import ARCHS, get_arch, get_shape
from ..models import transformer as T
from ..optim.optimizers import OptConfig, opt_init, opt_update
from ..parallel import ctx as pctx
from ..parallel import op_cost
from ..parallel import roofline as RL
from ..parallel.sharding import (batch_specs, cache_specs, map_with_path,
                                 opt_state_specs, param_specs, to_placements)
from ..train.trainer import _take_grads
from .specs import (active_params, count_params, decode_input_specs,
                    param_shapes, prefill_input_specs, train_input_specs)


def opt_for(cfg, n_params: int) -> OptConfig:
    # Adam f32 moments for >50B params exceed the 256-rank pod's memory
    return OptConfig(name="adafactor" if n_params > 50e9 else "adamw")


def make_train_step(cfg, opt_cfg):
    lf = T.loss_fn(cfg)

    def step(params, opt_state, batch):
        loss = lf(params, batch)
        loss.backward()
        params, opt_state, metrics = opt_update(opt_cfg, params,
                                                _take_grads(params), opt_state)
        return params, opt_state, dict(metrics, loss=loss.detach())
    return step


def _mesh_for(multi_pod: bool):
    """The fake world at the mesh's size, and the mesh on it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    override = os.environ.get("DRYRUN_MESH")  # e.g. "4,2" / "2,2,2"
    if override:
        dims = tuple(int(x) for x in override.split(","))
        axes = ("pod", "data", "model")[-len(dims):] if len(dims) == 3 \
            else ("data", "model")
    else:
        dims = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = math.prod(dims)
    cap = int(os.environ.get("DRYRUN_DEVICES", "512"))
    if world > cap:
        raise ValueError(f"a {dims} mesh needs {world} ranks; DRYRUN_DEVICES "
                         f"allows {cap}")
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return init_device_mesh("cpu", dims, mesh_dim_names=axes)


def _place(tree, specs, mesh, grad: bool = False):
    """``tree``'s meta leaves as DTensors placed by ``specs``."""
    from torch.distributed.tensor import distribute_tensor

    def one(path, leaf):
        spec = specs
        for k in path:
            spec = spec[k]
        t = distribute_tensor(leaf, mesh, to_placements(spec, mesh))
        return t.requires_grad_() if grad and t.is_floating_point() else t
    return map_with_path(one, tree)


def _local_bytes(*trees) -> int:
    return int(sum(op_cost.tensor_bytes(t) for t in trees))


def _traced(step, state, trips: int | None = None) -> tuple[
        op_cost.OpCost, dict]:
    """Run ``step(*state)`` once under the op counter and ``MemTracker``:
    (rank 0's cost, its peak live bytes or, where the tracker saw none, an
    ``error`` entry).  With its scans cut to ``trips`` steps, the counter
    alone: a peak is a maximum, not a count, and does not extrapolate."""
    if trips:
        with op_cost.OpCounter(trips) as counter:
            step(*state)
        return counter.cost, {}
    from torch.distributed._tools.mem_tracker import MemTracker
    leaves = []
    for tree in state:
        map_with_path(lambda _, t: leaves.append(op_cost._local(t)), tree)
    mt = MemTracker()
    mt.track_external(*leaves)
    with mt, op_cost.OpCounter() as counter:
        step(*state)
    # the rank's shards live on the meta device; what DTensor makes on
    # another device to propagate global shapes is not the rank's
    peak = mt.get_tracker_snapshot("peak").get(torch.device("meta"), {})
    if "Total" not in peak:
        return counter.cost, {"error": "MemTracker saw no meta tensors"}
    return counter.cost, {"peak_bytes": int(peak["Total"])}


def _stacks(cfg) -> list[tuple[str, int, object]]:
    """The layer stacks a step's cost is affine in: (name, units in
    ``cfg``, units -> the config fields for that many)."""
    fam = cfg.family
    if fam == "encdec":
        return [("decoder", cfg.n_layers, lambda u: {"n_layers": u}),
                ("encoder", cfg.encoder_layers,
                 lambda u: {"encoder_layers": u})]
    if fam == "moe" and cfg.moe.layer_period == 1:   # dense0 + MoE layers
        return [("layers", cfg.n_layers - 1, lambda u: {"n_layers": u + 1})]
    per = {"moe": cfg.moe.layer_period if cfg.moe else 1,
           "hybrid": cfg.ssm.attn_period if cfg.ssm else 1,
           "ssm": 2}.get(fam, 1)
    return [("layers", cfg.n_layers // per,
             lambda u, per=per: {"n_layers": per * u})]


def _build(cfg, shape, mesh, pspecs_for, n_params: int):
    """(step, state, optimizer name) of one cell's step on DTensors."""
    b, s = shape.global_batch, shape.seq_len
    p_meta = param_shapes(cfg)
    pspecs = pspecs_for(p_meta)
    if shape.kind == "train":
        opt_cfg = opt_for(cfg, n_params)
        o_meta = opt_init(opt_cfg, p_meta)
        params = _place(p_meta, pspecs, mesh, grad=True)
        opt_state = _place(o_meta, opt_state_specs(o_meta, pspecs), mesh)
        batch = train_input_specs(cfg, shape)
        batch = _place(batch, batch_specs(batch, mesh), mesh)
        return make_train_step(cfg, opt_cfg), (params, opt_state, batch), \
            opt_cfg.name
    params = _place(p_meta, pspecs, mesh)
    if shape.kind == "prefill":
        batch = prefill_input_specs(cfg, shape)
        batch = _place(batch, batch_specs(batch, mesh), mesh)
        fn = T.prefill_fn(cfg)

        def step(p, bt):
            return fn(p, bt, s + 8)
        return step, (params, batch), None
    cache, tok = decode_input_specs(cfg, shape)
    cache = _place(cache, cache_specs(cache, mesh, b), mesh)
    tok = _place({"tokens": tok}, batch_specs({"tokens": tok}, mesh),
                 mesh)["tokens"]
    return T.decode_fn(cfg), (params, cache, tok), None


#: the trip counts an xLSTM step's scans are traced at (``OpCounter``'s
#: ``trips``)
SCAN_TRIPS = (2, 3)


def scan_trips(cfg) -> tuple[int, int]:
    """The two trip counts a cell's scans are traced at (``SCAN_TRIPS``).

    Only the xLSTM family (``ssm``) runs its recurrences through
    ``op_cost.scan``: every other op of its step has the same shape at
    every trip count, so the step's count is affine in the trip count
    and is evaluated at the sequence's length.  (It is not affine in the
    length itself: the eager backward of the 512-position loss chunks
    sums a zero-padded full-length gradient a chunk, quadratic in S.)
    Any family with attention runs no such scan, and is refused."""
    if cfg.family != "ssm":
        raise ValueError(
            f"{cfg.name} ({cfg.family}) runs no op_cost.scan: its step is "
            f"traced at its full length, never extrapolated over a trip "
            f"count")
    return SCAN_TRIPS


def cell_cost(cfg, shape, mesh, fsdp: bool = True,
              extrapolate: bool = True) -> dict:
    """Rank 0's cost of one step of ``cfg`` at ``shape`` on ``mesh``.

    With ``extrapolate`` the step is traced at one unit of each layer
    stack and at two (the decoder and the encoder apart for enc-dec), and
    every count is extrapolated to the full depth: each is affine in the
    number of layers, as ``hlo_cost`` multiplies a scanned layer by its
    trip count.  A prefill is traced at two and three units instead,
    since ``place_cache`` lays out a fresh one-unit cache without the
    copy a longer stack takes; each traced depth runs once uncounted
    first.  An xLSTM train or prefill step is also traced with its scans
    cut to two trip counts (``scan_trips``), and the four traces are
    combined bilinearly in (units, trips).  Without ``extrapolate`` the
    full step is traced once.  Returns ``cost`` (an ``OpCost``),
    ``memory`` (the full state's argument bytes and the extrapolated peak,
    or an ``error`` entry), the optimizer's name, ``traced_units``,
    ``traced_trips`` (where the scans were cut) and ``trace_s``."""
    from torch.distributed.tensor.experimental import implicit_replication
    n_params = count_params(param_shapes(cfg))

    def pspecs_for(p_meta):
        return param_specs(p_meta, fsdp=fsdp, mesh=mesh)
    trip_counts = [None]
    if extrapolate and cfg.family == "ssm" and shape.kind != "decode":
        k1, k2 = scan_trips(cfg)
        if shape.seq_len > k2:
            trip_counts = [k1, k2]
    first = 2 if shape.kind == "prefill" else 1
    stacks = _stacks(cfg)
    if not extrapolate or all(full <= first + 1 for _, full, _ in stacks):
        points = [((), cfg)]
    else:
        base = {}
        for _, _, fields in stacks:
            base.update(fields(first))
        points = [((), cfg.scaled(**base))]
        for name, _, fields in stacks:
            points.append(((name,), cfg.scaled(**dict(base, **fields(
                first + 1)))))
    grad_mode = torch.enable_grad if shape.kind == "train" else torch.no_grad
    traced = []
    out = {}
    pctx.configure(mesh)
    try:
        with implicit_replication():
            _, state, opt = _build(cfg, shape, mesh, pspecs_for, n_params)
            out["memory"] = {"argument_bytes": _local_bytes(*state)}
            out["optimizer"] = opt
            del state
            t0 = time.time()
            # DTensor's first call of an op at a shape may run extra local
            # ops while it propagates shardings, which the extrapolation's
            # weights would multiply: each depth's step once, uncounted,
            # first
            for _, pcfg in points:
                step, state, _ = _build(pcfg, shape, mesh, pspecs_for,
                                        n_params)
                with grad_mode(), op_cost.OpCounter(trip_counts[0]):
                    step(*state)
                del step, state
            for k in trip_counts:
                for _, pcfg in points:
                    step, state, _ = _build(pcfg, shape, mesh, pspecs_for,
                                            n_params)
                    with grad_mode():
                        traced.append(_traced(step, state, k))
                    del step, state
            out["trace_s"] = round(time.time() - t0, 1)
    finally:
        pctx.disable()

    # extrapolate over depth at each trip count: base + (units - first) x
    # (one more unit of that stack) ...
    units = {name: full for name, full, _ in stacks}
    at_trips = []
    for i in range(len(trip_counts)):
        (base_cost, base_mem), rest = traced[i * len(points)], \
            traced[i * len(points) + 1:(i + 1) * len(points)]
        terms, peak = [(1.0, base_cost)], base_mem.get("peak_bytes")
        for ((name,), _), (cost, mem) in zip(points[1:], rest):
            w = float(units[name] - first)
            terms += [(w, cost), (-w, base_cost)]
            if peak is not None and "peak_bytes" in mem:
                peak += w * (mem["peak_bytes"] - base_mem["peak_bytes"])
        at_trips.append((terms, peak, base_mem))
    mem = out["memory"]
    if len(trip_counts) == 1:
        terms, peak, base_mem = at_trips[0]
        out["cost"] = op_cost.affine(terms)
        if peak is None:
            mem["error"] = base_mem["error"]
        elif peak < mem["argument_bytes"]:
            # the state alone is live at the start: a lower peak means
            # the tracker missed allocations at some depth
            mem["error"] = (f"MemTracker's peaks at the traced depths "
                            f"{[m.get('peak_bytes') for _, m in traced]} do "
                            f"not extrapolate to a peak above the arguments")
        else:
            mem["peak_bytes"] = int(peak)
    else:
        # ... then over the trip count: D(k1) + (S - k1) / (k2 - k1) x
        # (D(k2) - D(k1)) at the sequence's length S, the difference
        # first (every count is an integer, so each step is exact)
        k1, k2 = trip_counts
        w = float(shape.seq_len - k1) / (k2 - k1)
        d1, d2 = (op_cost.affine(t) for t, _, _ in at_trips)
        out["cost"] = op_cost.affine(
            [(1.0, d1), (w, op_cost.affine([(1.0, d2), (-1.0, d1)]))])
        mem["error"] = (f"not traced: the scans were cut to {k1} and {k2} "
                        f"trips, and a peak does not extrapolate over them")
        out["traced_trips"] = trip_counts
    out["traced_units"] = [units] if len(points) == 1 else [
        {n: first + 1 if n in which else first for n in units}
        for which, _ in points]
    return out


def lower_cell(arch_name: str, shape_name: str, multi_pod: bool,
               fsdp: bool | None = None, verbose: bool = True,
               overrides: dict | None = None,
               fused_credit: bool = False,
               seq_len: int | None = None) -> dict:
    """Trace one cell for rank 0 (``cell_cost``, extrapolated to the full
    depth and, for an xLSTM train or prefill step, to its scans' full
    trip count).

    The argument bytes are the full state's.  ``seq_len`` replaces the
    shape's sequence length (a decode's cache length).  ``overrides`` are
    ModelConfig fields for perf variants; ``fused_credit=True`` also
    records the roofline with the fused regions (flash attention, SSD and
    mLSTM scans) costed at their boundary bytes (``op_cost.region``)."""
    cfg = get_arch(arch_name)
    if overrides:
        cfg = cfg.scaled(**overrides)
    shape = get_shape(shape_name)
    if seq_len:
        shape = dataclasses.replace(shape, seq_len=seq_len)
    ok, why = shape_applicable(cfg, shape)
    mesh_name = "multipod" if multi_pod else "pod"
    if not ok:
        return {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}

    mesh = _mesh_for(multi_pod)
    chips = mesh.size()
    n_params = count_params(param_shapes(cfg))
    n_active = active_params(cfg, n_params)
    b, s = shape.global_batch, shape.seq_len
    model_flops = {"train": 6.0 * n_active * (b * s),
                   "prefill": 2.0 * n_active * (b * s),
                   "decode": 2.0 * n_active * b}[shape.kind]
    result = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
              "chips": chips, "n_params": n_params,
              "n_active_params": n_active, "kind": shape.kind,
              "seq_len": s, "status": "running"}
    got = cell_cost(cfg, shape, mesh, fsdp=True if fsdp is None else fsdp)
    result["memory"] = got["memory"]
    if got["optimizer"]:
        result["optimizer"] = got["optimizer"]
    result["trace_s"] = got["trace_s"]
    result["traced_units"] = got["traced_units"]
    if "traced_trips" in got:
        result["traced_trips"] = got["traced_trips"]
    cost = got["cost"]

    rl = RL.from_cost(cost, model_flops, chips)
    result["roofline"] = rl.to_dict()
    if fused_credit:
        result["roofline_fused"] = RL.from_cost(cost, model_flops, chips,
                                                fused=True).to_dict()
    result["status"] = "ok"
    if verbose:
        print("memory:", result["memory"])
        print("roofline:", json.dumps(rl.to_dict(), indent=2))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="replace each shape's sequence length (a decode's "
                         "cache length)")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a in ARCHS:
            for sh in SHAPES:
                cells.append((a, sh))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells.append((args.arch, args.shape))

    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multipod]

    failures = 0
    try:
        for a, sh in cells:
            for mp in meshes:
                tag = f"{a} x {sh} x {'multipod' if mp else 'pod'}"
                print(f"=== dry-run {tag} ===", flush=True)
                try:
                    res = lower_cell(a, sh, mp, fsdp=(not args.no_fsdp),
                                     seq_len=args.seq_len)
                except Exception as e:
                    traceback.print_exc()
                    res = {"arch": a, "shape": sh,
                           "mesh": "multipod" if mp else "pod",
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}"[:2000]}
                    failures += 1
                if args.out:
                    os.makedirs(os.path.dirname(args.out) or ".",
                                exist_ok=True)
                    with open(args.out, "a") as f:
                        f.write(json.dumps(res) + "\n")
                print(f"=== {tag}: {res['status']} ===", flush=True)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
