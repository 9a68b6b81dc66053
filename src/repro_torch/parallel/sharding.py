"""Sharding rules: parameter / optimizer-state / batch / cache specs for
the production meshes, the twin of ``repro.parallel.sharding``.

Scheme (MaxText-style logical rules, applied by leaf path):

  * TP  ('model'):  attention heads & FFN width column-sharded; output
    projections row-sharded; vocab sharded on the embedding/unembedding.
  * EP  ('model'):  MoE expert axis sharded over the same axis (experts
    replace FFN width as the model-parallel dimension).
  * DP  ('data' [+ 'pod']): batch.
  * FSDP ('data'):  optional ZeRO-3 — parameters (and hence optimizer
    moments, which mirror the param tree) additionally sharded over 'data'.
  * SP  ('data'):   long-context decode (global_batch < |dp|) shards the KV
    cache / SSM state sequence-or-head dims instead of batch.

A spec is a tuple with one entry per leading tensor dim — a mesh axis
name, a tuple of names, or None — exactly what ``tuple(PartitionSpec(...))``
gives in JAX (``()`` replicates; missing trailing entries are None).
``to_placements`` turns one into DTensor placements over a
``DeviceMesh``.  Non-divisible dims stay uneven DTensor shards, where
GSPMD would pad them.

The rules read only ``mesh.shape`` (a mapping from axis name to size) and
``mesh.axis_names``; ``mesh_info`` gives both for a ``DeviceMesh``.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any

import numpy as np

# parents whose 2-D weight is column-sharded (d_in, d_out=TP)
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "up", "in_proj", "unembed"}
# parents whose 2-D weight is row-sharded (d_in=TP, d_out)
_ROW = {"wo", "w_down", "down", "out_proj"}
# replicated small weights
_REPL = {"router", "wi", "wf", "wo_gate", "wz", "r"}


def mesh_info(mesh) -> SimpleNamespace:
    """The two things the rules read from a mesh, for a ``DeviceMesh``
    (or anything that already has ``shape`` as a mapping and
    ``axis_names``)."""
    if isinstance(getattr(mesh, "shape", None), dict):
        return mesh
    names = tuple(mesh.mesh_dim_names)
    return SimpleNamespace(axis_names=names,
                           shape=dict(zip(names, mesh.mesh.shape)))


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict, keeping its structure; the
    path is the tuple of keys (``jax.tree_util.tree_map_with_path``)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def _trailing_spec(path: tuple[str, ...], ndim: int, fsdp: bool):
    """Spec entries for the *logical* trailing dims of a leaf."""
    parent = path[-2] if len(path) >= 2 else ""
    leafname = path[-1]
    in_moe = "moe" in path
    fs = "data" if fsdp else None

    if leafname == "emb":                       # (vocab, d)
        return ("model", fs)
    if parent == "unembed":                     # (d, vocab)
        return (fs, "model")
    if in_moe and leafname in ("w_gate", "w_up", "w_down"):
        return ("model", fs, None)              # (E=EP, d, f) / (E, f, d)
    if parent in _REPL or leafname in _REPL:
        return None
    if parent in _COL:
        if leafname == "w" and ndim >= 2:
            return (fs, "model")
        if leafname == "b":
            return ("model",)
    if parent in _ROW and leafname == "w" and ndim >= 2:
        return ("model", fs)
    if leafname == "conv_w":                    # (cw, d_inner)
        return (None, "model")
    if leafname == "norm_scale" and ndim == 1:
        return ("model",)
    return None                                  # replicate


def _axis_size(mesh, axis) -> int:
    if mesh is None or axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return int(np.prod([mesh.shape[a] for a in axis]))
    return int(mesh.shape[axis])


def param_specs(params_shape: Any, fsdp: bool = False, mesh=None):
    """Spec tree matching a parameter tree (tensors, meta tensors, or
    anything with ``.shape``).

    When ``mesh`` is given, axes that do not divide the corresponding dim
    are dropped (JAX's ``in_shardings`` require divisibility — e.g.
    seamless-m4t's 256206-token vocabulary on a 16-way tensor axis stays
    replicated)."""
    mesh = None if mesh is None else mesh_info(mesh)

    def spec_one(names, leaf):
        nd = len(leaf.shape)
        trailing = _trailing_spec(names, nd, fsdp)
        if trailing is None:
            return ()
        trailing = tuple(trailing)[-nd:] if len(trailing) > nd else trailing
        pad = nd - len(trailing)
        entries = list((None,) * pad + tuple(trailing))
        if mesh is not None:
            for i, ax in enumerate(entries):
                if ax is not None and leaf.shape[i] % _axis_size(mesh, ax):
                    entries[i] = None
        return tuple(entries)

    return map_with_path(spec_one, params_shape)


def _leaf_paths(tree) -> dict:
    out = {}

    def collect(path, leaf):
        out[path] = leaf
    map_with_path(collect, tree)
    return out


def opt_state_specs(opt_state_shape: Any, pspecs: Any):
    """Optimizer-state specs: moments mirror their parameter's spec;
    factored Adafactor vectors inherit the matching trimmed spec."""
    pspec_leaves = _leaf_paths(pspecs)

    def spec_one(names, leaf):
        nd = len(leaf.shape)
        if names and names[0] == "step":
            return ()
        # strip the optimizer wrapper keys to find the parameter path
        core = tuple(n for n in names if n not in
                     ("m", "v", "vr", "vc", "master"))
        if core not in pspec_leaves:
            return ()
        base = tuple(pspec_leaves[core])
        entries = (base + (None,) * max(0, nd - len(base)))[:nd]
        if names[-1] == "vr":      # mean over last dim: drop last entry
            entries = (base[:-1] + (None,) * nd)[:nd]
        if names[-1] == "vc":      # mean over second-to-last dim
            keep = base[:-2] + base[-1:] if len(base) >= 2 else base
            entries = (tuple(keep) + (None,) * nd)[:nd]
        return tuple(entries)

    return map_with_path(spec_one, opt_state_shape)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def dp_axes(mesh):
    """The data-parallel axes as a spec entry: one name, or the names
    major first (``PartitionSpec`` stores a 1-tuple as its name)."""
    return ("pod", "data") if "pod" in mesh_info(mesh).axis_names \
        else "data"


def dp_size(mesh) -> int:
    return _axis_size(mesh_info(mesh), dp_axes(mesh))


def batch_specs(batch_shape: Any, mesh):
    dp = dp_axes(mesh)

    def spec_one(names, leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return ()
        if leaf.shape[0] % dp_size(mesh) != 0:
            # JAX's in_shardings require divisibility (unlike constraints,
            # which GSPMD pads): replicate, e.g. long_500k's batch of 1
            return (None,) * nd
        return (dp,) + (None,) * (nd - 1)

    return map_with_path(spec_one, batch_shape)


def cache_specs(cache_shape: Any, mesh, global_batch: int):
    """KV-cache/state specs for decode.

    Normal decode: batch over DP and the KV *sequence* over 'model' —
    flash-decode parallelism: every model-shard reads 1/TP of the context
    and the softmax combines across shards (``ctx.decode_on_seq_shards``:
    a max and one sum over the sequence's mesh dims, B·H·(hd + 2)
    numbers a layer, whatever the length; ``ctx.write_rows`` writes each
    new row into the shard that holds its position).  Long-context
    (global_batch < |dp|): the sequence shards over 'data' too.
    """
    info = mesh_info(mesh)
    dp = dp_axes(info)
    seq_parallel = global_batch < dp_size(info)
    tp = max(int(info.shape.get("model", 1)), 1)

    def spec_one(names, leaf):
        nd = len(leaf.shape)
        name = names[-1]
        if name in ("len", "enc_len"):
            return (dp,) if not seq_parallel else ()
        if name in ("k", "v", "ck", "cv"):
            # (L, B, S, Hkv, hd) or (G, B, S, Hkv, hd)
            if seq_parallel:
                return (None, None, ("data", "model"), None, None)
            if leaf.shape[2] % tp == 0:
                return (None, dp, "model", None, None)
            return (None, dp, None, None, None)
        if name == "ssm":          # (G, period, B, H, hd, N)
            if seq_parallel:
                return (None, None, None, "model", None, None)
            return (None, None, dp, "model", None, None)
        if name == "conv":         # (G, period, B, cw-1, d_inner)
            if seq_parallel:
                return (None, None, None, None, "model")
            return (None, None, dp, None, "model")
        if name == "C":            # (pairs, B, H, hd, hd)
            return (None, None if seq_parallel else dp, None, None, None)
        if name in ("n", "m", "sc", "sn", "sm", "sh"):
            return ((None,) + ((None,) if seq_parallel else (dp,))
                    + (None,) * (nd - 2))
        return (None,) * nd

    return map_with_path(spec_one, cache_shape)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------

def to_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements, one per *mesh* dim, for a spec.

    Mesh dim ``m`` gets ``Shard(d)`` when tensor dim ``d``'s entry names
    it, else ``Replicate()``.  A dim named by several axes (``("pod",
    "data")``, the sequence-parallel ``("data", "model")``) is sharded
    over each, the first name the major one, as in JAX; DTensor shards a
    dim over several mesh dims in mesh order, so the names must come in
    that order."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names mesh axes out of "
                             f"the mesh's order {names}")
        for m in idx:
            out[m] = Shard(d)
    return tuple(out)

