"""Ambient parallelism context for activation sharding, the twin of
``repro.parallel.ctx``.

Model code is mesh-agnostic; the launcher calls ``configure(mesh)`` before
it runs a step on DTensors, and the layer code calls the ``shard_*``
helpers, which redistribute a DTensor activation to the placements the
rule names when a context is active.  Otherwise — no context, or a plain
tensor (every single-card path) — they return ``x`` unchanged after one
check, so the host-bound decode step pays next to nothing.

Eager DTensor has no counterpart of GSPMD's propagation through in-place
writes, of its vocab-parallel gather and lookup, of its resharding around
a reshape, or of its partitioning of products (it reshards activations
where GSPMD gathers an FSDP weight, and some versions refuse to flatten
two sharded dims), so more helpers keep the model on the placements the
rules name: ``place_cache``, ``write_rows``, ``write_prefix``,
``gather_vocab``, ``embedding``, ``reshape``, ``einsum``, ``matmul``,
``per_shard``, which runs attention, independent over batch and heads,
on each rank's shards, ``decode_on_seq_shards``, which runs decode
attention on each rank's slice of a sequence-sharded cache and combines
the softmax across the slices, ``per_shard_rows``, which runs the xLSTM
scans on each rank's rows, ``per_shard_bh``, which runs the Mamba2 scan
on each rank's (batch, head) shards, ``split_channels``, which brings
each part of a joined projection to its own split, ``per_shard_channels``,
which runs the Mamba2 block between its products on each rank's shards
of d_inner, ``take_seq``, the causal conv's gather of windows, and
``logsigmoid``, whose backward DTensor has no rule for.
With the context off each is the plain op.

Rules:
  * batch dims shard over DP axes only when divisible (decode with
    global_batch < |dp| must stay unsharded — the KV cache is
    sequence-sharded instead),
  * head/width dims shard over 'model' (uneven shards allowed, e.g. 15
    heads on a 16-way axis, where GSPMD pads),
  * expert dim shards over 'model' (expert parallelism).
"""

from __future__ import annotations

import math

import torch

from .sharding import cache_specs, map_with_path, to_placements

_STATE = {"on": False, "mesh": None, "dp": ("data",), "tp": "model",
          "dp_size": 1}


def configure(mesh) -> None:
    """Turn the context on over a ``DeviceMesh``."""
    names = tuple(mesh.mesh_dim_names)
    size = dict(zip(names, mesh.mesh.shape))
    dp = tuple(a for a in names if a in ("pod", "data"))
    _STATE.update(on=True, mesh=mesh, dp=dp,
                  tp="model" if "model" in names else None,
                  dp_size=math.prod(int(size[a]) for a in dp) if dp else 1)


def disable() -> None:
    _STATE.update(on=False, mesh=None)


def active() -> bool:
    return _STATE["on"]


def on_mesh(x) -> bool:
    """Whether the context is on and ``x`` is a DTensor."""
    return _STATE["on"] and _is_dtensor(x)


def _wsc(x, spec):
    """``x`` redistributed to ``spec``'s placements on the context's mesh;
    a plain tensor (a constant the model made) counts as replicated."""
    mesh = _STATE["mesh"]
    x = _replicated(x, mesh)
    placements = to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def _dp_for(dim: int):
    dp = _STATE["dp"]
    if not dp:
        return None
    return dp if dim % max(_STATE["dp_size"], 1) == 0 else None


def shard_batch_seq(x):
    """(B, S, ...) activations: batch over DP."""
    if not _STATE["on"] or x.ndim < 2:
        return x
    spec = (_dp_for(x.shape[0]),) + (None,) * (x.ndim - 1)
    return _wsc(x, spec)


def shard_hidden(x):
    """(B, S, D): batch over DP, D replicated (Megatron activations)."""
    return shard_batch_seq(x)


def shard_heads(x):
    """(B, S, H, hd): batch over DP, heads over TP (uneven if needed)."""
    if not _STATE["on"] or x.ndim != 4:
        return x
    return _wsc(x, (_dp_for(x.shape[0]), None, _STATE["tp"], None))


def shard_ffn(x):
    """(B, S, F): FFN width over TP."""
    if not _STATE["on"] or x.ndim != 3:
        return x
    return _wsc(x, (_dp_for(x.shape[0]), None, _STATE["tp"]))


def shard_experts(x):
    """(E, ...): expert dim over TP ('model') — expert parallelism."""
    if not _STATE["on"]:
        return x
    return _wsc(x, (_STATE["tp"],) + (None,) * (x.ndim - 1))


def shard_bh(x):
    """(B, H, ...): batch over DP, heads over TP (scan carries, SSM state)."""
    if not _STATE["on"] or x.ndim < 2:
        return x
    return _wsc(x, (_dp_for(x.shape[0]), _STATE["tp"])
                + (None,) * (x.ndim - 2))


def shard_logits(x):
    """(..., V): vocab over TP."""
    if not _STATE["on"]:
        return x
    spec = (_dp_for(x.shape[0]),) + (None,) * (x.ndim - 2) + (_STATE["tp"],)
    return _wsc(x, spec)


# ---------------------------------------------------------------------------
# GSPMD's partitioning where eager DTensor has none (see the module doc)
# ---------------------------------------------------------------------------

def _reshape(x, shape):
    """``x.reshape(shape)`` on a DTensor, gathering first where DTensor
    refuses (see ``reshape``)."""
    try:
        return x.reshape(shape)
    except RuntimeError:
        from torch.distributed.tensor import Replicate
    keep = 0                      # leading dims the reshape leaves alone
    while keep < min(x.ndim, len(shape)) and x.shape[keep] == shape[keep]:
        keep += 1
    pl = [Replicate() if p.is_shard() and p.dim % x.ndim >= keep else p
          for p in x.placements]
    return x.redistribute(x.device_mesh, pl).reshape(shape)


class _Reshape(torch.autograd.Function):
    """``_reshape`` both ways: the gradient's reshape back may meet the
    same refusal."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _reshape(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape(g, ctx.in_shape), None


def reshape(x, shape):
    """``x.reshape(shape)``.  DTensor refuses to split or merge a sharded
    dim where the shard edges fall inside an output element (15 heads of
    a width split 16 ways), and some versions refuse any split of a
    sharded dim; GSPMD reshards there, and so does this: the mesh dims
    that shard a dim the reshape changes are gathered first, in the
    forward and in the backward."""
    if not (_STATE["on"] and _is_dtensor(x)):
        return x.reshape(shape)
    return _Reshape.apply(x, tuple(shape))


def einsum(eq: str, *ops):
    """``torch.einsum(eq, *ops)``.  On DTensors each rank contracts its own
    shards, with GSPMD's rule for the placements: on each mesh dim the
    first operand sharded there keeps its letter — an activation keeps
    its batch shard — and another operand sharded there on another letter
    is gathered first (a weight's FSDP shard), a partial sum meeting a
    shard is summed first; an operand replicated there is cut to the
    rank's slice of the letter, without communication.  The output keeps
    a sharded letter it has, and is a partial sum over a contracted one
    (or where one operand is a partial sum).  Some DTensor versions refuse
    these einsums' flattening of a sharded dim, and DTensor's own choice
    reshards activations where GSPMD gathers weights."""
    if not (_STATE["on"] and any(_is_dtensor(o) for o in ops)):
        return torch.einsum(eq, *ops)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    mesh = next(o.device_mesh for o in ops if isinstance(o, DTensor))
    ops = [_replicated(o, mesh) for o in ops]
    target = [list(o.placements) for o in ops]
    out_pl = []
    for m in range(mesh.ndim):
        owner = next(((i, ins[i][o.placements[m].dim % o.ndim])
                      for i, o in enumerate(ops)
                      if o.placements[m].is_shard()), None)
        partial = [i for i, o in enumerate(ops)
                   if o.placements[m].is_partial()]
        if owner is None and len(partial) <= 1:
            out_pl.append(Partial() if partial else Replicate())
            continue
        letter = owner[1] if owner else None
        for i, sub in enumerate(ins):
            target[i][m] = Shard(sub.index(letter)) if letter in sub \
                else Replicate()
        out_pl.append(Replicate() if letter is None else
                      Shard(out.index(letter)) if letter in out
                      else Partial())
    sizes = {}
    for sub, o in zip(ins, ops):
        sizes.update(zip(sub, o.shape))
    shape = tuple(sizes[c] for c in out)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    local = torch.einsum(eq, *(o.redistribute(mesh, t).to_local(
        grad_placements=_local_grads(t, out_pl))
        for o, t in zip(ops, target)))
    return DTensor.from_local(local, mesh, out_pl, run_check=False,
                              shape=shape, stride=stride)


def _local_grads(placements, out_pl) -> list:
    """What the gradient of a rank's operand (on ``placements``) is in an
    op whose output lies on ``out_pl``: a shard's gradient is its shard's;
    a whole operand's is a partial sum where the output is split over the
    ranks (sharded or partial), and whole where it is whole; a partial
    sum's is whole (each part has the output's gradient)."""
    from torch.distributed.tensor import Partial, Replicate
    return [Replicate() if p.is_partial() else
            Partial() if p.is_replicate() and not o.is_replicate() else p
            for p, o in zip(placements, out_pl)]


def matmul(x, w):
    """``x @ w`` for activations x (..., d) and a weight w (d, f); on
    DTensors through ``einsum``'s rule (the weight's FSDP shard gathered,
    the activations' batch shard kept)."""
    if not (_STATE["on"] and (_is_dtensor(x) or _is_dtensor(w))):
        return x @ w
    lead = "abcdefghijklmnopqrstuvw"[:x.ndim - 1]
    return einsum(f"{lead}y,yz->{lead}z", x, w)


def embedding(table, ids):
    """``table[ids]``.  On a DTensor table sharded over the vocabulary it
    is the vocab-parallel lookup (as ``gather_vocab``): each rank looks up
    the ids in its slice of the vocabulary, zeroes the others, and the
    partial sums are summed at once into rows placed as
    ``shard_batch_seq`` places them."""
    if not (_STATE["on"] and _is_dtensor(table)):
        return table[ids]
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh, pl = table.device_mesh, tuple(table.placements)
    vocab = [m for m, p in enumerate(pl) if p.is_shard(0)]
    ids = _replicated(ids, mesh)
    # whole rows (an FSDP-sharded width is gathered), ids whole over the
    # vocabulary's mesh dims
    table = table.redistribute(mesh, [p if m in vocab else Replicate()
                                      for m, p in enumerate(pl)])
    ids = ids.redistribute(mesh, [Replicate() if m in vocab else p
                                  for m, p in enumerate(ids.placements)])
    lo = _rank_offset(table.shape[0], mesh, vocab)
    out_pl = [Partial() if m in vocab else p
              for m, p in enumerate(ids.placements)]
    # a rank's rows of the table take the gradient of its own ids: a
    # partial sum over the mesh dims that shard the ids
    local = table.to_local(grad_placements=_local_grads(table.placements,
                                                        out_pl))
    li = ids.to_local()
    rel = li - lo
    inside = (rel >= 0) & (rel < local.shape[0])
    rows = F.embedding(rel.clamp(0, max(local.shape[0] - 1, 0)), local)
    rows = torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    shape = tuple(ids.shape) + (table.shape[1],)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return shard_batch_seq(DTensor.from_local(rows, mesh, out_pl,
                                              run_check=False, shape=shape,
                                              stride=stride))


def per_shard(fn, q, k, v, **kwargs):
    """``fn(q, k, v, **kwargs)`` for an attention ``fn`` over (B, S, H, hd)
    operands.  On DTensors placed alike and sharded only over batch and
    heads, each rank runs ``fn`` on its own shards and the output keeps
    their placements: no collective, as GSPMD partitions attention."""
    if not (_STATE["on"] and _is_dtensor(q)):
        return fn(q, k, v, **kwargs)
    from torch.distributed.tensor import DTensor
    pl = tuple(q.placements)
    local = all(p.is_replicate() or p.is_shard() and p.dim % 4 in (0, 2)
                for p in pl)
    if not (local and tuple(k.placements) == pl == tuple(v.placements)):
        return fn(q, k, v, **kwargs)
    _STATE["on"] = False            # the shards are plain tensors
    try:
        out = fn(q.to_local(), k.to_local(), v.to_local(), **kwargs)
    finally:
        _STATE["on"] = True
    shape = (q.shape[0], q.shape[1], q.shape[2], v.shape[3])
    stride = (shape[1] * shape[2] * shape[3], shape[2] * shape[3],
              shape[3], 1)
    return DTensor.from_local(out, q.device_mesh, pl, run_check=False,
                              shape=shape, stride=stride)


def decode_on_seq_shards(q, k_cache, v_cache, length, window: int = 0):
    """Single-token attention of ``q`` (B, H, hd) against a DTensor KV
    cache (B, S, Hkv, hd) placed by ``cache_specs``, split over the ranks
    as flash-decode splits it over blocks: each rank attends to its own
    slice of S (its batch shard of ``q`` and ``length``, a plain tensor
    cut to it) with its keys masked at their global positions, against
    ``length`` and ``window``, and keeps f32 partials: the scores' max
    ``m`` (a finite floor where the rank holds no attended key, which then
    adds zero), ``l = sum(exp(s - m))`` and ``o = exp(s - m) @ v``.  The
    partials are combined over the mesh dims that split S: a max of ``m``,
    then one sum of ``l`` and ``o``, each rescaled by ``exp(m - max)`` —
    B·H·(hd + 2) numbers a call, whatever S is, where the plain formula on
    DTensors gathers the scores or the cache.  The output, ``o / l`` in
    the cache's dtype, keeps the cache's batch split."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = k_cache.device_mesh
    split = [p if p.is_shard() and p.dim in (0, 1) else Replicate()
             for p in k_cache.placements]
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in split]
    seq = [m for m, p in enumerate(split) if p.is_shard(1)]
    b, smax, hkv, hd = k_cache.shape
    h = q.shape[1]
    s0 = _rank_range(smax, mesh, seq)[0]
    k, v = (c.redistribute(mesh, split).to_local() for c in (k_cache, v_cache))
    ql, ln = (_replicated(t, mesh).redistribute(mesh, rows).to_local()
              for t in (q, length))
    nb = ql.shape[0]
    s = torch.einsum("bkgd,bskd->bkgs", ql.reshape(nb, hkv, h // hkv, hd),
                     k).float() * (1.0 / math.sqrt(hd))
    pos = s0 + torch.arange(k.shape[1], device=k.device)
    mask = pos[None, :] < ln[:, None]
    if window:
        mask = mask & (pos[None, :] >= (ln[:, None] - window))
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1).clamp(min=-1e30)
    p = torch.exp(s - m[..., None])
    o = torch.cat([torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype), v).float(),
                   p.sum(dim=-1)[..., None]], dim=-1)         # (o, l)

    def combined(t, op: str):
        """``t``, a partial ``op`` over the mesh dims that split S, reduced
        there."""
        shape = (b,) + tuple(t.shape[1:])
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        pl = [Partial(op) if i in seq else r for i, r in enumerate(rows)]
        return DTensor.from_local(t, mesh, pl, run_check=False, shape=shape,
                                  stride=stride).redistribute(
                                      mesh, rows).to_local()
    if seq:
        top = combined(m, "max")
        o = combined(o * torch.exp(m - top)[..., None], "sum")
    out = (o[..., :hd] / o[..., hd:]).to(v.dtype).reshape(nb, h, hd)
    return DTensor.from_local(out, mesh, rows, run_check=False,
                              shape=(b, h, hd), stride=(h * hd, hd, 1))


def _replicated(t, mesh):
    """``t`` as a DTensor: a plain tensor counts as replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def per_shard_rows(fn, *args, weights=()):
    """``fn(*args, *weights)`` for a recurrence over the sequence (dim 1)
    that is independent over the batch, dim 0 of every tensor in ``args``
    and in its results (the xLSTM scans).  On DTensors each rank runs
    ``fn`` on its own rows, so the scan's steps are local ops, as GSPMD
    partitions a ``lax.scan`` over a batch-sharded carry (a single step,
    S = 1, stays on DTensor's own rules): the activations keep their batch
    shard
    (any other shard gathered first), a plain tensor in ``args`` (a fresh
    state of the global batch) is cut to the rank's rows, and ``weights``
    are whole, their gradient a partial sum over the mesh dims that shard
    the batch.  The results are placed as the activations were."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.utils._pytree import tree_flatten, tree_unflatten
    flat, spec = tree_flatten(args)
    lead = next((t for t in flat if _is_dtensor(t)), None)
    if not (_STATE["on"] and lead is not None) or lead.shape[1] == 1:
        return fn(*args, *weights)      # one step (decode): DTensor's rules
    mesh = lead.device_mesh
    rows = [p if p.is_shard() and p.dim == 0 else Replicate()
            for p in lead.placements]
    sharded = [m for m, p in enumerate(rows) if p.is_shard()]
    lo, n_rows = _rank_range(lead.shape[0], mesh, sharded)

    def local(t):
        if isinstance(t, DTensor):
            return t.redistribute(mesh, rows).to_local()
        if isinstance(t, torch.Tensor):
            return t.narrow(0, lo, n_rows)
        return t
    whole = [w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if p.is_shard() else Replicate()
                         for p in rows]) if isinstance(w, DTensor) else w
             for w in weights]
    _STATE["on"] = False            # the shards are plain tensors
    try:
        out = fn(*tree_unflatten([local(t) for t in flat], spec), *whole)
    finally:
        _STATE["on"] = True
    flat_out, out_spec = tree_flatten(out)

    def placed(o):
        shape = (lead.shape[0],) + tuple(o.shape[1:])
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        return DTensor.from_local(o, mesh, rows, run_check=False,
                                  shape=shape, stride=stride)
    return tree_unflatten([placed(o) for o in flat_out], out_spec)


def per_shard_bh(fn, state, *seq):
    """``fn(state, *seq)`` for a recurrence independent over the batch and
    the heads (the Mamba2 scan and its one-step update): ``state`` (B, H,
    ...) and the tensors of ``seq`` (B, S, H, ...) in, ``(y (B, S, H,
    ...), state (B, H, ...))`` out; other arguments pass through.  On
    DTensors each rank runs ``fn`` on its own (batch, head) shards, so
    the scan's body is plain tensors with no collective, as GSPMD
    partitions a ``lax.scan`` over a carry sharded on batch and heads
    (some DTensor versions refuse the body's einsums at these placements,
    and cumsum's backward).  The split is the state's placements under
    ``shard_bh``: each operand is brought to them (a shard of another dim
    gathered first, an operand replicated on a mesh dim cut to the rank's
    slice without communication, a plain tensor cut likewise), and the
    results are placed alike."""
    if not (_STATE["on"] and any(_is_dtensor(t) for t in (state,) + seq)):
        return fn(state, *seq)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    state = shard_bh(state)
    mesh = state.device_mesh
    split = [p if p.is_shard() and p.dim in (0, 1) else Replicate()
             for p in state.placements]
    ranges = [_rank_range(state.shape[d], mesh,
                          [m for m, p in enumerate(split) if p.is_shard(d)])
              for d in (0, 1)]

    def at(head: int):
        return [Shard(head) if p.is_shard(1) else p for p in split]

    def local(t, head: int):
        if isinstance(t, DTensor):
            return t.redistribute(mesh, at(head)).to_local()
        if isinstance(t, torch.Tensor):
            (b0, nb), (h0, nh) = ranges
            return t.narrow(0, b0, nb).narrow(head, h0, nh)
        return t
    _STATE["on"] = False            # the shards are plain tensors
    try:
        y, st = fn(local(state, 1), *(local(t, 2) for t in seq))
    finally:
        _STATE["on"] = True

    def placed(o, head: int):
        shape = list(o.shape)
        shape[0], shape[head] = state.shape[0], state.shape[1]
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        return DTensor.from_local(o, mesh, at(head), run_check=False,
                                  shape=tuple(shape), stride=stride)
    return placed(y, 2), placed(st, 1)


def split_channels(x, sizes):
    """``torch.split(x, sizes, dim=-1)`` for activations whose last dim
    joins several parts, each a channel dim of its own (the Mamba2
    block's z, x, B, C and dt columns).  On a DTensor split on that dim
    over one mesh dim whose size divides every part, the ranks' edges
    fall inside parts (at zamba2-2.7b's widths on 2 ranks, 40 columns
    into B's), and each part comes out split over that mesh dim on its
    own width: each rank sends every column it holds to the rank whose
    slice of a part holds it, in one all-to-all, and the backward is the
    all-to-all back, as GSPMD reshards such a split.  Otherwise it is the
    plain split."""
    last = x.ndim - 1
    if not (_STATE["on"] and _is_dtensor(x)):
        return torch.split(x, sizes, dim=-1)
    mesh = x.device_mesh
    split = [m for m, p in enumerate(x.placements) if p.is_shard(last)]
    if len(split) != 1 or any(s % mesh.size(split[0]) for s in sizes):
        return torch.split(x, sizes, dim=-1)
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor
    m = split[0]
    n, me = mesh.size(m), mesh.get_local_rank(m)
    width = x.shape[-1]
    step = -(-width // n)                     # torch.chunk's slices
    offsets = [sum(sizes[:i]) for i in range(len(sizes))]

    def pieces(q):
        """(columns, destination) of rank q's slice of ``x``, in order:
        cut at the edges of every part's slices."""
        lo, hi = min(q * step, width), min((q + 1) * step, width)
        out = []
        for o, s in zip(offsets, sizes):
            w = s // n
            for dst in range(n):
                a, b = max(lo, o + dst * w), min(hi, o + (dst + 1) * w)
                if a < b:
                    out.append((b - a, dst))
        return out
    mine = pieces(me)
    chunks = torch.split(x.to_local(), [c for c, _ in mine], dim=-1)
    send = torch.cat([c for (_, dst), c in sorted(zip(mine, chunks),
                                                  key=lambda t: t[0][1])],
                     dim=-1)
    sent = [sum(c for c, dst in mine if dst == q) for q in range(n)]
    got = [sum(c for c, dst in pieces(q) if dst == me) for q in range(n)]
    # the all-to-all splits dim 0; what rank q sends comes in q's order,
    # so the columns arrive in the joined dim's order: the rank's slice of
    # each part in turn
    recv = funcol.all_to_all_single_autograd(
        send.movedim(-1, 0).contiguous(), got, sent, (mesh, m))
    parts = torch.split(recv.movedim(0, -1), [s // n for s in sizes],
                        dim=-1)
    out = []
    for part, s in zip(parts, sizes):
        shape = tuple(x.shape[:-1]) + (s,)
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        out.append(DTensor.from_local(part, mesh, x.placements,
                                      run_check=False, shape=shape,
                                      stride=stride))
    return out


class _SumOver(torch.autograd.Function):
    """A rank's partial sum ``t`` summed over the mesh dims ``dims`` (a
    DTensor ``Partial`` made ``Replicate``, one all-reduce each), both
    ways: each rank's use of the sum gives a partial of its gradient, so
    the backward sums the gradient alike."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return _SumOver.total(t, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return _SumOver.total(g, ctx.mesh, ctx.dims), None, None

    @staticmethod
    def total(t, mesh, dims):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        pl = [Partial() if m in dims else Replicate()
              for m in range(mesh.ndim)]
        return DTensor.from_local(t, mesh, pl, run_check=False).redistribute(
            mesh, [Replicate()] * mesh.ndim).to_local()


def _plain_mean(t):
    return torch.mean(t, dim=-1, keepdim=True)


def per_shard_channels(fn, state, *seq, weights=()):
    """``fn(state, *seq, *weights, mean=mean)`` for a block that works on
    each channel alone but for means over the channels (the Mamba2 block
    between its two products: the conv, the scan and the gated RMSNorm),
    where ``mean(t)`` is the mean of ``t`` over its last dim, all the
    channels.  ``state`` is (B, C, ...), each tensor of ``seq`` (B, L, C,
    ...) and each weight (..., C), C a channel dim (the heads, d_inner, or
    the H·N columns of B and C); ``fn`` returns ``(state, *outs)``, laid
    out as ``state`` and ``seq``.  On DTensors, where every channel dim
    divides over the ranks that split it, each rank runs ``fn`` on its own
    (batch, channel) shards, as GSPMD partitions such a block: the split
    is the batch's and the channels' of the first DTensor of ``seq``;
    every operand is brought to it (a shard of another dim gathered; an
    operand replicated, or a plain tensor, cut to the rank's slice);
    a weight's gradient is a partial sum over the mesh dims that split the
    batch; ``mean`` sums the rank's partial sum over the mesh dims that
    split the channels, B_rank·L numbers, one all-reduce each way; and
    the results are placed as the operands were, so the gradients come in
    on them.  Otherwise ``fn`` runs on the tensors as they are, ``mean``
    the plain mean."""
    lead = next((t for t in seq if _is_dtensor(t)), None)
    if not (_STATE["on"] and lead is not None):
        return fn(state, *seq, *weights, mean=_plain_mean)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = lead.device_mesh
    batch = [m for m, p in enumerate(lead.placements) if p.is_shard(0)]
    chan = [m for m, p in enumerate(lead.placements) if p.is_shard(2)]
    n = math.prod(mesh.size(m) for m in chan)
    if any(t.shape[d] % n for t, d in [(state, 1)] + [(t, 2) for t in seq]
           + [(w, w.ndim - 1) for w in weights]):
        return fn(state, *seq, *weights, mean=_plain_mean)
    rows = _rank_range(lead.shape[0], mesh, batch)

    def at(dim: int, batched: bool = True):
        return [Shard(0) if batched and m in batch else
                Shard(dim) if m in chan else Replicate()
                for m in range(mesh.ndim)]

    def local(t, dim: int):
        if isinstance(t, DTensor):
            return t.redistribute(mesh, at(dim)).to_local()
        return t.narrow(0, *rows).narrow(
            dim, *_rank_range(t.shape[dim], mesh, chan))

    def whole(w):
        """The rank's channels of a weight: its own channel shard, or its
        whole tensor cut, whose gradient is then a partial sum over the
        channels' mesh dims too."""
        d = w.ndim - 1
        if isinstance(w, DTensor):
            own = [m for m, p in enumerate(w.placements) if p.is_shard(d)]
            pl = at(d, batched=False) if own == chan else \
                [Replicate()] * mesh.ndim
            w = w.redistribute(mesh, pl).to_local(grad_placements=[
                Partial() if m in batch or p.is_replicate() and m in chan
                else p for m, p in enumerate(pl)])
            if own == chan:
                return w
        return w.narrow(d, *_rank_range(w.shape[d], mesh, chan))

    def mean(t):
        part = t.sum(dim=-1, keepdim=True)
        if chan:
            part = _SumOver.apply(part, mesh, chan)
        return part / (t.shape[-1] * n)
    _STATE["on"] = False            # the shards are plain tensors
    try:
        out = fn(local(state, 1), *(local(t, 2) for t in seq),
                 *(whole(w) for w in weights), mean=mean)
    finally:
        _STATE["on"] = True

    def placed(o, dim: int):
        shape = list(o.shape)
        shape[0], shape[dim] = lead.shape[0], shape[dim] * n
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        return DTensor.from_local(o, mesh, at(dim), run_check=False,
                                  shape=tuple(shape), stride=stride)
    return (placed(out[0], 1),) + tuple(placed(o, 2) for o in out[1:])


def take_seq(x, idx):
    """``x[:, idx]`` for ``x`` (B, L, ...) and an index tensor ``idx``
    (any shape) into dim 1.  On a DTensor whose dim 1 is whole, each rank
    gathers from its own shard, and the result keeps ``x``'s shards of
    the other dims, as GSPMD partitions a gather along the dims it does
    not index (some DTensor versions have no rule for the gather's
    backward, an accumulating ``index_put``)."""
    if not (_STATE["on"] and _is_dtensor(x)) or any(
            p.is_shard(1) for p in x.placements):
        return x[:, idx]
    from torch.distributed.tensor import DTensor, Shard
    extra = idx.dim() - 1
    pl = [Shard(p.dim + extra) if p.is_shard() and p.dim > 1 else p
          for p in x.placements]
    shape = (x.shape[0],) + tuple(idx.shape) + tuple(x.shape[2:])
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(x.to_local()[:, idx], x.device_mesh, pl,
                              run_check=False, shape=shape, stride=stride)


class _LogSigmoid(torch.autograd.Function):
    """``F.logsigmoid`` on each rank's shard of a DTensor, both ways: the
    gradient is brought to the input's placements (a partial sum summed)
    and goes through the same ``log_sigmoid_backward`` on the shard."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import DTensor
        local = x.to_local()
        out, buf = torch.ops.aten.log_sigmoid_forward(local)
        ctx.save_for_backward(local, buf)
        ctx.mesh, ctx.pl = x.device_mesh, tuple(x.placements)
        ctx.meta = (tuple(x.shape), tuple(x.stride()))
        return DTensor.from_local(out, ctx.mesh, ctx.pl, run_check=False,
                                  shape=x.shape, stride=x.stride())

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        local, buf = ctx.saved_tensors
        g = g.redistribute(ctx.mesh, ctx.pl).to_local()
        dx = torch.ops.aten.log_sigmoid_backward(g, local, buf)
        return DTensor.from_local(dx, ctx.mesh, ctx.pl, run_check=False,
                                  shape=ctx.meta[0], stride=ctx.meta[1])


def logsigmoid(x):
    """``F.logsigmoid(x)``.  DTensor shards its forward (as pointwise
    ops) but has no sharding rule for its backward
    (``aten.log_sigmoid_backward``): where a gradient is needed, each rank
    applies it to its own shard, forward and backward, as the elementwise
    op it is."""
    import torch.nn.functional as F
    if not (_STATE["on"] and _is_dtensor(x) and x.requires_grad
            and torch.is_grad_enabled()):
        return F.logsigmoid(x)
    return _LogSigmoid.apply(x)


def _rank_offset(extent: int, mesh, mesh_dims) -> int:
    """This rank's first index of a dim of ``extent`` sharded over
    ``mesh_dims`` (major first), each split as ``torch.chunk`` splits
    it."""
    return _rank_range(extent, mesh, mesh_dims)[0]


def _rank_range(extent: int, mesh, mesh_dims) -> tuple[int, int]:
    """(first index, length) of this rank's slice of such a dim."""
    coords, lo = mesh.get_coordinate(), 0
    for m in mesh_dims:
        step = -(-extent // int(mesh.mesh.shape[m]))
        start = min(coords[m] * step, extent)
        lo, extent = lo + start, min(step, extent - start)
    return lo, extent


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def place_cache(cache: dict, global_batch: int) -> dict:
    """A fresh cache placed by ``cache_specs`` (what GSPMD gives a
    prefill's cache); off the context, the cache as it is."""
    if not _STATE["on"]:
        return cache
    from torch.distributed.tensor import distribute_tensor
    mesh = _STATE["mesh"]
    specs = cache_specs(cache, mesh, global_batch)

    def place(path, t):
        spec = specs
        for k in path:
            spec = spec[k]
        return distribute_tensor(t, mesh, to_placements(spec, mesh))
    return map_with_path(place, cache)


def write_rows(cache, rows, pos, value) -> None:
    """``cache[rows, pos] = value``: row ``rows[i]`` of a (B, S, ...) cache
    takes ``value[i]`` at position ``pos[i]`` (``rows`` is ``arange(B)``).
    On a DTensor cache each rank writes into its own shard, as GSPMD
    partitions a dynamic-update-slice: the rows of its batch shard whose
    position falls in its slice of S, at the position less the slice's
    first index, with no pass over the cache.  ``value`` (a plain tensor
    counts as replicated) is brought to the cache's split of the dims it
    shares: a local cut where it is replicated, no collective where it is
    split alike, and a gather of B·Hkv·hd numbers where its heads are
    split and the cache's are whole."""
    if not (_STATE["on"] and _is_dtensor(cache)):
        cache[rows, pos] = value
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    batch = [Shard(0) if p.is_shard(0) else Replicate()
             for p in cache.placements]
    lo = [_rank_range(cache.shape[d], mesh,
                      [m for m, p in enumerate(cache.placements)
                       if p.is_shard(d)])[0] for d in (0, 1)]
    local = cache.to_local()
    if local.shape[1] == 0:
        return
    # the value lacks the cache's dim 1: a shard of a later dim moves down
    at_value = [Shard(p.dim - 1) if p.is_shard() and p.dim > 1 else
                Replicate() if p.is_shard(1) else p for p in cache.placements]
    val = _replicated(value, mesh).redistribute(mesh, at_value).to_local()
    r, s = (_replicated(t, mesh).redistribute(mesh, batch).to_local() - o
            for t, o in ((rows, lo[0]), (pos, lo[1])))
    hit = (s >= 0) & (s < local.shape[1])
    s = s.clamp(0, local.shape[1] - 1)
    hit = hit.reshape(hit.shape + (1,) * (val.ndim - 1))
    local[r, s] = torch.where(hit, val, local[r, s])


def write_prefix(dst, src, dim: int = 1) -> None:
    """``dst[:, :n] = src`` along ``dim`` (n = src's extent there) into a
    fresh, zero ``dst``.  On DTensors ``src`` is zero-padded to ``dst``'s
    extent and copied whole, so a sharded ``dim`` needs no slice of it."""
    if not (_STATE["on"] and _is_dtensor(dst)):
        dst[(slice(None),) * dim + (slice(0, src.shape[dim]),)] = src
        return
    pad = list(src.shape)
    pad[dim] = dst.shape[dim] - src.shape[dim]
    zeros = torch.zeros(pad, dtype=src.dtype, device=src.device)
    dst.copy_(torch.cat([src, zeros], dim=dim))


def gather_vocab(logits, idx):
    """``torch.gather(logits, -1, idx)``.  On a DTensor sharded over the
    vocabulary it is the vocab-parallel gather: each rank gathers from its
    own slice of the vocabulary, zeroes the indices outside it, and the
    result is a partial sum over the vocabulary's mesh dims (one small
    all-reduce where it is read)."""
    if not (_STATE["on"] and _is_dtensor(logits)):
        return torch.gather(logits, -1, idx)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh, pl = logits.device_mesh, tuple(logits.placements)
    vdim = logits.ndim - 1
    vocab_dims = [m for m, p in enumerate(pl) if p.is_shard(vdim)]
    if not vocab_dims:
        return torch.gather(logits, -1, idx)
    idx_pl = tuple(Replicate() if m in vocab_dims else p
                   for m, p in enumerate(pl))
    idx = _replicated(idx, mesh).redistribute(mesh, idx_pl)
    lo = _rank_offset(logits.shape[vdim], mesh, vocab_dims)
    local, li = logits.to_local(), idx.to_local()
    n = local.shape[-1]
    rel = li - lo
    inside = (rel >= 0) & (rel < n)
    got = torch.gather(local, -1, rel.clamp(0, max(n - 1, 0)))
    got = torch.where(inside, got, torch.zeros((), dtype=got.dtype,
                                               device=got.device))
    out_pl = [Partial() if m in vocab_dims else p for m, p in enumerate(pl)]
    return DTensor.from_local(got, mesh, out_pl, run_check=False,
                              shape=idx.shape, stride=idx.stride())

