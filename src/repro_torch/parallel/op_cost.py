"""Per-rank op counting, the port's counterpart of ``repro.parallel.hlo_cost``.

The JAX package re-derives a chip's cost from the optimized HLO text of
the SPMD-partitioned module.  PyTorch runs eagerly and has no HLO, so this
module keeps ``hlo_cost``'s cost rules and drops its parser: ``OpCounter``
is a ``TorchDispatchMode`` that sees every aten op the program runs, on
the real device, on ``meta`` tensors (the dry-run), or under DTensor.

* **Dot FLOPs** of ``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions
  and scaled-dot-product attention: 2 x result elements x contraction, as
  ``hlo_cost._dot_flops`` counts an HLO ``dot``.
* **HBM bytes**: the inputs plus the outputs of each op; views and bare
  allocations move nothing, a gather moves its slice (read and written)
  and its index, a scatter its values and its index (``hlo_cost``'s
  slice and dynamic-update-slice rules).  Eager PyTorch fuses nothing, so
  this is the eager program's real traffic.  It differs by design from
  ``hlo_cost``'s count, which charges each XLA fusion once.
* **Collectives** by kind, from the ``_c10d_functional`` ops that DTensor
  and ``torch.distributed._functional_collectives`` issue (all-gather,
  all-reduce, reduce-scatter, all-to-all), plus what ``record_collective``
  is told by the callers of plain ``torch.distributed`` collectives (the
  compressed all-reduce, the pipeline's send/recv, whose group a dispatch
  mode cannot read): result bytes and counts, each also
  under the size of its process group (``collective_groups``), which sets
  the link it crosses (``roofline``).
* **Per rank.**  An op on DTensors is not counted: the counter declines
  it (``NotImplemented``), DTensor runs it as local ops and collectives
  on the rank's shards, and those are what is counted — rank 0's program,
  as the SPMD-partitioned HLO module is one chip's.  The ops DTensor runs
  under a fake-tensor mode to propagate global shapes are not the rank's
  and are skipped.
* **The hand-written kernels** are ctypes launches, invisible to a
  dispatch mode; each wrapper credits its launch here (``credit``) with
  its input-plus-output bytes and its FLOPs.  With no counter active a
  credit is one global read.
* **Fused regions** (``region``): the flash attention, the SSD and
  mLSTM scans and the MoE experts' gated FFN.  Their ops are counted as
  usual, and the counter also keeps ``bytes_fused``, in which a region
  costs only its boundary bytes (its tensor arguments and results, touched
  once) — ``hlo_cost``'s ``fuse_inner_loops``, which credits such loops
  with VMEM semantics — and each region's dot FLOPs (``region_flops``).
* **Scans** (``scan``): the xLSTM recurrences, ``lax.scan``'s counterpart.
  Under a counter made with ``trips=k`` a scan runs only its first k
  steps, so the dry-run traces a long recurrence at two trip counts and
  evaluates the count, affine in the trip count, at the sequence's
  length, as ``hlo_cost`` multiplies a scan's body by its trip count.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

#: the counters entered, innermost last: ``credit``, ``region``,
#: ``record_collective`` and ``scan`` report to the innermost
_ACTIVE: list = []

_DOTS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
         aten.baddbmm.default}
_CONVS = {aten.convolution.default}
_SDPA = {aten._scaled_dot_product_flash_attention.default,
         aten._scaled_dot_product_efficient_attention.default,
         aten._scaled_dot_product_cudnn_attention.default,
         aten._scaled_dot_product_flash_attention_for_cpu.default}
# allocations and metadata: no HBM traffic
_NO_BYTES = {aten.empty.memory_format, aten.empty_like.default,
             aten.empty_strided.default, aten.new_empty.default,
             aten.new_empty_strided.default, aten.detach.default,
             aten.lift_fresh.default}
# reads of a slice (a gather): the slice read and written, and the index
_SLICE_READS = {aten.index.Tensor, aten.gather.default,
                aten.index_select.default, aten.embedding.default}
# in-place writes of a slice (a scatter): the values read and written, and
# the index (``hlo_cost``'s dynamic-update-slice)
_SLICE_WRITES = {aten.index_put_.default, aten.index_put.default,
                 aten._index_put_impl_.default, aten.scatter_.src,
                 aten.scatter_add_.default, aten.index_add_.default,
                 aten.index_copy_.default}
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "broadcast", "broadcast_": "broadcast"}


def _local(t):
    """A DTensor's shard on this rank (the tensor itself otherwise)."""
    return getattr(t, "_local_tensor", t)


def _tensors(obj) -> list:
    """The tensors in ``obj``, through lists, tuples and dicts, in no
    particular order (an op's arguments and results; ``tree_flatten``'s
    leaves, without its specs, which would cost more than the rest of a
    counted op)."""
    out, todo = [], [obj]
    while todo:
        o = todo.pop()
        if isinstance(o, torch.Tensor):
            out.append(o)
        elif isinstance(o, (list, tuple)):
            todo.extend(o)
        elif isinstance(o, dict):
            todo.extend(o.values())
    return out


def tensor_bytes(obj) -> float:
    """Bytes of every tensor in ``obj`` (a DTensor's local shard)."""
    total = 0
    for t in _tensors(obj):
        t = _local(t)
        total += t.numel() * t.element_size()
    return float(total)


def _numel(t) -> int:
    return _local(t).numel()


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


@dataclass
class OpCost:
    """Per-rank cost (the fields of ``hlo_cost.HloCost``, plus the
    fused-region bytes, the collectives by group size and the kernels'
    credits)."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    bytes_fused: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = field(default_factory=dict)
    collective_counts: dict = field(default_factory=dict)
    collective_groups: dict = field(default_factory=dict)
    dot_calls: float = 0.0
    kernels: dict = field(default_factory=dict)
    region_flops: dict = field(default_factory=dict)


def affine(terms) -> OpCost:
    """The cost ``sum(w * cost for w, cost in terms)``, field by field: a
    step's cost extrapolated from traces at a few depths, each count being
    affine in the number of layers (``hlo_cost`` multiplies a scanned
    layer's body by its trip count)."""
    out = OpCost()
    for w, c in terms:
        for f in ("flops", "bytes_accessed", "bytes_fused",
                  "collective_bytes", "dot_calls"):
            setattr(out, f, getattr(out, f) + w * getattr(c, f))
        for f in ("collectives", "collective_counts", "collective_groups",
                  "region_flops"):
            acc = getattr(out, f)
            for k, v in getattr(c, f).items():
                acc[k] = acc.get(k, 0) + w * v
        for name, k in c.kernels.items():
            acc = out.kernels.setdefault(name, {"launches": 0, "bytes": 0.0,
                                                "flops": 0.0})
            for f, v in k.items():
                acc[f] += w * v
    return out


def dot_flops(func, args, out) -> float:
    """2 x result elements x contraction for one product op (0 for any
    other op), on the shapes this rank runs."""
    if func in _DOTS:
        a = args[1] if func in (aten.addmm.default, aten.baddbmm.default) \
            else args[0]
        return 2.0 * _numel(out) * _local(a).shape[-1]
    if func in _CONVS:
        w = _local(args[1])
        return 2.0 * _numel(out) * w[0].numel()     # (C_in/g) x kernel size
    if func in _SDPA:
        q, k = _local(args[0]), _local(args[1])
        b_h = q.numel() // (q.shape[-2] * q.shape[-1])
        # scores (Sq x Sk x hd) and values (Sq x Sk x hd_v)
        return 2.0 * b_h * q.shape[-2] * k.shape[-2] * (
            q.shape[-1] + _local(args[2]).shape[-1])
    return 0.0


class OpCounter(TorchDispatchMode):
    """Counts what this rank executes while it is entered (see the module
    docstring); the result is ``.cost``.

    ``trips=k`` (k >= 2) cuts every ``scan`` run inside to its first k
    steps, for counting only: the outputs of the steps not run are
    copies of step k's, cut from the graph, so the values are not the
    program's.  Steps 2..k-1 are alike (the first has no incoming carry
    gradient, the last no outgoing one), and each step not run leaves one
    undefined gradient slice, so every count is affine in k from k = 2 to
    the sequence's length, where the program is the one that runs
    uncut."""

    def __init__(self, trips: int | None = None):
        super().__init__()
        if trips is not None and trips < 2:
            raise ValueError(f"a scan is cut to 2 or more steps, not "
                             f"{trips}")
        self.cost = OpCost()
        self.trips = trips
        self._regions = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(type(t).__name__ == "DTensor"
               for t in _tensors((args, kwargs))):
            return NotImplemented            # counted as DTensor's local ops
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is None:
            self._account(func, args, kwargs, out)
        return out

    def _account(self, func, args, kwargs, out) -> None:
        c = self.cost
        ns = func.namespace
        if ns in ("_c10d_functional", "_c10d_functional_autograd"):
            kind = _COLLECTIVES.get(func._opname)
            if kind is not None:
                self.collective(kind, tensor_bytes(out),
                                _group_size(kwargs.get("group_name",
                                                       args[-1])))
            return
        if ns == "c10d":                # reported by its caller
            return
        if ns == "prim" or func.is_view or func in _NO_BYTES:
            return
        fl = dot_flops(func, args, out)
        if fl:
            c.flops += fl
            c.dot_calls += 1
        if func in _SLICE_READS:
            nb = 2 * tensor_bytes(out) + tensor_bytes(args[1:])
        elif func in _SLICE_WRITES:
            values = args[2] if func in (aten.index_put_.default,
                                         aten.index_put.default,
                                         aten._index_put_impl_.default) \
                else args[3]
            nb = 2 * tensor_bytes(values) + tensor_bytes(
                [a for a in args[1:] if a is not values])
        else:
            nb = tensor_bytes(args) + tensor_bytes(kwargs) + tensor_bytes(out)
        c.bytes_accessed += nb
        if not self._regions:
            c.bytes_fused += nb

    def collective(self, kind: str, nbytes: float, group: int) -> None:
        c = self.cost
        c.collective_bytes += nbytes
        c.collectives[kind] = c.collectives.get(kind, 0) + nbytes
        c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1
        c.collective_groups[group] = c.collective_groups.get(group, 0) \
            + nbytes

    def kernel(self, name: str, nbytes: float, flops: float) -> None:
        c = self.cost
        k = c.kernels.setdefault(name, {"launches": 0, "bytes": 0.0,
                                        "flops": 0.0})
        k["launches"] += 1
        k["bytes"] += nbytes
        k["flops"] += flops
        c.flops += flops
        c.bytes_accessed += nbytes
        if not self._regions:
            c.bytes_fused += nbytes


def active() -> bool:
    return bool(_ACTIVE)


def credit(name: str, inputs, outputs, flops: float = 0.0,
           nbytes: float | None = None) -> None:
    """A hand-written kernel's launch: its input-plus-output bytes (or
    ``nbytes`` where the kernel reads less than its inputs) and its
    FLOPs, to the active counter.  The caller checks ``active()`` first,
    so no bytes are summed when nothing counts."""
    if _ACTIVE:
        _ACTIVE[-1].kernel(name, tensor_bytes((inputs, outputs))
                           if nbytes is None else float(nbytes), flops)


def untracked(fn):
    """``fn()`` with no dispatch mode active: a kernel's data-dependent
    work, read on the host, is not the rank's program."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return fn()


def record_collective(kind: str, nbytes: float, group: int) -> None:
    """A collective the counter cannot see as an op (a point-to-point
    send/recv): its result bytes and its group's size."""
    if _ACTIVE:
        _ACTIVE[-1].collective(kind, float(nbytes), group)


def region(name: str, fn, *args):
    """``fn(*args)``, counted as a fused region: in ``bytes_fused`` only its
    boundary bytes (its tensor arguments and results) count, and its dot
    FLOPs are also kept under ``name`` (``region_flops``)."""
    if not _ACTIVE:
        return fn(*args)
    counter = _ACTIVE[-1]
    counter._regions += 1
    flops = counter.cost.flops
    try:
        out = fn(*args)
    finally:
        counter._regions -= 1
    kept = counter.cost.region_flops
    kept[name] = kept.get(name, 0.0) + counter.cost.flops - flops
    if not counter._regions:
        counter.cost.bytes_fused += tensor_bytes(args) + tensor_bytes(out)
    return out


def count(fn, *args, **kwargs) -> tuple[object, OpCost]:
    """(``fn(*args, **kwargs)``, what this rank ran for it)."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.cost


def scan(step, carry, *xs):
    """``lax.scan`` over dim 1 of ``xs``: ``carry, y_t = step(carry,
    *x_t)`` for t = 0..S-1, and the y_t stacked on dim 1; returns (ys,
    carry).  The sequences are unbound once, so the backward stacks the
    steps' gradients once (slicing each step out would write a zeroed
    full-length gradient a step).  Under a counter made with ``trips=k``
    only the first k steps run (see ``OpCounter``)."""
    n = xs[0].shape[1]
    seq = [x.unbind(1) for x in xs]
    cut = _ACTIVE[-1].trips if _ACTIVE else None
    run = n if cut is None else min(n, cut)
    ys = []
    for t in range(run):
        carry, y = step(carry, *(s[t] for s in seq))
        ys.append(y)
    if run < n:
        ys += [ys[-1].detach()] * (n - run)
    return torch.stack(ys, dim=1), carry
