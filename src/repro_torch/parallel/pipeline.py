"""Pipeline parallelism: a GPipe-style microbatch pipeline over the ranks
of a ``torch.distributed`` group, the twin of ``repro.parallel.pipeline``.

Rank i of the group is stage i.  The schedule is the classic GPipe
flush: M microbatches flow through S stages in S + M - 1 ticks; bubble
fraction (S - 1) / (S + M - 1).  Each tick every stage sends its output
to stage i + 1 mod S and receives from stage i - 1 (one
``batch_isend_irecv``: JAX's ``ppermute`` ring); at the end an
``all_reduce`` of the last stage's outputs (zeros elsewhere) gives every
rank the results (JAX's ``psum``).  A stage runs its block only on the
ticks a microbatch is in it; on the others it passes its input on.

``pipeline_apply`` is layer-agnostic: it pipelines any
``block_fn(params_stage, x) -> x`` where each stage holds its slice of the
stacked layer parameters.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import op_cost


def _select(tree, i: int):
    if isinstance(tree, dict):
        return {k: _select(v, i) for k, v in tree.items()}
    return tree[i]


def _ring(x: torch.Tensor, group, stage: int, s: int) -> torch.Tensor:
    """``x`` sent to stage + 1 and stage - 1's received (mod s)."""
    if s == 1:
        return x
    recv = torch.empty_like(x)
    nxt = dist.get_global_rank(group, (stage + 1) % s) if group else \
        (stage + 1) % s
    prv = dist.get_global_rank(group, (stage - 1) % s) if group else \
        (stage - 1) % s
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x.contiguous(), nxt, group),
        dist.P2POp(dist.irecv, recv, prv, group)])
    for r in reqs:
        r.wait()
    op_cost.record_collective("collective-permute", recv.nbytes, s)
    return recv


def pipeline_apply(block_fn, params_stacked, x_microbatches, group=None):
    """Run microbatches through the pipeline stages.

    params_stacked: nested dict whose leaves have leading dim = n_stages
    (every rank passes the same tree and uses its own slice);
    x_microbatches: (M, mb, ...) microbatches, the same on every rank.
    Returns the (M, mb, ...) outputs on every rank."""
    s = dist.get_world_size(group)
    stage = dist.get_rank(group)
    params = _select(params_stacked, stage)
    xs = x_microbatches
    m = xs.shape[0]
    outputs = torch.zeros_like(xs)
    inflight = torch.zeros_like(xs[0])
    for t in range(s + m - 1):
        recv = _ring(inflight, group, stage, s)
        if stage == 0:
            x_in = xs[t] if t < m else torch.zeros_like(xs[0])
        else:
            x_in = recv
        y = block_fn(params, x_in) if 0 <= t - stage < m else x_in
        done = t - (s - 1)
        if stage == s - 1 and 0 <= done < m:
            outputs[done] = y
        inflight = y
    # only the last stage holds real outputs; every rank gets them
    if stage != s - 1:
        outputs.zero_()
    dist.all_reduce(outputs, group=group)
    op_cost.record_collective("all-reduce", outputs.nbytes, s)
    return outputs


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_stages + n_microbatches - 1)
