"""The backward of the port's two chunked loops is linear in the sequence.

``chunked_loss`` (``models/transformer.py``) and the Mamba2 SSD scan
``_ssd_scan`` (``models/ssm.py``) cut their inputs into chunks once, as
JAX's reshape + ``lax.scan`` does, so each backward joins the chunks'
gradients once.  Slicing each chunk out of the full-length input inside
the loop would make every chunk's backward write a zero-padded
full-length gradient, (S / chunk) x S in all.

* Bytes: ``parallel/op_cost.py``'s counter over the backward at S, 2S
  and 4S is affine in S (b(4S) - b(2S) = 2 (b(2S) - b(S)) within 1%).
* Values: the loss, the outputs and the gradients of every input are
  ``torch.equal`` to those of the sliced loop (written out below), with
  S a multiple of the chunk and not.
* Graph: no ``SliceBackward0`` over the full length of an input is left
  a chunk; their number does not grow with the number of chunks.
* On a fake (4, 2) mesh, DTensor inputs placed as the dry-run places
  them: the chunks keep the inputs' placements, and the cut runs the
  collectives of the sliced loop and no more.  Both scans run as the
  model runs its scan there, through ``ctx.per_shard_bh`` on each rank's
  (batch, head) shards: DTensor of torch 2.11 refuses the scan's body
  einsums on DTensors at these placements, cut or sliced (2.13 runs
  them).

No JAX here: the parity of both functions with JAX is held by
``tests/test_torch_train_model.py`` and ``tests/test_torch_family_modules.py``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.registry import get_arch
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import op_cost

# batch 4 (one row a rank on the mesh's 'data' dim)
B = 4
# the loss: d_model 64, vocab 128, 512-position chunks
LOSS_D, LOSS_V, LOSS_CHUNK = 64, 128, 512
# the scan: 4 heads of 32, state 16, 128-step chunks
SCAN_H, SCAN_HD, SCAN_N, SCAN_CK = 4, 32, 16, 128


def _loss_cfg():
    return get_arch("smollm-360m").reduced().scaled(
        d_model=LOSS_D, vocab=LOSS_V, tie_embeddings=False)


def _loss_inputs(s: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((LOSS_D, LOSS_V)).astype(np.float32) / 8
    h = rng.standard_normal((B, s, LOSS_D)).astype(np.float32)
    labels = rng.integers(0, LOSS_V, (B, s))
    labels[0, -7:] = -1
    return ({"unembed": {"w": torch.from_numpy(w).requires_grad_()}},
            torch.from_numpy(h).requires_grad_(), torch.from_numpy(labels))


def _scan_inputs(s: int, seed: int = 0):
    """(state, xh, bh, ch, dt, decay) as ``mamba2_apply`` makes them: xh
    bf16, the rest f32, dt > 0 and the decay in (0, 1)."""
    g = torch.Generator().manual_seed(seed)
    b, h, hd, n = B, SCAN_H, SCAN_HD, SCAN_N
    state = torch.randn((b, h, hd, n), generator=g)
    xh = torch.randn((b, s, h, hd), generator=g).bfloat16()
    bh = torch.randn((b, s, h, n), generator=g)
    ch = torch.randn((b, s, h, n), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g))
    decay = torch.exp(-0.5 * dt)
    return [a.requires_grad_() for a in (state, xh, bh, ch, dt, decay)]


# the parent's loops, each chunk sliced out of the full-length input ------

def _sliced_chunked_loss(cfg, params, hidden, labels):
    w = T._unembed_matrix(cfg, params)
    b, s, d = hidden.shape
    chunk = min(T.LOSS_CHUNK, s)
    pad = (-s) % chunk
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s + pad, chunk):
        t, n = checkpoint(T._chunk_nll, hidden[:, c0:c0 + chunk],
                          labels[:, c0:c0 + chunk], w, use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def _sliced_ssd_scan(state, xh, bh, ch, dt, decay, ck: int):
    s = xh.shape[1]
    pad = (-s) % ck
    xh_, bh_, ch_, dt_ = (ssm._pad_seq(a, pad) for a in (xh, bh, ch, dt))
    dec_ = ssm._pad_seq(decay, pad, value=1.0)
    causal = torch.tril(torch.ones((ck, ck), device=xh.device))[None, :, :,
                                                                 None]
    ys = []
    for c0 in range(0, s + pad, ck):
        sl = slice(c0, c0 + ck)
        xc, bc, cc, dtc, dc = (a[:, sl] for a in (xh_, bh_, ch_, dt_, dec_))
        logd = torch.log(torch.clamp(dc, min=1e-20))
        cum = torch.cumsum(logd, dim=1)
        total = torch.exp(cum[:, -1])
        y_state = torch.einsum("bhpn,bkhn->bkhp", state, cc) \
            * torch.exp(cum)[..., None]
        rel = cum[:, :, None, :] - cum[:, None, :, :]
        w = torch.exp(torch.where(causal > 0, rel, float("-inf"))) * causal
        scores = torch.einsum("bkhn,bjhn->bkjh", cc, bc)
        xin = dtc[..., None] * xc.float()
        y_intra = torch.einsum("bkjh,bkjh,bjhp->bkhp", scores, w, xin)
        wend = torch.exp(cum[:, -1:, :] - cum)
        state = pctx.shard_bh(state * total[..., None, None] + torch.einsum(
            "bkhp,bkhn,bkh->bhpn", xin, bc, wend))
        ys.append(y_state + y_intra)
    return torch.cat(ys, dim=1)[:, :s], state


# the two functions as one interface: inputs needing a gradient, and a
# scalar to differentiate --------------------------------------------------

def _loss_case(fn, s):
    params, h, labels = _loss_inputs(s)
    leaves = [h, params["unembed"]["w"]]
    return leaves, lambda: fn(_loss_cfg(), params, h, labels)


def _scan_case(fn, s):
    leaves = _scan_inputs(s)
    # a fixed random cotangent for y and the final state
    g = torch.Generator().manual_seed(1)
    gy = torch.randn((B, s, SCAN_H, SCAN_HD), generator=g)
    gs = torch.randn((B, SCAN_H, SCAN_HD, SCAN_N), generator=g)

    def run():
        y, st = fn(*leaves, SCAN_CK)
        return (y * gy).sum() + (st * gs).sum()
    return leaves, run


CASES = {
    "chunked_loss": (_loss_case, T.chunked_loss, _sliced_chunked_loss,
                     LOSS_CHUNK),
    "ssd_scan": (_scan_case, ssm._ssd_scan, _sliced_ssd_scan, SCAN_CK),
}


@pytest.fixture
def loss_chunk(monkeypatch):
    monkeypatch.setattr(T, "LOSS_CHUNK", LOSS_CHUNK)


def _backward_bytes(case, fn, s) -> float:
    leaves, run = case(fn, s)
    out = run()
    with op_cost.OpCounter() as counter:
        out.backward()
    assert all(t.grad is not None for t in leaves)
    return counter.cost.bytes_accessed


@pytest.mark.parametrize("name,s", [("chunked_loss", 1024),
                                    ("ssd_scan", 512)])
def test_backward_bytes_are_affine_in_s(loss_chunk, name, s):
    """On the sliced loop the ratio is 2.73 for both: each chunk's
    backward wrote a full-length gradient."""
    case, fn, _, chunk = CASES[name]
    assert s % chunk == 0
    b1, b2, b4 = (_backward_bytes(case, fn, k * s) for k in (1, 2, 4))
    assert b1 < b2 < b4
    ratio = (b4 - b2) / (b2 - b1)
    assert abs(ratio - 2.0) <= 0.02, (b1, b2, b4, ratio)


@pytest.mark.parametrize("name,s", [("chunked_loss", 1024),
                                    ("chunked_loss", 1300),
                                    ("ssd_scan", 384),
                                    ("ssd_scan", 300)])
def test_gradients_equal_the_sliced_loops(loss_chunk, name, s):
    """S a multiple of the chunk and not (padded): the value and every
    input's gradient are the sliced loop's bit for bit (the sliced
    backward only added exact zeros)."""
    case, fn, sliced, _ = CASES[name]
    got_leaves, got_run = case(fn, s)
    want_leaves, want_run = case(sliced, s)
    got, want = got_run(), want_run()
    assert torch.equal(got, want)
    got.backward()
    want.backward()
    for a, b in zip(got_leaves, want_leaves):
        assert a.grad is not None and torch.isfinite(a.grad).all()
        assert torch.equal(a.grad, b.grad)


def _full_length_slices(root, length: int) -> int:
    """``SliceBackward0`` nodes in the graph below ``root`` that cut dim 1
    out of a tensor ``length`` long."""
    seen, todo, n = set(), [root], 0
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "SliceBackward0":
            sizes = node._saved_self_sym_sizes
            if node._saved_dim == 1 and len(sizes) > 1 \
                    and int(sizes[1]) == length:
                n += 1
        todo.extend(f for f, _ in node.next_functions)
    return n


@pytest.mark.parametrize("name", sorted(CASES))
def test_no_slice_of_the_full_length_a_chunk(loss_chunk, name):
    """At 4 and 8 chunks: the sliced loop leaves one full-length slice a
    chunk of each sequence that needs a gradient (the loss's hidden
    states; the scan's five inputs); the cut leaves at most the scan's
    one crop of its output."""
    case, fn, sliced, chunk = CASES[name]
    seqs = {"chunked_loss": 1, "ssd_scan": 5}[name]
    counts = {}
    for f in (fn, sliced):
        for k in (4, 8):
            _, run = case(f, k * chunk)
            counts[f, k] = _full_length_slices(run().grad_fn, k * chunk)
    assert counts[sliced, 4] == 4 * seqs + counts[fn, 4]
    assert counts[sliced, 8] == 8 * seqs + counts[fn, 8]
    assert counts[fn, 4] == counts[fn, 8] <= 1


# the dry-run's placements --------------------------------------------------

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


def _placed(mesh, t, placements, grad: bool = True):
    """``t`` as rank 0's shard of a DTensor (the global shape ``t``'s,
    sharded dims cut to this rank's extent)."""
    from torch.distributed.tensor import DTensor
    local = t.detach()
    for mesh_dim, p in enumerate(placements):
        if p.is_shard():
            local = local.tensor_split(mesh.size(mesh_dim), p.dim)[0]
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride()).requires_grad_(grad)


def _counted_on_mesh(mesh, case, fn, s):
    """(the function's DTensor inputs, its counted forward and backward),
    the inputs placed as the dry-run's ``mamba2_apply`` and ``loss_fn``
    hand them over: every input's batch over 'data'; the scan's state
    heads over 'model' (``shard_bh``), xh heads over 'model' (its
    reshape from the FFN-sharded projection), bh, ch, dt and the decay
    whole on 'model'; the vocab matrix's columns over 'model'."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    leaves, _ = case(fn, s)
    dp, rep = Shard(0), Replicate()
    if fn in (ssm._ssd_scan, _sliced_ssd_scan):
        heads = [Shard(1), Shard(2), rep, rep, rep, rep]
        args = [_placed(mesh, t, (dp, h)) for t, h in zip(leaves, heads)]

        def run():
            y, st = pctx.per_shard_bh(fn, *args, SCAN_CK)
            return y.sum() + st.sum()
    else:
        params, _, labels = _loss_inputs(s)
        args = [_placed(mesh, leaves[0], (dp, rep)),
                _placed(mesh, params["unembed"]["w"], (rep, Shard(1)))]
        lab = _placed(mesh, labels, (dp, rep), grad=False)

        def run():
            return fn(_loss_cfg(), {"unembed": {"w": args[1]}}, args[0], lab)
    with implicit_replication(), op_cost.OpCounter() as counter:
        run().backward()
    return args, counter.cost


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_cut_adds_no_collective_on_a_mesh(fake_mesh_4x2, loss_chunk,
                                              name):
    """The sequence dim is never sharded, so splitting it keeps every
    placement: the collectives are the sliced loop's, the bytes fewer."""
    case, fn, sliced, chunk = CASES[name]
    s = 4 * chunk
    args, got = _counted_on_mesh(fake_mesh_4x2, case, fn, s)
    for a in args:
        if a.ndim < 3 or a.shape[1] != s:
            continue              # the vocab matrix, the scan's state
        for part in torch.split(a, chunk, dim=1):
            assert tuple(part.placements) == tuple(a.placements)
    _, want = _counted_on_mesh(fake_mesh_4x2, case, sliced, s)
    assert got.flops == want.flops
    assert got.collectives == want.collectives
    assert got.collective_counts == want.collective_counts
    assert got.bytes_accessed < want.bytes_accessed
