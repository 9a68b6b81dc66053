"""The port's kernels and engine on the card (marker ``cuda``).

Every test skips without an NVIDIA card.  This file imports ``torch`` and
the port only, never ``jax``, so it runs on the GPU machine, which has no
JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version on the same CUDA tensors at
the slice's shapes, and the two attention kernels against the plain models
of their split-key algorithm, on the same inputs cast to f32, at lengths
that cross its granule and rank boundaries and at one shape for every
(query rows, head-dim capacity) the kernels are built for (atol 1e-4 /
rtol 4e-3: the kernels round their output to bf16); the engine's batched
greedy tokens must equal its one-at-a-time tokens through the kernels, a
prefill unit and a decode unit must give the unified engine's tokens, and
the one-at-a-time path behind the Router keeps its tokens with the prefix
cache on or off.  The contiguous kernel under a sliding window is held to
the windowed split model at every instantiation and to the layer's
windowed plain version on ``decode_fn``'s cache.  The decode kernel is
also held at every registered arch's (G, Hkv, hd) and at an enc-dec
cross-attention shorter than its cache, and every family's reduced model
on the card against the same weights on the host.  RMSNorm is held at every instantiation of its kernel
(the library reports which one a width takes), the PMF convolution up to
the longest row it takes, and its front door against the chance of success
it stands for; the success-chance signal of a simulator and of a
Router's plane scaler launches it on the card when no device is given, and
takes the decisions of the same runs on the host.  The merge-saving MLP trained on the card predicts as the
same training on the host does (``MLP_CARD_ATOL``).  The RMSNorm backward
kernel is held to its plain version at every instantiation, gives the same
bits in two calls, and is what autograd records on the card; a reduced
model's backward on the card reaches every parameter, and the kernels
without a backward refuse to cut an autograd graph.  The chunked prefill's
attention kernel is held against ``full_attention`` in f32 at smollm's,
yi-9b's and qwen1.5's widths over prefixes and real-row counts that cross
its tiles (padding rows zeros), gives a row the same bits wherever the
prompt is cut, is launched once a layer with no padded score tile in
memory, and keeps the engine's batched tokens equal to one-at-a-time ones
at smollm's widths.  DeepSeek-V2-Lite's latent attention: the chunk
kernel at keys of 192, values of 128 and its softmax scale, and the paged
kernel's latent instance at its full widths, are held per element to
twice their rounding bounds against plain f32 attention (the latent
instance gives a row the same bits in any batch); smollm's instances of
both kernels keep the bits the tree before them gave
(``test_smollm_instances_keep_their_bits``); the batched engine serves the
model at full widths (two layers) with the served tokens' logits within a
stated gap of the plain reference's best.
"""

import ctypes
import hashlib
import importlib.util
import itertools
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.chunk_attention.ops import (HEAD_DIMS,
                                                     chunk_attention_cuda)
from repro_torch.kernels.decode_attention.ops import (
    decode_attention_cuda, paged_decode_attention_cuda,
    paged_mla_decode_attention_cuda)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_split_ref,
    paged_decode_attention_ref, paged_decode_attention_split_ref)
from repro_torch.core.pmf import PMF, chance_of_success
from repro_torch.kernels.pmf_conv.ops import batched_success, pmf_conv_cuda
from repro_torch.kernels.pmf_conv.ref import pmf_conv_ref
from repro_torch.kernels.build import library
from repro_torch.kernels.rmsnorm.ops import (MAX_D, check_width, rmsnorm,
                                             rmsnorm_bwd_cuda, rmsnorm_cuda)
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.core.fleet import FleetSpec
from repro_torch.core.simulation import PETOracle, SimConfig, Simulator
from repro_torch.core.tasks import PETMatrix
from repro_torch.serving.autoscale import ElasticityConfig
from repro_torch.serving.autoscale import signals as autoscale_signals
from repro_torch.serving.batching import StepBatchingConfig
from repro_torch.serving.cluster import (Router, make_engine_plane_factory,
                                         make_engine_planes)
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


def _paged(cuda, b, mp=64, ps=16, h=15, hkv=5, hd=64, seed=0, lens=None):
    g = torch.Generator(device=cuda).manual_seed(seed)
    n_pages = b * mp + 1
    q = torch.randn((b, h, hd), generator=g, device=cuda).bfloat16()
    kp = torch.randn((n_pages, ps, hkv, hd), generator=g,
                     device=cuda).bfloat16()
    vp = torch.randn((n_pages, ps, hkv, hd), generator=g,
                     device=cuda).bfloat16()
    kp[0], vp[0] = 1000.0, -1000.0                 # poisoned pad page
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = rng.integers(1, mp * ps + 1, size=b)
    lens = np.asarray(lens, np.int32)
    perm = rng.permutation(n_pages - 1) + 1
    tables = np.zeros((b, mp), np.int32)
    for i, n in enumerate(lens):
        npg = min(-(-int(n) // ps), mp)
        tables[i, :npg] = perm[i * mp:i * mp + npg]
    return (q, kp, vp, torch.from_numpy(tables).to(cuda),
            torch.from_numpy(lens).to(cuda))


@pytest.mark.parametrize("b", [1, 3, 8])
def test_paged_attention_kernel(cuda, b):
    args = _paged(cuda, b, seed=b)
    torch.testing.assert_close(
        paged_decode_attention_cuda(*args).float(),
        paged_decode_attention_ref(*args).float(), atol=2e-2, rtol=2e-2)


def test_paged_attention_batch_invariant(cuda):
    q, kp, vp, tab, ln = _paged(cuda, 8, seed=5)
    full = paged_decode_attention_cuda(q, kp, vp, tab, ln)
    for i in range(8):
        one = paged_decode_attention_cuda(q[i:i + 1].contiguous(), kp, vp,
                                          tab[i:i + 1].contiguous(),
                                          ln[i:i + 1].contiguous())
        assert torch.equal(one[0], full[i])


def _contiguous(cuda, b, s=1024, h=15, hkv=5, hd=64, seed=0, lo=1):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, h, hd), generator=g, device=cuda).bfloat16()
    k = torch.randn((b, s, hkv, hd), generator=g, device=cuda).bfloat16()
    v = torch.randn((b, s, hkv, hd), generator=g, device=cuda).bfloat16()
    lens = np.random.default_rng(seed).integers(lo, s + 1, size=b)
    return q, k, v, torch.from_numpy(lens.astype(np.int32)).to(cuda)


@pytest.mark.parametrize("b,s,lo", [(1, 64, 38), (8, 64, 38), (3, 1024, 1),
                                    (8, 1024, 1)])
def test_decode_attention_kernel(cuda, b, s, lo):
    """Against the plain version on the same inputs cast to f32 (f32 scores,
    like the kernel) and on the bf16 inputs (the layer's bf16 scores)."""
    q, k, v, ln = _contiguous(cuda, b, s, seed=b + s, lo=lo)
    got = decode_attention_cuda(q, k, v, ln).float()
    torch.testing.assert_close(
        got, decode_attention_ref(q.float(), k.float(), v.float(), ln),
        atol=1e-4, rtol=4e-3)
    plain = L.decode_attention_plain(q, k, v, ln)
    torch.testing.assert_close(got, plain.float(), atol=1e-2, rtol=1e-2)


def test_decode_attention_masking_and_batch_invariance(cuda):
    q, k, v, ln = _contiguous(cuda, 8, 256, seed=3)
    full = decode_attention_cuda(q, k, v, ln)
    k2, v2 = k.clone(), v.clone()
    for i, n in enumerate(ln.tolist()):
        k2[i, n:], v2[i, n:] = 99.0, -99.0
    assert torch.equal(decode_attention_cuda(q, k2, v2, ln), full)
    for i in range(8):
        one = decode_attention_cuda(q[i:i + 1].contiguous(),
                                    k[i:i + 1].contiguous(),
                                    v[i:i + 1].contiguous(),
                                    ln[i:i + 1].contiguous())
        assert torch.equal(one[0], full[i])


def test_decode_attention_zero_length_row(cuda):
    q, k, v, ln = _contiguous(cuda, 3, 64, seed=4)
    ln[1] = 0
    out = decode_attention_cuda(q, k, v, ln)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert torch.isfinite(out.float()).all()


#: lengths that start, fill and cross a 16-key granule (one page) and the
#: 8-rank deal (128 keys), and the capacity
BOUNDARY_LENGTHS = (0, 1, 15, 16, 17, 127, 128, 129, 1024)


def _f32(*args):
    """The inputs as the split models take them to stand for the kernels:
    bf16 cast to f32, so the model's output is not rounded to bf16 and
    the kernel's own rounding, at most half a bf16 ulp (2^-8 of a value),
    is all that rtol 4e-3 has to cover."""
    return [a.float() if a.dtype == torch.bfloat16 else a for a in args]


#: (G, Hkv, hd): one per (query rows, head-dim capacity) instantiation of
#: the kernels (``DECODE_ATTN_SHAPES`` in ``csrc/decode_attention.cuh``),
#: then head dims below their capacity (96, 40), a group below its
#: instantiation's rows (5 on 8) and groups cut into two query blocks (12,
#: 16 on 8)
KERNEL_SHAPES = [(1, 2, 64), (2, 2, 64), (3, 5, 64), (4, 2, 64), (8, 2, 64),
                 (1, 2, 128), (2, 2, 128), (4, 2, 128), (8, 2, 128),
                 (1, 2, 256), (2, 2, 256), (4, 2, 256), (1, 2, 512),
                 (2, 2, 512), (1, 2, 1024), (3, 2, 96), (5, 2, 40),
                 (12, 1, 64), (16, 2, 64)]
#: one row per length: the granule and rank boundaries, 600 and 1,100 keys
#: (three tiles of rank 0 at hd 64, so both ring stages are reused), and a
#: length past the 1,100-key capacity, which the kernels clamp
SWEEP_LENGTHS = (0, 1, 15, 16, 17, 127, 128, 129, 600, 1100, 1200)


@pytest.mark.parametrize("group,hkv,hd", KERNEL_SHAPES)
def test_decode_attention_kernel_every_shape(cuda, group, hkv, hd):
    q, k, v, _ = _contiguous(cuda, len(SWEEP_LENGTHS), 1100, h=group * hkv,
                             hkv=hkv, hd=hd, seed=group * hd)
    ln = torch.tensor(SWEEP_LENGTHS, dtype=torch.int32, device=cuda)
    got = decode_attention_cuda(q, k, v, ln)
    torch.testing.assert_close(
        got.float(), decode_attention_split_ref(*_f32(q, k, v, ln)),
        atol=1e-4, rtol=4e-3)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


#: sliding windows for the sweep: inside a granule, at and across its
#: edge, across the rank deal, and one longer than the capacity
SWEEP_WINDOWS = (1, 16, 17, 129, 2048)


@pytest.mark.parametrize("group,hkv,hd", KERNEL_SHAPES)
def test_windowed_decode_attention_every_shape(cuda, group, hkv, hd):
    """The windowed kernel against the windowed split model at every
    instantiation: each row's origin moves to its first attended key
    (``max(0, length - window)``, the 1,200-key row's from its unclamped
    length); rows with no key left get zeros; a window longer than every
    row gives the bits of no window."""
    q, k, v, _ = _contiguous(cuda, len(SWEEP_LENGTHS), 1100, h=group * hkv,
                             hkv=hkv, hd=hd, seed=group * hd + 1)
    ln = torch.tensor(SWEEP_LENGTHS, dtype=torch.int32, device=cuda)
    for window in SWEEP_WINDOWS:
        got = decode_attention_cuda(q, k, v, ln, window=window)
        torch.testing.assert_close(
            got.float(),
            decode_attention_split_ref(*_f32(q, k, v, ln), window=window),
            atol=1e-4, rtol=4e-3)
        assert torch.equal(got[0], torch.zeros_like(got[0]))
        assert torch.equal(got, decode_attention_cuda(q, k, v, ln,
                                                      window=window))
    assert torch.equal(got, decode_attention_cuda(q, k, v, ln))


@pytest.mark.parametrize("group,hkv,hd,ps", [
    *[(g, hkv, hd, 16) for g, hkv, hd in KERNEL_SHAPES],
    (3, 5, 64, 8), (3, 5, 64, 32), (3, 5, 64, 128), (8, 2, 128, 32),
    (2, 2, 256, 32), (4, 2, 256, 64), (1, 2, 1024, 8)])
def test_paged_attention_kernel_every_shape(cuda, group, hkv, hd, ps):
    """Every instantiation at page size 16, and pages of 8 to 128 keys (a
    granule is one page: a tile holds 8, 4, 2 or 1 of them, and a 128-key
    page is one tile, scored in two blocks of 64 keys)."""
    args = _paged(cuda, len(SWEEP_LENGTHS), mp=-(-1100 // ps), ps=ps,
                  h=group * hkv, hkv=hkv, hd=hd, seed=group * hd + ps,
                  lens=SWEEP_LENGTHS)
    got = paged_decode_attention_cuda(*args)
    torch.testing.assert_close(
        got.float(), paged_decode_attention_split_ref(*_f32(*args)),
        atol=1e-4, rtol=4e-3)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


#: (G, Hkv, hd) of every registered arch's decode attention, at its kv
#: heads: llava, yi, smollm, qwen, llama3, seamless (self and cross),
#: zamba2, deepseek, llama4 (``chip_smoke.family_attention_shapes``)
FAMILY_SHAPES = [(7, 8, 128), (8, 4, 128), (3, 5, 64), (1, 20, 128),
                 (4, 8, 128), (1, 16, 64), (1, 32, 80), (1, 16, 128),
                 (5, 8, 128)]


@pytest.mark.parametrize("group,hkv,hd", FAMILY_SHAPES)
@pytest.mark.parametrize("b", [1, 8])
def test_decode_attention_at_every_served_shape(cuda, group, hkv, hd, b):
    """The one-at-a-time path's decode shapes of every family (38-50 keys
    of a 64-key cache, buckets 1 and 8), against the split model and the
    plain version on the f32 inputs (atol 1e-4 / rtol 4e-3), and the
    layer's bf16 plain version (1e-2)."""
    q, k, v, ln = _contiguous(cuda, b, 64, h=group * hkv, hkv=hkv, hd=hd,
                              seed=group * hd + b, lo=38)
    ln = torch.clamp(ln, max=50)
    got = decode_attention_cuda(q, k, v, ln)
    for want in (decode_attention_split_ref(*_f32(q, k, v, ln)),
                 decode_attention_ref(*_f32(q, k, v, ln))):
        torch.testing.assert_close(got.float(), want, atol=1e-4, rtol=4e-3)
    torch.testing.assert_close(got.float(), L.decode_attention_plain(
        q, k, v, ln).float(), atol=1e-2, rtol=1e-2)


def test_cross_attention_below_the_cache_width(cuda):
    """Enc-dec cross-attention: 8 encoder frames in a 64-key cache (the
    decode step's ``enc_len``), through the model's ``decode_attention``;
    the keys past the frames are never read."""
    q, k, v, _ = _contiguous(cuda, 2, 64, h=16, hkv=16, hd=64, seed=77)
    ln = torch.full((2,), 8, dtype=torch.int32, device=cuda)
    reset_launch_counts()
    got = L.decode_attention(q, k, v, ln)
    assert launch_counts()["decode_attention"] == 1
    torch.testing.assert_close(
        got.float(), decode_attention_ref(*_f32(q, k[:, :8], v[:, :8], ln)),
        atol=1e-4, rtol=4e-3)
    k[:, 8:], v[:, 8:] = 99.0, -99.0
    assert torch.equal(L.decode_attention(q, k, v, ln), got)


@pytest.mark.parametrize("name", ["smollm-360m", "llava-next-34b",
                                  "deepseek-moe-16b",
                                  "llama4-maverick-400b-a17b", "zamba2-2.7b",
                                  "xlstm-125m", "seamless-m4t-medium"])
def test_reduced_family_on_the_card_as_on_the_host(cuda, name):
    """The reduced config with the same weights on the card and on the
    host: prefill and 8 greedy decode steps on the card, the host fed the
    card's tokens.  Logits within the larger of 5e-2 and the host's own
    movement under one bf16 ulp on the embedding table; the card's greedy
    token is the host's wherever the host's top-2 margin exceeds twice
    that (``chip_smoke.card_vs_cpu``)."""
    cfg = get_arch(name).reduced()
    host = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    emb = host["embed"]["emb"]
    sign = torch.where(torch.rand(emb.shape, generator=torch.Generator()
                                  .manual_seed(1)) < 0.5, -1.0, 1.0)
    moved = dict(host, embed={"emb": (emb.float() * (1 + sign * 2.0 ** -8))
                              .to(emb.dtype)})
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab, (1, 38)))

    def batch(p, dev):
        if cfg.family == "encdec":
            enc = torch.randn((1, 8, cfg.d_model),
                              generator=torch.Generator().manual_seed(3))
            return {"tokens": toks.to(dev),
                    "enc_embeds": enc.to(torch.bfloat16).to(dev)}
        if not cfg.embed_inputs:
            return {"embeds": L.embed(p["embed"], toks.to(dev))}
        return {"tokens": toks.to(dev)}

    def run(p, dev, feed=None):
        logits, cache = T.prefill_fn(cfg)(p, batch(p, dev), 64)
        out, fed = [logits.float().cpu()], []
        for i in range(8):
            cur = logits.argmax(-1) if feed is None else feed[i].to(dev)
            fed.append(cur.cpu())
            logits, cache = T.decode_fn(cfg)(p, cache, cur)
            out.append(logits.float().cpu())
        return out, fed

    card, fed = run(_to(host, cuda), cuda)
    want, _ = run(host, "cpu", fed)
    ref, _ = run(moved, "cpu", fed)
    for lc, lh, lr in zip(card, want, ref):
        assert torch.isfinite(lc).all()
        tol = max(5e-2, float((lr - lh).abs().max()))
        torch.testing.assert_close(lc, lh, atol=tol, rtol=tol)
        pick, best = int(lc.argmax()), int(lh.argmax())
        top2 = torch.topk(lh[0], 2).values
        if float(top2[0] - top2[1]) > 2 * tol:
            assert pick == best
        assert float(lh[0, best] - lh[0, pick]) <= 2 * tol


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("length", BOUNDARY_LENGTHS)
def test_decode_attention_kernel_matches_split_ref(cuda, length):
    q, k, v, ln = _contiguous(cuda, 3, 1024, seed=30 + length)
    ln[0] = length
    torch.testing.assert_close(
        decode_attention_cuda(q, k, v, ln).float(),
        decode_attention_split_ref(*_f32(q, k, v, ln)), atol=1e-4,
        rtol=4e-3)


@pytest.mark.parametrize("length", BOUNDARY_LENGTHS)
def test_paged_attention_kernel_matches_split_ref(cuda, length):
    args = _paged(cuda, 3, seed=30 + length, lens=[length, 1024, 45])
    torch.testing.assert_close(
        paged_decode_attention_cuda(*args).float(),
        paged_decode_attention_split_ref(*_f32(*args)), atol=1e-4,
        rtol=4e-3)


def test_paged_attention_refuses_a_page_too_big_for_shared_memory(cuda):
    """A 128-key page at hd 256 needs a 256 KB ring: the launch is refused
    with an error, and leaves none behind for the next launch."""
    with pytest.raises(RuntimeError, match="cudaError 1"):
        paged_decode_attention_cuda(*_paged(cuda, 2, mp=2, ps=128, h=2,
                                            hkv=2, hd=256, lens=[5, 200]))
    args = _paged(cuda, 2, mp=8, ps=32, h=2, hkv=2, hd=256, lens=[5, 200])
    torch.testing.assert_close(
        paged_decode_attention_cuda(*args).float(),
        paged_decode_attention_split_ref(*_f32(*args)), atol=1e-4,
        rtol=4e-3)


def test_attention_kernels_are_deterministic(cuda):
    """No atomics: two calls on the same inputs give the same bits."""
    q, k, v, ln = _contiguous(cuda, 8, 1024, seed=41)
    assert torch.equal(decode_attention_cuda(q, k, v, ln),
                       decode_attention_cuda(q, k, v, ln))
    args = _paged(cuda, 8, seed=41)
    assert torch.equal(paged_decode_attention_cuda(*args),
                       paged_decode_attention_cuda(*args))


def test_long_row_alone_equals_row_in_batch(cuda):
    """B=8 with one 1,024-key row: the key deal does not depend on B, so
    every row alone has the bits it has in the batch."""
    q, k, v, ln = _contiguous(cuda, 8, 1024, seed=42)
    ln[0] = 1024
    full = decode_attention_cuda(q, k, v, ln)
    for i in range(8):
        one = decode_attention_cuda(q[i:i + 1].contiguous(),
                                    k[i:i + 1].contiguous(),
                                    v[i:i + 1].contiguous(),
                                    ln[i:i + 1].contiguous())
        assert torch.equal(one[0], full[i])
    lens = np.random.default_rng(42).integers(1, 1025, size=8)
    lens[0] = 1024
    q, kp, vp, tab, ln = _paged(cuda, 8, seed=42, lens=lens)
    full = paged_decode_attention_cuda(q, kp, vp, tab, ln)
    for i in range(8):
        one = paged_decode_attention_cuda(q[i:i + 1].contiguous(), kp, vp,
                                          tab[i:i + 1].contiguous(),
                                          ln[i:i + 1].contiguous())
        assert torch.equal(one[0], full[i])


def test_zero_length_row_in_a_long_batch(cuda):
    q, k, v, ln = _contiguous(cuda, 8, 1024, seed=43)
    ln[0], ln[3] = 1024, 0
    out = decode_attention_cuda(q, k, v, ln)
    assert torch.equal(out[3], torch.zeros_like(out[3]))
    assert torch.isfinite(out.float()).all()
    lens = [1024, 700, 0, 64, 1, 333, 1024, 17]
    out = paged_decode_attention_cuda(*_paged(cuda, 8, seed=43, lens=lens))
    assert torch.equal(out[2], torch.zeros_like(out[2]))
    assert torch.isfinite(out.float()).all()


def test_paged_attention_never_reads_past_the_length(cuda):
    """Page 0 holds +-1000 (the pad page) and every table entry past a
    sequence's last page is replaced by one that indexes no page at all:
    the output keeps its bits and matches the split model."""
    q, kp, vp, tab, ln = _paged(cuda, 8, seed=44)
    want = paged_decode_attention_cuda(q, kp, vp, tab, ln)
    poisoned = tab.clone()
    for i, n in enumerate(ln.tolist()):
        poisoned[i, -(-n // kp.shape[1]):] = 2 ** 30
    assert torch.equal(paged_decode_attention_cuda(q, kp, vp, poisoned, ln),
                       want)
    torch.testing.assert_close(
        want.float(), paged_decode_attention_split_ref(*_f32(q, kp, vp, tab,
                                                             ln)),
        atol=1e-4, rtol=4e-3)


def test_decode_step_launches_the_kernel_per_layer(cuda):
    cfg = get_arch("smollm-360m").reduced()
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    cache = T.init_cache(cfg, 2, 32, cuda)
    cache["len"] += 5
    reset_launch_counts()
    T.decode_fn(cfg)(params, cache, torch.ones((2,), dtype=torch.long,
                                               device=cuda))
    assert launch_counts()["decode_attention"] == cfg.n_layers
    # a sliding window launches the kernel too: on decode_fn's cache it
    # agrees with the layer's windowed plain version
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((2, cfg.n_heads, cfg.resolved_head_dim), generator=g,
                    device=cuda).bfloat16()
    length = cache["len"] + 1
    reset_launch_counts()
    got = L.decode_attention(q, cache["k"][0], cache["v"][0], length,
                             window=4)
    assert launch_counts()["decode_attention"] == 1
    torch.testing.assert_close(
        got.float(), L.decode_attention_plain(q, cache["k"][0],
                                              cache["v"][0], length,
                                              window=4).float(),
        atol=1e-2, rtol=1e-2)


def test_router_one_at_a_time_prefix_cache_keeps_tokens(cuda):
    """The one-at-a-time path behind a 2-plane Router on the card: greedy
    tokens with the prefix cache on equal those with it off, through the
    kernels."""
    cfg = get_arch("smollm-360m").reduced()
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    rng = np.random.default_rng(2)
    systems = [tuple(int(x) for x in rng.integers(1, cfg.vocab, 32))
               for _ in range(2)]
    prompts = [systems[i % 2] + tuple(int(x) for x in
                                      rng.integers(1, cfg.vocab, 6))
               for i in range(6)]
    runs = []
    for prefix_cache in (True, False):
        ecfg = EngineConfig(n_units=1, elasticity=None, merging="none",
                            pruning=None, result_cache=False, max_len=64,
                            prefix_cache=prefix_cache)
        reqs = [Request(prompt=p, n_new=4, deadline=1e9) for p in prompts]
        reset_launch_counts()
        stats = Router(make_engine_planes(cfg, params, ecfg, 2,
                                          device=cuda)).run(
            [(1000.0 * i, r) for i, r in enumerate(reqs)])
        assert stats["completed"] == len(prompts)
        assert launch_counts()["decode_attention"] > 0
        runs.append((stats["prefix_hits"], [r.tokens for r in reqs]))
    assert runs[0][0] > 0
    assert runs[0][1] == runs[1][1]


@pytest.mark.parametrize("shape", [(8, 1, 960), (64, 960)])
def test_rmsnorm_kernel(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (3 * torch.randn(shape, generator=g, device=cuda)).bfloat16()
    s = torch.randn((shape[-1],), generator=g, device=cuda).bfloat16()
    torch.testing.assert_close(rmsnorm_cuda(x, s).float(),
                               rmsnorm_ref(x, s).float(), atol=2e-2,
                               rtol=2e-2)


#: row widths that between them reach every instantiation of the kernel,
#: in bf16 and in f32, from the smallest to smollm's 960 and the widest
#: model's 7,168
RMSNORM_D = (64, 256, 512, 960, 2048, 2560, 4096, 5120, 7168)
#: bf16 holds the kernel to two bf16 roundings of the plain version: the
#: f32 1 / rms differs in its last bits (another summation order), which
#: can move x * r across a rounding point (one ulp of the cast) and, after
#: the scale, the output by up to two ulps (2^-6 of a value; on the H100
#: one output of the (64, 960) case differs by 0.0086 of its value).  That
#: the kernel rounds x * r at all is held by
#: ``test_rmsnorm_rounds_as_the_plain_version``
RMSNORM_TOL = {torch.bfloat16: (1e-5, 1.6e-2), torch.float32: (1e-5, 1e-5)}
#: the largest share of bf16 outputs that may differ from the plain
#: version's bits, as ``chip_smoke.py`` holds it: a kernel that skips the
#: cast of x * r changes about a quarter of them
RMSNORM_DIFFER_MAX = 1e-3


def _rms_geometry(d, dtype):
    """(warps, vectors a lane) the library picks for rows of ``d``, or None
    for a width it does not take."""
    warps, vpl = ctypes.c_int(), ctypes.c_int()
    err = library().rmsnorm_geometry(d, dtype.itemsize, ctypes.byref(warps),
                                     ctypes.byref(vpl))
    return None if err else (warps.value, vpl.value)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_every_width_has_an_instantiation(cuda, dtype):
    """Every D the wrapper's checks take has an instantiation in the
    library and every other D none, and ``RMSNORM_D`` reaches every
    instantiation that any D reaches."""
    per_vec = 16 // dtype.itemsize
    picked = {}
    for d in range(1, MAX_D + 2 * per_vec):
        try:
            check_width(d, dtype)
            taken = True
        except ValueError:
            taken = False
        g = _rms_geometry(d, dtype)
        assert (g is not None) == taken, d
        if taken:
            picked[d] = g
    assert set(picked.values()) == {picked[d] for d in RMSNORM_D}


def _rms_inputs(cuda, rows, d, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (3 * torch.randn((rows, d), generator=g, device=cuda)).to(dtype)
    s = (1 + 0.1 * torch.randn((d,), generator=g, device=cuda)).to(dtype)
    return x, s


@pytest.mark.parametrize("rows", [1, 8, 64, 1000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", RMSNORM_D)
def test_rmsnorm_every_instantiation(cuda, d, dtype, rows):
    x, s = _rms_inputs(cuda, rows, d, dtype, seed=d + rows)
    got = rmsnorm_cuda(x, s)
    assert got.dtype == dtype and got.shape == x.shape
    atol, rtol = RMSNORM_TOL[dtype]
    torch.testing.assert_close(got.float(), rmsnorm_ref(x, s).float(),
                               atol=atol, rtol=rtol)
    assert torch.equal(got, rmsnorm_cuda(x, s))


def test_rmsnorm_rounds_as_the_plain_version(cuda):
    """The cast order of ``layers.rmsnorm``: x * r rounded to bf16, then
    times the scale.  Over 64 rows of every width, at most
    ``RMSNORM_DIFFER_MAX`` of the outputs differ from the plain version's
    bits."""
    differ = total = 0
    for d in RMSNORM_D:
        x, s = _rms_inputs(cuda, 64, d, torch.bfloat16, seed=11 + d)
        got, want = rmsnorm_cuda(x, s), rmsnorm_ref(x, s)
        differ += int((got != want).sum())
        total += got.numel()
    assert differ <= RMSNORM_DIFFER_MAX * total, (differ, total)


@pytest.mark.parametrize("d", [960, 7168])
def test_rmsnorm_row_alone_equals_row_in_batch(cuda, d):
    """A single-warp row (960) and an eight-warp row (7,168): each row
    alone has the bits it has among 64."""
    x, s = _rms_inputs(cuda, 64, d, torch.bfloat16, seed=3)
    full = rmsnorm_cuda(x, s)
    for i in range(64):
        assert torch.equal(rmsnorm_cuda(x[i:i + 1], s)[0], full[i])


def test_rmsnorm_refuses_what_it_does_not_take(cuda):
    x, s = _rms_inputs(cuda, 4, 960, torch.bfloat16, seed=4)
    for bad in ((x, s.float()), (x.half(), s.half()), (x.float(), s)):
        with pytest.raises(ValueError):
            rmsnorm_cuda(*bad)
    flat = torch.zeros((2 * 960 + 8,), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        rmsnorm_cuda(flat[1:1 + 960].view(1, 960), s)
    with pytest.raises(ValueError):
        rmsnorm_cuda(x[:, :956].contiguous(), s[:956].contiguous())
    with pytest.raises(ValueError):
        rmsnorm_cuda(*_rms_inputs(cuda, 2, 7176, torch.bfloat16, seed=5))


@pytest.mark.parametrize("n,le,lc", [(32, 64, 64), (32, 128, 128),
                                     (3, 5, 64), (9, 64, 128)])
def test_pmf_conv_kernel(cuda, n, le, lc):
    rng = np.random.default_rng(4)
    pet = rng.random((n, le)).astype(np.float32)
    pet /= pet.sum(axis=1, keepdims=True)
    pct = rng.random((n, lc)).astype(np.float32)
    pct /= pct.sum(axis=1, keepdims=True)
    dl = rng.integers(-2, le + lc + 2, n).astype(np.float32)
    # the PEND cut at the success index, and apart from it
    cut = dl + rng.integers(-3, 4, n).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in (pet, pct, dl, cut)]
    for call in (args[:3], args):
        for got, want in zip(pmf_conv_cuda(*call), pmf_conv_ref(*call)):
            torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def test_pmf_conv_longest_row(cuda):
    """The longest row the kernel takes, Le + Lc = 57,832 (one row a block
    in 227 KB of shared memory, its header says why), against the plain
    version; four more PCT values are refused with an error and leave
    nothing behind for the next launch.  PET is a few spikes, so each
    output is a short exact sum that shows any misplaced term."""
    rng = np.random.default_rng(5)
    le = lc = 28916
    pet = np.zeros((1, le), np.float32)
    pet[0, rng.integers(0, le, 6)] = rng.random(6)
    pet[0, [0, le - 1]] = 0.5
    pct = rng.random((1, lc)).astype(np.float32)
    dl = np.array([lc // 3], np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in (pet, pct, dl)]
    for got, want in zip(pmf_conv_cuda(*args), pmf_conv_ref(*args)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    longer = torch.from_numpy(rng.random((1, lc + 4)).astype(np.float32))
    with pytest.raises(RuntimeError, match="cudaError 1"):
        pmf_conv_cuda(args[0], longer.to(cuda), args[2])
    small = [a[:, :64].contiguous() if a.dim() == 2 else a for a in args]
    for got, want in zip(pmf_conv_cuda(*small), pmf_conv_ref(*small)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def test_batched_success_on_the_card(cuda):
    """The front door on the card (one buffer up, the chances back) against
    its plain version on the host and against ``chance_of_success``: its
    two indices per row keep the term ``pet[0] * pct(dl - pet_off)`` that
    the JAX front door drops (``test_torch_kernels.py``,
    ``test_packed_success_with_filler_rows``)."""
    rng = np.random.default_rng(7)
    specs = [(rng.uniform(4, 30), rng.uniform(1, 5), rng.uniform(5, 60),
              rng.uniform(1, 8), int(rng.integers(-10, 15)))
             for _ in range(32)]
    pets = [PMF.from_normal(m, s) for m, s, _, _, _ in specs]
    pcts = [PMF.from_normal(m, s) for _, _, m, s, _ in specs]
    dls = [int(e.mean() + c.mean() + d)
           for e, c, (_, _, _, _, d) in zip(pets, pcts, specs)]
    reset_launch_counts()
    got = batched_success(pets, pcts, dls, length=64)
    assert launch_counts()["pmf_conv"] == 1
    np.testing.assert_allclose(
        got, batched_success(pets, pcts, dls, length=64, device="cpu"),
        atol=1e-6)

    want = [chance_of_success(e, c, dl, droppable_prev=True)
            for e, c, dl in zip(pets, pcts, dls)]
    np.testing.assert_allclose(got, want, atol=1e-5)


def _scaler_pet():
    return PETMatrix.generate(["generate"], ["m0"],
                              np.random.default_rng(3), mean_range=(8, 16))


def _scaler_trace():
    """``tests/test_autoscale.py``'s cross-substrate trace."""
    rng = np.random.default_rng(1)
    out, t = [], 0.0
    for _ in range(40):
        out.append((t, Request(
            prompt=tuple(rng.integers(1, 1000, size=8).tolist()),
            op="generate", n_new=int(rng.integers(1, 4)), deadline=t + 60.0)))
        t += float(rng.exponential(1.0))
    return out


def _counting_host_signal(monkeypatch):
    """Count the batched success-chance calls a host run makes: one for
    each decision that scored at least one queued task."""
    calls = {"n": 0}
    inner = autoscale_signals._kernel_success

    def counted(*a, **kw):
        calls["n"] += 1
        return inner(*a, **kw)
    monkeypatch.setattr(autoscale_signals, "_kernel_success", counted)
    return calls


def test_simulator_signal_on_the_card(cuda, monkeypatch):
    """A success-chance ``Simulator`` with no device launches ``pmf_conv``
    on the card once for each decision that scores a queued task, and
    takes the decisions of its stub engine and of the same run with
    ``device="cpu"``, which launches nothing."""
    el = ElasticityConfig(policy="success-chance", max_extra=2,
                          scale_up_queue=6, scale_down_queue=1,
                          low_chance=0.6)
    runs = {}
    for device in (None, "cpu"):
        trace = _scaler_trace()
        sim = Simulator([r.to_task(t, i) for i, (t, r) in enumerate(trace)],
                        FleetSpec.homogeneous(1),
                        PETOracle(_scaler_pet(), seed=11),
                        SimConfig(heuristic="EDF", merging="none",
                                  elasticity=el), device=device)
        eng = ServingEngine(None, None, EngineConfig(
            n_units=1, heuristic="EDF", merging="none", result_cache=False,
            prefix_cache=False, elasticity=el),
            stub_oracle=PETOracle(_scaler_pet(), seed=11), device=device)
        sim.cp.trace, eng.cp.trace = [], []
        calls = (_counting_host_signal(monkeypatch) if device == "cpu"
                 else None)
        reset_launch_counts()
        st = sim.run()
        launches = launch_counts()["pmf_conv"]
        scored = calls["n"] if calls is not None else None
        eng.run(trace)
        assert sim.cp.trace == eng.cp.trace
        runs[device] = (sim.cp.trace, st.scale_ups, st.scale_downs,
                        launches, scored)
    card, host = runs[None], runs["cpu"]
    assert card[:3] == host[:3] and card[1] > 0
    assert host[3] == 0
    assert card[3] == host[4] > 0


def _stub_plane_router(device):
    ecfg = EngineConfig(n_units=1, elasticity=None, result_cache=False,
                        prefix_cache=False, heuristic="EDF", merging="none")
    pet = PETMatrix.generate(["generate"], ["m0"], np.random.default_rng(3),
                             mean_range=(10, 20))
    planes = make_engine_planes(None, None, ecfg, 1,
                                stub_oracles=[PETOracle(pet, seed=11)],
                                device=device)
    factory = make_engine_plane_factory(
        None, None, ecfg, device=device,
        stub_oracle_fn=lambda pid: PETOracle(pet, seed=11 + pid))
    router = Router(planes, policy="least-loaded",
                    autoscale=ElasticityConfig(policy="success-chance",
                                               max_extra=3, cooldown=30.0,
                                               low_chance=0.5),
                    plane_factory=factory)
    t, rng = 0.0, np.random.default_rng(9)
    for i in range(80):
        router.submit(Request(prompt=(i, 2, 3), op="generate", n_new=2,
                              deadline=t + 80.0), t)
        t += float(rng.exponential(4.0))
    return router, router.drain()["router"]["autoscale"]


def test_router_signal_on_the_card(cuda):
    """A stub-plane Router with no device scores its planes on the card:
    ``pmf_conv`` launches, planes are added and retired, and the routing
    decisions are those of the same Router on ``"cpu"``, which launches
    nothing on the card."""
    reset_launch_counts()
    card, card_auto = _stub_plane_router(None)
    launches = launch_counts()["pmf_conv"]
    reset_launch_counts()
    host, host_auto = _stub_plane_router("cpu")
    assert launch_counts()["pmf_conv"] == 0
    assert launches > 0
    assert card.plane_scaler.device == cuda
    assert card_auto["plane_scale_ups"] > 0
    assert card_auto["plane_scale_downs"] > 0
    assert card.decisions == host.decisions and card_auto == host_auto


def test_engine_batched_equals_one_at_a_time(cuda):
    cfg = get_arch("smollm-360m").reduced()
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    rng = np.random.default_rng(7)
    prompts = [tuple(int(x) for x in rng.integers(1, cfg.vocab,
                                                   rng.integers(4, 60)))
               for _ in range(8)]
    bat = StepBatchingConfig(max_batch=4, step_token_budget=16)
    tokens = []
    for spacing in (1.0, 1000.0):
        eng = ServingEngine(cfg, params, EngineConfig(
            n_units=1, elasticity=None, merging="none", pruning=None,
            result_cache=False, max_len=96, batching=bat), device=cuda)
        reqs = [Request(prompt=p, n_new=4, deadline=1e9) for p in prompts]
        reset_launch_counts()
        assert eng.run([(spacing * i, r) for i, r in
                        enumerate(reqs)])["completed"] == len(prompts)
        counts = launch_counts()
        assert counts["paged_decode_attention"] > 0 and counts["rmsnorm"] > 0
        tokens.append([r.tokens for r in reqs])
    assert tokens[0] == tokens[1]


#: (H, Hkv, hd) of smollm-360m, yi-9b and qwen1.5-4b
CHUNK_WIDTHS = [(15, 5, 64), (32, 4, 128), (20, 20, 128)]
#: the chunk's rows, the unit runner's step budget
CHUNK_S = 2048


def _chunk_inputs(cuda, b, p, h, hkv, hd, seed, s=CHUNK_S):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=cuda).bfloat16()
    return (draw(b, s, h, hd), draw(b, p, hkv, hd), draw(b, p, hkv, hd),
            draw(b, s, hkv, hd), draw(b, s, hkv, hd))


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("n_rows", [1, 63, 64, 1000, 2048])
@pytest.mark.parametrize("p", [0, 1, 17, 2047, 6144])
@pytest.mark.parametrize("h,hkv,hd", CHUNK_WIDTHS)
def test_chunk_attention_against_full_attention(cuda, h, hkv, hd, p, n_rows,
                                                b):
    """The chunked prefill's kernel against ``full_attention`` in f32 on the
    same inputs (the prefix's and the chunk's K/V joined and repeated for
    every query head), over the real rows; the padding rows are zeros."""
    q, pk, pv, k, v = _chunk_inputs(cuda, b, p, h, hkv, hd,
                                    seed=p + n_rows + hd)
    got = chunk_attention_cuda(q, pk, pv, k, v, n_rows)
    torch.cuda.synchronize()
    _assert_within_rounding(got, q, pk, pv, k, v, n_rows)


def _assert_within_rounding(got, q, pk, pv, k, v, n_rows, scale=None):
    """``got`` against ``full_attention`` in f32 over the real rows, each
    element within twice the most the kernel's two bf16 roundings can move
    it: rounding each probability p_j before P.V moves an output by at
    most 2^-9 sum_j p_j |v_j| (the attention of |v|), and rounding the
    output by at most 2^-9 of it.  On randn inputs that is about 2^-8 of
    a mean |v| of 0.8, a tenth of a typical output after 2,000 keys: a
    key tile dropped or a causal limit off by one moves rows past it.
    The padding rows are zeros."""
    g = q.shape[2] // k.shape[2]
    kk = L._repeat_kv(torch.cat([pk, k[:, :n_rows]], dim=1).float(), g)
    vv = L._repeat_kv(torch.cat([pv, v[:, :n_rows]], dim=1).float(), g)
    qr = q[:, :n_rows].float()
    want = L.full_attention(qr, kk, vv, causal=True, q_offset=pk.shape[1],
                            scale=scale)
    tol = 2.0 ** -8 * (L.full_attention(qr, kk, vv.abs(), causal=True,
                                        q_offset=pk.shape[1], scale=scale)
                       + want.abs())
    err = (got[:, :n_rows].float() - want).abs()
    assert (err <= tol).all(), \
        f"max |err| / bound {float((err / tol).max()):.3g}"
    assert not got[:, n_rows:].any()


@pytest.mark.parametrize("bucket,max_len,p", [(2, 64, 0), (4, 64, 32),
                                              (8, 64, 17), (2, 1024, 700)])
def test_chunk_attention_at_the_one_at_a_time_shapes(cuda, bucket, max_len,
                                                     p):
    """``ProcessingUnit._prefill``'s shapes: ``bucket`` copies of one prompt,
    its rows padded to ``max_len``, its prefix one (P, Hkv, hd) tensor
    expanded over the batch with stride 0, at smollm-360m's widths."""
    h, hkv, hd = CHUNK_WIDTHS[0]
    q, pk, pv, k, v = _chunk_inputs(cuda, 1, p, h, hkv, hd, seed=bucket + p,
                                    s=max_len)
    pk, pv = (t.expand((bucket,) + t.shape[1:]) for t in (pk, pv))
    q, k, v = (t.expand((bucket,) + t.shape[1:]).contiguous()
               for t in (q, k, v))
    assert pk.stride(0) == 0
    n_rows = max_len - p - 3
    got = chunk_attention_cuda(q, pk, pv, k, v, n_rows)
    torch.cuda.synchronize()
    _assert_within_rounding(got, q, pk, pv, k, v, n_rows)
    assert all(torch.equal(got[0], got[i]) for i in range(1, bucket))


def test_chunk_attention_bits_do_not_depend_on_the_cut(cuda):
    """One prompt of 3,000 positions cut into chunks at different
    boundaries, alone and beside another sequence: every position two
    chunks share comes out with the same bits.  Padding rows and their K/V
    are NaN, which reach no real row: no key past the last real row is
    read."""
    h, hkv, hd = 15, 5, 64
    g = torch.Generator(device=cuda).manual_seed(3)
    total = 3000
    qa, ka, va = (torch.randn((total, n, hd), generator=g,
                              device=cuda).bfloat16()
                  for n in (h, hkv, hkv))

    def chunk(p, n, other=None):
        """Positions p .. p + n - 1 as a padded chunk after a p-token
        prefix; ``other`` adds a second sequence in batch row 0."""
        q, k, v = (torch.full((1, CHUNK_S) + t.shape[1:], float("nan"),
                              dtype=torch.bfloat16, device=cuda)
                   for t in (qa, ka, va))
        q[0, :n], k[0, :n], v[0, :n] = qa[p:p + n], ka[p:p + n], va[p:p + n]
        pk, pv = ka[None, :p], va[None, :p]
        if other is not None:
            q, k, v = (torch.cat([o, t]) for o, t in zip(other[:3],
                                                         (q, k, v)))
            pk = torch.cat([other[3], pk])
            pv = torch.cat([other[4], pv])
        out = chunk_attention_cuda(q.contiguous(), pk.contiguous(),
                                   pv.contiguous(), k.contiguous(),
                                   v.contiguous(), n)
        return out[-1, :n]

    oq, opk, opv, ok, ov = _chunk_inputs(cuda, 1, 1700, h, hkv, hd, seed=9)
    cuts = [(1000, 1500, None), (1700, 300, None), (1717, 1, None),
            (0, 2048, None), (1650, 1350, None),
            (1700, 300, (oq, ok, ov, opk, opv))]
    outs = [chunk(p, n, other) for p, n, other in cuts]
    assert all(torch.isfinite(o.float()).all() for o in outs)
    compared = 0
    for i, j in itertools.combinations(range(len(cuts)), 2):
        (pa, na, _), (pb, nb, _) = cuts[i], cuts[j]
        lo, hi = max(pa, pb), min(pa + na, pb + nb)
        if lo < hi:
            assert torch.equal(outs[i][lo - pa:hi - pa],
                               outs[j][lo - pb:hi - pb]), (cuts[i][:2],
                                                           cuts[j][:2])
            compared += 1
    assert compared >= 8


def test_chunk_attention_refuses_what_it_does_not_take(cuda):
    q, pk, pv, k, v = _chunk_inputs(cuda, 1, 8, 4, 2, 80, seed=0, s=16)
    with pytest.raises(ValueError, match="head_dim"):
        chunk_attention_cuda(q, pk, pv, k, v, 16)
    q, pk, pv, k, v = _chunk_inputs(cuda, 1, 8, 4, 2, 64, seed=0, s=16)
    with pytest.raises(ValueError, match="n_rows"):
        chunk_attention_cuda(q, pk, pv, k, v, 17)
    with pytest.raises(ValueError, match="rows"):
        chunk_attention_cuda(q, pk.transpose(1, 2).contiguous()
                             .transpose(1, 2), pv, k, v, 16)
    assert (64, 64) in HEAD_DIMS and (128, 128) in HEAD_DIMS
    assert (192, 128) in HEAD_DIMS


def test_chunked_prefill_launches_the_kernel_per_layer(cuda):
    """``chunk_prefill_fn`` on the card at the unit runner's shapes: one
    kernel launch a layer, and no tensor of the padded (S x kv_len) score
    tile, nor K/V padded to kv_len or expanded to every head: the chunk's
    peak memory stays below a quarter of the bf16 tile of its heads."""
    cfg = get_arch("smollm-360m").scaled(n_layers=2)
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    s, p, c, kv_len = 2048, 1900, 1000, 8448
    rng = np.random.default_rng(0)
    toks = torch.zeros((1, s), dtype=torch.long)
    toks[0, :c] = torch.from_numpy(rng.integers(1, cfg.vocab, c))
    shape = (cfg.n_layers, 1, p, cfg.n_kv_heads, cfg.resolved_head_dim)
    g = torch.Generator(device=cuda).manual_seed(1)
    pk = torch.randn(shape, generator=g, device=cuda).bfloat16()
    pv = torch.randn(shape, generator=g, device=cuda).bfloat16()
    fn = T.chunk_prefill_fn(cfg)
    fn(params, toks.to(cuda), pk, pv, last=c - 1, kv_len=kv_len)
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        logits, kn, vn = fn(params, toks.to(cuda), pk, pv, last=c - 1,
                            kv_len=kv_len)
    torch.cuda.synchronize()
    assert launch_counts()["chunk_attention"] == cfg.n_layers
    tile = cfg.n_heads * s * kv_len * 2        # the bf16 score tile alone
    assert torch.cuda.max_memory_allocated() - base < tile // 4
    assert torch.isfinite(logits.float()).all()
    assert kn.shape == vn.shape == (cfg.n_layers, 1, s, cfg.n_kv_heads,
                                    cfg.resolved_head_dim)


def test_engine_batched_equals_one_at_a_time_at_served_widths(cuda):
    """smollm-360m's widths (15/5 heads of 64), two layers: prompts that
    span several chunks, cut at other boundaries when requests share steps
    than when each runs alone, give the same greedy tokens, and every
    chunk's attention is the kernel's."""
    cfg = get_arch("smollm-360m").scaled(n_layers=2)
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    rng = np.random.default_rng(11)
    prompts = [tuple(int(x) for x in rng.integers(1, cfg.vocab,
                                                   rng.integers(100, 500)))
               for _ in range(6)]
    bat = StepBatchingConfig(max_batch=4, step_token_budget=256)
    tokens = []
    for spacing in (1.0, 1000.0):
        eng = ServingEngine(cfg, params, EngineConfig(
            n_units=1, elasticity=None, merging="none", pruning=None,
            result_cache=False, max_len=640, batching=bat), device=cuda)
        reqs = [Request(prompt=p, n_new=6, deadline=1e9) for p in prompts]
        reset_launch_counts()
        stats = eng.run([(spacing * i, r) for i, r in enumerate(reqs)])
        assert stats["completed"] == len(prompts)
        assert launch_counts()["chunk_attention"] == \
            cfg.n_layers * stats["chunk_launches"] > 0
        tokens.append([r.tokens for r in reqs])
    assert tokens[0] == tokens[1]


def test_engine_disaggregated_equals_unified(cuda):
    """A prefill unit and a decode unit hand every sequence off, the KV
    blocks migrate, and the greedy tokens equal the unified one-unit run
    through the kernels."""
    cfg = get_arch("smollm-360m").reduced()
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           cuda)
    rng = np.random.default_rng(7)
    prompts = [tuple(int(x) for x in rng.integers(1, cfg.vocab,
                                                   rng.integers(4, 60)))
               for _ in range(8)]
    bat = StepBatchingConfig(max_batch=4, step_token_budget=16)
    tokens = []
    for fleet in (None, FleetSpec.parse("m0@prefill:1,m0@decode:1")):
        eng = ServingEngine(cfg, params, EngineConfig(
            n_units=1, fleet=fleet, elasticity=None, merging="none",
            pruning=None, result_cache=False, max_len=96, batching=bat),
            device=cuda)
        eng.cp.trace = []
        reqs = [Request(prompt=p, n_new=6, deadline=1e9) for p in prompts]
        reset_launch_counts()
        assert eng.run([(float(i), r) for i, r in
                        enumerate(reqs)])["completed"] == len(prompts)
        counts = launch_counts()
        assert counts["paged_decode_attention"] > 0 and counts["rmsnorm"] > 0
        tokens.append([r.tokens for r in reqs])
    assert sum(e[0] == "handoff" for e in eng.cp.trace) == len(prompts)
    phases = {m.phase: m.mid for m in eng.machines}
    src, dst = (eng.kvcaches[phases[k]] for k in ("prefill", "decode"))
    assert dst.stats["migrated_in"] == src.stats["migrated_out"] > 0
    assert dst.stats["tokens_reused"] > 0
    assert tokens[0] == tokens[1]


#: the merge-saving MLP trained on the card against the same training on
#: the host, on its predictions (targets lie in [-0.1, 0.7]; the accuracy
#: tolerance tau is 0.12): f32 on both with TF32 off, so only the order of
#: the products' and gradients' sums differs.  The JAX and the port's CPU
#: trainers, which differ the same way, agree to 4e-7 after 500 steps
#: (``test_torch_predictor.py``); ``chip_smoke.py`` holds the benchmark's
#: 500-step fit to the same limit.
MLP_CARD_ATOL = 1e-4


def test_mlp_trains_on_the_card_as_on_the_host(cuda):
    """The same seeded initial parameters (drawn on the host) trained on
    the card and on the host; ``predict`` hands numpy back on the host."""
    from repro_torch.core.merge_model import VideoExecModel
    from repro_torch.core.predictor import MLPPredictor
    model = VideoExecModel(seed=1)
    X, y = model.make_dataset(2000, np.random.default_rng(0))
    Xt, _ = model.make_dataset(500, np.random.default_rng(99))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = MLPPredictor(steps=300).fit(X, y)         # CUDA by default
        host = MLPPredictor(steps=300, device="cpu").fit(X, y)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert all(v.device.type == "cuda" and v.dtype == torch.float32
               for v in card._params.values())
    got = card.predict(Xt)
    assert isinstance(got, np.ndarray) and got.shape == (len(Xt),)
    np.testing.assert_allclose(got, host.predict(Xt), rtol=0,
                               atol=MLP_CARD_ATOL)


# ---------------------------------------------------------------------------
# RMSNorm backward and training on the card
# ---------------------------------------------------------------------------

def _bwd_inputs(cuda, rows, d, dtype, seed):
    x, s = _rms_inputs(cuda, rows, d, dtype, seed)
    g = torch.randn((rows, d), generator=torch.Generator(device=cuda)
                    .manual_seed(seed + 1), device=cuda).to(dtype)
    return x, s, g


#: how far the kernel's f32 1 / rms may sit from the plain version's,
#: relatively (it sums x * x in another order: a few f32 ulps)
R_SLACK = 2.0 ** -20


def dscale_room(x, g):
    """Room for each column of dscale: R_SLACK of the sum of |g * n| over
    the rows (n = cast(x * r), the sum taken in another order), plus, for
    every term, |g| times how far n moves when r moves by R_SLACK either
    way: where x * r lies that close to a bf16 rounding point, the
    kernel's r may round it the other way.  Not one term more: one missing
    or doubled row moves a column by far more."""
    d = x.shape[-1]
    xf, ga = x.float(), g.float().abs()
    v = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-5)
    n = v.to(x.dtype).float()
    flips = sum(((v * (1 + t)).to(x.dtype).float() - n).abs()
                for t in (R_SLACK, -R_SLACK))
    return (ga * (R_SLACK * n.abs() + flips)).reshape(-1, d).sum(0)


def assert_bwd_close(got, want, x, s, g):
    """dx at the forward's bar (``RMSNORM_TOL``: its f32 1 / rms in
    another summation order, then one or two roundings in bf16); dscale
    within ``dscale_room`` plus, in bf16, one ulp of the result."""
    atol, rtol = RMSNORM_TOL[x.dtype]
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol,
                               rtol=rtol)
    room = dscale_room(x, g)
    if x.dtype == torch.bfloat16:
        room = room + 8e-3 * want[1].float().abs()
    err = (got[1].float() - want[1].float()).abs()
    assert bool((err <= room + 1e-6).all()), float((err - room).max())


@pytest.mark.parametrize("rows", [1, 64, 2000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", RMSNORM_D)
def test_rmsnorm_bwd_every_instantiation(cuda, d, dtype, rows):
    x, s, g = _bwd_inputs(cuda, rows, d, dtype, seed=d + rows)
    got = rmsnorm_bwd_cuda(x, s, g)
    assert got[0].dtype == got[1].dtype == dtype
    assert got[0].shape == x.shape and got[1].shape == s.shape
    assert_bwd_close(got, rmsnorm_bwd_ref(x, s, g), x, s, g)


@pytest.mark.parametrize("rows,d,dtype", [(8192, 960, torch.bfloat16),
                                          (8, 960, torch.bfloat16),
                                          (2000, 7168, torch.float32)])
def test_rmsnorm_bwd_is_deterministic(cuda, rows, d, dtype):
    """dscale is summed over every row without atomics: a training step's
    8,192 rows, a decode step's 8 and the widest row give the same bits
    in two calls."""
    x, s, g = _bwd_inputs(cuda, rows, d, dtype, seed=21)
    a, b = rmsnorm_bwd_cuda(x, s, g), rmsnorm_bwd_cuda(x, s, g)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert_bwd_close(a, rmsnorm_bwd_ref(x, s, g), x, s, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_function_agrees_with_plain_autograd(cuda, dtype):
    """``rmsnorm`` on the card records ``RMSNormFunction``, whose backward
    is the kernel: its gradients against autograd through the plain
    forward on the same tensors, at the backward's bar.  In bf16 autograd
    also rounds each product g * n to bf16 before it sums them (half an
    ulp, 2^-8 of a term at most), and forms g * scale in bf16 for dx (the
    CPU tests' 2e-2)."""
    x, s, g = _bwd_inputs(cuda, 64, 960, dtype, seed=22)
    xs = [x.clone().requires_grad_(), s.clone().requires_grad_()]
    y = rmsnorm(*xs)
    assert type(y.grad_fn).__name__ == "RMSNormFunctionBackward"
    reset_launch_counts()
    got = torch.autograd.grad(y, xs, g)
    assert launch_counts()["rmsnorm_bwd"] == 1
    assert_bwd_close(got, rmsnorm_bwd_ref(x, s, g), x, s, g)
    ref = [x.clone().requires_grad_(), s.clone().requires_grad_()]
    want = torch.autograd.grad(rmsnorm_ref(*ref), ref, g)
    if dtype == torch.float32:
        assert_bwd_close(got, want, x, s, g)
        return
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=2e-2,
                               rtol=2e-2)
    terms = (g.float() * rmsnorm_ref(x, torch.ones_like(s)).float()).abs()
    room = dscale_room(x, g) + 2.0 ** -8 * terms.sum(0) \
        + 8e-3 * want[1].float().abs()
    err = (got[1].float() - want[1].float()).abs()
    assert bool((err <= room + 1e-6).all()), float((err - room).max())


def test_rmsnorm_bwd_refuses_what_it_does_not_take(cuda):
    x, s, g = _bwd_inputs(cuda, 4, 960, torch.bfloat16, seed=23)
    for bad in ((x, s, g.float()), (x, s.float(), g), (x, s, g[:2]),
                (x.t().contiguous().t(), s, g)):
        with pytest.raises(ValueError):
            rmsnorm_bwd_cuda(*bad)
    flat = torch.zeros((2 * 960 + 8,), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        rmsnorm_bwd_cuda(flat[1:1 + 960].view(1, 960), s, g[:1])


def test_card_backward_reaches_every_parameter(cuda):
    """A reduced dense model's loss on the card: every parameter gets a
    finite gradient (a kernel that cut the graph would leave those below
    it with none), the backward kernel runs once a norm (2L+1) and the
    forward kernel once a norm plus once a recomputed layer norm (remat);
    the loss and gradients agree with the same weights on the host (each
    gradient within 5e-2 of its norm: bf16 sums in other orders)."""
    cfg = get_arch("smollm-360m").reduced()
    host = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 24)))
    batch = {"tokens": toks, "labels": toks.roll(-1, dims=1)}
    runs = []
    for dev in ("cpu", cuda):
        params = _tree_map(lambda t: t.detach().to(dev).requires_grad_(),
                           host)
        leaves = _tree_leaves(params)
        reset_launch_counts()
        loss = T.loss_fn(cfg)(params, {k: v.to(dev) for k, v in
                                       batch.items()})
        loss.backward()
        runs.append((float(loss.detach()), [p.grad for p in leaves],
                     launch_counts()))
    (hl, hg, _), (cl, cg, counts) = runs
    n = 2 * cfg.n_layers + 1
    assert counts["rmsnorm_bwd"] == n
    assert counts["rmsnorm"] == n + 2 * cfg.n_layers
    assert abs(cl - hl) < 5e-2
    for a, b in zip(cg, hg):
        assert a is not None and bool(torch.isfinite(a.float()).all())
        a, b = a.float().cpu(), b.float()
        assert float((a - b).norm()) <= 5e-2 * float(b.norm()) + 1e-6


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    return [tree]


@pytest.mark.parametrize("kernel", ["decode_attention",
                                    "paged_decode_attention", "pmf_conv",
                                    "chunk_attention"])
def test_forward_only_kernels_refuse_to_cut_the_graph(cuda, kernel):
    """With grad mode on and an input that requires a gradient, a kernel
    without a backward raises instead of returning a tensor with no
    ``grad_fn``; under ``torch.no_grad()`` it runs."""
    if kernel == "decode_attention":
        g = torch.Generator(device=cuda).manual_seed(0)
        q = torch.randn((1, 15, 64), generator=g, device=cuda).bfloat16()
        kc = torch.randn((1, 64, 5, 64), generator=g, device=cuda).bfloat16()
        args = [q, kc, kc.clone(), torch.full((1,), 40, dtype=torch.int32,
                                              device=cuda)]
        fn = decode_attention_cuda
    elif kernel == "paged_decode_attention":
        args, fn = list(_paged(cuda, 2)), paged_decode_attention_cuda
    elif kernel == "chunk_attention":
        args = list(_chunk_inputs(cuda, 1, 8, 4, 2, 64, seed=0, s=16)) + [16]
        fn = chunk_attention_cuda
    else:
        pet = torch.full((4, 8), 1 / 8, device=cuda)
        args = [pet, pet.clone(), torch.full((4,), 6.0, device=cuda)]
        fn = pmf_conv_cuda
    args[0] = args[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args)
    with torch.no_grad():
        fn(*args)
    fn(*[a.detach() if torch.is_tensor(a) else a for a in args])


# ---------------------------------------------------------------------------
# DeepSeek-V2-Lite's latent attention
# ---------------------------------------------------------------------------

#: the softmax scale of DeepSeek-V2-Lite: (128 + 64)^-1/2 times YaRN's
#: mscale(40, 0.707) squared
MLA_SIGMA = 192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("n_rows", [1, 63, 1000, 2048])
@pytest.mark.parametrize("p", [0, 17, 6144])
def test_chunk_attention_at_latent_widths(cuda, p, n_rows, b):
    """The chunk kernel's (192, 128) instance with the model's scale, on
    the chunk's real rows only (the K/V of a latent chunk hold its real
    rows), against ``full_attention`` in f32, each element within twice
    its rounding bound (``_assert_within_rounding``)."""
    g = torch.Generator(device=cuda).manual_seed(p + n_rows + b)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=cuda).bfloat16()
    q = draw(b, CHUNK_S, 16, 192)
    pk, pv = draw(b, p, 16, 192), draw(b, p, 16, 128)
    k, v = draw(b, n_rows, 16, 192), draw(b, n_rows, 16, 128)
    got = chunk_attention_cuda(q, pk, pv, k, v, n_rows, MLA_SIGMA)
    torch.cuda.synchronize()
    assert got.shape == (b, CHUNK_S, 16, 128)
    _assert_within_rounding(got, q, pk, pv, k, v, n_rows, MLA_SIGMA)


def _mla_pages(cuda, lens, mp=1056, ps=16, seed=0):
    """Latent pages (NP, PS, 576) with page 0 poisoned, each sequence's
    pages drawn apart, and absorbed queries (B, 16, 576)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    b = len(lens)
    n_pages = sum(-(-n // ps) for n in lens) + 1
    pages = torch.randn((n_pages, ps, 576), generator=g,
                        device=cuda).bfloat16()
    pages[0] = 1000.0
    q = torch.randn((b, 16, 576), generator=g, device=cuda).bfloat16()
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(seed)) + 1
    tab = torch.zeros((b, mp), dtype=torch.int32)
    at = 0
    for i, n in enumerate(lens):
        npg = -(-n // ps)
        tab[i, :npg] = perm[at:at + npg]
        at += npg
    return (q, pages, tab.to(cuda),
            torch.tensor(lens, dtype=torch.int32, device=cuda))


def _mla_plain(q, pages, tab, lens, scale):
    """The latent attention in f32 (outputs) and its attention of |v|."""
    ps = pages.shape[1]
    out, att_abs = [], []
    for i in range(q.shape[0]):
        n = int(lens[i])
        rows = pages[tab[i, :-(-n // ps)].long()].reshape(-1, 576)[:n]
        p = torch.softmax(q[i].float() @ rows.float().T * scale, -1)
        v = rows[:, :512].float()
        out.append(p @ v)
        att_abs.append(p @ v.abs())
    return torch.stack(out), torch.stack(att_abs)


@pytest.mark.parametrize("lens", [[1], [16, 17, 300, 4096],
                                  [16896] * 2 + [5000] * 30],
                         ids=["1", "4-rows", "32-rows"])
def test_paged_mla_kernel_against_plain(cuda, lens):
    """The latent instance of ``paged_decode_kernel`` at DeepSeek-V2-Lite's
    widths (16 heads over 576-wide rows, values their first 512 columns)
    against plain f32 attention over the same pages, each element within
    twice its two bf16 roundings (2^-9 of the attention of |v| for P, 2^-9
    of the output), and every row alone in a batch of padding rows with
    the same bits as in the batch."""
    q, pages, tab, ln = _mla_pages(cuda, lens, seed=len(lens))
    got = paged_mla_decode_attention_cuda(q, pages, tab, ln, MLA_SIGMA)
    torch.cuda.synchronize()
    want, att_abs = _mla_plain(q, pages, tab, ln, MLA_SIGMA)
    err = (got.float() - want).abs()
    tol = 2.0 ** -8 * (att_abs + want.abs())
    assert (err <= tol).all(), float((err / tol).max())
    for i in range(min(len(lens), 4)):
        pad = torch.zeros_like(ln)
        pad[0] = ln[i]
        t = torch.zeros_like(tab)
        t[0] = tab[i]
        qa = torch.zeros_like(q)
        qa[0] = q[i]
        alone = paged_mla_decode_attention_cuda(qa, pages, t, pad, MLA_SIGMA)
        assert torch.equal(alone[0], got[i])
        assert not alone[1:].any()


#: sha256 of smollm-360m's kernel outputs on the seeded inputs of
#: ``_smollm_kernel_bits``, as the tree before the latent instances gave
#: them on the H100 (chunk kernel <64>, paged decode kernel <3, 64>)
SMOLLM_BITS = {
    "chunk": "c57dcdf88de5f03e7544923011ce8e14008a7a3b479999c0beb14666ecb1ea70",
    "paged": "2d43ac91b46765860a97de8763b01c53f6e66626935183225791e6fe7c6fb5c0"}


def _smollm_kernel_bits(cuda) -> dict:
    """The two kernels at smollm-360m's widths (15/5 heads of 64) on seeded
    inputs: a 1,000-row chunk after 1,900 prefix keys, and a paged decode
    step of 8 rows; the sha256 of each output's bytes."""
    q, pk, pv, k, v = _chunk_inputs(cuda, 1, 1900, 15, 5, 64, seed=41)
    chunk = chunk_attention_cuda(q, pk, pv, k, v, 1000)
    paged = paged_decode_attention_cuda(*_paged(cuda, 8, seed=42))
    torch.cuda.synchronize()
    return {name: hashlib.sha256(t.view(torch.int16).cpu().numpy()
                                 .tobytes()).hexdigest()
            for name, t in (("chunk", chunk), ("paged", paged))}


def test_smollm_instances_keep_their_bits(cuda):
    """smollm's instances of both kernels give the bits they gave before
    the latent instances and the value width were added."""
    got = _smollm_kernel_bits(cuda)
    assert got == SMOLLM_BITS, got


def _dsv2_reference():
    path = Path(__file__).resolve().parents[1] / "perfbench" / \
        "reference" / "deepseek_v2.py"
    spec = importlib.util.spec_from_file_location("dsv2_reference_card",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_engine_serves_deepseek_v2_lite_at_full_widths(cuda):
    """DeepSeek-V2-Lite at its published widths, two layers (the dense one
    and one of 64 experts), through the batched engine on the card: both
    kernels' latent instances run (one chunk launch and one latent decode
    launch a layer), and every served token's reference logit lies within
    0.25 of the plain f32 reference's best at its position (the
    benchmark's check; its cells read 0.03-0.10 on served tokens)."""
    from repro_torch.configs.registry import PORT_ARCHS
    from repro_torch.models.transformer import init_params
    cfg = PORT_ARCHS["deepseek-v2-lite"].scaled(n_layers=2, remat=False)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    rng = np.random.default_rng(13)
    prompts = [tuple(int(x) for x in rng.integers(1, cfg.vocab, n))
               for n in (40, 700, 3000, 2100)]
    eng = ServingEngine(cfg, params, EngineConfig(
        n_units=1, elasticity=None, merging="none", pruning=None,
        result_cache=False, max_len=3200, batch_buckets=(1,),
        kv_cache_blocks=256, prefix_max_prompt=3200,
        batching=StepBatchingConfig(max_batch=4, step_token_budget=1024)),
        device=cuda)
    reqs = [Request(prompt=p, n_new=8, deadline=1e9) for p in prompts]
    reset_launch_counts()
    stats = eng.run([(float(i), r) for i, r in enumerate(reqs)])
    counts = launch_counts()
    assert stats["completed"] == len(prompts)
    assert counts["chunk_attention"] == cfg.n_layers * stats["chunk_launches"]
    assert counts["paged_mla_decode_attention"] == \
        cfg.n_layers * stats["decode_launches"] > 0
    assert stats["moe_real_rows"] > 0
    ref = _dsv2_reference()
    conf = {"num_hidden_layers": 2, "hidden_size": 2048,
            "num_attention_heads": 16, "kv_lora_rank": 512,
            "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
            "v_head_dim": 128, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
            "rope_scaling": {"type": "yarn", "factor": 40,
                             "original_max_position_embeddings": 4096,
                             "beta_fast": 32, "beta_slow": 1,
                             "mscale": 0.707, "mscale_all_dim": 0.707},
            "first_k_dense_replace": 1, "q_lora_rank": None,
            "n_routed_experts": 64, "num_experts_per_tok": 6,
            "norm_topk_prob": False, "routed_scaling_factor": 1.0,
            "vocab_size": cfg.vocab}
    del eng
    with torch.no_grad():
        lg = ref.logits(conf, params, [p + tuple(r.tokens[:-1]) for p, r
                                       in zip(prompts, reqs)],
                        [len(p) - 1 for p in prompts])
    for r, l in zip(reqs, lg):
        tok = torch.tensor(r.tokens, device=cuda)[:, None]
        gap = float((l.max(-1).values - l.gather(-1, tok)[:, 0]).max())
        assert gap <= 0.25, gap
