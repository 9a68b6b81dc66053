"""The port's kernels and engine on the card (marker ``cuda``).

Every test skips without an NVIDIA card.  This file imports ``torch`` and
the port only, never ``jax``, so it runs on the GPU machine, which has no
JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version on the same CUDA tensors at
the slice's shapes; the engine's batched greedy tokens must equal its
one-at-a-time tokens through the kernels, and the one-at-a-time path
behind the Router keeps its tokens with the prefix cache on or off.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention.ops import (
    decode_attention_cuda, paged_decode_attention_cuda)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)
from repro_torch.kernels.pmf_conv.ops import pmf_conv_cuda
from repro_torch.kernels.pmf_conv.ref import pmf_conv_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm_triton
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.batching import StepBatchingConfig
from repro_torch.serving.cluster import Router, make_engine_planes
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA/Triton kernels run only "
                    "there")
    return torch.device("cuda")


def _paged(cuda, b, mp=64, ps=16, h=15, hkv=5, hd=64, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    n_pages = b * mp + 1
    q = torch.randn((b, h, hd), generator=g, device=cuda).bfloat16()
    kp = torch.randn((n_pages, ps, hkv, hd), generator=g,
                     device=cuda).bfloat16()
    vp = torch.randn((n_pages, ps, hkv, hd), generator=g,
                     device=cuda).bfloat16()
    kp[0], vp[0] = 1000.0, -1000.0                 # poisoned pad page
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, mp * ps + 1, size=b).astype(np.int32)
    perm = rng.permutation(n_pages - 1) + 1
    tables = np.zeros((b, mp), np.int32)
    for i, n in enumerate(lens):
        npg = -(-int(n) // ps)
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
    with pytest.raises(NotImplementedError, match="windowed"):
        L.decode_attention(cache["k"][0], cache["k"][0], cache["v"][0],
                           cache["len"], window=4)


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
    torch.testing.assert_close(rmsnorm_triton(x, s).float(),
                               rmsnorm_ref(x, s).float(), atol=2e-2,
                               rtol=2e-2)


def test_pmf_conv_kernel(cuda):
    rng = np.random.default_rng(4)
    pet = rng.random((32, 64)).astype(np.float32)
    pet /= pet.sum(axis=1, keepdims=True)
    pct = rng.random((32, 64)).astype(np.float32)
    pct /= pct.sum(axis=1, keepdims=True)
    dl = rng.integers(-2, 130, 32).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in (pet, pct, dl)]
    for got, want in zip(pmf_conv_cuda(*args), pmf_conv_ref(*args)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


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
