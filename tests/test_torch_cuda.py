"""The port's kernels and engine on the card (marker ``cuda``).

Every test skips without an NVIDIA card.  This file imports ``torch`` and
the port only, never ``jax``, so it runs on the GPU machine, which has no
JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version on the same CUDA tensors at
the slice's shapes; the engine's batched greedy tokens must equal its
one-at-a-time tokens through the kernels.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention.ops import \
    paged_decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import \
    paged_decode_attention_ref
from repro_torch.kernels.pmf_conv.ops import pmf_conv_cuda
from repro_torch.kernels.pmf_conv.ref import pmf_conv_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm_triton
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models import transformer as T
from repro_torch.serving.batching import StepBatchingConfig
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
