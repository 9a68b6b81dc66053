"""The port's kernels against the JAX package's, on the same inputs.

CPU part: each plain PyTorch version (what the port's wrapper runs for a
tensor on the CPU) against the JAX Pallas kernel in interpret mode and
against the JAX ref, with ``tests/test_kernels.py``'s tolerances
(pmf_conv atol 1e-6 / rtol 1e-5; decode attention 2e-5 in f32; rmsnorm
1e-5 in f32 and 2e-2 in bf16).  Inputs come from seeded numpy generators
and cross the boundary as numpy arrays.

The kernels themselves run only on a card: ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.pmf import PMF, chance_of_success
from repro.kernels.decode_attention.decode_attention import \
    paged_decode_attention_pallas
from repro.kernels.decode_attention.ref import paged_decode_attention_ref \
    as jax_paged_ref
from repro.kernels.pmf_conv.ops import batched_success as jax_batched_success
from repro.kernels.pmf_conv.pmf_conv import pmf_conv_pallas
from repro.kernels.pmf_conv.ref import pmf_conv_ref as jax_pmf_conv_ref
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro.kernels.rmsnorm.rmsnorm import rmsnorm_pallas
from repro_torch.bridge import to_tensor
from repro_torch.core.pmf import PMF as TPMF
from repro_torch.core.pmf import chance_of_success as t_chance_of_success
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention.ops import (
    paged_decode_attention, paged_decode_attention_cuda)
from repro_torch.kernels.pmf_conv.ops import (batched_success, pmf_conv,
                                              pmf_conv_cuda)
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_triton


def _np(t) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# pmf_conv
# ---------------------------------------------------------------------------

def _pmf_data(n, le, lc, seed=0):
    rng = np.random.default_rng(seed)
    pet = rng.random((n, le)).astype(np.float32)
    pet /= pet.sum(axis=1, keepdims=True)
    pct = rng.random((n, lc)).astype(np.float32)
    pct /= pct.sum(axis=1, keepdims=True)
    dl = rng.integers(-2, le + lc + 2, size=n).astype(np.float32)
    return pet, pct, dl


class TestPmfConv:
    @pytest.mark.parametrize("n,le,lc", [(4, 8, 16), (16, 32, 32),
                                         (3, 5, 64), (9, 64, 128),
                                         (32, 64, 64)])
    def test_plain_matches_pallas_and_ref(self, n, le, lc):
        pet, pct, dl = _pmf_data(n, le, lc)
        out_t, suc_t = pmf_conv(*map(torch.from_numpy, (pet, pct, dl)))
        out_k, suc_k = pmf_conv_pallas(jnp.asarray(pet), jnp.asarray(pct),
                                       jnp.asarray(dl), interpret=True)
        out_r, suc_r = jax_pmf_conv_ref(jnp.asarray(pet), jnp.asarray(pct),
                                        jnp.asarray(dl))
        for want_o, want_s in ((out_k, suc_k), (out_r, suc_r)):
            np.testing.assert_allclose(out_t.numpy(), np.asarray(want_o),
                                       atol=1e-6, rtol=1e-5)
            np.testing.assert_allclose(suc_t.numpy(), np.asarray(want_s),
                                       atol=1e-6, rtol=1e-5)

    def test_mass_conservation(self):
        pet, pct, dl = _pmf_data(8, 16, 24, seed=3)
        out, _ = pmf_conv(*map(torch.from_numpy, (pet, pct, dl)))
        np.testing.assert_allclose(out.numpy().sum(axis=1), 1.0, atol=1e-5)

    def test_success_against_core_pmf(self):
        """The deadline-index algebra of ``batched_success``: held against
        ``chance_of_success`` (the port's copy and the JAX package's) and
        against the JAX front door, not only against the ref."""
        rng = np.random.default_rng(7)
        specs = [(rng.uniform(8, 30), rng.uniform(1, 5),
                  rng.uniform(10, 60), rng.uniform(2, 8),
                  int(rng.integers(-10, 15))) for _ in range(12)]
        pets = [TPMF.from_normal(m, s) for m, s, _, _, _ in specs]
        pcts = [TPMF.from_normal(m, s) for _, _, m, s, _ in specs]
        dls = [int(e.mean() + c.mean() + d)
               for e, c, (_, _, _, _, d) in zip(pets, pcts, specs)]
        got = batched_success(pets, pcts, dls, length=128, device="cpu")
        want = [t_chance_of_success(e, c, dl, droppable_prev=True)
                for e, c, dl in zip(pets, pcts, dls)]
        np.testing.assert_allclose(got, want, atol=1e-5)
        jpets = [PMF.from_normal(m, s) for m, s, _, _, _ in specs]
        jpcts = [PMF.from_normal(m, s) for _, _, m, s, _ in specs]
        jwant = [chance_of_success(e, c, dl, droppable_prev=True)
                 for e, c, dl in zip(jpets, jpcts, dls)]
        np.testing.assert_allclose(got, jwant, atol=1e-5)
        np.testing.assert_allclose(
            got, jax_batched_success(jpets, jpcts, dls, length=128),
            atol=1e-6)

    def test_batched_success_defaults_to_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device exists")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            batched_success([TPMF.impulse(3)], [TPMF.impulse(1)], [10])


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

def _paged_data(b, mp, ps, h, hkv, hd, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    n_pages = b * mp + 1
    q = rng.standard_normal((b, h, hd)).astype(dtype)
    kp = rng.standard_normal((n_pages, ps, hkv, hd)).astype(dtype)
    vp = rng.standard_normal((n_pages, ps, hkv, hd)).astype(dtype)
    tables = (rng.permutation(n_pages - 1)[:b * mp] + 1) \
        .reshape(b, mp).astype(np.int32)
    lens = rng.integers(1, mp * ps + 1, size=b).astype(np.int32)
    return q, kp, vp, tables, lens


def _t(*arrs):
    return [to_tensor(a, "cpu") for a in arrs]


class TestPagedDecodeAttention:
    @pytest.mark.parametrize("b,mp,ps,h,hkv,hd", [
        (4, 3, 8, 4, 2, 16), (2, 4, 8, 4, 4, 16), (3, 5, 16, 15, 5, 64),
        (1, 2, 16, 6, 2, 32)])
    def test_plain_matches_pallas_and_ref_f32(self, b, mp, ps, h, hkv, hd):
        q, kp, vp, tables, lens = _paged_data(b, mp, ps, h, hkv, hd)
        got = paged_decode_attention(*_t(q, kp, vp, tables, lens))
        args = tuple(map(jnp.asarray, (q, kp, vp, tables, lens)))
        for want in (paged_decode_attention_pallas(*args, interpret=True),
                     jax_paged_ref(*args)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=2e-5, rtol=2e-5)

    def test_plain_matches_ref_bf16(self):
        """In bf16 the plain version keeps the JAX ref's cast order (bf16
        scores, bf16 probs); the two agree to one bf16 rounding."""
        q, kp, vp, tables, lens = _paged_data(3, 4, 16, 15, 5, 64, seed=2,
                                              dtype=ml_dtypes.bfloat16)
        got = paged_decode_attention(*_t(q, kp, vp, tables, lens))
        want = jax_paged_ref(*map(jnp.asarray, (q, kp, vp, tables, lens)))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=2e-2, rtol=2e-2)

    def test_pad_page_and_stale_slots_never_leak(self):
        """Table entries past a sequence's last page point at page 0 and
        stale in-page slots hold garbage: neither may change the output."""
        q, kp, vp, tables, _ = _paged_data(2, 3, 8, 4, 2, 16, seed=5)
        lens = np.asarray([5, 11], np.int32)
        tables[0, 1:] = 0
        tables[1, 2:] = 0
        out1 = paged_decode_attention(*_t(q, kp, vp, tables, lens))
        kp2, vp2 = kp.copy(), vp.copy()
        kp2[0], vp2[0] = 99.0, -99.0
        kp2[tables[0, 0], 5:], vp2[tables[0, 0], 5:] = 99.0, -99.0
        out2 = paged_decode_attention(*_t(q, kp2, vp2, tables, lens))
        np.testing.assert_array_equal(out1.numpy(), out2.numpy())

    def test_batch_invariant(self):
        """A sequence's output does not depend on its batch-mates."""
        q, kp, vp, tables, lens = _paged_data(4, 3, 8, 4, 2, 16, seed=9)
        full = paged_decode_attention(*_t(q, kp, vp, tables, lens))
        for i in range(4):
            one = paged_decode_attention(*_t(q[i:i + 1], kp, vp,
                                             tables[i:i + 1], lens[i:i + 1]))
            np.testing.assert_allclose(one.numpy()[0], full.numpy()[i],
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

class TestRmsnorm:
    @pytest.mark.parametrize("shape,dtype,tol", [
        ((4, 128), np.float32, 1e-5), ((1, 960), np.float32, 1e-5),
        ((8, 1, 960), ml_dtypes.bfloat16, 2e-2),
        ((2, 16, 256), ml_dtypes.bfloat16, 2e-2),
        ((5, 7, 64), ml_dtypes.bfloat16, 2e-2)])
    def test_plain_matches_pallas_and_ref(self, shape, dtype, tol):
        rng = np.random.default_rng(11)
        x = (3.0 * rng.standard_normal(shape)).astype(dtype)
        scale = rng.standard_normal(shape[-1:]).astype(dtype)
        got = rmsnorm(*_t(x, scale))
        xj, sj = jnp.asarray(x), jnp.asarray(scale)
        for want in (rmsnorm_pallas(xj, sj, interpret=True),
                     jax_rmsnorm_ref(xj, sj)):
            np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                       atol=tol, rtol=tol)

    def test_unit_variance(self):
        x = 37.0 * torch.randn((8, 512), generator=torch.Generator()
                               .manual_seed(0))
        out = rmsnorm(x, torch.ones((512,)))
        rms = torch.sqrt((out * out).mean(dim=-1))
        np.testing.assert_allclose(rms.numpy(), 1.0, atol=1e-3)


# ---------------------------------------------------------------------------
# the wrappers: plain version on the CPU, kernel or raise on the card
# ---------------------------------------------------------------------------

class TestWrappers:
    def test_cpu_tensors_never_count_a_launch(self):
        reset_launch_counts()
        q, kp, vp, tables, lens = _paged_data(1, 2, 8, 4, 2, 16)
        paged_decode_attention(*_t(q, kp, vp, tables, lens))
        rmsnorm(torch.ones((2, 8)), torch.ones((8,)))
        pet, pct, dl = _pmf_data(2, 4, 4)
        pmf_conv(*map(torch.from_numpy, (pet, pct, dl)))
        assert launch_counts() == {"paged_decode_attention": 0,
                                   "rmsnorm": 0, "pmf_conv": 0}

    @pytest.mark.parametrize("fn,args", [
        (paged_decode_attention_cuda,
         lambda: _t(*_paged_data(1, 2, 8, 4, 2, 16))),
        (rmsnorm_triton, lambda: (torch.ones((2, 8)), torch.ones((8,)))),
        (pmf_conv_cuda,
         lambda: tuple(map(torch.from_numpy, _pmf_data(2, 4, 4))))])
    def test_kernels_refuse_host_tensors(self, fn, args):
        with pytest.raises(ValueError):
            fn(*args())
