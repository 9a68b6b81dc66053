"""The port's kernels against the JAX package's, on the same inputs.

CPU part: each plain PyTorch version (what the port's wrapper runs for a
tensor on the CPU) against the JAX Pallas kernel in interpret mode and
against the JAX ref, with ``tests/test_kernels.py``'s tolerances
(pmf_conv atol 1e-6 / rtol 1e-5; decode attention 2e-5 in f32 and 2e-2 in
bf16; rmsnorm 1e-5 in f32 and 2e-2 in bf16).  Inputs come from seeded numpy generators
and cross the boundary as numpy arrays.  The plain models of the attention
kernels' split-key algorithm (``*_split_ref``) are held to the Pallas
kernels and the f32 plain versions at atol/rtol 1e-5 in f32, at lengths
that cross their granule and rank boundaries.

The kernels themselves run only on a card: ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.pmf import PMF, chance_of_success
from repro.kernels.decode_attention.decode_attention import (
    decode_attention_pallas, paged_decode_attention_pallas)
from repro.kernels.decode_attention.ops import \
    tune_block_s as jax_tune_block_s
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref
from repro.kernels.decode_attention.ref import paged_decode_attention_ref \
    as jax_paged_ref
from repro.kernels.pmf_conv.ops import batched_success as jax_batched_success
from repro.kernels.pmf_conv.pmf_conv import pmf_conv_pallas
from repro.kernels.pmf_conv.ref import pmf_conv_ref as jax_pmf_conv_ref
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro.kernels.rmsnorm.rmsnorm import rmsnorm_pallas
from repro.configs.registry import ARCHS
from repro.serving.autoscale.signals import \
    _kernel_success as jax_kernel_success
from repro_torch.bridge import to_tensor
from repro_torch.core.pmf import PMF as TPMF
from repro_torch.core.pmf import chance_of_success as t_chance_of_success
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.chunk_attention.ops import (chunk_attention,
                                                     chunk_attention_cuda)
from repro_torch.kernels.decode_attention import ops as attn_ops
from repro_torch.kernels.decode_attention.ops import (
    SPLIT_GRANULE, SPLIT_RANKS, decode_attention, decode_attention_cuda,
    paged_decode_attention, paged_decode_attention_cuda,
    paged_mla_decode_attention, tune_block_s)
from repro_torch.kernels.decode_attention import ref as attn_ref
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_split_ref,
    paged_decode_attention_ref, paged_decode_attention_split_ref)
from repro_torch.models import layers as L
from repro_torch.kernels.pmf_conv import ops as pmf_ops
from repro_torch.kernels.pmf_conv.ops import (batched_success, pack_pmfs,
                                              pmf_conv, pmf_conv_cuda)
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ops import (MAX_D, check_width, rmsnorm,
                                             rmsnorm_cuda)
from repro_torch.serving.autoscale.signals import _kernel_success


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


def _edge(pets, pcts, dls) -> np.ndarray:
    """Per row, ``pet[0] * pct(dl - pet_off)``: the term of Procedure 2
    that a single deadline index (the JAX front door's) drops."""
    def at(pmf, t):
        i = t - pmf.offset
        return float(pmf.values[i]) if 0 <= i < len(pmf.values) else 0.0
    return np.array([e.values[0] * at(c, dl - e.offset)
                     for e, c, dl in zip(pets, pcts, dls)])


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
        against the JAX front door plus the one term that front door's
        single index drops (``test_packed_success_with_filler_rows``), not
        only against the ref."""
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
            got, jax_batched_success(jpets, jpcts, dls, length=128)
            + _edge(jpets, jpcts, dls), atol=1e-6)

    @staticmethod
    def _specs(n, seed):
        rng = np.random.default_rng(seed)
        specs = [(rng.uniform(4, 20), rng.uniform(1, 4), rng.uniform(5, 30),
                  rng.uniform(1, 5), int(rng.integers(-10, 12)))
                 for _ in range(n)]
        dls = [int(em + cm + d) for em, _, cm, _, d in specs]
        return specs, dls

    def test_packed_success_with_filler_rows(self):
        """The scheduler's call: 20 tasks on a 64-point grid padded to 32
        rows with zero-success filler (``signals._kernel_success``), held
        against the JAX package's padded kernel call and against
        ``chance_of_success`` (the port's and the JAX package's); the filler
        rows themselves come out 0.

        The JAX front door folds the two PMF offsets into one deadline
        index, so its PEND cut falls at ``dl - pet_off`` where Procedure 2
        cuts at ``dl``: a previous task freeing the machine at exactly
        ``dl - pet_off`` is dropped, and its success misses
        ``pet[0] * pct(dl - pet_off)``.  The port's front door passes the
        cut and the success index apart, so it equals ``chance_of_success``
        and the JAX front door plus that term.  PETs clipped at time 1 put
        real mass on ``pet[0]``, so here the term is held exactly."""
        specs, dls = self._specs(20, seed=21)
        pets = [TPMF.from_normal(m, s) for m, s, _, _, _ in specs]
        pcts = [TPMF.from_normal(m, s) for _, _, m, s, _ in specs]
        got = _kernel_success(pets, pcts, dls, 64, pad_to=32, device="cpu")
        assert got.shape == (20,)
        jpets = [PMF.from_normal(m, s) for m, s, _, _, _ in specs]
        jpcts = [PMF.from_normal(m, s) for _, _, m, s, _ in specs]
        edge = _edge(jpets, jpcts, dls)
        assert edge.max() > 1e-3
        np.testing.assert_allclose(
            got, jax_kernel_success(jpets, jpcts, dls, 64, pad_to=32) + edge,
            atol=1e-6)
        for cos, pe, pc in ((t_chance_of_success, pets, pcts),
                            (chance_of_success, jpets, jpcts)):
            want = [cos(e, c, dl, droppable_prev=True)
                    for e, c, dl in zip(pe, pc, dls)]
            np.testing.assert_allclose(got, want, atol=1e-5)
        filler = [TPMF.impulse(0)] * 12
        full = batched_success(pets + filler, pcts + filler, dls + [-1] * 12,
                               length=64, device="cpu")
        np.testing.assert_array_equal(full[20:], 0.0)
        np.testing.assert_array_equal(full[:20], got)

    def test_packed_inputs_are_one_buffer(self, monkeypatch):
        """pet, pct, the success indices and the cut indices reach the
        kernel as four contiguous views of one buffer (one copy to the
        device), in that order, and give the bits of four separately built
        inputs."""
        specs, dls = self._specs(7, seed=22)
        pets = [TPMF.from_normal(m, s) for m, s, _, _, _ in specs]
        pcts = [TPMF.from_normal(m, s) for _, _, m, s, _ in specs]
        seen = []

        def spy(pet, pct, dl, cut):
            seen.append((pet, pct, dl, cut))
            return pmf_conv(pet, pct, dl, cut)

        monkeypatch.setattr(pmf_ops, "pmf_conv", spy)
        got = batched_success(pets, pcts, dls, length=64, device="cpu")
        (pet, pct, dl, cut), = seen
        base = pet.untyped_storage().data_ptr()
        for t in (pct, dl, cut):
            assert t.untyped_storage().data_ptr() == base
        assert (pet.storage_offset(), pct.storage_offset(),
                dl.storage_offset(), cut.storage_offset()) == \
            (0, 7 * 64, 2 * 7 * 64, 2 * 7 * 64 + 7)
        assert all(t.is_contiguous() for t in (pet, pct, dl, cut))
        pet_v, pet_o = pack_pmfs(pets, 64)
        pct_v, pct_o = pack_pmfs(pcts, 64)
        dl_k = np.maximum(np.asarray(dls) - pet_o - pct_o, -1)
        cut_k = np.maximum(np.asarray(dls) - pct_o, -1)
        _, want = pmf_conv(torch.from_numpy(pet_v), torch.from_numpy(pct_v),
                           torch.from_numpy(dl_k.astype(np.float32)),
                           torch.from_numpy(cut_k.astype(np.float32)))
        np.testing.assert_array_equal(got, want.numpy())

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
# contiguous decode attention
# ---------------------------------------------------------------------------

def _decode_data(b, s, h, hkv, hd, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(dtype)
    k = rng.standard_normal((b, s, hkv, hd)).astype(dtype)
    v = rng.standard_normal((b, s, hkv, hd)).astype(dtype)
    lens = rng.integers(1, s + 1, size=b).astype(np.int32)
    return q, k, v, lens


class TestDecodeAttention:
    @pytest.mark.parametrize("b,s,h,hkv,hd,bs", [
        (2, 128, 8, 4, 32, 64), (1, 256, 4, 1, 64, 128),
        (3, 96, 6, 2, 16, 32), (2, 512, 16, 16, 64, 512)])
    def test_plain_matches_pallas_and_ref_f32(self, b, s, h, hkv, hd, bs):
        """``tests/test_kernels.py``'s shapes and block sizes."""
        q, k, v, lens = _decode_data(b, s, h, hkv, hd, seed=s)
        got = decode_attention(*_t(q, k, v, lens))
        args = tuple(map(jnp.asarray, (q, k, v, lens)))
        for want in (decode_attention_pallas(*args, block_s=bs,
                                             interpret=True),
                     jax_decode_ref(*args)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=2e-5, rtol=2e-5)

    def test_plain_matches_pallas_and_ref_bf16(self):
        q, k, v, lens = _decode_data(2, 64, 4, 2, 32, seed=1,
                                     dtype=ml_dtypes.bfloat16)
        got = decode_attention(*_t(q, k, v, lens))
        assert got.dtype == torch.bfloat16
        args = tuple(map(jnp.asarray, (q, k, v, lens)))
        for want in (decode_attention_pallas(*args, block_s=32,
                                             interpret=True),
                     jax_decode_ref(*args)):
            np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                       atol=2e-2, rtol=2e-2)

    def test_masking_exact(self):
        """Entries beyond a row's length must not affect its output."""
        q, k, v, _ = _decode_data(2, 64, 4, 2, 32, seed=3)
        lens = np.asarray([10, 30], np.int32)
        out1 = decode_attention(*_t(q, k, v, lens))
        k2, v2 = k.copy(), v.copy()
        k2[:, 40:], v2[:, 40:] = 99.0, -99.0
        k2[0, 10:], v2[0, 10:] = 99.0, -99.0
        out2 = decode_attention(*_t(q, k2, v2, lens))
        np.testing.assert_array_equal(out1.numpy(), out2.numpy())

    def test_zero_length_row(self):
        """A row of length 0 attends over nothing.  The Pallas kernel, whose
        contract the CUDA kernel keeps (``test_torch_cuda.py``), returns
        zeros there; the plain versions in both packages give NaN, and the
        other rows are untouched."""
        q, k, v, _ = _decode_data(3, 32, 4, 2, 16, seed=4)
        lens = np.asarray([7, 0, 32], np.int32)
        got = decode_attention(*_t(q, k, v, lens)).numpy()
        args = tuple(map(jnp.asarray, (q, k, v, lens)))
        pallas = np.asarray(decode_attention_pallas(*args, block_s=16,
                                                    interpret=True))
        want = np.asarray(jax_decode_ref(*args))
        np.testing.assert_array_equal(pallas[1], 0.0)
        assert np.isnan(got[1]).all() and np.isnan(want[1]).all()
        for i in (0, 2):
            np.testing.assert_allclose(got[i], pallas[i], atol=2e-5,
                                       rtol=2e-5)

    def test_batch_invariant(self):
        """A row's output does not depend on its batch-mates."""
        q, k, v, lens = _decode_data(4, 48, 6, 2, 32, seed=9)
        full = decode_attention(*_t(q, k, v, lens))
        for i in range(4):
            one = decode_attention(*_t(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                       lens[i:i + 1]))
            np.testing.assert_allclose(one.numpy()[0], full.numpy()[i],
                                       atol=1e-6)

    def test_tune_block_s_cases(self):
        """``tests/test_batching.py``'s cases, and the JAX function's
        choice for every cache length up to 4096."""
        assert tune_block_s(64, block_s=512) == 64
        assert tune_block_s(512, block_s=512) == 512
        assert tune_block_s(520, block_s=512) == 128
        for s in (1, 3, 96, 130, 500, 1000, 4096):
            bs = tune_block_s(s, block_s=512)
            assert 1 <= bs <= max(s, 1)
            assert (-s) % bs < bs
        for s in range(1, 4097):
            for block_s in (64, 512):
                assert tune_block_s(s, block_s) == \
                    jax_tune_block_s(s, block_s)


# ---------------------------------------------------------------------------
# the split-key models of both attention kernels
# ---------------------------------------------------------------------------

#: lengths that start, fill and cross a 16-key granule and the 8-rank deal
#: (8 x 16 = 128 keys), and the capacity (160 keys below)
BOUNDARY_LENGTHS = (0, 1, 15, 16, 17, 127, 128, 129, 160)


def _split_case(length, seed):
    """Three rows: ``length``, the capacity and 77 keys."""
    return np.asarray([length, 160, 77], np.int32), seed + length


class TestSplitRefs:
    @pytest.mark.parametrize("length", BOUNDARY_LENGTHS)
    def test_contiguous_matches_pallas_and_plain(self, length):
        lens, seed = _split_case(length, 20)
        q, k, v, _ = _decode_data(3, 160, 6, 2, 32, seed=seed)
        got = decode_attention_split_ref(*_t(q, k, v, lens)).numpy()
        args = tuple(map(jnp.asarray, (q, k, v, lens)))
        pallas = np.asarray(decode_attention_pallas(*args, block_s=32,
                                                    interpret=True))
        np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-5)
        plain = decode_attention_ref(*_t(q, k, v, lens)).numpy()
        live = lens > 0        # the plain versions give NaN at length 0
        np.testing.assert_allclose(got[live], plain[live], atol=1e-5,
                                   rtol=1e-5)
        if not live.all():
            np.testing.assert_array_equal(got[~live], 0.0)

    @pytest.mark.parametrize("length", BOUNDARY_LENGTHS)
    def test_paged_matches_pallas_and_plain(self, length):
        lens, seed = _split_case(length, 40)
        q, kp, vp, tables, _ = _paged_data(3, 10, 16, 6, 2, 32, seed=seed)
        got = paged_decode_attention_split_ref(
            *_t(q, kp, vp, tables, lens)).numpy()
        args = tuple(map(jnp.asarray, (q, kp, vp, tables, lens)))
        pallas = np.asarray(paged_decode_attention_pallas(*args,
                                                          interpret=True))
        np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-5)
        plain = paged_decode_attention_ref(
            *_t(q, kp, vp, tables, lens)).numpy()
        live = lens > 0
        np.testing.assert_allclose(got[live], plain[live], atol=1e-5,
                                   rtol=1e-5)
        if not live.all():
            np.testing.assert_array_equal(got[~live], 0.0)

    def test_paged_granule_is_a_page(self):
        """At page size 8 a granule is one 8-key page: the model still
        matches the Pallas kernel across page and rank boundaries."""
        q, kp, vp, tables, _ = _paged_data(4, 20, 8, 4, 1, 16, seed=7)
        lens = np.asarray([7, 8, 65, 160], np.int32)
        got = paged_decode_attention_split_ref(*_t(q, kp, vp, tables, lens))
        want = paged_decode_attention_pallas(
            *map(jnp.asarray, (q, kp, vp, tables, lens)), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)

    def test_contiguous_row_alone_equals_row_in_batch(self):
        q, k, v, _ = _decode_data(5, 160, 6, 2, 32, seed=11)
        lens = np.asarray([0, 17, 129, 160, 64], np.int32)
        full = decode_attention_split_ref(*_t(q, k, v, lens))
        for i in range(5):
            one = decode_attention_split_ref(
                *_t(q[i:i + 1], k[i:i + 1], v[i:i + 1], lens[i:i + 1]))
            assert torch.equal(one[0], full[i])

    def test_paged_row_alone_equals_row_in_batch(self):
        q, kp, vp, tables, _ = _paged_data(5, 10, 16, 6, 2, 32, seed=12)
        lens = np.asarray([0, 17, 129, 160, 64], np.int32)
        full = paged_decode_attention_split_ref(*_t(q, kp, vp, tables, lens))
        for i in range(5):
            one = paged_decode_attention_split_ref(
                *_t(q[i:i + 1], kp, vp, tables[i:i + 1], lens[i:i + 1]))
            assert torch.equal(one[0], full[i])

    def test_keys_past_the_length_are_never_read(self):
        """Poisoned keys past each length, and table entries past each
        sequence's last page that index no page at all, change nothing."""
        q, k, v, _ = _decode_data(2, 64, 4, 2, 16, seed=13)
        lens = np.asarray([17, 40], np.int32)
        want = decode_attention_split_ref(*_t(q, k, v, lens))
        k[0, 17:], v[0, 17:], k[1, 40:], v[1, 40:] = 99.0, -99.0, 99.0, -99.0
        assert torch.equal(decode_attention_split_ref(*_t(q, k, v, lens)),
                           want)
        q, kp, vp, tables, _ = _paged_data(2, 4, 16, 4, 2, 16, seed=14)
        want = paged_decode_attention_split_ref(*_t(q, kp, vp, tables, lens))
        tables[0, 2:], tables[1, 3:] = 10 ** 6, -1
        assert torch.equal(
            paged_decode_attention_split_ref(*_t(q, kp, vp, tables, lens)),
            want)

    def test_partition_constants_agree(self):
        """The partition the wrapper checks the kernel library against (when
        it loads) is the one the split models deal: one definition."""
        assert SPLIT_RANKS is attn_ref.SPLIT_RANKS
        assert SPLIT_GRANULE is attn_ref.SPLIT_GRANULE
        assert (SPLIT_RANKS, SPLIT_GRANULE) == (8, 16)

    def test_library_with_another_partition_is_refused(self, monkeypatch):
        class FakeLib:
            @staticmethod
            def decode_attention_geometry(ranks, granule):
                ranks._obj.value, granule._obj.value = 4, 16
                return 0

        monkeypatch.setattr(attn_ops, "library", lambda: FakeLib)
        attn_ops._library.cache_clear()
        try:
            with pytest.raises(RuntimeError, match="4 ranks"):
                attn_ops._library()
        finally:
            attn_ops._library.cache_clear()


class _FakeCuda:
    """Stands in for a CUDA query tensor: the layer routes on ``is_cuda``
    before it touches anything else."""
    is_cuda = True

    def contiguous(self):
        return self


class TestLayerRouting:
    def test_cpu_layer_keeps_plain_code(self):
        """On the CPU the layer is the JAX layer's plain code (bf16 scores)
        and launches nothing."""
        from repro.models.layers import decode_attention as jax_layer
        reset_launch_counts()
        q, k, v, lens = _decode_data(2, 40, 15, 5, 64, seed=6,
                                     dtype=ml_dtypes.bfloat16)
        got = L.decode_attention(*_t(q, k, v, lens))
        want = jax_layer(*map(jnp.asarray, (q, k, v, lens)))
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=2e-2, rtol=2e-2)
        assert launch_counts()["decode_attention"] == 0

    def test_cuda_layer_calls_the_kernel(self, monkeypatch):
        """On the card the layer launches the kernel, with the window
        where there is one: it never raises and never takes the plain
        version."""
        calls = []
        monkeypatch.setattr(L, "_decode_attention_kernel",
                            lambda *a: calls.append(a) or "kernel")

        def plain(*a, **k):
            raise AssertionError("the card took the plain version")
        monkeypatch.setattr(L, "decode_attention_plain", plain)
        lens = torch.tensor([3, 5], dtype=torch.int64)
        assert L.decode_attention(_FakeCuda(), "k", "v", lens) == "kernel"
        assert len(calls) == 1 and calls[0][3].dtype == torch.int32
        assert calls[0][4] == 0
        assert L.decode_attention(_FakeCuda(), "k", "v", lens,
                                  window=4) == "kernel"
        assert len(calls) == 2 and calls[1][3].dtype == torch.int32
        assert calls[1][4] == 4


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


#: every d_model in the JAX package's configs, full and reduced
CONFIG_D = sorted({c.d_model for c in ARCHS.values()}
                  | {c.reduced().d_model for c in ARCHS.values()})


class TestRmsnormGeometry:
    """The wrapper's checks; the kernel picks its instantiation from D and
    the dtype (``geometry`` in ``csrc/rmsnorm.cu``), and the card tests hold
    every width the checks take to an instantiation of the library."""

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_every_config_d_model_is_taken(self, dtype):
        assert CONFIG_D[0] == 128 and CONFIG_D[-1] == MAX_D == 7168
        for d in CONFIG_D:
            check_width(d, dtype)

    @pytest.mark.parametrize("d,dtype", [
        (964, torch.bfloat16), (962, torch.float32), (0, torch.bfloat16),
        (MAX_D + 8, torch.bfloat16), (960, torch.float16)])
    def test_refuses_what_it_does_not_take(self, d, dtype):
        with pytest.raises(ValueError):
            check_width(d, dtype)

    def test_chosen_from_d_and_dtype_alone(self, monkeypatch):
        """The wrapper's launch for 1, 8, 64 and 1,000 rows differs in the
        row count alone: nothing else it passes the kernel depends on the
        batch."""
        calls = []

        class Lib:
            @staticmethod
            def rmsnorm_bf16(*args):
                calls.append(args)
                return 0

        monkeypatch.setattr(rms_ops, "library", lambda: Lib)
        monkeypatch.setattr(rms_ops, "current_stream", lambda dev: 7)
        monkeypatch.setattr(torch, "empty_like",
                            lambda t: _FakeCudaTensor(t.shape, t.dtype, 512))
        scale = _FakeCudaTensor((960,), torch.bfloat16, 256)
        before = rmsnorm_cuda.launches
        for rows in (1, 8, 64, 1000):
            rmsnorm_cuda(_FakeCudaTensor((rows, 960), torch.bfloat16, 1024),
                         scale)
        assert rmsnorm_cuda.launches == before + 4
        assert [c[3] for c in calls] == [1, 8, 64, 1000]
        assert {c[:3] + c[4:] for c in calls} == \
            {(1024, 256, 512, 960, 1e-5, 7)}
        with pytest.raises(ValueError, match="aligned"):
            rmsnorm_cuda(_FakeCudaTensor((8, 960), torch.bfloat16, 1032),
                         scale)
        with pytest.raises(ValueError, match="one dtype"):
            rmsnorm_cuda(_FakeCudaTensor((8, 960), torch.bfloat16, 1024),
                         _FakeCudaTensor((960,), torch.float32, 256))
        assert rmsnorm_cuda.launches == before + 4


class _FakeCudaTensor:
    """Stands in for a contiguous CUDA tensor at a given address: what the
    RMSNorm wrapper reads before it launches."""
    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, shape, dtype, ptr):
        self.shape, self.dtype, self.ptr = torch.Size(shape), dtype, ptr

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.ptr

    def numel(self):
        return self.shape.numel()


# ---------------------------------------------------------------------------
# the wrappers: plain version on the CPU, kernel or raise on the card
# ---------------------------------------------------------------------------

def _chunk_data():
    """q (1, 8, 4, 32), a 3-row prefix and the chunk's K/V, 2 kv heads."""
    g = torch.Generator().manual_seed(0)
    return tuple(torch.randn(shape, generator=g).to(torch.bfloat16)
                 for shape in ((1, 8, 4, 32), (1, 3, 2, 32), (1, 3, 2, 32),
                               (1, 8, 2, 32), (1, 8, 2, 32)))


class TestWrappers:
    def test_cpu_tensors_never_count_a_launch(self):
        reset_launch_counts()
        q, kp, vp, tables, lens = _paged_data(1, 2, 8, 4, 2, 16)
        paged_decode_attention(*_t(q, kp, vp, tables, lens))
        decode_attention(*_t(*_decode_data(1, 8, 4, 2, 16)))
        x = torch.ones((2, 8), requires_grad=True)
        rmsnorm(x, torch.ones((8,))).sum().backward()
        pet, pct, dl = _pmf_data(2, 4, 4)
        pmf_conv(*map(torch.from_numpy, (pet, pct, dl)))
        chunk_attention(*_chunk_data(), 5)
        paged_mla_decode_attention(
            torch.ones((1, 2, 24)), torch.ones((3, 4, 24)),
            torch.tensor([[1, 2]], dtype=torch.int32),
            torch.tensor([5], dtype=torch.int32), 0.1, 16)
        assert launch_counts() == {"chunk_attention": 0,
                                   "decode_attention": 0,
                                   "paged_decode_attention": 0,
                                   "paged_mla_decode_attention": 0,
                                   "rmsnorm": 0, "rmsnorm_bwd": 0,
                                   "pmf_conv": 0}

    @pytest.mark.parametrize("fn,args", [
        (paged_decode_attention_cuda,
         lambda: _t(*_paged_data(1, 2, 8, 4, 2, 16))),
        (rmsnorm_cuda, lambda: (torch.ones((2, 8)), torch.ones((8,)))),
        (pmf_conv_cuda,
         lambda: tuple(map(torch.from_numpy, _pmf_data(2, 4, 4)))),
        (decode_attention_cuda,
         lambda: _t(*_decode_data(1, 8, 4, 2, 16))),
        (chunk_attention_cuda, lambda: _chunk_data() + (5,))])
    def test_kernels_refuse_host_tensors(self, fn, args):
        with pytest.raises(ValueError):
            fn(*args())
