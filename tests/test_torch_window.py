"""Sliding-window decode attention in the port against the JAX model.

The JAX model masks the keys below ``length - window`` in
``layers.decode_attention`` (its Pallas kernel has no window); the port's
contiguous flash-decode kernel takes the window itself, its rows' origin
moved to their first attended key.  Here, on the CPU:

* the plain model of the kernel's split (``decode_attention_split_ref``
  with a window) against the layer's plain version
  (``decode_attention_plain``), the wrapper's CPU path
  (``decode_attention_ref``) and JAX's ``layers.decode_attention``, all
  in f32 at the parity bar (2e-5), over lengths that start, fill and
  cross a 16-key granule and the 8-rank deal, windows that cut them, and
  a window at least as long as the row (the same bits as no window);
* a row with no key to attend (length 0, or a window wholly past the
  cache) gets zeros from the split model, as from the kernel, where the
  formula gives NaN in both packages: a known difference, held here;
* the op counter's credit for a launch counts the keys read,
  ``min(length, window)`` a row;
* a reduced smollm-360m with ``sliding_window = 6`` through both
  packages' ``prefill_fn`` + ``decode_fn``, JAX weights bridged in: the
  greedy tokens of 12 steps equal, the logits within
  ``tests/test_torch_families.py``'s bf16 tolerance (5e-2).

The kernel itself runs only on a card (``test_torch_cuda.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax, to_tensor
from repro_torch.configs import registry
from repro_torch.kernels.decode_attention import ops as attn_ops
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import (
    attended_keys, decode_attention_split_ref)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel import op_cost

PARITY = 2e-5
#: the model's logits, as tests/test_torch_families.py
LOGIT_TOL = 5e-2
S, H, HKV, HD = 1024, 6, 2, 32
#: lengths that start, fill and cross a 16-key granule and the 8-rank deal
#: (8 x 16 = 128 keys), and the capacity
LENGTHS = (0, 1, 15, 16, 17, 127, 128, 129, 1024)
#: windows that cut those rows, and one at least as long as any row
WINDOWS = (1, 15, 16, 17, 100, 2048)


def _data(b, s, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, H, HD)).astype(np.float32)
    k = rng.standard_normal((b, s, HKV, HD)).astype(np.float32)
    v = rng.standard_normal((b, s, HKV, HD)).astype(np.float32)
    return q, k, v


def _all(q, k, v, lens, window):
    """The split model, the layer's plain version, the wrapper's CPU path
    and JAX's layer on the same inputs, as numpy."""
    t = [to_tensor(a, "cpu") for a in (q, k, v, lens)]
    jax_out = JL.decode_attention(*map(jnp.asarray, (q, k, v, lens)),
                                  window=window)
    return {"split": decode_attention_split_ref(*t, window=window).numpy(),
            "plain": L.decode_attention_plain(*t, window=window).numpy(),
            "wrapper": decode_attention(*t, window=window).numpy(),
            "jax": np.asarray(jax_out)}


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("length", LENGTHS)
def test_split_model_matches_plain_and_jax(length, window):
    """Three rows, ``length``, the capacity and 45 keys, under one
    window: every version agrees wherever the row attends to a key."""
    lens = np.asarray([length, S, 45], np.int32)
    q, k, v = _data(3, S, seed=length + 7 * window)
    got = _all(q, k, v, lens, window)
    live = lens > 0
    for name in ("plain", "wrapper", "jax"):
        np.testing.assert_allclose(got["split"][live], got[name][live],
                                   atol=PARITY, rtol=PARITY, err_msg=name)
    np.testing.assert_array_equal(got["split"][~live], 0.0)


@pytest.mark.parametrize("length", LENGTHS)
def test_a_window_covering_the_row_is_no_window(length):
    """``window >= length`` attends to every key, bit for bit (the plain
    version's NaN at length 0 included)."""
    lens = np.asarray([length, 45, 1], np.int32)
    t = [to_tensor(a, "cpu") for a in _data(3, S, seed=3) + (lens,)]
    for window in (max(length, 45), S, 2 * S):
        assert torch.equal(decode_attention_split_ref(*t, window=window),
                           decode_attention_split_ref(*t))
        torch.testing.assert_close(
            L.decode_attention_plain(*t, window=window),
            L.decode_attention_plain(*t), atol=0, rtol=0, equal_nan=True)


def test_the_window_cuts_where_the_reference_does():
    """The first key comes from the unclamped length (the reference's
    ``pos >= length - window``), not from ``min(length, S) - window``: a
    row longer than its cache keeps the window's keys that lie in it, and
    a row whose window lies wholly past the cache attends to none."""
    s, window = 160, 20
    lens = np.asarray([170, 175, 181, 200, 160], np.int32)
    # keys 150-159, 155-159, none, none, 140-159
    assert attended_keys(torch.from_numpy(lens), s, window).tolist() == \
        [10, 5, 0, 0, 20]
    q, k, v = _data(5, s, seed=5)
    got = _all(q, k, v, lens, window)
    live = np.asarray([True, True, False, False, True])
    for name in ("plain", "wrapper", "jax"):
        np.testing.assert_allclose(got["split"][live], got[name][live],
                                   atol=PARITY, rtol=PARITY, err_msg=name)
    # the known difference: zeros from the split model (and the kernel),
    # NaN from the formula in both packages
    np.testing.assert_array_equal(got["split"][~live], 0.0)
    for name in ("plain", "wrapper", "jax"):
        assert np.isnan(got[name][~live]).all(), name


def test_the_credit_counts_the_window_keys():
    """A launch's credit to the op counter: the keys a row reads are
    ``min(length, window)`` (the capacity's share without a window), and
    the bytes and FLOPs follow them."""
    b, s, window = 4, 160, 24
    lens = torch.tensor([0, 10, 24, 150], dtype=torch.int32)
    assert attended_keys(lens, s, window).tolist() == [0, 10, 24, 24]
    assert attended_keys(lens, s).tolist() == [0, 10, 24, 150]
    q = torch.zeros((b, H, HD), dtype=torch.bfloat16)
    out = torch.empty_like(q)

    def launch():
        attn_ops._credit("decode_attention", q, out, lens, HKV, HD,
                         lambda: int(attended_keys(lens, s, window).sum()))
    _, cost = op_cost.count(launch)
    n = sum(min(int(x), window) for x in lens)
    assert n == 58
    assert cost.kernels["decode_attention"] == {
        "launches": 1, "flops": 4.0 * n * H * HD,
        "bytes": 2 * q.nbytes + 2 * n * HKV * HD * 2 + lens.nbytes}


# ---------------------------------------------------------------------------
# the model: reduced smollm-360m with a window, both packages
# ---------------------------------------------------------------------------

B, SEQ, MAX_LEN, STEPS, WINDOW = 2, 11, 32, 12, 6


@pytest.fixture(scope="module")
def windowed_runs():
    """Prefill and ``STEPS`` greedy decode steps of the windowed reduced
    smollm-360m in each package, each on its own greedy tokens: per step
    the logits and the token picked.  JAX runs op by op (each op rounds
    to its dtype, as the port's do)."""
    name = "smollm-360m"
    cfg = dataclasses.replace(registry.ARCHS[name].reduced(),
                              sliding_window=WINDOW)
    jcfg = dataclasses.replace(jax_registry.ARCHS[name].reduced(),
                               sliding_window=WINDOW)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (B, SEQ))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.disable_jit():
            jl, jc = JT.prefill_fn(jcfg)(jp, {"tokens": jnp.asarray(toks)},
                                         MAX_LEN)
            jdec = JT.decode_fn(jcfg)
            jax_run = [(np.asarray(jl).astype(np.float32), None)]
            for _ in range(STEPS):
                cur = jnp.argmax(jl, axis=-1).astype(jnp.int32)
                jl, jc = jdec(jp, jc, cur)
                jax_run.append((np.asarray(jl).astype(np.float32),
                                np.asarray(cur)))
        tl, tc = T.prefill_fn(cfg)(params, {"tokens": torch.from_numpy(toks)},
                                   MAX_LEN)
        tdec = T.decode_fn(cfg)
        port_run = [(tl.float().numpy(), None)]
        for _ in range(STEPS):
            cur = tl.argmax(-1)
            tl, tc = tdec(params, tc, cur)
            port_run.append((tl.float().numpy(), cur.numpy()))
    finally:
        torch.set_num_threads(threads)
    return port_run, jax_run


def test_windowed_model_decodes_as_jax(windowed_runs):
    """Every step cuts the window (11 + step keys > 6): the greedy tokens
    of all 12 steps are JAX's, and the logits within 5e-2."""
    port_run, jax_run = windowed_runs
    for step, ((tl, tt), (jl, jt)) in enumerate(zip(port_run, jax_run)):
        if tt is not None:
            np.testing.assert_array_equal(tt, jt, err_msg=f"step {step}")
        np.testing.assert_allclose(tl, jl, atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=f"step {step}")


def test_the_window_changes_the_model(windowed_runs):
    """The same weights without a window decode to other logits: the
    window reaches the model's attention."""
    port_run, _ = windowed_runs
    cfg = registry.ARCHS["smollm-360m"].reduced()
    jp = JT.init_params(jax_registry.ARCHS["smollm-360m"].reduced(),
                        jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (B, SEQ))
    tl, tc = T.prefill_fn(cfg)(params, {"tokens": torch.from_numpy(toks)},
                               MAX_LEN)
    np.testing.assert_array_equal(tl.float().numpy(), port_run[0][0])
    tl, _ = T.decode_fn(cfg)(params, tc, tl.argmax(-1))
    assert np.abs(tl.float().numpy() - port_run[1][0]).max() > LOGIT_TOL
