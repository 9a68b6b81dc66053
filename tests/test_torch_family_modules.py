"""The port's model families against the JAX package in f32, module by
module, and the port's own prefill/decode consistency, on each registered
arch's ``reduced()`` config (bf16 parity: ``test_torch_families.py``).

* f32 (the JAX weights cast to f32, on both sides): prefill logits and
  every cache tensor, then 5 greedy decode steps, held to ``F32_TOL``,
  with every greedy token equal; here the arithmetic is the same in
  another order, so no arch amplifies rounding past it.
* The port's own ``decode(prefill(x[:-1]), x[-1]) == prefill(x)`` at
  JAX's 2e-2 (the twin of
  ``tests/test_models.py::test_prefill_decode_consistency``).
* Module by module on f32 inputs and weights (``MODULE_TOL``):
  ``moe_apply``, ``mamba2_apply`` (one step, and S > 1 across chunk
  boundaries from a carried state), ``mlstm_apply`` (sequential and
  chunked), ``slstm_apply`` and cross-attention.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X

F32_TOL = 1e-3
#: modules on f32 inputs: the same f32 arithmetic in another order
MODULE_TOL = 1e-4
ARCH_NAMES = sorted(jax_registry.ARCHS)
HYBRID = "zamba2-2.7b"


@pytest.fixture(autouse=True, scope="module")
def _op_by_op():
    """The modules' JAX runs op by op (``jax.disable_jit``): each op
    compiles once for every test instead of a scan body for every call
    (the whole-model f32 runs compile: in f32 XLA keeps no excess
    precision).  Torch takes one thread: these models are small, and the
    suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.disable_jit():
            yield
    finally:
        torch.set_num_threads(threads)


def _f(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_f(got), _f(want), atol=tol, rtol=tol,
                               err_msg=what)


@functools.cache
def _jax_params(name):
    with jax.disable_jit(False):      # the init alone may compile
        jp = JT.init_params(jax_registry.ARCHS[name].reduced(),
                            jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: a.astype(jnp.float32), jp)


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# whole models in f32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_NAMES)
def test_f32_prefill_and_greedy_decode_match_jax(name):
    cfg = registry.ARCHS[name].reduced()
    jcfg = jax_registry.ARCHS[name].reduced()
    jp = _jax_params(name)
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab, (2, 11))
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "encdec":
        e = _x(rng, (2, 5, cfg.d_model))
        jb["enc_embeds"], tb["enc_embeds"] = jnp.asarray(e), torch.from_numpy(e)
    elif not cfg.embed_inputs:
        e = _x(rng, (2, 11, cfg.d_model))
        jb, tb = {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    with jax.disable_jit(False):      # in f32 XLA keeps no excess precision
        jpre = jax.jit(JT.prefill_fn(jcfg), static_argnums=2)
        jdec = jax.jit(JT.decode_fn(jcfg))
        jl, jc = jpre(jp, jb, 32)
    tl, tc = T.prefill_fn(cfg)(params, tb, 32)
    tdec = T.decode_fn(cfg)
    for step in range(6):
        _close(tl, jl, F32_TOL, f"logits {step}")
        assert set(tc) == set(jc)
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape, k
            _close(tc[k], jc[k], F32_TOL, f"step {step} cache[{k}]")
        cur = tl.argmax(-1)
        np.testing.assert_array_equal(cur.numpy(), np.asarray(jl).argmax(-1))
        if step < 5:
            with jax.disable_jit(False):
                jl, jc = jdec(jp, jc, jnp.asarray(cur.numpy(), jnp.int32))
            tl, tc = tdec(params, tc, cur)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_decode_consistency(name):
    """decode(prefill(x[:-1]), x[-1]) equals prefill(x) within the port,
    at JAX's 2e-2; a vlm prefill takes the embedding rows its decode
    step looks up."""
    cfg = registry.ARCHS[name].reduced().scaled(remat=False)
    if cfg.moe:
        # capacity dropping is batch-size-dependent; disable for exactness
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe,
                                                 capacity_factor=8.0))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    n, s = 2, 17
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (n, s)))
    full, pre = {"tokens": toks}, {"tokens": toks[:, :s - 1]}
    if cfg.family == "encdec":
        enc = torch.randn((n, 8, cfg.d_model),
                          generator=torch.Generator().manual_seed(2)) \
            .to(torch.bfloat16)
        full["enc_embeds"] = pre["enc_embeds"] = enc
    elif not cfg.embed_inputs:
        emb = L.embed(params["embed"], toks)
        full, pre = {"embeds": emb}, {"embeds": emb[:, :s - 1]}
    logits_full, _ = T.prefill_fn(cfg)(params, full, 32)
    _, cache = T.prefill_fn(cfg)(params, pre, 32)
    logits_dec, cache = T.decode_fn(cfg)(params, cache, toks[:, s - 1])
    np.testing.assert_allclose(logits_dec.numpy(), logits_full.numpy(),
                               atol=2e-2, rtol=2e-2)
    assert (cache["len"] == s).all()


# ---------------------------------------------------------------------------
# module by module (f32 inputs and weights: MODULE_TOL)
# ---------------------------------------------------------------------------

def _module_params(name, pick):
    jp = _jax_params(name)
    jlp = pick(jp)
    return jlp, params_from_jax(jax.tree.map(np.asarray, jlp), "cpu")


@pytest.mark.parametrize("name,shape", [
    ("deepseek-moe-16b", (2, 1, 128)), ("deepseek-moe-16b", (2, 11, 128)),
    ("deepseek-moe-16b", (1, 40, 128)), ("llama4-maverick-400b-a17b",
                                         (3, 7, 128))])
def test_moe_apply(name, shape):
    """Group padding (40 tokens in groups of 32), capacity dropping and the
    shared experts; the aux loss too (the padded tokens' tied routing picks
    the lower experts, as ``lax.top_k`` does)."""
    cfg = registry.ARCHS[name].reduced()
    jlp, lp = _module_params(name, lambda p: jax.tree.map(
        lambda a: a[0], p["layers"]["moe"]))
    x = _x(np.random.default_rng(4), shape)
    jout, jaux = JM.moe_apply(jlp, jnp.asarray(x), cfg.moe)
    out, aux = M.moe_apply(lp, torch.from_numpy(x), cfg.moe)
    _close(out, jout, MODULE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def _mamba(which=(0, 0)):
    return _module_params(HYBRID, lambda p: jax.tree.map(
        lambda a: a[which], p["layers"]["mamba"]))


@pytest.mark.parametrize("s", [1, 15, 40])
def test_mamba2_apply(s):
    """One step (S == 1) and the chunked scan across chunk boundaries
    (chunk 16: S = 40 pads 8 steps), each from a carried state and conv
    state."""
    cfg = registry.ARCHS[HYBRID].reduced()
    jlp, lp = _mamba()
    rng = np.random.default_rng(5)
    d_inner = cfg.ssm.expand * cfg.d_model
    heads = d_inner // 64
    x = _x(rng, (2, s, cfg.d_model))
    st = 0.5 * _x(rng, (2, heads, 64, cfg.ssm.state_dim))
    cst = _x(rng, (2, cfg.ssm.conv_width - 1, d_inner))
    want = JS.mamba2_apply(jlp, jnp.asarray(x), cfg.ssm,
                           state=jnp.asarray(st), conv_state=jnp.asarray(cst))
    got = S.mamba2_apply(lp, torch.from_numpy(x), cfg.ssm,
                         state=torch.from_numpy(st),
                         conv_state=torch.from_numpy(cst))
    for g, w in zip(got, want):
        _close(g, w, MODULE_TOL)
    if s > 1:
        # the chunked scan is the one-step update applied S times
        y1, st1, cst1 = [], torch.from_numpy(st), torch.from_numpy(cst)
        for t in range(s):
            y, st1, cst1 = S.mamba2_apply(lp, torch.from_numpy(x[:, t:t + 1]),
                                          cfg.ssm, state=st1, conv_state=cst1)
            y1.append(y)
        _close(torch.cat(y1, dim=1), got[0], MODULE_TOL)
        _close(st1, got[1], MODULE_TOL)


@pytest.mark.parametrize("s,chunk", [(1, 0), (13, 0), (19, 8), (16, 8)])
def test_mlstm_apply(s, chunk):
    """Sequential and chunked (19 steps pad to 24) from a cache's start
    (log-max -1e30) and from a prefill's state."""
    cfg = registry.ARCHS["xlstm-125m"].reduced()
    jlp, lp = _module_params("xlstm-125m", lambda p: jax.tree.map(
        lambda a: a[1], p["layers"]["mlstm"]))
    rng = np.random.default_rng(6)
    x = _x(rng, (2, s, cfg.d_model))
    for st in (None, "prefill"):
        jstate = tstate = None
        if st is not None:
            pre = _x(rng, (2, 5, cfg.d_model))
            _, jstate = JX.mlstm_apply(jlp, jnp.asarray(pre), cfg.n_heads)
            _, tstate = X.mlstm_apply(lp, torch.from_numpy(pre), cfg.n_heads)
        jout, jst = JX.mlstm_apply(jlp, jnp.asarray(x), cfg.n_heads,
                                   state=jstate, chunk=chunk)
        out, tst = X.mlstm_apply(lp, torch.from_numpy(x), cfg.n_heads,
                                 state=tstate, chunk=chunk)
        _close(out, jout, MODULE_TOL)
        for a, b in zip(tst, jst):
            _close(a, b, MODULE_TOL)
        if chunk:
            seq, _ = X.mlstm_apply(lp, torch.from_numpy(x), cfg.n_heads,
                                   state=tstate)
            _close(out, seq, MODULE_TOL)


@pytest.mark.parametrize("s", [1, 9])
def test_slstm_apply(s):
    """From no state (log-max -inf) and from the cache's start (-1e30):
    finite, and equal to JAX."""
    cfg = registry.ARCHS["xlstm-125m"].reduced()
    jlp, lp = _module_params("xlstm-125m", lambda p: jax.tree.map(
        lambda a: a[0], p["layers"]["slstm"]))
    x = _x(np.random.default_rng(7), (2, s, cfg.d_model))
    cache = T.init_cache(cfg, 2, 8, "cpu")
    for state in (None, tuple(cache[k][0] for k in ("sc", "sn", "sm",
                                                      "sh"))):
        jstate = None if state is None else tuple(
            jnp.asarray(t.numpy()) for t in state)
        jout, jst = JX.slstm_apply(jlp, jnp.asarray(x), state=jstate)
        out, tst = X.slstm_apply(lp, torch.from_numpy(x), state=state)
        assert torch.isfinite(out).all()
        _close(out, jout, MODULE_TOL)
        for a, b in zip(tst, jst):
            _close(a, b, MODULE_TOL)


def test_cross_attention():
    """``attention_apply(memory=...)``: K/V from the memory, no RoPE, no
    causal mask; ``kv_out`` returns the memory's K/V.  The decode step's
    cross-attention reads that K/V through ``decode_attention`` up to
    ``enc_len`` in a cache of ``max_len``."""
    name = "seamless-m4t-medium"
    cfg = registry.ARCHS[name].reduced()
    jlp, lp = _module_params(name, lambda p: jax.tree.map(
        lambda a: a[1], p["layers"]["cross_attn"]))
    rng = np.random.default_rng(8)
    x, mem = _x(rng, (2, 6, cfg.d_model)), _x(rng, (2, 9, cfg.d_model))
    jout, (jk, jv) = JL.attention_apply(jlp, jnp.asarray(x), cfg,
                                        memory=jnp.asarray(mem), kv_out=True)
    out, (k, v) = L.attention_apply(lp, torch.from_numpy(x), cfg,
                                    memory=torch.from_numpy(mem), kv_out=True)
    for a, b in ((out, jout), (k, jk), (v, jv)):
        _close(a, b, MODULE_TOL)
    # the last query row, decoded against the padded memory cache
    hd = cfg.resolved_head_dim
    ck = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, 7))
    cv = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 7))
    q = L.dense(lp["wq"], torch.from_numpy(x[:, -1:])).reshape(
        2, cfg.n_heads, hd)
    a = L.decode_attention(q, ck, cv, torch.tensor([9, 9], dtype=torch.int32))
    got = L.dense(lp["wo"], a.reshape(2, 1, cfg.n_heads * hd))
    _close(got, out[:, -1:], MODULE_TOL)
