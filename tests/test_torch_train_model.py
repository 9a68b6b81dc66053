"""The training half of the port's model against the JAX package's, on the
same numpy-seeded inputs and JAX weights bridged in.

* ``flash_attention``: its gradients against JAX's ``custom_vjp`` at f32,
  causal and not, 200 queries over 64-blocks (``FLASH_TOL``); its residuals
  are O(S).
* RMSNorm's plain backward (``rmsnorm_bwd_ref``, the backward kernel's
  oracle) against JAX's gradient of ``layers.rmsnorm``: f32 at 1e-6, bf16 at
  2e-2 (the plain version forms g * scale in f32, JAX's autodiff in bf16);
  the differentiable front door takes it on the CPU.
* ``chunked_loss`` against ``cross_entropy_loss`` and JAX's, padded chunks
  and ignored labels included.
* ``loss_fn`` for every registered arch's ``reduced()`` config: value and
  every gradient in f32 (JAX weights cast to f32 on both sides, JAX jitted:
  in f32 XLA keeps no excess precision) within ``F32_TOL``; a parameter the
  loss does not reach gets no gradient here and zeros in JAX.  In bf16 the
  loss within ``BF16_TOL``, as ``test_torch_families.py`` holds logits;
  JAX is jitted here too: a loss averages over every token, and on these
  configs the port's is within 4.2e-3 of jitted JAX's and 2.9e-3 of JAX's
  run op by op, which takes up to ten times as long.
* ``cfg.remat`` on and off give bitwise equal gradients on the CPU.
"""

import functools

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
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCH_NAMES = sorted(jax_registry.ARCHS)
#: f32 flash attention, the same tile arithmetic in another order
FLASH_TOL = 1e-5
#: f32 whole-model gradients (``test_torch_family_modules.py``'s bar)
F32_TOL = 1e-3
#: bf16 losses (``test_torch_families.py``'s logit bar)
BF16_TOL = 5e-2
B, S, ENC = 2, 24, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch takes one thread: these models are small, and the suite's
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _f(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,sq,sk", [(True, 200, 200),
                                          (False, 200, 200),
                                          (False, 200, 130)])
def test_flash_attention_gradients_match_jax(causal, sq, sk):
    rng = np.random.default_rng(0)
    q, do = (rng.standard_normal((2, sq, 3, 16)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((2, sk, 3, 16)).astype(np.float32)
            for _ in range(2))

    def jf(q, k, v):
        return JL.flash_attention(q, k, v, causal=causal, q_block=64,
                                  kv_block=64)
    jout, vjp = jax.vjp(jf, q, k, v)
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = L.flash_attention(tq, tk, tv, causal=causal, q_block=64,
                            kv_block=64)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(_f(out), np.asarray(jout), atol=FLASH_TOL,
                               rtol=FLASH_TOL)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(_f(g), np.asarray(jg), atol=FLASH_TOL,
                                   rtol=FLASH_TOL, err_msg=f"d{name}")


def test_flash_attention_saves_o_of_s():
    """The residuals are (q, k, v, out, m, l), padded to whole blocks: no
    score tile of any block pair is kept for the backward."""
    q, k, v = (torch.randn((2, 200, 3, 16), requires_grad=True)
               for _ in range(3))
    out = L.flash_attention(q, k, v, q_block=64, kv_block=64)
    fn = out.grad_fn
    while type(fn).__name__ != "FlashAttentionBackward":
        fn = fn.next_functions[0][0]
    shapes = [tuple(t.shape) for t in fn.saved_tensors]
    assert shapes == [(2, 256, 3, 16)] * 4 + [(2, 3, 256)] * 2


# ---------------------------------------------------------------------------
# RMSNorm backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 5, 64), (3, 960)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_backward_matches_jax(dtype, shape):
    rng = np.random.default_rng(1)
    jdt = jnp.dtype(dtype)
    x = jnp.asarray(3 * rng.standard_normal(shape), jdt)
    scale = jnp.asarray(1 + 0.1 * rng.standard_normal(shape[-1:]), jdt)
    g = jnp.asarray(rng.standard_normal(shape), jdt)
    _, vjp = jax.vjp(lambda x, s: JL.rmsnorm({"scale": s}, x), x, scale)
    jdx, jds = vjp(g)
    tx, ts, tg = (to_tensor(np.asarray(a), "cpu") for a in (x, scale, g))
    dx, ds = rmsnorm_bwd_ref(tx, ts, tg)
    assert dx.dtype == ds.dtype == tx.dtype
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f(dx), _f(jdx), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f(ds), _f(jds), atol=tol, rtol=tol)
    # the front door records the plain backward on the CPU
    tx.requires_grad_()
    ts.requires_grad_()
    got = torch.autograd.grad(rmsnorm(tx, ts), (tx, ts), tg)
    assert torch.equal(got[0], dx) and torch.equal(got[1], ds)


def test_rmsnorm_without_grad_records_nothing():
    x, s = torch.randn((3, 64)), torch.ones(64)
    assert rmsnorm(x, s).grad_fn is None
    with torch.no_grad():
        assert rmsnorm(x.requires_grad_(), s).grad_fn is None


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def test_cross_entropy_loss_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 7, 33)).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7))
    labels[1, :3] = -1
    ours = L.cross_entropy_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels))
    theirs = JL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)


@pytest.mark.parametrize("s,chunk", [(24, 512), (21, 8)])
def test_chunked_loss_matches_cross_entropy(monkeypatch, s, chunk):
    """One chunk, and 21 positions in chunks of 8 (3 padded with -1); some
    labels ignored.  Equal to ``cross_entropy_loss`` over the full logits
    and to JAX's ``chunked_loss``."""
    cfg = registry.ARCHS["smollm-360m"].reduced()
    jcfg = jax_registry.ARCHS["smollm-360m"].reduced()
    rng = np.random.default_rng(3)
    w = rng.standard_normal((cfg.d_model, cfg.vocab)).astype(np.float32)
    h = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (2, s))
    labels[0, -5:] = -1
    monkeypatch.setattr(T, "LOSS_CHUNK", chunk)
    monkeypatch.setattr(JT, "LOSS_CHUNK", chunk)
    ours = T.chunked_loss(cfg, {"unembed": {"w": torch.from_numpy(w)}},
                          torch.from_numpy(h), torch.from_numpy(labels))
    full = L.cross_entropy_loss(torch.from_numpy(h) @ torch.from_numpy(w),
                                torch.from_numpy(labels))
    theirs = JT.chunked_loss(jcfg, {"unembed": {"w": jnp.asarray(w)}},
                             jnp.asarray(h), jnp.asarray(labels))
    np.testing.assert_allclose(float(ours), float(full), rtol=1e-5)
    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-5)


@functools.cache
def _jax_params(name):
    return JT.init_params(jax_registry.ARCHS[name].reduced(),
                          jax.random.PRNGKey(0))


def _batches(cfg, dtype, s=S):
    """The same batch for both packages: tokens and labels (some -1),
    plus frames for enc-dec or embeddings in place of tokens (vlm)."""
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab, (B, s))
    labels = rng.integers(0, cfg.vocab, (B, s))
    labels[0, :3] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    extra = None
    if cfg.family == "encdec":
        extra, shape = "enc_embeds", (B, ENC, cfg.d_model)
    elif not cfg.embed_inputs:
        extra, shape = "embeds", (B, s, cfg.d_model)
        del jb["tokens"], tb["tokens"]
    if extra:
        e = rng.standard_normal(shape).astype(np.float32)
        jb[extra] = jnp.asarray(e, dtype)
        tb[extra] = to_tensor(np.asarray(jb[extra]), "cpu")
    return jb, tb


def _torch_grads(cfg, params, batch):
    leaves = list(_leaves(params))
    for _, t in leaves:
        t.requires_grad_()
    loss = T.loss_fn(cfg)(params, batch)
    grads = torch.autograd.grad(loss, [t for _, t in leaves],
                                allow_unused=True)
    return loss.detach(), dict(zip([k for k, _ in leaves], grads))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_f32_loss_and_gradients_match_jax(name):
    cfg = registry.ARCHS[name].reduced()
    jcfg = jax_registry.ARCHS[name].reduced()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), _jax_params(name))
    jb, tb = _batches(cfg, jnp.float32)
    jloss, jgrads = jax.jit(jax.value_and_grad(JT.loss_fn(jcfg)))(jp, jb)
    loss, grads = _torch_grads(
        cfg, params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), tb)
    np.testing.assert_allclose(float(loss), float(jloss), atol=F32_TOL,
                               rtol=F32_TOL)
    jflat = dict(_leaves(jgrads))
    assert set(grads) == set(jflat)
    for path, g in grads.items():
        want = np.asarray(jflat[path])
        if g is None:
            assert not want.any(), f"{path}: no gradient here, JAX's is not 0"
            continue
        np.testing.assert_allclose(_f(g), want, atol=F32_TOL, rtol=F32_TOL,
                                   err_msg=path)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_bf16_loss_matches_jax(name):
    cfg = registry.ARCHS[name].reduced()
    jcfg = jax_registry.ARCHS[name].reduced()
    jp = _jax_params(name)
    jb, tb = _batches(cfg, jnp.bfloat16)
    jloss = jax.jit(JT.loss_fn(jcfg))(jp, jb)
    loss = T.loss_fn(cfg)(params_from_jax(jax.tree.map(np.asarray, jp),
                                          "cpu"), tb)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), atol=BF16_TOL,
                               rtol=BF16_TOL)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_remat_on_and_off_give_the_same_gradients(name):
    base = registry.ARCHS[name].reduced()
    _, tb = _batches(base, jnp.bfloat16)
    out = []
    for remat in (True, False):
        cfg = base.scaled(remat=remat)
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        out.append(_torch_grads(cfg, params, tb))
    (la, ga), (lb, gb) = out
    assert torch.equal(la, lb)
    for path in ga:
        assert (ga[path] is None) == (gb[path] is None), path
        if ga[path] is not None:
            assert torch.equal(ga[path], gb[path]), path
