"""Every model family of the port against the JAX package, on each
registered arch's ``reduced()`` config with JAX weights bridged in (f32
parity and the modules one by one: ``test_torch_family_modules.py``).

* The registry, the parameter trees and the bridge: the same ten archs with
  equal configs and shape cells, the same tree, shapes and dtypes,
  bit-exact weights; the attention-only entry points refuse the other
  families in JAX's words.
* bf16 prefill logits and every cache tensor, then 5 decode steps fed the
  JAX model's greedy tokens, against JAX run op by op.  Logits and caches
  are held to ``LOGIT_TOL``/``BF16_TOL`` (atol and rtol, as
  ``test_torch_model.py``).  The port's greedy token must be JAX's wherever
  JAX's top-2 logit margin exceeds twice the logit tolerance; closer than
  that (bf16 logits tie often at a vocab of 512) the port's pick must score
  within twice the tolerance of JAX's best.
* Two reduced configs amplify rounding past 5e-2 in JAX itself: one bf16
  ulp on the embedding table moves JAX's own logits by up to 0.076
  (seamless, two enc-dec layers over unit-scale frames), and by up to 0.74
  with its KV cache by up to 1.19 (zamba2, six Mamba2 blocks and two
  shared-attention passes).  For these two a tensor's tolerance is the
  larger of 5e-2 and that movement, measured in the test; their f32 parity
  is held at 1e-3 like every arch's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax, to_tensor
from repro_torch.configs import registry
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from torch_jax_side import config_fields

LOGIT_TOL = 5e-2
BF16_TOL = 5e-2
ARCH_NAMES = sorted(jax_registry.ARCHS)
B, SEQ, ENC, MAX_LEN, STEPS = 2, 11, 5, 32, 5
HYBRID = "zamba2-2.7b"


@pytest.fixture(autouse=True, scope="module")
def _op_by_op():
    """JAX runs op by op (``jax.disable_jit``): each op rounds to its
    dtype, as the port's do (under jit XLA may keep f32 where an op
    rounds to bf16), and each op compiles once for all the archs instead
    of a scan body for every call.  Torch takes one thread: these models
    are small, and the suite's workers share the host's cores."""
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


def _batches(cfg, rng):
    """The same prefill inputs for both packages: tokens, plus frame
    embeddings for enc-dec or patch embeddings in place of tokens (vlm)."""
    toks = rng.integers(1, cfg.vocab, (B, SEQ))
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "encdec":
        e = rng.standard_normal((B, ENC, cfg.d_model)) \
            .astype(ml_dtypes.bfloat16)
        jb["enc_embeds"], tb["enc_embeds"] = jnp.asarray(e), to_tensor(e, "cpu")
    elif not cfg.embed_inputs:
        e = rng.standard_normal((B, SEQ, cfg.d_model)) \
            .astype(ml_dtypes.bfloat16)
        jb, tb = {"embeds": jnp.asarray(e)}, {"embeds": to_tensor(e, "cpu")}
    return jb, tb


@functools.cache
def _jax_params(name):
    with jax.disable_jit(False):      # the init alone may compile
        return JT.init_params(jax_registry.ARCHS[name].reduced(),
                              jax.random.PRNGKey(0))


_RUNS: dict = {}


def _run(name, embeds_scale=None, feed=None):
    """Both packages' prefill and ``STEPS`` decode steps fed JAX's greedy
    tokens (or ``feed``), once per (arch, perturbation): per step the
    logits of each and the tokens fed, and the caches after the prefill
    and after the last step."""
    key = (name, embeds_scale)
    if key in _RUNS:
        return _RUNS[key]
    cfg = registry.ARCHS[name].reduced()
    jcfg = jax_registry.ARCHS[name].reduced()
    jp = _jax_params(name)
    if embeds_scale is not None:
        # one ulp of the embedding table, with a random sign per entry
        emb = np.asarray(jp["embed"]["emb"]).astype(np.float32)
        sign = np.random.default_rng(3).choice([-1.0, 1.0], emb.shape)
        jp = dict(jp, embed={"emb": jnp.asarray(
            emb * (1 + sign * embeds_scale)).astype(jp["embed"]["emb"].dtype)})
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jb, tb = _batches(cfg, np.random.default_rng(0))
    jl, jc = JT.prefill_fn(jcfg)(jp, jb, MAX_LEN)
    tl, tc = T.prefill_fn(cfg)(params, tb, MAX_LEN)
    out = {"cfg": cfg, "logits": [(tl, jl)], "fed": [],
           "prefill_cache": ({k: v.clone() for k, v in tc.items()}, jc)}
    jdec, tdec = JT.decode_fn(jcfg), T.decode_fn(cfg)
    for step in range(STEPS):
        cur = (jnp.argmax(jl, axis=-1).astype(jnp.int32) if feed is None
               else feed[step])
        out["fed"].append(cur)
        jl, jc = jdec(jp, jc, cur)
        tl, tc = tdec(params, tc, torch.tensor(np.asarray(cur)).long())
        out["logits"].append((tl, jl))
    out["cache"] = (tc, jc)
    _RUNS[key] = out
    return out


def _check_tokens(tl, jl, tol):
    """The port's greedy pick against JAX's (module doc)."""
    t, j = _f(tl), _f(jl)
    pick, want = t.argmax(-1), j.argmax(-1)
    top2 = np.sort(j, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    np.testing.assert_array_equal(pick[clear], want[clear])
    rows = np.arange(len(pick))
    assert (j[rows, want] - j[rows, pick] <= 2 * tol).all()
    return int((pick == want).sum())


# ---------------------------------------------------------------------------
# registry, trees, bridge
# ---------------------------------------------------------------------------

def test_registry_is_the_same():
    assert list(registry.ARCHS) == list(jax_registry.ARCHS)
    for name in ARCH_NAMES:
        assert config_fields(registry.get_arch(name)) == \
            dataclasses.asdict(jax_registry.get_arch(name))
        assert config_fields(registry.get_arch(name).reduced()) == \
            dataclasses.asdict(jax_registry.get_arch(name).reduced())
    for shape in jax_registry.SHAPES:
        assert dataclasses.asdict(registry.get_shape(shape)) == \
            dataclasses.asdict(jax_registry.get_shape(shape))
    ours = [(a.name, s.name, ok, why) for a, s, ok, why
            in registry.all_cells(include_skipped=True)]
    theirs = [(a.name, s.name, ok, why) for a, s, ok, why
              in jax_registry.all_cells(include_skipped=True)]
    assert ours == theirs and len(ours) == 40
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_arch("gpt-5")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_bridge_carries_every_family_bit_for_bit(name):
    """Every leaf of the JAX tree (hybrid's doubly stacked layers, moe's
    ``dense0``/``dense_layers``, enc-dec's encoder) crosses with its bits;
    the port's own init builds the same tree, shapes and dtypes."""
    cfg = registry.ARCHS[name].reduced()
    jp = _jax_params(name)
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    fresh = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    n = 0
    for path, leaf in flat:
        t, f = params, fresh
        for k in path:
            t, f = t[k.key], f[k.key]
        a = np.asarray(leaf)
        assert tuple(t.shape) == a.shape == tuple(f.shape)
        assert t.dtype == f.dtype
        if a.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(fresh))


def test_init_draws_in_bounded_slices(monkeypatch):
    """A weight larger than ``DRAW_CHUNK`` is drawn a slice at a time, so
    full-width init holds no f32 copy of a stacked tensor."""
    cfg = registry.ARCHS["deepseek-moe-16b"].reduced()
    monkeypatch.setattr(L, "DRAW_CHUNK", 4096)
    sizes = []
    randn = torch.randn

    def spy(*a, **k):
        out = randn(*a, **k)
        sizes.append(out.numel())
        return out
    monkeypatch.setattr(torch, "randn", spy)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert max(sizes) <= 4096
    assert params["layers"]["moe"]["w_gate"].numel() > 4096
    assert params["layers"]["moe"]["w_gate"].float().std() > 0


@pytest.mark.parametrize("family,what", [
    ("moe", "paged cache"), ("hybrid", "chunked prefill"),
    ("ssm", "paged decode"), ("encdec", "prefix-cached prefill")])
def test_attention_only_entry_points_refuse_as_jax_does(family, what):
    names = {"moe": "deepseek-moe-16b", "hybrid": HYBRID,
             "ssm": "xlstm-125m", "encdec": "seamless-m4t-medium"}
    cfg = registry.ARCHS[names[family]].reduced()
    jcfg = jax_registry.ARCHS[names[family]].reduced()
    calls = {"paged cache": (lambda m, c: m.init_paged_cache(c, 3, 4)),
             "chunked prefill": (lambda m, c: m.chunk_prefill_fn(c)),
             "paged decode": (lambda m, c: m.paged_decode_fn(c)),
             "prefix-cached prefill": (lambda m, c: m.prefill_from_cache(c))}
    words = f"{what} unsupported for family {family}"
    with pytest.raises(ValueError) as theirs:
        calls[what](JT, jcfg)
    with pytest.raises(ValueError, match=words) as ours:
        calls[what](T, cfg)
    assert str(ours.value) == str(theirs.value) == words


# ---------------------------------------------------------------------------
# whole models against JAX
# ---------------------------------------------------------------------------

#: the bf16 archs whose reduced config amplifies one bf16 ulp past
#: ``BF16_TOL`` in JAX itself (module doc)
CONDITIONED = (HYBRID, "seamless-m4t-medium")


def _movement(name):
    """Per logits step and per cache tensor, the largest change one bf16
    ulp on the embedding table makes to JAX's own bf16 run (the perturbed
    run is fed the same tokens)."""
    run = _run(name)
    ref = _run(name, 2.0 ** -8, feed=run["fed"])

    def gap(a, b):
        return float(np.abs(_f(a) - _f(b)).max())
    return {"logits": [gap(r, j) for (_, j), (r, _) in
                       zip(run["logits"], ref["logits"])],
            **{w: {k: gap(ref[w][1][k], run[w][1][k]) for k in run[w][1]}
               for w in ("prefill_cache", "cache")}}


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_and_decode_match_jax(name):
    """bf16, against JAX run op by op: logits and every cache tensor within
    5e-2 (or, for ``CONDITIONED``, within JAX's own one-ulp movement where
    that is larger), and the greedy tokens as the module doc says."""
    run = _run(name)
    move = _movement(name) if name in CONDITIONED else None

    def tol(kind, *key):
        if move is None:
            return BF16_TOL
        m = move[kind]
        for k in key:
            m = m[k]
        return max(BF16_TOL, m)
    for which in ("prefill_cache", "cache"):
        tc, jc = run[which]
        assert set(tc) == set(jc)
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape, k
            assert str(tc[k].dtype).removeprefix("torch.") == \
                str(jc[k].dtype), k
            _close(tc[k], jc[k], tol(which, k), f"{which}[{k}]")
    for i, (tl, jl) in enumerate(run["logits"]):
        assert tl.shape == (B, run["cfg"].vocab) and tl.dtype == torch.float32
        _close(tl, jl, tol("logits", i), f"step {i}")
        _check_tokens(tl, jl, tol("logits", i))
    np.testing.assert_array_equal(run["cache"][0]["len"].numpy(),
                                  SEQ + STEPS)
    if move is not None:
        # the conditioning is real: JAX moves past BF16_TOL by itself
        assert max(move["logits"]) > BF16_TOL
