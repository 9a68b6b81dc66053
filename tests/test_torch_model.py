"""The port's dense model against the JAX model, layer by layer and step by
step, on ``get_arch("smollm-360m").reduced()`` with bridged weights.

Tolerances: layers on f32 inputs agree to 1e-4 (the same f32 arithmetic in
another order).  Anything through bf16 weights is held to LOGIT_TOL
absolute on logits of order 1 and BF16_TOL on bf16 activations: XLA and
PyTorch round bf16 products at different places (one rounding after a
fused silu*up in one, two in the other), so the two frameworks agree to a
few bf16 ulps, not bit for bit.  Greedy tokens must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax, to_tensor
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from torch_jax_side import config_fields

LOGIT_TOL = 5e-2
BF16_TOL = 5e-2


@pytest.fixture(scope="module")
def model():
    cfg = get_arch("smollm-360m").reduced()
    jcfg = jax_get_arch("smollm-360m").reduced()
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jcfg, params, jparams


def _bf16(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(ml_dtypes.bfloat16)


def _cpu(arr) -> torch.Tensor:
    """A numpy array as a CPU tensor with the same bits."""
    return to_tensor(arr, "cpu")


def _f(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f(got), _f(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# weights across the boundary
# ---------------------------------------------------------------------------

def test_bridge_is_bit_exact(model):
    _, _, params, jparams = model
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert flat
    for path, leaf in flat:
        t = params
        for k in path:
            t = t[k.key]
        a = np.asarray(leaf)
        assert tuple(t.shape) == a.shape
        if a.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)


def test_configs_are_the_same(model):
    """The test model's config, and every registered arch's at full width
    and reduced (sub-configs compared field by field: they are the two
    packages' own dataclasses)."""
    cfg, jcfg, _, _ = model
    assert config_fields(cfg) == dataclasses.asdict(jcfg)
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for name, full in JAX_ARCHS.items():
        for a, b in ((get_arch(name), full),
                     (get_arch(name).reduced(), full.reduced())):
            assert config_fields(a) == dataclasses.asdict(b), name


def test_torch_init_matches_jax_shapes_and_dtypes(model):
    cfg, _, params, _ = model
    fresh = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")

    def walk(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
            else:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
    walk(fresh, params)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class TestLayers:
    def test_dense_embed_rmsnorm(self, model):
        cfg, _, params, jparams = model
        rng = np.random.default_rng(0)
        x = _bf16(rng, (2, 5, cfg.d_model))
        lp, jlp = T.layer_params(params, 0), jax.tree.map(lambda a: a[0],
                                                          jparams["layers"])
        _close(L.dense(lp["attn"]["wq"], _cpu(x)),
               JL.dense(jlp["attn"]["wq"], jnp.asarray(x)), BF16_TOL)
        _close(L.rmsnorm(lp["ln1"], _cpu(x)),
               JL.rmsnorm(jlp["ln1"], jnp.asarray(x)), BF16_TOL)
        toks = rng.integers(0, cfg.vocab, (2, 5))
        np.testing.assert_array_equal(
            _f(L.embed(params["embed"], torch.from_numpy(toks))),
            _f(JL.embed(jparams["embed"], jnp.asarray(toks))))

    def test_apply_rope(self, model):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
        pos = np.arange(7)[None, :] + np.array([[0], [300]])
        _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
               JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), 1e-4)

    @pytest.mark.parametrize("sq,sk,q_offset", [(6, 6, 0), (4, 10, 6)])
    def test_full_attention(self, sq, sk, q_offset):
        rng = np.random.default_rng(2)
        q, k, v = (rng.standard_normal((2, s, 4, 32)).astype(np.float32)
                   for s in (sq, sk, sk))
        _close(L.full_attention(*map(torch.from_numpy, (q, k, v)),
                                q_offset=q_offset),
               JL.full_attention(*map(jnp.asarray, (q, k, v)),
                                 q_offset=q_offset), 1e-4)

    def test_flash_attention_blocked(self):
        """Blocks smaller than the sequence: the online-softmax path."""
        rng = np.random.default_rng(3)
        q, k, v = (rng.standard_normal((1, 37, 4, 16)).astype(np.float32)
                   for _ in range(3))
        got = L.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                q_block=16, kv_block=8)
        _close(got, JL.flash_attention(*map(jnp.asarray, (q, k, v)),
                                       q_block=16, kv_block=8), 1e-4)
        _close(got, L.full_attention(*map(torch.from_numpy, (q, k, v))),
               1e-4)

    def test_decode_attention(self):
        rng = np.random.default_rng(4)
        q = rng.standard_normal((3, 4, 16)).astype(np.float32)
        k, v = (rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
                for _ in range(2))
        ln = np.array([1, 9, 24], np.int32)
        _close(L.decode_attention(*map(torch.from_numpy, (q, k, v, ln))),
               JL.decode_attention(*map(jnp.asarray, (q, k, v, ln))), 1e-4)

    def test_attention_apply_modes(self, model):
        cfg, jcfg, params, jparams = model
        rng = np.random.default_rng(5)
        lp, jlp = T.layer_params(params, 1)["attn"], \
            jax.tree.map(lambda a: a[1], jparams["layers"]["attn"])
        x = _bf16(rng, (2, 9, cfg.d_model))
        # prefill
        out, (k, v) = L.attention_apply(lp, _cpu(x), cfg, kv_out=True)
        jout, (jk, jv) = JL.attention_apply(jlp, jnp.asarray(x), jcfg,
                                            kv_out=True)
        for a, b in ((out, jout), (k, jk), (v, jv)):
            _close(a, b, BF16_TOL)
        # cached prefill: the suffix attends to the prefix's KV
        pk, pv = np.asarray(jk)[:, :5], np.asarray(jv)[:, :5]
        out, (k2, _) = L.attention_apply(
            lp, _cpu(x[:, 5:]), cfg, kv_out=True,
            prefix_kv=(_cpu(pk), _cpu(pv)), q_offset=5)
        jout, (jk2, _) = JL.attention_apply(
            jlp, jnp.asarray(x[:, 5:]), jcfg, kv_out=True,
            prefix_kv=(jnp.asarray(pk), jnp.asarray(pv)), q_offset=5)
        _close(out, jout, BF16_TOL)
        # the port returns the suffix's KV alone; JAX's leads with pk
        _close(k2, jk2[:, 5:], BF16_TOL)
        # padding the attended keys changes nothing the causal mask shows
        padded, _ = L.attention_apply(
            lp, _cpu(x[:, 5:]), cfg, prefix_kv=(_cpu(pk), _cpu(pv)),
            q_offset=5, kv_len=32)
        _close(padded, out, 1e-6)
        # single-step decode against a contiguous cache
        kc = np.zeros((2, 16, cfg.n_kv_heads, cfg.resolved_head_dim),
                      ml_dtypes.bfloat16)
        kc[:, :9], vc = np.asarray(jk), kc.copy()
        vc[:, :9] = np.asarray(jv)
        ln = np.array([9, 4], np.int32)
        xd = _bf16(rng, (2, 1, cfg.d_model))
        out, (kc_t, _) = L.attention_apply(
            lp, _cpu(xd), cfg, positions=torch.from_numpy(ln)[:, None],
            kv_cache=(_cpu(kc), _cpu(vc)),
            length=torch.from_numpy(ln))
        jout, (jkc, _) = JL.attention_apply(
            jlp, jnp.asarray(xd), jcfg, positions=jnp.asarray(ln)[:, None],
            kv_cache=(jnp.asarray(kc), jnp.asarray(vc)),
            length=jnp.asarray(ln))
        _close(out, jout, BF16_TOL)
        _close(kc_t, jkc, BF16_TOL)

    def test_mlp(self, model):
        cfg, _, params, jparams = model
        x = _bf16(np.random.default_rng(6), (2, 3, cfg.d_model))
        _close(L.mlp_apply(T.layer_params(params, 0)["mlp"], _cpu(x)),
               JL.mlp_apply(jax.tree.map(lambda a: a[0],
                                         jparams["layers"]["mlp"]),
                            jnp.asarray(x)), BF16_TOL)


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------

def _prompt(cfg, n, seed=7):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (1, n))


class TestServingFns:
    def test_prefill_then_decode_greedy(self, model):
        cfg, jcfg, params, jparams = model
        toks = np.repeat(_prompt(cfg, 11), 2, axis=0)
        logits, cache = T.prefill_fn(cfg)(params,
                                          {"tokens": torch.from_numpy(toks)},
                                          32)
        jlogits, jcache = JT.prefill_fn(jcfg)(jparams,
                                              {"tokens": jnp.asarray(toks)},
                                              32)
        _close(logits, jlogits, LOGIT_TOL)
        _close(cache["k"], jcache["k"], BF16_TOL)
        assert cache["k"].shape == jcache["k"].shape
        dec, jdec = T.decode_fn(cfg), JT.decode_fn(jcfg)
        cur, jcur = logits.argmax(-1), jnp.argmax(jlogits, axis=-1)
        for _ in range(5):
            np.testing.assert_array_equal(cur.numpy(), np.asarray(jcur))
            logits, cache = dec(params, cache, cur)
            jlogits, jcache = jdec(jparams, jcache, jcur)
            _close(logits, jlogits, LOGIT_TOL)
            cur, jcur = logits.argmax(-1), jnp.argmax(jlogits, axis=-1)
        np.testing.assert_array_equal(cache["len"].numpy(),
                                      np.asarray(jcache["len"]))

    def test_chunk_prefill_and_prefill_from_cache(self, model):
        cfg, jcfg, params, jparams = model
        toks = _prompt(cfg, 20, seed=8)
        empty = np.zeros((cfg.n_layers, 1, 0, cfg.n_kv_heads,
                          cfg.resolved_head_dim), ml_dtypes.bfloat16)
        # first chunk cold, second chunk on the first one's KV
        jl1, jk1, jv1 = JT.chunk_prefill_fn(jcfg)(
            jparams, jnp.asarray(toks[:, :12]), jnp.asarray(empty),
            jnp.asarray(empty))
        l1, k1, v1 = T.chunk_prefill_fn(cfg)(
            params, torch.from_numpy(toks[:, :12]), _cpu(empty),
            _cpu(empty))
        _close(l1, jl1, LOGIT_TOL)
        _close(k1, jk1, BF16_TOL)
        jl2, jk2, _ = JT.chunk_prefill_fn(jcfg)(
            jparams, jnp.asarray(toks[:, 12:]), jk1, jv1)
        pk, pv = _cpu(np.asarray(jk1)), _cpu(np.asarray(jv1))
        l2, k2, _ = T.chunk_prefill_fn(cfg)(params,
                                            torch.from_numpy(toks[:, 12:]),
                                            pk, pv)
        _close(l2, jl2, LOGIT_TOL)
        _close(k2, jk2, BF16_TOL)
        assert k2.shape == (cfg.n_layers, 1, 8, cfg.n_kv_heads,
                            cfg.resolved_head_dim)
        # a chunk padded to a fixed shape gives the same logits and KV
        pad = np.zeros((1, 16), np.int64)
        pad[:, :8] = toks[:, 12:]
        l3, k3, _ = T.chunk_prefill_fn(cfg)(params, torch.from_numpy(pad),
                                            pk, pv, last=7, kv_len=64)
        _close(l3, l2, 1e-6)
        _close(k3[:, :, :8], k2, 1e-6)
        # the exclusive path's cached prefill: same logits, full cache
        logits, cache = T.prefill_from_cache(cfg)(
            params, {"tokens": torch.from_numpy(toks[:, 12:])}, pk, pv, 32)
        jlogits, jcache = JT.prefill_from_cache(jcfg)(
            jparams, {"tokens": jnp.asarray(toks[:, 12:])}, jk1, jv1, 32)
        _close(logits, jlogits, LOGIT_TOL)
        _close(cache["k"], jcache["k"], BF16_TOL)
        assert int(cache["len"][0]) == int(jcache["len"][0]) == 20

    def test_paged_decode_writes_then_attends(self, model):
        """The new KV lands in page ``tables[b, len // PS]`` slot
        ``len % PS`` before the step attends over ``len + 1`` positions;
        logits and arenas agree with JAX and the argmax is equal."""
        cfg, jcfg, params, jparams = model
        ps, mp, b = 8, 4, 3
        jpages = JT.init_paged_cache(jcfg, b * mp + 1, ps)
        rng = np.random.default_rng(9)
        kp = _bf16(rng, jpages["kp"].shape)
        vp = _bf16(rng, jpages["vp"].shape)
        tables = (rng.permutation(b * mp)[:b * mp] + 1).reshape(b, mp) \
            .astype(np.int32)
        lens = np.array([0, 7, 19], np.int32)     # page starts and middles
        toks = rng.integers(0, cfg.vocab, b)
        jl, jkp, jvp = JT.paged_decode_fn(jcfg)(
            jparams, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
            jnp.asarray(lens), jnp.asarray(toks))
        l, kp_t, vp_t = T.paged_decode_fn(cfg)(
            params, _cpu(kp), _cpu(vp), torch.from_numpy(tables),
            torch.from_numpy(lens), torch.from_numpy(toks))
        _close(l, jl, LOGIT_TOL)
        # greedy tokens agree wherever the JAX top-2 margin exceeds the
        # logit tolerance (random arena contents make near-ties likely)
        top2 = np.sort(np.asarray(jl), axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * LOGIT_TOL
        assert clear.any()
        np.testing.assert_array_equal(l.argmax(-1).numpy()[clear],
                                      np.asarray(jnp.argmax(jl, -1))[clear])
        _close(kp_t, jkp, BF16_TOL)
        _close(vp_t, jvp, BF16_TOL)
        # exactly one slot per sequence per layer changed
        changed = (kp_t.float().numpy() != kp.astype(np.float32)) \
            .any(axis=(3, 4))
        for i in range(b):
            page, slot = tables[i, lens[i] // ps], lens[i] % ps
            assert changed[:, page, slot].all()
        assert changed.sum() == b * cfg.n_layers

    def test_family_guard(self, model):
        """The paged path refuses what JAX's refuses, in its words."""
        cfg = model[0]
        with pytest.raises(ValueError,
                           match="paged decode unsupported for family moe"):
            T.paged_decode_fn(cfg.scaled(family="moe"))
