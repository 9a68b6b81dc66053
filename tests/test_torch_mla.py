"""DeepSeek-V2's latent attention (MLA) in the port, on the CPU, against the
benchmark's plain float32 reference (``perfbench/reference/deepseek_v2.py``,
which imports neither the port nor JAX; the JAX package has no latent
attention, so there is no JAX twin).

The model is DeepSeek-V2-Lite cut to d 128, 4 heads, latent 64 (rope 16,
nope 32, v 32), 8 experts top-2 with 1 shared of 64, 3 layers (the first
dense), on seeded random weights.

Tolerances.  The port runs in bf16, the reference in f32.  Over every
position of a sequence the port's logits lie within ``MEDIAN_TOL`` of the
reference's at the median position and within ``P90_TOL`` at the 90th
percentile: a few positions move further where a token's second and third
router choices are nearly tied, so bf16 activations pick the other expert
(each of the 8 carries a gate near 0.25 here).  Every projection computed
with both operands rounded to fp8 e4m3, the precision below bf16, moves
every position by 0.27 or more and fails both
(``test_fp8_projections_fail_the_tolerances``).  Where the port is held
to itself (chunks, batch-mates, the absorbed form), the bounds are those
of the rounding that differs, stated in each test.
"""

import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import PORT_ARCHS, get_arch
from repro_torch.kernels.decode_attention.ops import \
    paged_mla_decode_attention
from repro_torch.models import layers as L
from repro_torch.models import trace
from repro_torch.models import transformer as T
from repro_torch.obs import Telemetry
from repro_torch.serving.batching import StepBatchingConfig
from repro_torch.serving.cluster import Router, make_engine_planes
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
MEDIAN_TOL = 0.15
P90_TOL = 0.35


def _load_reference():
    path = ROOT / "perfbench" / "reference" / "deepseek_v2.py"
    spec = importlib.util.spec_from_file_location("dsv2_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference()


def small_cfg():
    base = get_arch("deepseek-v2-lite")
    red = base.reduced()
    return red.scaled(n_layers=3, remat=False, moe=dataclasses.replace(
        red.moe, n_experts=8, top_k=2, n_shared=1))


def conf_of(cfg) -> dict:
    """The reference's configuration (the published config's keys) of a
    port ``ModelConfig``."""
    m = cfg.mla
    return {"num_hidden_layers": cfg.n_layers, "hidden_size": cfg.d_model,
            "num_attention_heads": cfg.n_heads,
            "kv_lora_rank": m.kv_lora_rank,
            "qk_nope_head_dim": m.qk_nope_head_dim,
            "qk_rope_head_dim": m.qk_rope_head_dim,
            "v_head_dim": m.v_head_dim, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.norm_eps,
            "rope_scaling": {"type": "yarn", "factor": m.rope_factor,
                             "original_max_position_embeddings":
                                 m.original_max_position,
                             "beta_fast": m.beta_fast,
                             "beta_slow": m.beta_slow, "mscale": m.mscale,
                             "mscale_all_dim": m.mscale_all_dim},
            "first_k_dense_replace": 1, "q_lora_rank": None,
            "n_routed_experts": cfg.moe.n_experts,
            "num_experts_per_tok": cfg.moe.top_k,
            "norm_topk_prob": cfg.moe.norm_topk_prob,
            "routed_scaling_factor": cfg.moe.routed_scaling_factor,
            "vocab_size": cfg.vocab}


@pytest.fixture(scope="module")
def model():
    cfg = small_cfg()
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _tokens(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(1, cfg.vocab, n)]


def _reference(cfg, params, seq):
    with torch.no_grad():
        return REF.logits(conf_of(cfg), params, [seq], [0])[0]


def _serve(cfg, params, prompt, cuts, n_new):
    """The prompt through chunked prefills cut at ``cuts``, its latent
    committed to pages, then ``n_new`` greedy paged decode steps: the
    logits at every prompt position (each chunk's last rows come from its
    own launch) and the tokens it fed."""
    chunk = T.chunk_prefill_fn(cfg)
    pdec = T.paged_decode_fn(cfg)
    ps, mp = 4, 16
    pages = T.init_paged_cache(cfg, mp + 1, ps, "cpu")
    prefix = T.empty_prefix(cfg, 1)
    logits = []
    bounds = [0] + list(cuts) + [len(prompt)]
    with torch.no_grad():
        for a, b in zip(bounds, bounds[1:]):
            for n in range(a + 1, b + 1):       # each position's logits
                lg, _ = chunk(params, torch.tensor([prompt[a:n]]), *prefix)
                logits.append(lg[0])
            _, lat = chunk(params, torch.tensor([prompt[a:b]]), *prefix)
            prefix = (torch.cat([prefix[0], lat], dim=2),)
        lat = prefix[0][:, 0]                          # (L, P, w)
        npg = -(-len(prompt) // ps)
        tab = torch.zeros((1, mp), dtype=torch.int32)
        tab[0, :mp] = torch.arange(1, mp + 1)
        flat = pages["kp"][:, 1:npg + 1].reshape(cfg.n_layers, -1,
                                                 lat.shape[-1])
        flat[:, :len(prompt)] = lat
        pages["kp"][:, 1:npg + 1] = flat.view(cfg.n_layers, npg, ps, -1)
        fed = [int(logits[-1].argmax())]
        for i in range(n_new):
            lens = torch.tensor([len(prompt) + i], dtype=torch.int32)
            lg, _, _ = pdec(params, pages["kp"], pages["vp"], tab, lens,
                            torch.tensor([fed[-1]]))
            logits.append(lg[0])
            fed.append(int(lg[0].argmax()))
    return torch.stack(logits), fed


def _errors(got, want):
    return (got.float() - want).abs().amax(-1).numpy()


def _within(err):
    return (np.median(err) <= MEDIAN_TOL
            and np.percentile(err, 90) <= P90_TOL)


# ---------------------------------------------------------------------------
# YaRN and the scale
# ---------------------------------------------------------------------------

def test_yarn_tables_equal_their_closed_form():
    """DeepSeek-V2-Lite's published rope: the blend of theta^(-2i/64) and
    its 40th between the correction dims 10 and 23, cos/sin unscaled
    (mscale(40, 0.707) / mscale(40, 0.707) = 1), and the softmax scale
    192^-1/2 (0.1 * 0.707 * ln 40 + 1)^2, written out here in float64."""
    cfg = PORT_ARCHS["deepseek-v2-lite"]
    m = cfg.mla
    assert L.yarn_range(m, 64, 10_000.0) == (10, 23)
    i = np.arange(32, dtype=np.float64)
    extra = 10_000.0 ** (-2 * i / 64)
    ramp = np.clip((i - 10) / 13, 0, 1)
    want = extra / 40 * ramp + extra * (1 - ramp)
    got = L.rope_frequencies(64, 10_000.0, mla=m).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    pos = torch.tensor([[0, 1, 4095, 16895]])
    cos, sin = L.mla_rope_tables(pos, cfg)
    ang = pos.double().numpy()[..., None] * got
    np.testing.assert_allclose(cos[..., 0, :].double().numpy(), np.cos(ang),
                               atol=2e-3)
    np.testing.assert_allclose(sin[..., 0, :].double().numpy(), np.sin(ang),
                               atol=2e-3)
    ms = 0.1 * 0.707 * math.log(40) + 1
    assert L.mla_scale(cfg) == pytest.approx(192 ** -0.5 * ms * ms,
                                             rel=1e-12)


def test_rope_pairs_are_permuted_to_halves():
    """Pair (x_2i, x_2i+1) of the input rotates by angle i: the output's
    halves hold the pairs' first and second members, rotated."""
    x = torch.randn(1, 3, 2, 8)
    cos, sin = L.rope_tables(torch.tensor([[0, 1, 2]]), 8, 10.0)
    out = L.mla_rope(x, (cos, sin))
    even, odd = x[..., 0::2], x[..., 1::2]
    want = torch.cat([even * cos - odd * sin, even * sin + odd * cos], -1)
    torch.testing.assert_close(out, want)


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cuts", [(), (7,), (1, 13, 14), (16, 20)],
                         ids=["whole", "7", "1-13-14", "16-20"])
def test_chunks_then_paged_decode_equal_the_reference(model, cuts):
    """A 24-token prompt cut into chunks at the given boundaries, then 6
    paged decode steps: every position's logits against the reference's
    full forward pass over the prompt and the tokens fed."""
    cfg, params = model
    prompt = _tokens(cfg, 24, seed=len(cuts))
    got, fed = _serve(cfg, params, prompt, cuts, 6)
    want = _reference(cfg, params, prompt + fed[:-1])
    err = _errors(got, want)
    assert _within(err), (np.median(err), np.percentile(err, 90))


def test_fp8_projections_fail_the_tolerances(model, monkeypatch):
    """The same comparison with both operands of every projection rounded
    to fp8 e4m3 (the step computed below bf16): it fails both bounds."""
    cfg, params = model
    prompt = _tokens(cfg, 24, seed=0)
    plain = L.pctx.matmul

    def fp8(x, w):
        def q(t, dim):
            amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
            s = amax / 448.0
            return (t / s).to(torch.float8_e4m3fn).float() * s
        return (q(x.float(), -1) @ q(w.float(), -2)).to(x.dtype)
    monkeypatch.setattr(L.pctx, "matmul", fp8)
    got, fed = _serve(cfg, params, prompt, (7,), 6)
    monkeypatch.setattr(L.pctx, "matmul", plain)
    err = _errors(got, _reference(cfg, params, prompt + fed[:-1]))
    assert np.median(err) > MEDIAN_TOL and np.percentile(err, 90) > P90_TOL


def test_prefill_fn_and_decode_fn_equal_the_reference(model):
    """The one-at-a-time path: a whole-prompt prefill into the contiguous
    latent cache, then greedy decode steps in the absorbed form."""
    cfg, params = model
    prompt = _tokens(cfg, 20, seed=5)
    with torch.no_grad():
        lg, cache = T.prefill_fn(cfg)(params, {"tokens": torch.tensor(
            [prompt])}, 32)
        logits, fed = [lg[0]], [int(lg[0].argmax())]
        for _ in range(5):
            lg, cache = T.decode_fn(cfg)(params, cache,
                                         torch.tensor([fed[-1]]))
            logits.append(lg[0])
            fed.append(int(lg[0].argmax()))
    want = _reference(cfg, params, prompt + fed[:-1])[len(prompt) - 1:]
    assert _within(_errors(torch.stack(logits), want))
    assert int(cache["len"][0]) == len(prompt) + 5


def test_chunks_equal_the_whole_prompt(model):
    """On the CPU a chunk's latent and its last logits do not depend on
    where the prompt was cut: the same rows, the same f32 score and
    softmax order, and each row's experts on its own rows."""
    cfg, params = model
    prompt = _tokens(cfg, 30, seed=9)
    chunk = T.chunk_prefill_fn(cfg)
    with torch.no_grad():
        lw, cw = chunk(params, torch.tensor([prompt]),
                       *T.empty_prefix(cfg, 1))
        la, ca = chunk(params, torch.tensor([prompt[:11]]),
                       *T.empty_prefix(cfg, 1))
        lb, cb = chunk(params, torch.tensor([prompt[11:]]), ca)
    torch.testing.assert_close(torch.cat([ca, cb], dim=2), cw, atol=0,
                               rtol=0)
    torch.testing.assert_close(lb, lw, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the absorbed decode
# ---------------------------------------------------------------------------

def test_absorbed_decode_equals_the_non_absorbed_formula(model):
    """One layer's decode attention in f32 (weights and latent cast up):
    absorbing W_UK into the query and W_UV into the output over the latent
    rows gives the decompressed keys' and values' attention, to f32
    rounding (1e-4 of outputs of order 1)."""
    cfg, params = model
    lp = {k: {n: v.float() for n, v in t.items()}
          for k, t in T.layer_params(params, 0)["attn"].items()}
    m, h = cfg.mla, cfg.n_heads
    g = torch.Generator().manual_seed(3)
    b, s = 3, 11
    lat = torch.randn((b, s, m.latent_dim), generator=g)
    q_nope = torch.randn((b, h, m.qk_nope_head_dim), generator=g)
    q_pe = torch.randn((b, h, m.qk_rope_head_dim), generator=g)
    lens = torch.tensor([11, 4, 1])
    q = L.mla_absorb_query(lp, q_nope, q_pe, cfg)
    o = L.mla_decode_plain(q, lat, lens, L.mla_scale(cfg), m.kv_lora_rank)
    got = L.mla_absorb_out(lp, o, cfg)[:, 0]
    k, v = L.mla_expand(lp, lat, cfg)                  # (B, S, H, .)
    qq = torch.cat([q_nope, q_pe], -1)
    sc = torch.einsum("bhd,bshd->bhs", qq, k) * L.mla_scale(cfg)
    sc = sc.masked_fill(torch.arange(s)[None, None] >= lens[:, None, None],
                        float("-inf"))
    att = torch.einsum("bhs,bshd->bhd", torch.softmax(sc, -1), v)
    want = att.reshape(b, -1) @ lp["wo"]["w"]
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_paged_latent_attention_equals_the_contiguous(model):
    """The paged front door's plain version reads a sequence's latent rows
    through its table as the contiguous cache holds them (f32, to
    rounding)."""
    cfg, _ = model
    m = cfg.mla
    g = torch.Generator().manual_seed(4)
    b, ps, mp, w = 3, 4, 5, m.latent_dim
    pages = torch.randn((b * mp + 1, ps, w), generator=g)
    tab = torch.arange(1, b * mp + 1, dtype=torch.int32).view(b, mp)
    tab = tab[:, torch.randperm(mp, generator=g)]
    lens = torch.tensor([17, 1, 20], dtype=torch.int32)
    q = torch.randn((b, cfg.n_heads, w), generator=g)
    got = paged_mla_decode_attention(q, pages, tab, lens, 0.1,
                                     m.kv_lora_rank)
    contig = pages[tab.long()].reshape(b, mp * ps, w)
    want = L.mla_decode_plain(q, contig, lens, 0.1, m.kv_lora_rank)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the batched engine
# ---------------------------------------------------------------------------

def _engine(cfg, params, batching=None, **kw):
    return ServingEngine(cfg, params, EngineConfig(
        n_units=1, elasticity=None, merging="none", pruning=None,
        result_cache=False, max_len=96, batch_buckets=(1,),
        batching=batching, **kw), device="cpu")


def test_paged_decode_rows_do_not_depend_on_batch_mates(model):
    """One paged decode step over four sequences equals each sequence's
    step alone in a batch of padding rows (the decode step's projections
    and routing are row by row, its experts compute the real rows only)."""
    cfg, params = model
    ps, mp = 4, 8
    pages = T.init_paged_cache(cfg, 4 * mp + 1, ps, "cpu")
    g = torch.Generator().manual_seed(6)
    pages["kp"].copy_(torch.randn(pages["kp"].shape, generator=g))
    tab = torch.arange(1, 4 * mp + 1, dtype=torch.int32).view(4, mp)
    lens = torch.tensor([5, 17, 2, 30], dtype=torch.int32)
    toks = torch.tensor([3, 9, 27, 81])
    pdec = T.paged_decode_fn(cfg)
    with torch.no_grad():
        full, _, _ = pdec(params, pages["kp"].clone(), pages["vp"], tab,
                          lens, toks, n_rows=4)
        for i in range(4):
            t = torch.zeros_like(tab)
            t[0] = tab[i]
            ln = torch.zeros_like(lens)
            ln[0] = lens[i]
            tk = torch.zeros_like(toks)
            tk[0] = toks[i]
            alone, _, _ = pdec(params, pages["kp"].clone(), pages["vp"], t,
                               ln, tk, n_rows=1)
            torch.testing.assert_close(alone[0], full[i], atol=0, rtol=0)


def test_batched_engine_equals_one_at_a_time(model):
    """The batched engine (chunked prefill, paged decode) gives every
    request the greedy tokens the one-at-a-time path (``prefill_fn``'s
    fixed-shape route, ``decode_fn``) gives it, prompts cut into chunks
    at the step budget."""
    cfg, params = model
    prompts = [tuple(_tokens(cfg, n, seed=n)) for n in (5, 23, 40, 61)]
    bat = StepBatchingConfig(max_batch=4, step_token_budget=16)
    tokens = []
    for batching in (bat, None):
        eng = _engine(cfg, params, batching)
        reqs = [Request(prompt=p, n_new=5, deadline=1e9) for p in prompts]
        stats = eng.run([(float(i), r) for i, r in enumerate(reqs)])
        assert stats["completed"] == len(prompts)
        tokens.append([r.tokens for r in reqs])
    assert tokens[0] == tokens[1]


def test_router_serves_it_and_counts(model):
    """DeepSeek-V2's served path: the Router over ``make_engine_planes``'
    batched engine with the prefix cache; a repeated prompt reuses its
    latent blocks and gets the same tokens.  The runner counts the
    experts' rows (no padding: every row real) and the latent tokens the
    chunks decompressed (each chunk its prefix and its real rows)."""
    cfg, params = model
    ecfg = EngineConfig(n_units=1, elasticity=None, merging="none",
                        pruning=None, result_cache=False, max_len=96,
                        batch_buckets=(1,), kv_block_size=4,
                        kv_cache_blocks=64, prefix_max_prompt=96,
                        batching=StepBatchingConfig(max_batch=4,
                                                    step_token_budget=16))
    planes = make_engine_planes(cfg, params, ecfg, 1, device="cpu")
    router = Router(planes, policy="least-loaded")
    prompt = tuple(_tokens(cfg, 37, seed=1))
    reqs = [Request(prompt=prompt, n_new=4, deadline=1e9),
            Request(prompt=tuple(_tokens(cfg, 12, seed=2)), n_new=3,
                    deadline=1e9)]
    eng = planes[0].sub
    stats0 = dict(eng.collect_stats())
    router.run([(float(i), r) for i, r in enumerate(reqs)])
    again = Request(prompt=prompt, n_new=4, deadline=1e9)
    router.run([(1e6, again)])
    st = eng.collect_stats()
    assert all(r.status == "done" for r in reqs + [again])
    assert again.tokens == reqs[0].tokens
    assert st["prefix_hits"] >= 1
    d = {k: st[k] - stats0[k] for k in ("moe_real_rows",
                                        "mla_expand_tokens", "chunk_rows")}
    assert d["moe_real_rows"] > 0
    assert d["mla_expand_tokens"] >= d["chunk_rows"] > 0


def test_model_spans_record_only_with_a_telemetry(model):
    """``model.mla_expand``, ``model.moe_route`` and ``model.moe_experts``
    land in the engine's Telemetry while one is attached, and nowhere
    without one."""
    cfg, params = model
    bat = StepBatchingConfig(max_batch=2, step_token_budget=16)
    eng = _engine(cfg, params, bat)
    tel = Telemetry()
    eng.attach_telemetry(tel)
    eng.run([(0.0, Request(prompt=tuple(_tokens(cfg, 20, seed=3)), n_new=3,
                           deadline=1e9))])
    spans = tel.span_totals()
    for name in ("model.mla_expand", "model.moe_route", "model.moe_experts"):
        assert spans[name]["span_n"] > 0, name
    assert trace._TEL[0] is not tel       # set only around each launch


def test_attention_family_admits_latent_attention(model):
    cfg, _ = model
    assert T.kv_names(cfg) == ("c",)
    T.init_paged_cache(cfg, 3, 4, "cpu")
    with pytest.raises(ValueError, match="paged decode unsupported"):
        T.paged_decode_fn(cfg.scaled(mla=None))


# ---------------------------------------------------------------------------
# the benchmark's family module: the config it maps, its counts
# ---------------------------------------------------------------------------

def _family():
    path = ROOT / "perfbench" / "families" / "deepseek_v2.py"
    spec = importlib.util.spec_from_file_location("dsv2_family", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    import json
    conf = json.loads((ROOT / "perfbench" / "configs" /
                       "deepseek-v2-lite.json").read_text())
    return mod, conf


def test_family_maps_the_published_config_onto_the_port():
    """The benchmark's configuration file is the port's registered
    DeepSeek-V2-Lite, and the file refuses what the port would not run as
    written."""
    fam, conf = _family()
    assert fam.port_config(conf) == PORT_ARCHS["deepseek-v2-lite"].scaled(
        remat=False)
    for key, bad in (("q_lora_rank", 1536), ("first_k_dense_replace", 2),
                     ("scoring_func", "sigmoid"), ("tie_word_embeddings",
                                                   True)):
        with pytest.raises(ValueError):
            fam.port_config(dict(conf, **{key: bad}))


def test_family_counts_by_hand():
    """Hand counts at the published sizes.  Weights: embedding and head
    2 x 102,400 x 2,048; a layer's attention 2,048 x 3,072 (q) + 2,048 x
    576 (kv_a) + 512 x 4,096 (kv_b) + 2,048 x 2,048 (o) + norms 2 x 2,048 +
    512; the dense MLP 3 x 2,048 x 10,944; an expert layer's router 2,048 x
    64 (f32) and 66 SwiGLUs of 1,408 (64 routed, 2 shared); the final
    norm.  A latent row is (512 + 64) x 2 bytes a layer."""
    fam, conf = _family()
    attn = 2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048
    norms = 2 * 2048 + 512
    moe = 2048 * 64 + 66 * 3 * 2048 * 1408
    total = (2 * 102400 * 2048 + 27 * (attn + norms) + 3 * 2048 * 10944
             + 26 * moe + 2048)
    assert fam.param_count(conf) == total == 15_706_484_224
    assert fam.kv_bytes_per_token(conf) == 27 * 576 * 2 == 31_104
    # a chunk of 100 rows after 1,000: per row 27 (q, kv_a, o) + the dense
    # MLP + 26 x (router + 8 SwiGLUs); the prefix's and the rows' latent
    # decompressed (512 x 4,096 a token a layer); 100,000 + 5,050 cells of
    # 16 x (192 + 128) products; one row of logits
    qko = 2048 * 3072 + 2048 * 576 + 2048 * 2048
    per_row = 27 * qko + 3 * 2048 * 10944 + 26 * (2048 * 64
                                                  + 8 * 3 * 2048 * 1408)
    want = (2 * 100 * per_row + 2 * 27 * 512 * 4096 * 1100
            + 2 * 27 * 16 * 320 * 105_050 + 2 * 2048 * 102400)
    assert fam.chunk_flops(conf, 1000, 100) == want
    # decode rows of 10 and 20: absorbed (16 x 128 x 512 twice a layer),
    # latent attention over 11 and 21 rows of 576 + 512 a head
    absorb = 2 * 16 * 128 * 512
    row = 2 * (27 * (qko + absorb) + per_row - 27 * qko) + 2 * 2048 * 102400
    assert fam.decode_flops(conf, [10, 20]) == \
        2 * row + 27 * 2 * 16 * 1088 * 32
    assert fam.paged_attention_bytes(conf, [5, 17], 1056) == \
        2 * 16 * (576 + 512) * 2 + 22 * 1152 + 2 * 1056 * 4 + 2 * 4
    assert fam.paged_attention_flops(conf, [5, 17]) == 2 * 16 * 1088 * 22


def test_family_weights_are_the_port_layout():
    """``make_weights`` at a small size gives the port's parameter tree:
    every leaf the port's own init makes, in its shape and dtype."""
    fam, conf = _family()
    small = dict(conf, hidden_size=64, intermediate_size=96,
                 num_hidden_layers=3, num_attention_heads=2,
                 num_key_value_heads=2, vocab_size=100, kv_lora_rank=32,
                 qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                 moe_intermediate_size=24, n_routed_experts=4,
                 num_experts_per_tok=2, n_shared_experts=1)
    got = fam.make_weights(small, 2 ** 40 + 7, "cpu")
    cfg = fam.port_config(small)
    want = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def leaves(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, tuple(t.shape), t.dtype
    assert sorted(leaves(got)) == sorted(leaves(want))
