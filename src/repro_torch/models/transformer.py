"""The model in PyTorch, mirroring ``repro.models.transformer``: one
init/loss/prefill/decode quartet covering every family the JAX package has
(dense, vlm, moe, hybrid Mamba2, xLSTM and enc-dec), plus the paged and
prefix-cached entry points of the attention families.  A model with
latent attention (``cfg.mla``: DeepSeek-V2, which the JAX package does not
have) runs through the same entry points: its caches hold one latent row a
token where the others hold K and V (``kv_names``), and its experts run
dropless (``moe.moe_dropless``) wherever it serves.

Parameters keep the JAX package's pytree: per-layer weights stacked on
axis 0 (twice for hybrid's (groups, period) Mamba2 blocks), and a Python
loop over layers replaces ``lax.scan``.  Each stacked leaf is split into
its layers by one ``torch.unbind`` (``_unstack``): under autograd its
backward stacks the layers' gradients once, where a select per layer would
give back a zero tensor the size of the whole stack for each layer.  Caches
have the JAX layouts and are updated in place (the JAX functions return
fresh arrays; these return the same tensors, written).

The training half (``loss_fn``: ``_backbone`` or the enc-dec stacks, the
final norm and ``chunked_loss``) wraps each layer in
``torch.utils.checkpoint`` when ``cfg.remat``, as JAX wraps it in
``jax.checkpoint``, and each loss chunk always: the backward recomputes
one chunk's logits at a time, so no (B, S, V) f32 logits are ever held.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels.decode_attention.ops import (paged_decode_attention,
                                            paged_mla_decode_attention)
from ..parallel import ctx as pctx
from . import trace
from . import xlstm as xl
from .layers import (ParamInit, apply_rope, attention_apply,
                     decode_attention, dense, embed, mla_absorb_out,
                     mla_absorb_query, mla_attention, mla_decode_plain,
                     mla_project, mla_rope_tables, mla_scale, mlp_apply,
                     rmsnorm, rope_tables)
from .moe import moe_apply, moe_dropless, moe_init
from .ssm import mamba2_apply, mamba2_init


def _attention_family(cfg: ModelConfig, what: str) -> None:
    """The JAX entry points' refusal of the recurrent, enc-dec and
    capacity-routed MoE families (``init_paged_cache``,
    ``chunk_prefill_fn``, ``paged_decode_fn``, ``prefill_from_cache``), in
    their words; a latent-attention model (its experts dropless) is
    served."""
    if cfg.family not in ("dense", "vlm") and cfg.mla is None:
        raise ValueError(f"{what} unsupported for family {cfg.family}")


def kv_names(cfg: ModelConfig) -> tuple:
    """The per-token cache tensors of an attention model, in the order the
    chunked prefill returns them and the engine stages them: K and V, or
    latent attention's one latent row."""
    return ("c",) if cfg.mla is not None else ("k", "v")


def cache_widths(cfg: ModelConfig) -> tuple:
    """A cached token's trailing shape in each of ``kv_names``: (Hkv, hd)
    for K and V, (r + dr,) for the latent."""
    if cfg.mla is not None:
        return ((cfg.mla.latent_dim,),)
    return ((cfg.n_kv_heads, cfg.resolved_head_dim),) * 2


def empty_prefix(cfg: ModelConfig, batch: int, device=None) -> tuple:
    """A prefix of no tokens for the chunked prefill: one (L, B, 0, ...)
    bf16 tensor per ``kv_names``."""
    return tuple(torch.zeros((cfg.n_layers, batch, 0) + w,
                             dtype=torch.bfloat16, device=device)
                 for w in cache_widths(cfg))


# ===========================================================================
# Parameter init
# ===========================================================================

def _attention_init(init: ParamInit, cfg: ModelConfig, lead, bias):
    if cfg.mla is not None:
        return init.mla(lead, cfg)
    return init.attention(lead, cfg, bias)


def _dense_layer(init: ParamInit, cfg: ModelConfig, d_ff: int, lead=(),
                 bias: bool | None = None) -> dict:
    return {"ln1": init.rmsnorm(lead, cfg.d_model),
            "attn": _attention_init(init, cfg, lead, cfg.qkv_bias
                                    if bias is None else bias),
            "ln2": init.rmsnorm(lead, cfg.d_model),
            "mlp": init.mlp(lead, cfg.d_model, d_ff)}


def _moe_layer(init: ParamInit, cfg: ModelConfig, lead=()) -> dict:
    return {"ln1": init.rmsnorm(lead, cfg.d_model),
            "attn": _attention_init(init, cfg, lead, cfg.qkv_bias),
            "ln2": init.rmsnorm(lead, cfg.d_model),
            "moe": moe_init(init, cfg.d_model, cfg.moe, lead)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random-init parameters with the JAX package's tree, shapes, scales
    and dtypes (normal / sqrt(d_in) weights, 0.02 embeddings, unit norms),
    drawn from ``generator`` on ``device`` (CUDA unless ``"cpu"`` is
    passed; the generator must live on the same device).  Weights are
    drawn in bounded slices (``layers.ParamInit``), so a full-width model
    needs no f32 copy of a stacked tensor."""
    device = resolve_device(device)
    init = ParamInit(generator, device)
    d, fam = cfg.d_model, cfg.family
    params: dict = {"final_ln": init.rmsnorm((), d)}
    if cfg.embed_inputs or fam in ("vlm", "encdec", "audio"):
        params["embed"] = {"emb": init.normal((cfg.vocab, d), 0.02)}
    if not cfg.tie_embeddings:
        params["unembed"] = init.dense((), d, cfg.vocab)

    if fam in ("dense", "vlm"):
        params["layers"] = _dense_layer(init, cfg, cfg.d_ff, (cfg.n_layers,))
    elif fam == "moe":
        period = cfg.moe.layer_period
        if period == 1:
            # layer 0 dense (DeepSeek-MoE), rest MoE
            params["dense0"] = _dense_layer(init, cfg, cfg.d_ff)
            params["layers"] = _moe_layer(init, cfg, (cfg.n_layers - 1,))
        else:
            # interleaved dense/MoE units (llama4: period 2)
            n_units = cfg.n_layers // period
            params["dense_layers"] = _dense_layer(init, cfg, cfg.d_ff,
                                                  (n_units,))
            params["layers"] = _moe_layer(init, cfg, (n_units,))
    elif fam == "hybrid":
        period = cfg.ssm.attn_period
        lead = (cfg.n_layers // period, period)
        params["layers"] = {"ln": init.rmsnorm(lead, d),
                            "mamba": mamba2_init(init, d, cfg.ssm, lead)}
        params["shared_attn"] = _dense_layer(init, cfg, cfg.d_ff)
    elif fam == "ssm":          # xlstm
        lead = (cfg.n_layers // 2,)
        params["layers"] = {
            "m_ln": init.rmsnorm(lead, d),
            "mlstm": xl.mlstm_init(init, d, cfg.n_heads,
                                   cfg.xlstm.proj_factor, lead),
            "s_ln": init.rmsnorm(lead, d),
            "slstm": xl.slstm_init(init, d, cfg.n_heads, lead)}
    elif fam == "encdec":
        params["encoder"] = _dense_layer(init, cfg, cfg.d_ff,
                                         (cfg.encoder_layers,), bias=False)
        lead = (cfg.n_layers,)
        params["layers"] = {
            "ln1": init.rmsnorm(lead, d),
            "self_attn": init.attention(lead, cfg),
            "ln_x": init.rmsnorm(lead, d),
            "cross_attn": init.attention(lead, cfg),
            "ln2": init.rmsnorm(lead, d),
            "mlp": init.mlp(lead, d, cfg.d_ff)}
    else:
        raise ValueError(f"unknown family {fam}")
    return params


def init_abstract(cfg: ModelConfig) -> dict:
    """The parameter tree on the ``meta`` device: shapes and dtypes, no
    allocation (the dry-run's ``jax.eval_shape`` of ``init_params``)."""
    return init_params(cfg, None, "meta")


def _unstack(tree) -> list:
    """The layers of a stacked tree (each leaf split along axis 0 by one
    ``torch.unbind``), one dict per layer: what ``lax.scan`` hands its
    body."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree))


def _layers(params: dict, key: str = "layers") -> list:
    return _unstack(params[key])


def layer_params(params: dict, i: int, key: str = "layers") -> dict:
    """Layer ``i`` of the stacked ``params[key]``."""
    return _layers(params, key)[i]


def _attention_layers(cfg: ModelConfig, params: dict) -> list:
    """(layer params, cache index) of every attention layer of the dense,
    vlm and moe families, in the order they run.  MoE with period 1 runs
    ``dense0`` first; with period 2, unit u runs its dense layer (cache u)
    then its MoE layer (cache n_units + u): dense caches first, MoE caches
    second, as the JAX stack holds them."""
    if cfg.family == "moe" and cfg.moe.layer_period == 1:
        return [(params["dense0"], 0)] + [
            (lp, i + 1) for i, lp in enumerate(_layers(params))]
    if cfg.family == "moe":
        dense_l, moe_l = _layers(params, "dense_layers"), _layers(params)
        nu = len(moe_l)
        return [pair for u in range(nu)
                for pair in ((dense_l[u], u), (moe_l[u], nu + u))]
    return [(lp, i) for i, lp in enumerate(_layers(params))]


def _ffn(cfg, lp, h, n_rows: int | None = None):
    """The block's second half: the dense MLP or the MoE layer.  A
    latent-attention model's experts run dropless over the first
    ``n_rows`` rows (all when None; the padding rows after them get no
    expert output); the others keep the JAX package's capacity routing."""
    x = rmsnorm(lp["ln2"], h, cfg.norm_eps)
    if "mlp" in lp:
        return h + mlp_apply(lp["mlp"], x)
    if cfg.mla is not None:
        return h + moe_dropless(lp["moe"], x, cfg.moe, n_rows)
    out, _ = moe_apply(lp["moe"], x, cfg.moe)
    return h + out


def _unembed_matrix(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"]["emb"].T
    return params["unembed"]["w"]


def _logits(cfg, params, h_last):
    """Final norm + vocab projection of (B, D) hidden rows -> f32 logits."""
    h_last = rmsnorm(params["final_ln"], h_last, cfg.norm_eps)
    return pctx.matmul(h_last, _unembed_matrix(cfg, params)).float()


def _inputs(cfg, params, batch):
    """The prefill's input rows: embedded tokens, or the precomputed
    embeddings of a model whose inputs are not tokens (vlm)."""
    if cfg.embed_inputs:
        return embed(params["embed"], batch["tokens"])
    return batch["embeds"]


# ===========================================================================
# Training: blocks, the cache-less backbone, the chunked loss
# ===========================================================================

#: sequence positions of one loss chunk (``transformer.LOSS_CHUNK``)
LOSS_CHUNK = 512


def _maybe_remat(fn, cfg):
    """``fn``, recomputed in the backward instead of saving its
    activations when ``cfg.remat`` (``jax.checkpoint``)."""
    if not cfg.remat:
        return fn

    def remat(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return remat


def _self_attention(cfg, p, xn):
    """Causal self-attention of a whole sequence (no cache)."""
    if cfg.mla is not None:
        positions = torch.arange(xn.shape[1], device=xn.device)[None, :]
        return mla_attention(p, xn, cfg,
                             mla_rope_tables(positions, cfg, xn.device))[0]
    return attention_apply(p, xn, cfg)[0]


def _dense_block(cfg):
    def block(x, lp):
        x = x + _self_attention(cfg, lp["attn"],
                                rmsnorm(lp["ln1"], x, cfg.norm_eps))
        return x + mlp_apply(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return block


def _moe_block(cfg):
    def block(x, aux, lp):
        x = x + _self_attention(cfg, lp["attn"],
                                rmsnorm(lp["ln1"], x, cfg.norm_eps))
        h, aux_l = moe_apply(lp["moe"], rmsnorm(lp["ln2"], x, cfg.norm_eps),
                             cfg.moe)
        return x + h, aux + aux_l
    return block


def _backbone(cfg: ModelConfig, params, x):
    """Hidden states after the layer stack.  x: (B, S, D).  Returns
    (hidden, aux_loss)."""
    fam = cfg.family
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = pctx.shard_hidden(x)
    if fam in ("dense", "vlm"):
        blk = _maybe_remat(_dense_block(cfg), cfg)
        for lp in _layers(params):
            x = blk(x, lp)
    elif fam == "moe":
        mblk = _maybe_remat(_moe_block(cfg), cfg)
        dblk = _maybe_remat(_dense_block(cfg), cfg)
        if cfg.moe.layer_period == 1:
            x = dblk(x, params["dense0"])
            for lp in _layers(params):
                x, aux = mblk(x, aux, lp)
        else:
            for dlp, mlp_ in zip(_layers(params, "dense_layers"),
                                 _layers(params)):
                x = dblk(x, dlp)
                x, aux = mblk(x, aux, mlp_)
    elif fam == "hybrid":
        shared = params["shared_attn"]

        def mamba_block(h, lp):
            y, _, _ = mamba2_apply(lp["mamba"],
                                   rmsnorm(lp["ln"], h, cfg.norm_eps), cfg.ssm)
            return h + y
        mamba_block = _maybe_remat(mamba_block, cfg)
        attn_block = _maybe_remat(_dense_block(cfg), cfg)
        for glp in _layers(params):
            for lp in _unstack(glp):
                x = mamba_block(x, lp)
            x = attn_block(x, shared)
    elif fam == "ssm":
        def pair(h, lp):
            y, _ = xl.mlstm_apply(lp["mlstm"],
                                  rmsnorm(lp["m_ln"], h, cfg.norm_eps),
                                  cfg.n_heads, chunk=cfg.xlstm.chunk)
            h = h + y
            y, _ = xl.slstm_apply(lp["slstm"],
                                  rmsnorm(lp["s_ln"], h, cfg.norm_eps))
            return h + y
        pair = _maybe_remat(pair, cfg)
        for lp in _layers(params):
            x = pair(x, lp)
    else:
        raise ValueError(fam)
    return x, aux


def _decode_stack(cfg, params, x, memory):
    """The enc-dec decoder over the whole sequence: causal self-attention,
    cross-attention over ``memory``, MLP."""
    def dec_block(h, lp, memory):
        a, _ = attention_apply(lp["self_attn"],
                               rmsnorm(lp["ln1"], h, cfg.norm_eps), cfg)
        h = h + a
        a, _ = attention_apply(lp["cross_attn"],
                               rmsnorm(lp["ln_x"], h, cfg.norm_eps), cfg,
                               memory=memory)
        h = h + a
        return h + mlp_apply(lp["mlp"], rmsnorm(lp["ln2"], h, cfg.norm_eps))
    blk = _maybe_remat(dec_block, cfg)
    for lp in _layers(params):
        x = blk(x, lp, memory)
    return x


def _chunk_nll(h, labels, w):
    """(summed token NLL, token count) of one chunk, in f32."""
    logits = pctx.shard_logits(pctx.matmul(h, w).float())
    logz = torch.logsumexp(logits, dim=-1)
    gold = pctx.gather_vocab(
        logits, torch.clamp(labels, min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).float()
    return ((logz - gold) * mask).sum(), mask.sum()


def chunked_loss(cfg, params, hidden, labels):
    """Cross-entropy over sequence chunks of ``LOSS_CHUNK`` (labels padded
    with -1); each chunk is recomputed in the backward, so neither pass
    holds (B, S, V) f32 logits."""
    w = _unembed_matrix(cfg, params)
    b, s, d = hidden.shape
    chunk = min(LOSS_CHUNK, s)
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    # cut once (JAX's reshape + scan): the backward joins the chunks'
    # gradients once, where slicing each chunk out would write a zeroed
    # full-length gradient a chunk
    for h, lab in zip(torch.split(hidden, chunk, dim=1),
                      torch.split(labels, chunk, dim=1)):
        t, n = checkpoint(_chunk_nll, h, lab, w, use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(cfg: ModelConfig):
    """Returns f(params, batch) -> scalar loss.

    batch: {"tokens": (B,S) int} or {"embeds": (B,S,D)} (+ "enc_embeds"
    for enc-dec), and "labels": (B,S) int (-1 = ignore).  MoE adds 0.01
    times the layers' load-balancing loss.
    """
    def f(params, batch):
        if cfg.family == "encdec":
            memory = _encode(cfg, params, batch["enc_embeds"])
            x = embed(params["embed"], batch["tokens"])
            hidden = _decode_stack(cfg, params, x, memory)
        else:
            hidden, aux = _backbone(cfg, params, _inputs(cfg, params, batch))
        hidden = rmsnorm(params["final_ln"], hidden, cfg.norm_eps)
        loss = chunked_loss(cfg, params, hidden, batch["labels"])
        if cfg.family == "moe":
            loss = loss + 0.01 * aux
        return loss
    return f


# ---------------------------------------------------------------------------
# Serving: contiguous cache init / prefill / decode-step
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               dtype=torch.bfloat16):
    """Zero cache with the JAX layouts: stacked KV for the attention
    families, (groups, period) SSM/conv states plus the shared attention's
    KV for hybrid, stacked recurrent states for xLSTM, self- and cross-KV
    (padded to ``max_len``, ``enc_len`` deep) for enc-dec.  KV and conv
    states are in ``dtype`` (the activations' dtype, as a JAX prefill
    makes them); recurrent states are f32."""
    device = resolve_device(device)
    hd, fam = cfg.resolved_head_dim, cfg.family
    bf, f32 = dtype, torch.float32

    def zeros(shape, dtype=bf):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv(n):
        return zeros((n, batch, max_len, cfg.n_kv_heads, hd))

    length = zeros((batch,), torch.int32)
    if cfg.mla is not None:
        return {"c": zeros((cfg.n_layers, batch, max_len,
                            cfg.mla.latent_dim)), "len": length}
    if fam in ("dense", "vlm", "moe"):
        return {"k": kv(cfg.n_layers), "v": kv(cfg.n_layers), "len": length}
    if fam == "hybrid":
        period = cfg.ssm.attn_period
        groups = cfg.n_layers // period
        d_inner = cfg.ssm.expand * cfg.d_model
        n_heads = cfg.ssm.n_ssm_heads or max(1, d_inner // 64)
        return {"ssm": zeros((groups, period, batch, n_heads,
                              d_inner // n_heads, cfg.ssm.state_dim), f32),
                "conv": zeros((groups, period, batch,
                               cfg.ssm.conv_width - 1, d_inner)),
                "k": kv(groups), "v": kv(groups), "len": length}
    if fam == "ssm":
        pairs, d = cfg.n_layers // 2, cfg.d_model
        hd_m = int(cfg.xlstm.proj_factor * d) // cfg.n_heads

        def full(shape):
            return torch.full(shape, -1e30, dtype=f32, device=device)
        return {"C": zeros((pairs, batch, cfg.n_heads, hd_m, hd_m), f32),
                "n": zeros((pairs, batch, cfg.n_heads, hd_m), f32),
                "m": full((pairs, batch, cfg.n_heads)),
                "sc": zeros((pairs, batch, d), f32),
                "sn": zeros((pairs, batch, d), f32),
                "sm": full((pairs, batch, d)),
                "sh": zeros((pairs, batch, d), f32),
                "len": length}
    if fam == "encdec":
        return {"k": kv(cfg.n_layers), "v": kv(cfg.n_layers),
                "ck": kv(cfg.n_layers), "cv": kv(cfg.n_layers),
                "len": length,
                "enc_len": torch.full((batch,), max_len, dtype=torch.int32,
                                      device=device)}
    raise ValueError(fam)


def decode_fn(cfg: ModelConfig):
    """Returns f(params, cache, tokens) -> (logits, cache).

    tokens: (B,) int — the latest token per sequence.  ``cache["len"]``
    holds the current context length per sequence.  Every attention
    (self- and cross-) runs through the port's flash-decode kernel on the
    card, every norm but Mamba2's gated one through its RMSNorm kernel.
    """
    fam = cfg.family
    if fam not in ("dense", "vlm", "moe", "hybrid", "ssm", "encdec"):
        raise ValueError(fam)
    hd = cfg.resolved_head_dim

    def self_attn(p, ln, h, kc, vc, length):
        a, _ = attention_apply(p, rmsnorm(ln, h, cfg.norm_eps), cfg,
                               positions=length[:, None], kv_cache=(kc, vc),
                               length=length)
        return h + a

    def latent_attn(p, ln, h, cc, length, rope):
        """The absorbed latent attention over the contiguous cache, in
        plain torch: the new token's latent row written at ``length``."""
        q_nope, q_pe, lat = mla_project(p, rmsnorm(ln, h, cfg.norm_eps), cfg,
                                        rope)
        rows = torch.arange(h.shape[0], device=h.device)
        pctx.write_rows(cc, rows, length.long(), lat[:, 0].to(cc.dtype))
        q = mla_absorb_query(p, q_nope[:, 0], q_pe[:, 0], cfg)
        o = mla_decode_plain(q, cc, length + 1, mla_scale(cfg),
                             cfg.mla.kv_lora_rank)
        return h + mla_absorb_out(p, o, cfg)

    def f(params, cache, tokens):
        h = embed(params["embed"], tokens[:, None])
        length = cache["len"]
        if cfg.mla is not None:
            rope = mla_rope_tables(length[:, None], cfg, h.device)
            for lp, i in _attention_layers(cfg, params):
                h = latent_attn(lp["attn"], lp["ln1"], h, cache["c"][i],
                                length, rope)
                h = _ffn(cfg, lp, h)
        elif fam in ("dense", "vlm", "moe"):
            for lp, i in _attention_layers(cfg, params):
                h = self_attn(lp["attn"], lp["ln1"], h, cache["k"][i],
                              cache["v"][i], length)
                h = _ffn(cfg, lp, h)
        elif fam == "hybrid":
            shared = params["shared_attn"]
            for g, glp in enumerate(_layers(params)):
                for j, lp in enumerate(_unstack(glp)):
                    y, st, cst = mamba2_apply(
                        lp["mamba"], rmsnorm(lp["ln"], h, cfg.norm_eps),
                        cfg.ssm,
                        state=cache["ssm"][g, j], conv_state=cache["conv"][g, j])
                    h = h + y
                    cache["ssm"][g, j] = st
                    cache["conv"][g, j] = cst
                h = self_attn(shared["attn"], shared["ln1"], h, cache["k"][g],
                              cache["v"][g], length)
                h = _ffn(cfg, shared, h)
        elif fam == "ssm":
            for i, lp in enumerate(_layers(params)):
                y, mst = xl.mlstm_apply(
                    lp["mlstm"], rmsnorm(lp["m_ln"], h, cfg.norm_eps),
                    cfg.n_heads,
                    state=(cache["C"][i], cache["n"][i], cache["m"][i]))
                h = h + y
                y, sst = xl.slstm_apply(
                    lp["slstm"], rmsnorm(lp["s_ln"], h, cfg.norm_eps),
                    state=(cache["sc"][i], cache["sn"][i], cache["sm"][i],
                           cache["sh"][i]))
                h = h + y
                for name, t in zip(("C", "n", "m", "sc", "sn", "sm", "sh"),
                                   mst + sst):
                    cache[name][i] = t
        else:                                   # encdec
            for i, lp in enumerate(_layers(params)):
                h = self_attn(lp["self_attn"], lp["ln1"], h, cache["k"][i],
                              cache["v"][i], length)
                # cross-attention reads the precomputed memory KV directly
                b = h.shape[0]
                xq = dense(lp["cross_attn"]["wq"],
                           rmsnorm(lp["ln_x"], h, cfg.norm_eps))
                a2 = decode_attention(pctx.reshape(xq, (b, cfg.n_heads, hd)),
                                      cache["ck"][i], cache["cv"][i],
                                      cache["enc_len"])
                h = h + pctx.shard_hidden(dense(
                    lp["cross_attn"]["wo"],
                    pctx.reshape(a2, (b, 1, cfg.n_heads * hd))))
                h = h + mlp_apply(lp["mlp"],
                                  rmsnorm(lp["ln2"], h, cfg.norm_eps))
        cache = dict(cache, len=length + 1)
        return _logits(cfg, params, h[:, 0]), cache
    return f


def _encode(cfg, params, enc_embeds):
    """The encoder stack: each block attends over its own normed input."""
    def enc_block(h, lp):
        xn = rmsnorm(lp["ln1"], h, cfg.norm_eps)
        a, _ = attention_apply(lp["attn"], xn, cfg, memory=xn)
        h = h + a
        return h + mlp_apply(lp["mlp"], rmsnorm(lp["ln2"], h, cfg.norm_eps))
    blk = _maybe_remat(enc_block, cfg)
    h = enc_embeds
    for lp in _layers(params, "encoder"):
        h = blk(h, lp)
    return h


def prefill_fn(cfg: ModelConfig):
    """Returns f(params, batch, max_len) -> (last-token logits, cache).

    ``batch`` holds ``tokens`` (B, S), or ``embeds`` (B, S, D) for a model
    whose inputs are not tokens (vlm), plus ``enc_embeds`` (B, Sm, D) for
    enc-dec.  The cache is fully populated so ``decode_fn`` can continue
    generation: KV for the attention families, SSM/conv states and the
    shared attention's KV for hybrid, recurrent states for xLSTM, self- and
    cross-KV for enc-dec.
    """
    fam = cfg.family
    if fam not in ("dense", "vlm", "moe", "hybrid", "ssm", "encdec"):
        raise ValueError(fam)

    def attn_block(p, ln, h):
        a, (k, v) = attention_apply(p, rmsnorm(ln, h, cfg.norm_eps), cfg,
                                    kv_out=True)
        return h + a, k, v

    def f(params, batch, max_len: int):
        if fam == "encdec":
            memory = _encode(cfg, params, batch["enc_embeds"])
            h = embed(params["embed"], batch["tokens"])
        else:
            h = _inputs(cfg, params, batch)
        b, s = h.shape[0], h.shape[1]
        cache = pctx.place_cache(init_cache(cfg, b, max_len, h.device,
                                            h.dtype), b)
        if cfg.mla is not None:
            logits, lat = _prefix_prefill(cfg, params, h,
                                          empty_prefix(cfg, b, h.device),
                                          s - 1, None)
            cache["c"][:, :, :s] = lat
            cache["len"].fill_(s)
            return logits, cache
        if fam in ("dense", "vlm", "moe"):
            for lp, i in _attention_layers(cfg, params):
                h, k, v = attn_block(lp["attn"], lp["ln1"], h)
                pctx.write_prefix(cache["k"][i], k)
                pctx.write_prefix(cache["v"][i], v)
                h = _ffn(cfg, lp, h)
        elif fam == "hybrid":
            shared = params["shared_attn"]
            for g, glp in enumerate(_layers(params)):
                for j, lp in enumerate(_unstack(glp)):
                    y, st, cst = mamba2_apply(lp["mamba"],
                                              rmsnorm(lp["ln"], h,
                                                      cfg.norm_eps), cfg.ssm)
                    h = h + y
                    cache["ssm"][g, j], cache["conv"][g, j] = st, cst
                h, k, v = attn_block(shared["attn"], shared["ln1"], h)
                pctx.write_prefix(cache["k"][g], k)
                pctx.write_prefix(cache["v"][g], v)
                h = _ffn(cfg, shared, h)
        elif fam == "ssm":
            for i, lp in enumerate(_layers(params)):
                y, mst = xl.mlstm_apply(lp["mlstm"],
                                        rmsnorm(lp["m_ln"], h, cfg.norm_eps),
                                        cfg.n_heads, chunk=cfg.xlstm.chunk)
                h = h + y
                y, sst = xl.slstm_apply(lp["slstm"],
                                        rmsnorm(lp["s_ln"], h, cfg.norm_eps))
                h = h + y
                for name, t in zip(("C", "n", "m", "sc", "sn", "sm", "sh"),
                                   mst + sst):
                    cache[name][i] = t
        else:                                   # encdec
            sm = memory.shape[1]
            for i, lp in enumerate(_layers(params)):
                h, k, v = attn_block(lp["self_attn"], lp["ln1"], h)
                pctx.write_prefix(cache["k"][i], k)
                pctx.write_prefix(cache["v"][i], v)
                a, (ck, cv) = attention_apply(
                    lp["cross_attn"], rmsnorm(lp["ln_x"], h, cfg.norm_eps),
                    cfg,
                    memory=memory, kv_out=True)
                h = h + a
                pctx.write_prefix(cache["ck"][i], ck)
                pctx.write_prefix(cache["cv"][i], cv)
                h = h + mlp_apply(lp["mlp"],
                                  rmsnorm(lp["ln2"], h, cfg.norm_eps))
            cache["enc_len"].fill_(sm)
        cache["len"].fill_(s)
        return _logits(cfg, params, h[:, -1]), cache
    return f


# ---------------------------------------------------------------------------
# Serving: paged arena, chunked prefill, batched paged decode
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     device=None):
    """Zero paged KV pool: one shared page arena per unit.

    Sequences own non-contiguous pages through per-sequence block tables
    (kept host-side by the engine); ``chunk_prefill_fn`` output is written
    into pages and ``paged_decode_fn`` appends + attends through the
    tables.  Attention families only (dense/vlm, and latent attention).

    ``kp`` and ``vp`` are (L, NP, PS, Hkv, hd) K and V pools.  With latent
    attention ``kp`` is the one (L, NP, PS, r + dr) pool of latent rows
    [c_kv | k_pe], the keys of its absorbed decode, and ``vp`` a view of
    its first r columns, the values (DESIGN.md §2.14): written once
    through ``kp``.
    """
    _attention_family(cfg, "paged cache")
    device = resolve_device(device)
    if cfg.mla is not None:
        kp = torch.zeros((cfg.n_layers, n_pages, page_size,
                          cfg.mla.latent_dim), dtype=torch.bfloat16,
                         device=device)
        return {"kp": kp, "vp": kp[..., :cfg.mla.kv_lora_rank]}
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"kp": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "vp": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def _prefix_prefill(cfg, params, h, prefix, last: int,
                    kv_len: int | None):
    """Shared body of ``chunk_prefill_fn``, ``prefill_from_cache`` and
    latent attention's ``prefill_fn``: (logits at position ``last``, the
    new rows' cache tensors stacked over layers, one per ``kv_names``).
    ``prefix`` holds the earlier tokens' cache tensors (L, B, P, ...).
    Rows past ``last`` trail as padding: on the card the attention
    computes none of them, nor (latent attention) do the experts.  The
    positions and their RoPE tables are made once for every layer."""
    p_len, s = prefix[0].shape[2], h.shape[1]
    n_rows = last % s + 1
    positions = torch.arange(s, device=h.device)[None, :] + p_len
    if cfg.mla is not None:
        rope = mla_rope_tables(positions, cfg, h.device)
        # each layer decompresses the prefix's and the real rows' latent
        trace.count("mla_expand_tokens", h.shape[0] * (p_len + n_rows))
        lats = []
        for lp, i in _attention_layers(cfg, params):
            a, lat = mla_attention(lp["attn"],
                                   rmsnorm(lp["ln1"], h, cfg.norm_eps), cfg,
                                   rope, prefix[0][i], n_rows)
            h = _ffn(cfg, lp, h + a, n_rows)
            lats.append(lat)
        return _logits(cfg, params, h[:, last]), torch.stack(lats)
    prefix_k, prefix_v = prefix
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta,
                       h.device)
    ks, vs = [], []
    for i, lp in enumerate(_layers(params)):
        a, (k, v) = attention_apply(lp["attn"],
                                    rmsnorm(lp["ln1"], h, cfg.norm_eps), cfg,
                                    positions=positions, kv_out=True,
                                    prefix_kv=(prefix_k[i], prefix_v[i]),
                                    q_offset=p_len, kv_len=kv_len,
                                    n_rows=n_rows, rope=rope)
        h = h + a
        h = h + mlp_apply(lp["mlp"], rmsnorm(lp["ln2"], h, cfg.norm_eps))
        ks.append(k)
        vs.append(v)
    return _logits(cfg, params, h[:, last]), torch.stack(ks), torch.stack(vs)


def chunk_prefill_fn(cfg: ModelConfig):
    """Returns f(params, tokens, prefix_k, prefix_v, last=-1, kv_len=None)
    -> (logits, k_new, v_new); with latent attention f(params, tokens,
    prefix_c, last=-1, kv_len=None) -> (logits, c_new).

    One chunk of a chunked prefill: ``tokens`` (B, C) is the next C prompt
    tokens, ``prefix_k``/``prefix_v`` (L, B, P, Hkv, hd) the KV of the P
    tokens already prefilled (``prefix_c`` (L, B, P, r + dr) their latent
    rows).  Returns the logits at chunk position ``last`` plus the KV (the
    latent) of only the new chunk (L, B, C, ...).

    ``last`` and ``kv_len`` let a caller pad a chunk to a fixed shape:
    trailing pad tokens sit after every real one, so the causal mask hides
    them from the real tokens, and ``last`` picks the last real position.
    On the card the attention reads no key past ``last`` and gives the
    rows after it zeros (``layers.attention_apply``), so their K/V differ
    from the CPU's from the second layer on; the real rows' do not.  A
    latent-attention model's experts compute no padding row (they get no
    expert output), on the card and on the CPU, and ``kv_len`` has no use
    there: its attention reads the prefix and the real rows only.
    """
    _attention_family(cfg, "chunked prefill")

    def f(params, tokens, *prefix, last: int = -1, kv_len: int | None = None):
        if len(prefix) != len(kv_names(cfg)):
            raise TypeError(f"a chunk takes the prefix's {kv_names(cfg)}, "
                            f"then last and kv_len by name")
        return _prefix_prefill(cfg, params, embed(params["embed"], tokens),
                               prefix, last, kv_len)
    return f


def paged_decode_fn(cfg: ModelConfig):
    """Returns f(params, kp, vp, tables, lens, tokens, n_rows=None)
    -> (logits, kp, vp).

    Batched single-step decode over the paged KV pool: ``tokens`` (B,) are
    the latest tokens of B independent sequences, ``tables`` (B, MP) int32
    their page tables into the (L, NP, PS, Hkv, hd) pools and ``lens``
    (B,) int32 their context lengths.  Each step writes the new KV into
    page ``tables[b, len // PS]`` slot ``len % PS`` *before* attending over
    ``len + 1`` positions through the block tables, in place.

    With latent attention ``kp`` is the latent pool (``init_paged_cache``):
    each step writes the new latent row and attends in the absorbed form
    through the paged kernel's latent instance; ``n_rows`` (the real
    rows, first; all when None) bounds what its experts compute.
    """
    _attention_family(cfg, "paged decode")
    if cfg.sliding_window:
        raise ValueError("paged decode does not support sliding windows")
    hd = cfg.resolved_head_dim
    h_, hkv = cfg.n_heads, cfg.n_kv_heads

    def where(tables, lens, ps):
        rows = torch.arange(tables.shape[0], device=tables.device)
        page = tables[rows, (lens // ps).long()].long()      # (B,)
        return page, (lens % ps).long(), (lens + 1).to(torch.int32)

    def f_mla(params, kp, vp, tables, lens, tokens, n_rows=None):
        h = embed(params["embed"], tokens[:, None])          # (B, 1, D)
        page, slot, lens1 = where(tables, lens, kp.shape[2])
        rope = mla_rope_tables(lens[:, None], cfg, h.device)
        sigma, r = mla_scale(cfg), cfg.mla.kv_lora_rank
        for lp, i in _attention_layers(cfg, params):
            at = lp["attn"]
            q_nope, q_pe, lat = mla_project(
                at, rmsnorm(lp["ln1"], h, cfg.norm_eps), cfg, rope)
            kp[i][page, slot] = lat[:, 0].to(kp.dtype)
            q = mla_absorb_query(at, q_nope[:, 0], q_pe[:, 0], cfg)
            o = paged_mla_decode_attention(q, kp[i], tables, lens1, sigma, r)
            h = _ffn(cfg, lp, h + mla_absorb_out(at, o, cfg), n_rows)
        return _logits(cfg, params, h[:, 0]), kp, vp

    def f(params, kp, vp, tables, lens, tokens):
        h = embed(params["embed"], tokens[:, None])          # (B, 1, D)
        b = h.shape[0]
        positions = lens[:, None]
        page, slot, lens1 = where(tables, lens, kp.shape[2])
        for i, lp in enumerate(_layers(params)):
            at = lp["attn"]
            xn = rmsnorm(lp["ln1"], h, cfg.norm_eps)
            q = apply_rope(dense(at["wq"], xn).reshape(b, 1, h_, hd),
                           positions, cfg.rope_theta)
            k_new = apply_rope(dense(at["wk"], xn).reshape(b, 1, hkv, hd),
                               positions, cfg.rope_theta)
            v_new = dense(at["wv"], xn).reshape(b, 1, hkv, hd)
            kc, vc = kp[i], vp[i]
            kc[page, slot] = k_new[:, 0].to(kc.dtype)
            vc[page, slot] = v_new[:, 0].to(vc.dtype)
            a = paged_decode_attention(q[:, 0].contiguous(), kc, vc, tables,
                                       lens1)
            h = h + dense(at["wo"], a.reshape(b, 1, h_ * hd))
            h = h + mlp_apply(lp["mlp"], rmsnorm(lp["ln2"], h, cfg.norm_eps))
        return _logits(cfg, params, h[:, 0]), kp, vp
    return f_mla if cfg.mla is not None else f


def prefill_from_cache(cfg: ModelConfig):
    """Returns f(params, batch, prefix_k, prefix_v, max_len) -> (logits, cache)
    (with latent attention f(params, batch, prefix_c, max_len)).

    Prefill that attaches to a cached prompt prefix: ``batch["tokens"]``
    (or ``batch["embeds"]`` for vlm) holds only the uncached suffix (B, S);
    ``prefix_k``/``prefix_v`` are (L, B, P, Hkv, hd) KV for the first P
    prompt tokens (RoPE already applied; ``prefix_c`` their latent rows).
    The returned cache covers the full P+S context so ``decode_fn``
    continues identically to a cold prefill.  Sequence-local attention
    families only (dense/vlm, and latent attention).
    """
    _attention_family(cfg, "prefix-cached prefill")
    names = kv_names(cfg)

    def f(params, batch, *rest):
        *prefix, max_len = rest
        h = _inputs(cfg, params, batch)
        b, s = h.shape[0], h.shape[1]
        p_len = prefix[0].shape[2]
        logits, *new = _prefix_prefill(cfg, params, h, prefix, -1, None)
        cache = init_cache(cfg, b, max_len, h.device, h.dtype)
        for name, old, part in zip(names, prefix, new):
            cache[name][:, :, :p_len] = old
            cache[name][:, :, p_len:p_len + s] = part
        cache["len"].fill_(p_len + s)
        return logits, cache
    return f
