"""Dense serving model in PyTorch, mirroring ``repro.models.transformer``.

Only the dense family (smollm, llama-style) is ported.  Parameters keep
the JAX package's pytree: ``params["layers"]`` holds every per-layer
weight stacked on axis 0, and a Python loop over layers replaces
``lax.scan``.  KV caches and the paged arena are updated in place (the JAX
functions return fresh arrays; these return the same tensors, written).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels.decode_attention.ops import paged_decode_attention
from .layers import (apply_rope, attention_apply, dense, embed, mlp_apply,
                     rmsnorm)


def _check_dense(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "dense":
        raise ValueError(f"{what} is ported for the dense family only, "
                         f"not {cfg.family}")


# ===========================================================================
# Parameter init
# ===========================================================================

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random-init parameters with the JAX package's shapes, scales and
    dtypes (normal / sqrt(d_in) weights, 0.02 embeddings, unit norms),
    drawn from ``generator`` on ``device`` (CUDA unless ``"cpu"`` is
    passed; the generator must live on the same device)."""
    _check_dense(cfg, "init_params")
    device = resolve_device(device)
    bf = torch.bfloat16
    d, L = cfg.d_model, cfg.n_layers
    hd = cfg.resolved_head_dim

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * std).to(bf)

    def dense_w(d_in, d_out):
        return {"w": normal((L, d_in, d_out), 1.0 / math.sqrt(d_in))}

    def ones(shape):
        return {"scale": torch.ones(shape, dtype=bf, device=device)}

    attn = {"wq": dense_w(d, cfg.n_heads * hd),
            "wk": dense_w(d, cfg.n_kv_heads * hd),
            "wv": dense_w(d, cfg.n_kv_heads * hd),
            "wo": dense_w(cfg.n_heads * hd, d)}
    if cfg.qkv_bias:
        for name, width in (("wq", cfg.n_heads * hd),
                            ("wk", cfg.n_kv_heads * hd),
                            ("wv", cfg.n_kv_heads * hd)):
            attn[name]["b"] = torch.zeros((L, width), dtype=bf, device=device)
    params = {
        "final_ln": {"scale": torch.ones((d,), dtype=bf, device=device)},
        "embed": {"emb": normal((cfg.vocab, d), 0.02)},
        "layers": {"ln1": ones((L, d)), "attn": attn, "ln2": ones((L, d)),
                   "mlp": {"w_gate": dense_w(d, cfg.d_ff),
                           "w_up": dense_w(d, cfg.d_ff),
                           "w_down": dense_w(cfg.d_ff, d)}},
    }
    if not cfg.tie_embeddings:
        params["unembed"] = {"w": normal((d, cfg.vocab), 1.0 / math.sqrt(d))}
    return params


def layer_params(params: dict, i: int) -> dict:
    """Per-layer views of the stacked ``params["layers"]``, one dict per
    layer (what ``lax.scan`` hands its body)."""
    def index(tree, j):
        if isinstance(tree, dict):
            return {k: index(v, j) for k, v in tree.items()}
        return tree[j]
    return index(params["layers"], i)


def _layers(params: dict, n: int) -> list:
    return [layer_params(params, i) for i in range(n)]


def _unembed_matrix(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"]["emb"].T
    return params["unembed"]["w"]


def _logits(cfg, params, h_last):
    """Final norm + vocab projection of (B, D) hidden rows -> f32 logits."""
    h_last = rmsnorm(params["final_ln"], h_last.contiguous())
    return (h_last @ _unembed_matrix(cfg, params)).float()


# ---------------------------------------------------------------------------
# Serving: contiguous cache init / prefill / decode-step
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    _check_dense(cfg, "init_cache")
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def decode_fn(cfg: ModelConfig):
    """Returns f(params, cache, tokens) -> (logits, cache).

    tokens: (B,) int — the latest token per sequence.  ``cache["len"]``
    holds the current context length per sequence.
    """
    _check_dense(cfg, "decode_fn")

    def f(params, cache, tokens):
        h = embed(params["embed"], tokens[:, None])
        length = cache["len"]
        positions = length[:, None]
        for i, lp in enumerate(_layers(params, cfg.n_layers)):
            a, _ = attention_apply(
                lp["attn"], rmsnorm(lp["ln1"], h), cfg, positions=positions,
                kv_cache=(cache["k"][i], cache["v"][i]), length=length)
            h = h + a
            h = h + mlp_apply(lp["mlp"], rmsnorm(lp["ln2"], h))
        cache = dict(cache, len=length + 1)
        return _logits(cfg, params, h[:, 0]), cache
    return f


def _pad_kv(kv, max_len: int):
    """(L, B, S, Hkv, hd) -> (L, B, max_len, Hkv, hd)."""
    return F.pad(kv, (0, 0, 0, 0, 0, max_len - kv.shape[2]))


def prefill_fn(cfg: ModelConfig):
    """Returns f(params, batch, max_len) -> (last-token logits, cache).

    The cache is fully populated so ``decode_fn`` can continue generation.
    """
    _check_dense(cfg, "prefill_fn")

    def f(params, batch, max_len: int):
        h = embed(params["embed"], batch["tokens"])
        b, s = h.shape[0], h.shape[1]
        ks, vs = [], []
        for lp in _layers(params, cfg.n_layers):
            a, (k, v) = attention_apply(lp["attn"], rmsnorm(lp["ln1"], h),
                                        cfg, kv_out=True)
            h = h + a
            h = h + mlp_apply(lp["mlp"], rmsnorm(lp["ln2"], h))
            ks.append(k)
            vs.append(v)
        cache = {"k": _pad_kv(torch.stack(ks), max_len),
                 "v": _pad_kv(torch.stack(vs), max_len),
                 "len": torch.full((b,), s, dtype=torch.int32,
                                   device=h.device)}
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
    tables.
    """
    _check_dense(cfg, "init_paged_cache")
    device = resolve_device(device)
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"kp": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "vp": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def _prefix_prefill(cfg, params, tokens, prefix_k, prefix_v, last: int,
                    kv_len: int | None):
    """Shared body of ``chunk_prefill_fn`` and ``prefill_from_cache``:
    (logits at position ``last``, full-context K, V stacked over layers)."""
    h = embed(params["embed"], tokens)
    p_len = prefix_k.shape[2]
    ks, vs = [], []
    for i, lp in enumerate(_layers(params, cfg.n_layers)):
        a, (k, v) = attention_apply(lp["attn"], rmsnorm(lp["ln1"], h), cfg,
                                    kv_out=True,
                                    prefix_kv=(prefix_k[i], prefix_v[i]),
                                    q_offset=p_len, kv_len=kv_len)
        h = h + a
        h = h + mlp_apply(lp["mlp"], rmsnorm(lp["ln2"], h))
        ks.append(k)
        vs.append(v)
    return _logits(cfg, params, h[:, last]), torch.stack(ks), torch.stack(vs)


def chunk_prefill_fn(cfg: ModelConfig):
    """Returns f(params, tokens, prefix_k, prefix_v, last=-1, kv_len=None)
    -> (logits, k_new, v_new).

    One chunk of a chunked prefill: ``tokens`` (B, C) is the next C prompt
    tokens, ``prefix_k``/``prefix_v`` (L, B, P, Hkv, hd) the KV of the P
    tokens already prefilled.  Returns the logits at chunk position
    ``last`` plus the KV of only the new chunk (L, B, C, Hkv, hd).

    ``last`` and ``kv_len`` let a caller pad a chunk to a fixed shape:
    trailing pad tokens sit after every real one, so the causal mask hides
    them from the real tokens, and ``last`` picks the last real position.
    """
    _check_dense(cfg, "chunk_prefill_fn")

    def f(params, tokens, prefix_k, prefix_v, last: int = -1,
          kv_len: int | None = None):
        p_len = prefix_k.shape[2]
        logits, ks, vs = _prefix_prefill(cfg, params, tokens, prefix_k,
                                         prefix_v, last, kv_len)
        return logits, ks[:, :, p_len:], vs[:, :, p_len:]
    return f


def paged_decode_fn(cfg: ModelConfig):
    """Returns f(params, kp, vp, tables, lens, tokens) -> (logits, kp, vp).

    Batched single-step decode over the paged KV pool: ``tokens`` (B,) are
    the latest tokens of B independent sequences, ``tables`` (B, MP) int32
    their page tables into the (L, NP, PS, Hkv, hd) pools and ``lens``
    (B,) int32 their context lengths.  Each step writes the new KV into
    page ``tables[b, len // PS]`` slot ``len % PS`` *before* attending over
    ``len + 1`` positions through the block tables, in place.
    """
    _check_dense(cfg, "paged_decode_fn")
    if cfg.sliding_window:
        raise ValueError("paged decode does not support sliding windows")
    hd = cfg.resolved_head_dim
    h_, hkv = cfg.n_heads, cfg.n_kv_heads

    def f(params, kp, vp, tables, lens, tokens):
        h = embed(params["embed"], tokens[:, None])          # (B, 1, D)
        b = h.shape[0]
        ps = kp.shape[2]
        positions = lens[:, None]
        rows = torch.arange(b, device=h.device)
        page = tables[rows, (lens // ps).long()].long()      # (B,)
        slot = (lens % ps).long()
        lens1 = (lens + 1).to(torch.int32)
        for i, lp in enumerate(_layers(params, cfg.n_layers)):
            at = lp["attn"]
            xn = rmsnorm(lp["ln1"], h)
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
            h = h + mlp_apply(lp["mlp"], rmsnorm(lp["ln2"], h))
        return _logits(cfg, params, h[:, 0]), kp, vp
    return f


def prefill_from_cache(cfg: ModelConfig):
    """Returns f(params, batch, prefix_k, prefix_v, max_len) -> (logits, cache).

    Prefill that attaches to a cached prompt prefix: ``batch["tokens"]``
    holds only the uncached suffix (B, S); ``prefix_k``/``prefix_v`` are
    (L, B, P, Hkv, hd) KV for the first P prompt tokens (RoPE already
    applied).  The returned cache covers the full P+S context so
    ``decode_fn`` continues identically to a cold prefill.
    """
    _check_dense(cfg, "prefill_from_cache")

    def f(params, batch, prefix_k, prefix_v, max_len: int):
        tokens = batch["tokens"]
        b, s = tokens.shape
        p_len = prefix_k.shape[2]
        logits, ks, vs = _prefix_prefill(cfg, params, tokens, prefix_k,
                                         prefix_v, -1, None)
        cache = {"k": _pad_kv(ks, max_len), "v": _pad_kv(vs, max_len),
                 "len": torch.full((b,), p_len + s, dtype=torch.int32,
                                   device=tokens.device)}
        return logits, cache
    return f
