"""The dense GQA decoder family of the benchmark's yardstick.

A configuration file names its family (``"family": "dense_gqa"``); the
harness finds this module by that name.  It holds three things that belong
to the family and not to the program under test:

* ``port_config`` maps the configuration file onto the port's
  ``ModelConfig`` and refuses a file the port cannot run as written;
* ``make_weights`` draws the weights from the run's seed, on the card, in
  the port's parameter layout and in the type they are served in (bf16),
  one call per stacked tensor.  The benchmark hands the same tensors to the
  port and to the plain reference;
* the FLOP and byte counts of the timed path: what one chunk of a chunked
  prefill, one batched decode step and one launch of each kernel needs,
  counted from the sizes alone (real rows and real keys, no padding).

Only ``port_config`` imports the port, and only when it is called.
"""

from __future__ import annotations

import math

import torch

#: the norm epsilon the port's RMSNorm applies to every norm of a model
PORT_NORM_EPS = 1e-5


def dims(conf: dict) -> dict:
    """The sizes the counts and the weights use, from the config file."""
    h = conf["num_attention_heads"]
    d = conf["hidden_size"]
    return {"L": conf["num_hidden_layers"], "D": d, "H": h,
            "Hkv": conf["num_key_value_heads"],
            "hd": conf.get("head_dim", d // h),
            "F": conf["intermediate_size"], "V": conf["vocab_size"]}


def port_config(conf: dict):
    """The port's ``ModelConfig`` for this file; raises where the port
    would run something other than the file says."""
    from repro_torch.configs.base import ModelConfig
    if conf.get("tie_word_embeddings", False):
        raise ValueError("the port's dense path keeps a separate output head")
    if conf.get("attention_bias", False):
        raise ValueError("the port's dense path has no attention bias")
    if conf.get("hidden_act", "silu") != "silu":
        raise ValueError("the port's MLP is SwiGLU")
    if conf["rms_norm_eps"] != PORT_NORM_EPS:
        raise ValueError(f"the port's RMSNorm uses eps {PORT_NORM_EPS}")
    if conf.get("torch_dtype", "bfloat16") != "bfloat16":
        raise ValueError("the port serves bf16 weights")
    g = dims(conf)
    return ModelConfig(name=conf["name"], family="dense", n_layers=g["L"],
                       d_model=g["D"], n_heads=g["H"], n_kv_heads=g["Hkv"],
                       d_ff=g["F"], vocab=g["V"], head_dim=g["hd"],
                       rope_theta=float(conf["rope_theta"]),
                       norm_eps=float(conf["rms_norm_eps"]),
                       tie_embeddings=False, remat=False)


def weight_shapes(conf: dict) -> dict:
    """Every leaf of the port's parameter tree: path -> (shape, std).
    ``std`` None is a norm scale (ones).  Projections are normal with std
    1/sqrt(fan_in), the embedding normal with std 0.02: the scales the
    port's own random init uses, so activations keep unit size through
    the depth."""
    g = dims(conf)
    L, D, H, Hkv, hd, F, V = (g[k] for k in ("L", "D", "H", "Hkv", "hd",
                                             "F", "V"))
    return {
        "embed.emb": ((V, D), 0.02),
        "unembed.w": ((D, V), 1 / math.sqrt(D)),
        "final_ln.scale": ((D,), None),
        "layers.ln1.scale": ((L, D), None),
        "layers.ln2.scale": ((L, D), None),
        "layers.attn.wq.w": ((L, D, H * hd), 1 / math.sqrt(D)),
        "layers.attn.wk.w": ((L, D, Hkv * hd), 1 / math.sqrt(D)),
        "layers.attn.wv.w": ((L, D, Hkv * hd), 1 / math.sqrt(D)),
        "layers.attn.wo.w": ((L, H * hd, D), 1 / math.sqrt(H * hd)),
        "layers.mlp.w_gate.w": ((L, D, F), 1 / math.sqrt(D)),
        "layers.mlp.w_up.w": ((L, D, F), 1 / math.sqrt(D)),
        "layers.mlp.w_down.w": ((L, F, D), 1 / math.sqrt(F)),
    }


def make_weights(conf: dict, seed: int, device) -> dict:
    """The weights of one run, drawn from ``seed`` on ``device`` in bf16,
    one ``torch.randn`` per stacked tensor, as a nested dict in the port's
    layout."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    tree: dict = {}
    for path, (shape, std) in weight_shapes(conf).items():
        if std is None:
            t = torch.ones(shape, dtype=torch.bfloat16, device=device)
        else:
            t = torch.randn(shape, generator=gen, dtype=torch.bfloat16,
                            device=device).mul_(std)
        node = tree
        *head, leaf = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


def param_count(conf: dict) -> int:
    return sum(math.prod(s) for s, _ in weight_shapes(conf).values())


def kv_bytes_per_token(conf: dict) -> int:
    """bf16 K and V of one token over every layer."""
    g = dims(conf)
    return g["L"] * g["Hkv"] * g["hd"] * 2 * 2


# ---------------------------------------------------------------------------
# FLOPs of the timed path (real rows and keys only)
# ---------------------------------------------------------------------------

def layer_matmul_params(conf: dict) -> int:
    """Weights one token multiplies through in one layer's projections."""
    g = dims(conf)
    D, H, Hkv, hd, F = g["D"], g["H"], g["Hkv"], g["hd"], g["F"]
    return D * H * hd + 2 * D * Hkv * hd + H * hd * D + 3 * D * F


def attn_flops_per_key(conf: dict) -> int:
    """QK^T and PV of one query row against one key, over all heads and
    layers."""
    g = dims(conf)
    return g["L"] * 4 * g["H"] * g["hd"]


def chunk_flops(conf: dict, prefix: int, rows: int) -> int:
    """One chunk of ``rows`` real prompt tokens after ``prefix`` tokens
    already in the cache: the projections of each row, causal attention
    over the real context, and the one row of logits the chunk returns."""
    g = dims(conf)
    keys = rows * prefix + rows * (rows + 1) // 2
    return (2 * g["L"] * layer_matmul_params(conf) * rows
            + attn_flops_per_key(conf) * keys + 2 * g["D"] * g["V"])


def decode_flops(conf: dict, lens) -> int:
    """One batched decode step over the real rows, each ``len`` tokens
    long before the step (it attends ``len + 1`` keys) and each returning
    one row of logits."""
    g = dims(conf)
    rows = len(lens)
    per_row = 2 * g["L"] * layer_matmul_params(conf) + 2 * g["D"] * g["V"]
    return per_row * rows + attn_flops_per_key(conf) * sum(n + 1
                                                           for n in lens)


# ---------------------------------------------------------------------------
# bytes of one kernel launch (each input read once, each output written once)
# ---------------------------------------------------------------------------

def rmsnorm_bytes(rows: int, d: int, elem: int = 2) -> int:
    """x in, out, and the scale."""
    return 2 * rows * d * elem + d * elem


def rmsnorm_flops(rows: int, d: int) -> int:
    """Square, sum, scale and multiply: four operations an element."""
    return 4 * rows * d


def paged_attention_bytes(conf: dict, keys, pages_per_seq: int) -> int:
    """One layer's paged decode attention over a batch whose rows attend
    ``keys[b]`` keys: q in and out (bf16), each attended key's K and V
    (bf16), the page tables and the lengths (int32)."""
    g = dims(conf)
    b = len(keys)
    qo = 2 * b * g["H"] * g["hd"] * 2
    kv = sum(keys) * g["Hkv"] * g["hd"] * 2 * 2
    return qo + kv + b * pages_per_seq * 4 + b * 4


def paged_attention_flops(conf: dict, keys) -> int:
    """One layer's QK^T and PV over the attended keys."""
    g = dims(conf)
    return 4 * g["H"] * g["hd"] * sum(keys)
