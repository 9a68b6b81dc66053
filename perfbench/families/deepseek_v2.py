"""The DeepSeek-V2 family of the benchmark's yardstick: latent attention
(MLA) and fine-grained sparse experts (``"family": "deepseek_v2"``).

Like ``dense_gqa.py`` it holds what belongs to the family and not to the
program under test:

* ``port_config`` maps the configuration file onto the port's
  ``ModelConfig`` and refuses a file the port cannot run as written;
* ``make_weights`` draws the weights from the run's seed, on the card, in
  the port's parameter layout and the type they are served in (bf16; the
  router f32), one draw per stacked tensor (per layer where a tensor holds
  more than 2^31 values);
* the FLOP and byte counts of the timed path, from the sizes alone (real
  rows and keys, no padding): a chunk of the chunked prefill (the
  non-absorbed form: the prefix's latent decompressed again, keys of
  dn + dr and values of dv), a batched decode step (the absorbed form), a
  launch of the paged decode kernel's latent instance and of RMSNorm.

Only ``port_config`` imports the port, and only when it is called.
"""

from __future__ import annotations

import math

import torch


def dims(conf: dict) -> dict:
    """The sizes the counts and the weights use, from the config file."""
    return {"L": conf["num_hidden_layers"], "D": conf["hidden_size"],
            "H": conf["num_attention_heads"], "V": conf["vocab_size"],
            "F": conf["intermediate_size"],
            "Fe": conf["moe_intermediate_size"],
            "E": conf["n_routed_experts"], "k": conf["num_experts_per_tok"],
            "ns": conf["n_shared_experts"], "r": conf["kv_lora_rank"],
            "dn": conf["qk_nope_head_dim"], "dr": conf["qk_rope_head_dim"],
            "dv": conf["v_head_dim"],
            "dense": conf["first_k_dense_replace"]}


def port_config(conf: dict):
    """The port's ``ModelConfig`` for this file; raises where the port
    would run something other than the file says."""
    from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig
    checks = [
        (conf.get("q_lora_rank") is None, "no query compression"),
        (conf["first_k_dense_replace"] == 1, "one leading dense layer"),
        (conf.get("moe_layer_freq", 1) == 1, "experts in every later layer"),
        (conf.get("scoring_func", "softmax") == "softmax",
         "a softmax router"),
        (conf.get("topk_method", "greedy") == "greedy", "greedy top-k"),
        (conf.get("n_group", 1) == 1 and conf.get("topk_group", 1) == 1,
         "no group-limited routing"),
        (conf.get("hidden_act", "silu") == "silu", "SwiGLU"),
        (not conf.get("attention_bias", False), "no attention bias"),
        (not conf.get("tie_word_embeddings", False),
         "a separate output head"),
        (conf["rope_scaling"].get("type") == "yarn", "YaRN RoPE"),
        (conf["num_key_value_heads"] == conf["num_attention_heads"],
         "one latent shared by every head"),
        (conf.get("torch_dtype", "bfloat16") == "bfloat16", "bf16 weights"),
    ]
    for ok, what in checks:
        if not ok:
            raise ValueError(f"the port's latent-attention model takes "
                             f"{what}")
    g, rs = dims(conf), conf["rope_scaling"]
    return ModelConfig(
        name=conf["name"], family="moe", n_layers=g["L"], d_model=g["D"],
        n_heads=g["H"], n_kv_heads=g["H"], d_ff=g["F"], vocab=g["V"],
        head_dim=g["dn"] + g["dr"], rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]), tie_embeddings=False,
        remat=False,
        moe=MoEConfig(n_experts=g["E"], top_k=g["k"], n_shared=g["ns"],
                      d_ff_expert=g["Fe"], layer_period=1,
                      norm_topk_prob=bool(conf["norm_topk_prob"]),
                      routed_scaling_factor=float(
                          conf["routed_scaling_factor"])),
        mla=MLAConfig(kv_lora_rank=g["r"], qk_nope_head_dim=g["dn"],
                      qk_rope_head_dim=g["dr"], v_head_dim=g["dv"],
                      rope_factor=float(rs["factor"]),
                      original_max_position=int(
                          rs["original_max_position_embeddings"]),
                      beta_fast=float(rs["beta_fast"]),
                      beta_slow=float(rs["beta_slow"]),
                      mscale=float(rs["mscale"]),
                      mscale_all_dim=float(rs["mscale_all_dim"])))


def _attn(lead, g) -> dict:
    D, H, r, dn, dr, dv = (g[k] for k in ("D", "H", "r", "dn", "dr", "dv"))
    return {"attn.wq.w": (lead + (D, H * (dn + dr)), 1 / math.sqrt(D)),
            "attn.wkva.w": (lead + (D, r + dr), 1 / math.sqrt(D)),
            "attn.kv_ln.scale": (lead + (r,), None),
            "attn.wkvb.w": (lead + (r, H * (dn + dv)), 1 / math.sqrt(r)),
            "attn.wo.w": (lead + (H * dv, D), 1 / math.sqrt(H * dv)),
            "ln1.scale": (lead + (D,), None), "ln2.scale": (lead + (D,), None)}


def _swiglu(prefix, lead, d, f) -> dict:
    return {f"{prefix}.w_gate.w": (lead + (d, f), 1 / math.sqrt(d)),
            f"{prefix}.w_up.w": (lead + (d, f), 1 / math.sqrt(d)),
            f"{prefix}.w_down.w": (lead + (f, d), 1 / math.sqrt(f))}


def weight_shapes(conf: dict) -> dict:
    """Every leaf of the port's parameter tree: path -> (shape, std).
    ``std`` None is a norm scale (ones).  Projections are normal with std
    1/sqrt(fan_in), the embedding normal with std 0.02: the scales the
    port's own random init uses."""
    g = dims(conf)
    D, V, E, Fe = g["D"], g["V"], g["E"], g["Fe"]
    n = (g["L"] - 1,)
    out = {"embed.emb": ((V, D), 0.02),
           "unembed.w": ((D, V), 1 / math.sqrt(D)),
           "final_ln.scale": ((D,), None)}
    out.update({"dense0." + k: v for k, v in _attn((), g).items()})
    out.update({"dense0." + k: v for k, v in
                _swiglu("mlp", (), D, g["F"]).items()})
    out.update({"layers." + k: v for k, v in _attn(n, g).items()})
    out.update({"layers.moe.router.w": (n + (D, E), 1 / math.sqrt(D)),
                "layers.moe.w_gate": (n + (E, D, Fe), 1 / math.sqrt(D)),
                "layers.moe.w_up": (n + (E, D, Fe), 1 / math.sqrt(D)),
                "layers.moe.w_down": (n + (E, Fe, D), 1 / math.sqrt(Fe))})
    out.update({"layers." + k: v for k, v in
                _swiglu("moe.shared", n, D, g["ns"] * Fe).items()})
    return out


#: the router is drawn and kept in f32, as the port holds it
F32 = ("layers.moe.router.w",)


def make_weights(conf: dict, seed: int, device) -> dict:
    """The weights of one run, drawn from ``seed`` on ``device`` in bf16
    (the router in f32), one ``torch.randn`` per stacked tensor (per layer
    where it holds more than 2^31 values), as a nested dict in the port's
    layout."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    tree: dict = {}
    for path, (shape, std) in weight_shapes(conf).items():
        dt = torch.float32 if path in F32 else torch.bfloat16
        if std is None:
            t = torch.ones(shape, dtype=dt, device=device)
        else:
            t = torch.empty(shape, dtype=dt, device=device)
            parts = [t] if t.numel() < (1 << 31) else list(t)
            for part in parts:
                part.copy_(torch.randn(part.shape, generator=gen, dtype=dt,
                                       device=device).mul_(std))
        node = tree
        *head, leaf = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


def param_count(conf: dict) -> int:
    return sum(math.prod(s) for s, _ in weight_shapes(conf).values())


def kv_bytes_per_token(conf: dict) -> int:
    """One bf16 latent row [c_kv | k_pe] a token a layer."""
    g = dims(conf)
    return g["L"] * (g["r"] + g["dr"]) * 2


# ---------------------------------------------------------------------------
# FLOPs of the timed path (real rows and keys only)
# ---------------------------------------------------------------------------

def _attn_in_out(g) -> int:
    """Weights a token multiplies through in one layer's attention outside
    the latent's up projection: W_q, W_kva and W_o."""
    return (g["D"] * g["H"] * (g["dn"] + g["dr"])
            + g["D"] * (g["r"] + g["dr"]) + g["H"] * g["dv"] * g["D"])


def _ffn_params(g) -> tuple[int, int]:
    """Weights a token multiplies through in the dense layer's FFN and in
    an expert layer's (its router, its k routed and its shared experts)."""
    return (3 * g["D"] * g["F"],
            g["D"] * g["E"] + (g["k"] + g["ns"]) * 3 * g["D"] * g["Fe"])


def _stack(g) -> int:
    dense, moe = _ffn_params(g)
    n_dense = g["dense"]
    return n_dense * dense + (g["L"] - n_dense) * moe


def chunk_flops(conf: dict, prefix: int, rows: int) -> int:
    """One chunk of ``rows`` real prompt tokens after ``prefix`` tokens
    already cached: each row's projections and FFN (the k routed and the
    shared experts), the decompression of the prefix's and the rows'
    latent into per-head keys and values, the causal attention over them
    (keys of dn + dr, values of dv), and the chunk's one row of logits."""
    g = dims(conf)
    L, H = g["L"], g["H"]
    cells = rows * prefix + rows * (rows + 1) // 2
    expand = g["r"] * H * (g["dn"] + g["dv"])
    return (2 * rows * (L * _attn_in_out(g) + _stack(g))
            + 2 * L * expand * (prefix + rows)
            + 2 * L * H * (g["dn"] + g["dr"] + g["dv"]) * cells
            + 2 * g["D"] * g["V"])


def decode_flops(conf: dict, lens) -> int:
    """One batched decode step over the real rows, each ``len`` tokens long
    before the step (it attends ``len + 1`` latent rows), in the absorbed
    form: each row's projections, W_UK into the query and W_UV out of the
    latent output, its FFN, the attention over the latent (scores over
    r + dr, values r wide) and one row of logits."""
    g = dims(conf)
    L, H, r = g["L"], g["H"], g["r"]
    absorb = H * g["dn"] * r + H * r * g["dv"]
    per_row = 2 * (L * (_attn_in_out(g) + absorb) + _stack(g)) \
        + 2 * g["D"] * g["V"]
    return per_row * len(lens) + L * paged_attention_flops(
        conf, [n + 1 for n in lens])


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
    """One layer's latent decode attention over a batch whose rows attend
    ``keys[b]`` latent rows: each row's 16 absorbed queries in (r + dr
    wide) and outputs out (r wide), bf16; each attended latent row once
    (r + dr bf16, read for all heads); the page tables and lengths
    (int32)."""
    g = dims(conf)
    b, w = len(keys), g["r"] + g["dr"]
    return (b * g["H"] * (w + g["r"]) * 2 + sum(keys) * w * 2
            + b * pages_per_seq * 4 + b * 4)


def paged_attention_flops(conf: dict, keys) -> int:
    """One layer's scores (r + dr) and P.V (r) over the attended latent
    rows, for every head."""
    g = dims(conf)
    return 2 * g["H"] * (g["r"] + g["dr"] + g["r"]) * sum(keys)
