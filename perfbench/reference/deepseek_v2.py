"""Plain float32 reference of DeepSeek-V2 (``family: deepseek_v2``).

Frozen with the benchmark; it imports nothing of the program under test
and no kernel.  It works out from the shared inputs (the bf16 weights the
benchmark drew, in the port's layout, and the token ids) everything the
port derives for itself: YaRN's rotary tables, the softmax scale, the
causal mask, the latent decompression, the routing.

Model (DeepSeek-V2, arXiv:2405.04434; the published modelling code's
equations): token embedding; per layer, pre-norm RMSNorm and multi-head
latent attention without a query compression: q = h W_q split per head
into q_nope and q_pe, [c_kv | k_pe] = h W_kva, c_kv normed by its own
RMSNorm, [k_nope | v] = c_kv W_kvb per head, q_pe and the one shared k_pe
rotated by YaRN RoPE (interleaved pairs permuted to halves, then
rotate-half), scores (q_nope . k_nope + q_pe . k_pe) * sigma with
sigma = (dn + dr)^-1/2 * mscale(factor, mscale_all_dim)^2, causal softmax,
the heads' outputs through W_o; then RMSNorm and the FFN: the first
``first_k_dense_replace`` layers a SwiGLU, the rest a softmax router over
the routed experts (f32), the top k taken greedily (renormalised only if
``norm_topk_prob``, scaled by ``routed_scaling_factor``), the chosen
experts' SwiGLUs weighted by their gates plus the shared experts' SwiGLU;
final RMSNorm and a separate output head.  Every matmul runs in float32
with TF32 off (``strict_f32``); rotary angles in float64.

Departures from the published checkpoint, which this benchmark does not
load: the weights are random (normal, std 1/sqrt(fan_in), embedding 0.02,
norm scales 1, the router in f32).  The attention is computed in the
non-absorbed form, keys and values decompressed per head, the query rows
in blocks of ``Q_BLOCK``; each expert computes over the tokens routed to
it.  Weights are converted to float32 one layer at a time, so the
reference fits beside the served bf16 model.  ``quant="fp8"`` is the
control: both operands of every projection (the router's and the
experts' included) rounded to float8 e4m3 with per-row activation and
per-column weight scales before the float32 product.
"""

from __future__ import annotations

import math

import torch

Q_BLOCK = 512


def strict_f32() -> None:
    """No TF32 anywhere: a float32 product is a float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(x: torch.Tensor, w: torch.Tensor, quant: str | None) -> torch.Tensor:
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, -2)
    if quant is not None:
        raise ValueError(f"unknown control precision {quant!r}")
    return x @ w


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _yarn_mscale(factor, m):
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_inv_freq(dim: int, base: float, rs: dict) -> torch.Tensor:
    """YaRN's blended inverse frequencies (dim / 2,), in float64."""
    def corr(rot):
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (rot * 2 * math.pi))) / (2 * math.log(base))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    exps = torch.arange(0, dim, 2, dtype=torch.float64) / dim
    extra = 1.0 / base ** exps
    inter = 1.0 / (rs["factor"] * base ** exps)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low)
            / (high - low if high > low else 0.001)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def _rope(x, inv_freq, mscale):
    """x (S, heads, d) at positions 0..S-1: pairs (x0, x1), (x2, x3), ...
    permuted to halves, then rotated in the rotate-half form."""
    s, heads, d = x.shape
    x = x.view(s, heads, d // 2, 2).transpose(-1, -2).reshape(s, heads, d)
    ang = torch.arange(s, dtype=torch.float64)[:, None] * inv_freq[None, :]
    ang = ang.to(x.device)
    cos = (torch.cos(ang) * mscale).to(torch.float32)[:, None, :]
    sin = (torch.sin(ang) * mscale).to(torch.float32)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, sigma):
    """Causal attention in float32: q, k (S, H, dq); v (S, H, dv)."""
    s = q.shape[0]
    kt = k.permute(1, 2, 0)                        # (H, dq, S)
    vh = v.permute(1, 0, 2)                        # (H, S, dv)
    out = q.new_empty((s, q.shape[1], v.shape[2]))
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(s, q0 + Q_BLOCK)
        sc = (q[q0:q1].permute(1, 0, 2) @ kt[:, :, :q1]) * sigma
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        cols = torch.arange(q1, device=q.device)[None, :]
        sc = sc.masked_fill(cols > rows, float("-inf"))
        out[q0:q1] = (torch.softmax(sc, dim=-1) @ vh[:, :q1]).permute(1, 0, 2)
    return out


def _swiglu(x, g, u, d, quant):
    return _mm(torch.nn.functional.silu(_mm(x, g, quant)) * _mm(x, u, quant),
               d, quant)


def _moe(x, m, conf, quant):
    """The routed experts' weighted sum plus the shared experts, over the
    rows x (N, D): each expert computes over the rows routed to it."""
    k = conf["num_experts_per_tok"]
    probs = torch.softmax(_mm(x, m["router"], quant), dim=-1)
    gates, sel = torch.topk(probs, k, dim=-1)
    if conf["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    gates = gates * conf["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in range(conf["n_routed_experts"]):
        rows, slot = torch.nonzero(sel == e, as_tuple=True)
        if rows.numel():
            y = _swiglu(x[rows], m["w_gate"][e], m["w_up"][e],
                        m["w_down"][e], quant)
            out.index_add_(0, rows, y * gates[rows, slot][:, None])
    sh = m["shared"]
    return out + _swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"], quant)


def logits(conf: dict, params: dict, seqs, score_from, quant=None):
    """Logits (n_i, V) in float32 at positions ``score_from[i]`` to the end
    of each token sequence ``seqs[i]``: position p's row predicts token
    p + 1."""
    strict_f32()
    h = conf["num_attention_heads"]
    r, dn = conf["kv_lora_rank"], conf["qk_nope_head_dim"]
    dr, dv = conf["qk_rope_head_dim"], conf["v_head_dim"]
    eps = float(conf["rms_norm_eps"])
    rs = conf["rope_scaling"]
    inv_freq = yarn_inv_freq(dr, float(conf["rope_theta"]), rs)
    rope_ms = (_yarn_mscale(rs["factor"], rs["mscale"])
               / _yarn_mscale(rs["factor"], rs["mscale_all_dim"]))
    sigma = (dn + dr) ** -0.5 * _yarn_mscale(rs["factor"],
                                             rs["mscale_all_dim"]) ** 2
    if conf["first_k_dense_replace"] != 1 or conf["q_lora_rank"] is not None:
        raise ValueError("this reference takes one leading dense layer and "
                         "no query compression")
    emb = params["embed"]["emb"]
    dev = emb.device
    hs = [emb[torch.as_tensor(list(s), dtype=torch.long, device=dev)].float()
          for s in seqs]
    for i in range(conf["num_hidden_layers"]):
        lay = params["dense0"] if i == 0 else {
            k: _layer(v, i - 1) for k, v in params["layers"].items()}
        at = {k: lay["attn"][k]["w"].float()
              for k in ("wq", "wkva", "wkvb", "wo")}
        kv_ln = lay["attn"]["kv_ln"]["scale"].float()
        ln1 = lay["ln1"]["scale"].float()
        ln2 = lay["ln2"]["scale"].float()
        for j, x in enumerate(hs):
            s = x.shape[0]
            xn = _rmsnorm(x, ln1, eps)
            q = _mm(xn, at["wq"], quant).view(s, h, dn + dr)
            kva = _mm(xn, at["wkva"], quant)
            c = _rmsnorm(kva[:, :r], kv_ln, eps)
            k_pe = _rope(kva[:, None, r:], inv_freq, rope_ms)
            kv = _mm(c, at["wkvb"], quant).view(s, h, dn + dv)
            qq = torch.cat([q[..., :dn], _rope(q[..., dn:], inv_freq,
                                                rope_ms)], dim=-1)
            kk = torch.cat([kv[..., :dn], k_pe.expand(s, h, dr)], dim=-1)
            a = _attention(qq, kk, kv[..., dn:], sigma).reshape(s, h * dv)
            hs[j] = x + _mm(a, at["wo"], quant)
        del at
        sizes = [x.shape[0] for x in hs]
        x = torch.cat(hs)
        xn = _rmsnorm(x, ln2, eps)
        if "mlp" in lay:
            m = {k: lay["mlp"][k]["w"].float()
                 for k in ("w_gate", "w_up", "w_down")}
            y = _swiglu(xn, m["w_gate"], m["w_up"], m["w_down"], quant)
        else:
            mo = lay["moe"]
            m = {"router": mo["router"]["w"].float(),
                 **{k: mo[k].float() for k in ("w_gate", "w_up", "w_down")},
                 "shared": {k: mo["shared"][k]["w"].float()
                            for k in ("w_gate", "w_up", "w_down")}}
            y = _moe(xn, m, conf, quant)
        del m
        hs = list(torch.split(x + y, sizes))
    fin = params["final_ln"]["scale"].float()
    head = params["unembed"]["w"].float()
    return [_mm(_rmsnorm(x[p:], fin, eps), head, quant)
            for x, p in zip(hs, score_from)]


def _layer(tree, i):
    """Layer ``i`` of a stacked weight tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]
