"""Plain float32 reference of the dense GQA decoder (``family: dense_gqa``).

Frozen with the benchmark; it imports nothing of the program under test.
It works out from the shared inputs (the bf16 weights the benchmark drew
and the token ids) everything the port derives for itself: RoPE angles,
the causal mask, GQA head sharing, the norms.

Model: token embedding; per layer, pre-norm RMSNorm, GQA attention with
rotary position embedding (rotate-half form, theta from the config, angles
in float64), a SwiGLU MLP; final RMSNorm; a separate output head.  Every
matmul runs in float32 with TF32 off (``strict_f32``).

Departures from the published checkpoints, which this benchmark does not
load: the weights are random (normal, std 1/sqrt(fan_in), embedding 0.02,
norm scales 1), and SmolLM-360M's tied output head is a separate matrix
here, as the port holds it.  Sequences run past the published context
length (4,096 for Yi-9B, 2,048 for SmolLM-360M); nothing in the formula
depends on it.

``logits`` runs the whole stack layer by layer over a list of sequences
(each weight converted to float32 once per layer, attention in blocks of
query rows), so a 9 B model fits beside its own bf16 weights.
``quant`` names the control: ``"fp8"`` rounds both operands of every
projection to float8 e4m3 (per-row activation and per-column weight
scales) before the float32 product, as an fp8 GEMM would see them.
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
    """Round ``x`` to float8 e4m3 with one absmax scale per slice along
    ``dim`` and return it in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(x: torch.Tensor, w: torch.Tensor, quant: str | None) -> torch.Tensor:
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    if quant is not None:
        raise ValueError(f"unknown control precision {quant!r}")
    return x @ w


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x (S, heads, hd) at positions 0..S-1."""
    s, _, hd = x.shape
    freqs = 1.0 / (float(theta) ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                                  device=x.device) / hd))
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos = torch.cos(ang).to(torch.float32)[:, None, :]
    sin = torch.sin(ang).to(torch.float32)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, groups):
    """Causal GQA attention in float32: q (S, H, hd), k/v (S, Hkv, hd)."""
    s, h, hd = q.shape
    k = k.repeat_interleave(groups, dim=1)
    v = v.repeat_interleave(groups, dim=1)
    kt = k.permute(1, 2, 0)                        # (H, hd, S)
    vh = v.permute(1, 0, 2)                        # (H, S, hd)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(hd)
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(s, q0 + Q_BLOCK)
        sc = (q[q0:q1].permute(1, 0, 2) @ kt[:, :, :q1]) * scale
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        cols = torch.arange(q1, device=q.device)[None, :]
        sc = sc.masked_fill(cols > rows, float("-inf"))
        out[q0:q1] = (torch.softmax(sc, dim=-1) @ vh[:, :q1]).permute(1, 0, 2)
    return out


def logits(conf: dict, params: dict, seqs, score_from, quant=None):
    """Logits (n_i, V) in float32 at positions ``score_from[i]`` to the end
    of each token sequence ``seqs[i]``: position p's row predicts token
    p + 1."""
    strict_f32()
    d = conf["hidden_size"]
    h = conf["num_attention_heads"]
    hkv = conf["num_key_value_heads"]
    hd = conf.get("head_dim", d // h)
    eps = float(conf["rms_norm_eps"])
    theta = conf["rope_theta"]
    emb = params["embed"]["emb"]
    dev = emb.device
    hs = [emb[torch.as_tensor(list(s), dtype=torch.long, device=dev)].float()
          for s in seqs]
    lay = params["layers"]
    for i in range(conf["num_hidden_layers"]):
        w = {k: lay["attn"][k]["w"][i].float()
             for k in ("wq", "wk", "wv", "wo")}
        m = {k: lay["mlp"][k]["w"][i].float()
             for k in ("w_gate", "w_up", "w_down")}
        ln1 = lay["ln1"]["scale"][i].float()
        ln2 = lay["ln2"]["scale"][i].float()
        for j, x in enumerate(hs):
            s = x.shape[0]
            xn = _rmsnorm(x, ln1, eps)
            q = _rope(_mm(xn, w["wq"], quant).view(s, h, hd), theta)
            k = _rope(_mm(xn, w["wk"], quant).view(s, hkv, hd), theta)
            v = _mm(xn, w["wv"], quant).view(s, hkv, hd)
            a = _attention(q, k, v, h // hkv).reshape(s, h * hd)
            x = x + _mm(a, w["wo"], quant)
            xn = _rmsnorm(x, ln2, eps)
            gate = torch.nn.functional.silu(_mm(xn, m["w_gate"], quant))
            x = x + _mm(gate * _mm(xn, m["w_up"], quant), m["w_down"], quant)
            hs[j] = x
        del w, m
    fin = params["final_ln"]["scale"].float()
    head = params["unembed"]["w"].float()
    return [_mm(_rmsnorm(x[p:], fin, eps), head, quant)
            for x, p in zip(hs, score_from)]
