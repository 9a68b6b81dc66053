"""The serving path's dropless MoE (``moe.moe_dropless``) on the CPU: 8
experts of 64, top-2 over d 128 plus one shared expert, DeepSeek-V2's
routing (softmax scores, greedy top-k, not renormalised).

It is held against the benchmark reference's per-expert loop
(``perfbench/reference/deepseek_v2.py``: each expert computes the rows
routed to it in f32) with the weights in f32 (1e-5: f32 rounding of the
same sums in another order), and in bf16 within the bf16 roundings of its
three products and its output (3e-2 of outputs of order 1; fp8 operands
move them past that: ``test_bf16_within_rounding_and_fp8_not``).  The
capacity path ``moe_apply`` (training, JAX parity) keeps its own tests in
``test_torch_families.py`` and ``test_torch_family_modules.py``,
untouched.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as M
from repro_torch.models import trace
from repro_torch.models.layers import ParamInit

ROOT = Path(__file__).resolve().parents[1]
CFG = MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=64,
                norm_topk_prob=False)
D = 128


def _load_reference():
    path = ROOT / "perfbench" / "reference" / "deepseek_v2.py"
    spec = importlib.util.spec_from_file_location("dsv2_reference_moe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference()


def _params(dtype=torch.bfloat16, seed=0):
    p = M.moe_init(ParamInit(torch.Generator().manual_seed(seed), "cpu"),
                   D, CFG)

    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        return t if t.dtype == torch.float32 and t.dim() == 2 \
            and t.shape[-1] == CFG.n_experts else t.to(dtype)
    return cast(p)


def _reference(p, x, cfg=CFG):
    conf = {"num_experts_per_tok": cfg.top_k,
            "norm_topk_prob": cfg.norm_topk_prob,
            "routed_scaling_factor": cfg.routed_scaling_factor,
            "n_routed_experts": cfg.n_experts}
    m = {"router": p["router"]["w"].float(),
         **{k: p[k].float() for k in ("w_gate", "w_up", "w_down")},
         "shared": {k: p["shared"][k]["w"].float()
                    for k in ("w_gate", "w_up", "w_down")}}
    with torch.no_grad():
        return REF._moe(x.float().reshape(-1, D), m, conf, None).view(
            x.shape)


def _x(b, s, seed=1, dtype=torch.bfloat16):
    return torch.randn((b, s, D), generator=torch.Generator().manual_seed(
        seed)).to(dtype)


@pytest.mark.parametrize("b,s", [(1, 37), (5, 1), (2, 64)])
def test_equals_the_reference_loop_in_f32(b, s):
    p, x = _params(torch.float32), _x(b, s, dtype=torch.float32)
    with torch.no_grad():
        got = M.moe_dropless(p, x, CFG)
    torch.testing.assert_close(got, _reference(p, x), atol=1e-5, rtol=1e-5)


def test_bf16_within_rounding_and_fp8_not(monkeypatch):
    """In bf16 every row lies within 3e-2 of the f32 reference on the same
    (bf16) weights; with fp8 e4m3 operands in every product it does not."""
    p, x = _params(), _x(3, 40)
    want = _reference(p, x)
    with torch.no_grad():
        err = (M.moe_dropless(p, x, CFG).float() - want).abs().max()
    assert err <= 3e-2

    def q(t, dim):
        amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
        s = amax / 448.0
        return (t / s).to(torch.float8_e4m3fn).float() * s
    real = M.grouped_mm

    def fp8(a, w, offs):
        return real(q(a.float(), -1).to(a.dtype), q(w.float(), -2)
                    .to(w.dtype), offs)
    monkeypatch.setattr(M, "grouped_mm", fp8)
    with torch.no_grad():
        err8 = (M.moe_dropless(p, x, CFG).float() - want).abs().max()
    assert err8 > 3e-2


def test_padding_rows_get_zeros_and_move_nothing():
    """Rows past ``n_rows`` are neither routed nor computed: they come out
    zero, and the real rows' outputs are those of the real rows alone."""
    p = _params()
    x = _x(1, 50)
    before = dict(trace.COUNTS)
    with torch.no_grad():
        got = M.moe_dropless(p, x, CFG, n_rows=20)
        alone = M.moe_dropless(p, x[:, :20], CFG)
    assert not got[:, 20:].any()
    torch.testing.assert_close(got[:, :20], alone, atol=0, rtol=0)
    assert trace.COUNTS["moe_real_rows"] - before["moe_real_rows"] == \
        (20 + 20) * CFG.top_k


def test_a_row_does_not_depend_on_its_batch_mates():
    """A row's output is the same in any batch (no capacity, no drop):
    the capacity path would drop tokens of a group that overflows."""
    p = _params()
    x = _x(1, 64)
    with torch.no_grad():
        full = M.moe_dropless(p, x, CFG)
        for i in (0, 17, 63):
            alone = M.moe_dropless(p, x[:, i:i + 1], CFG)
            torch.testing.assert_close(alone[0, 0], full[0, i], atol=0,
                                       rtol=0)


def test_grouped_mm_fallback_equals_the_grouped_gemm(monkeypatch):
    """The per-expert GEMMs over the row groups (torch builds without
    ``torch._grouped_mm``) give what the grouped GEMM gives, empty groups
    included (bf16 products of the same rows, 1e-2 for the accumulation
    order)."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((30, 16), generator=g).bfloat16()
    w = torch.randn((4, 16, 8), generator=g).bfloat16()
    offs = torch.tensor([7, 7, 22, 30], dtype=torch.int32)
    grouped = M.grouped_mm(x, w, offs)
    monkeypatch.delattr(torch, "_grouped_mm", raising=False)
    loop = M.grouped_mm(x, w, offs)
    torch.testing.assert_close(loop.float(), grouped.float(), atol=1e-2,
                               rtol=1e-2)
    want = torch.cat([x[:7] @ w[0], x[7:22] @ w[2], x[22:] @ w[3]])
    torch.testing.assert_close(loop, want, atol=0, rtol=0)


@pytest.mark.parametrize("norm,scale", [(True, 1.0), (False, 2.5)])
def test_gates_follow_the_config(norm, scale):
    """``norm_topk_prob`` renormalises the top-k gates to sum to 1 and
    ``routed_scaling_factor`` multiplies them, in both routing paths."""
    cfg = dataclasses.replace(CFG, norm_topk_prob=norm,
                              routed_scaling_factor=scale)
    p = _params(torch.float32)
    x = _x(1, 9, dtype=torch.float32)
    gates, _ = M.route(p, x[0], cfg)
    probs = torch.softmax(x[0] @ p["router"]["w"], -1)
    top = probs.topk(cfg.top_k, -1).values
    want = (top / top.sum(-1, keepdim=True) if norm else top) * scale
    torch.testing.assert_close(gates, want)
    with torch.no_grad():
        torch.testing.assert_close(M.moe_dropless(p, x, cfg),
                                   _reference(p, x, cfg), atol=1e-5,
                                   rtol=1e-5)
