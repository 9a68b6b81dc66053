#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Print the card's name and power limit; build the kernels from the
   sources in the checkout (nvcc for the CUDA C++ library, Triton's JIT
   for RMSNorm).
2. Hold each kernel against its plain PyTorch version on the card, at this
   slice's shapes, and time kernel, plain version and the one-call PyTorch
   yardstick where there is one:
   * paged decode attention, B in {1, 3, 8}, ragged lengths both at the
     38-47 keys the main path serves and up to ``max_len``, a poisoned pad
     page 0.  Against the plain version on the bf16 inputs (scores in bf16
     like the JAX ref): atol 1e-2 / rtol 1e-2, a bf16 ulp of outputs up to
     2.  Against the plain version on the same inputs cast to f32 (scores
     in f32 like the kernel and the Pallas kernel): atol 1e-4 / rtol 4e-3,
     the kernel's own bf16 rounding of its output.  One key too many or
     too few moves some output by far more than either limit;
   * RMSNorm on (8, 1, 960) and (64, 960) bf16 (atol/rtol 2e-2, one bf16
     rounding apart);
   * the PMF convolution on (32, 64), deadlines below, inside and above
     the grid (f32, atol 1e-6 / rtol 1e-5).
3. The main path: a full-width smollm-360m ``ServingEngine`` with
   continuous batching, pruning and success-chance elasticity serves 16
   greedy requests (4 shared 32-token system prompts + 6-token suffixes,
   8 new tokens each) with the kernel launch counters zeroed just before
   and read just after.  The same requests then run one at a time on a
   second engine, under the kernel profiler, and must give the same tokens.
   A small input is checked against the plain versions on the CPU.
4. Print tokens/s, the median decode-step wall, per-kernel launches and
   times, the kernel JSON line, and last the device JSON line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12             # f32 outside the tensor cores

SEED = 0
N_SYS, SYS_LEN, SUFFIX_LEN, N_NEW, N_REQ = 4, 32, 6, 8, 16


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def assert_close(name, got, want, atol, rtol):
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        raise AssertionError(f"{name}: max |err| {max_err(got, want)} "
                             f"exceeds atol {atol} / rtol {rtol}")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_paged_attention(mc, max_len: int, max_batch: int, ps: int) -> dict:
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    hkv, hd, h = mc.n_kv_heads, mc.resolved_head_dim, mc.n_heads
    mp = -(-max_len // ps)
    n_pages = max_batch * mp + 1
    layers = mc.n_layers
    # a full-size arena: timing walks the layers, as a decode step does,
    # so the pages come from device memory and not from L2
    kp = torch.randn((layers, n_pages, ps, hkv, hd), generator=g, device=dev,
                     dtype=torch.float32).to(torch.bfloat16)
    vp = torch.randn((layers, n_pages, ps, hkv, hd), generator=g, device=dev,
                     dtype=torch.float32).to(torch.bfloat16)
    kp[:, 0] = 1000.0          # poisoned pad page
    vp[:, 0] = -1000.0
    rng = np.random.default_rng(SEED)
    kf, vf = kp[0].float(), vp[0].float()
    served = (SYS_LEN + SUFFIX_LEN, SYS_LEN + SUFFIX_LEN + N_NEW)
    worst, worst_f32, rows = 0.0, 0.0, {}
    for (lo, hi), b in [(r, b) for r in ((1, max_len + 1), served)
                        for b in (1, 3, 8)]:
        lens = rng.integers(lo, hi, size=b)
        if hi > max_len and b > 1:
            lens[0] = max_len
        perm = rng.permutation(np.arange(1, n_pages))
        tables = np.zeros((b, mp), np.int32)
        for i, n in enumerate(lens):
            npg = -(-int(n) // ps)
            tables[i, :npg] = perm[i * mp:i * mp + npg]
        tab = torch.from_numpy(tables).to(dev)
        ln = torch.from_numpy(lens.astype(np.int32)).to(dev)
        q = torch.randn((b, h, hd), generator=g, device=dev).to(torch.bfloat16)
        got = paged_decode_attention_cuda(q, kp[0], vp[0], tab, ln)
        want = paged_decode_attention_ref(q, kp[0], vp[0], tab, ln)
        assert_close(f"paged_decode_attention B={b} lens {lens.tolist()}",
                     got, want, 1e-2, 1e-2)
        want32 = paged_decode_attention_ref(q.float(), kf, vf, tab, ln)
        assert_close(f"paged_decode_attention B={b} lens {lens.tolist()} "
                     f"(f32 plain)", got, want32, 1e-4, 4e-3)
        worst = max(worst, max_err(got, want))
        worst_f32 = max(worst_f32, max_err(got, want32))
        if hi > max_len:
            rows[b] = (q, tab, ln, lens)
    q, tab, ln, lens = rows[max_batch]
    it = iter(range(10 ** 9))

    def kern():
        i = next(it) % layers
        paged_decode_attention_cuda(q, kp[i], vp[i], tab, ln)

    def plain():
        i = next(it) % layers
        paged_decode_attention_ref(q, kp[i], vp[i], tab, ln)

    n_keys = int(lens.sum())
    nbytes = (q.numel() * 2 * 2 + 2 * n_keys * hkv * hd * 2
              + tab.numel() * 4 + ln.numel() * 4)
    flops = 4.0 * n_keys * h * hd
    b_ms, b_by = bound(nbytes, flops)
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/"
                        "decode_attention.py:166",
            "max_abs_err": worst, "ms": time_ms(kern, iters=64),
            "plain_ms": time_ms(plain, iters=64), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shape": f"B={max_batch} H={h} Hkv={hkv} hd={hd} PS={ps} "
                     f"MP={mp} keys={n_keys}; max|err| vs f32 plain "
                     f"{worst_f32:.3g}"}


def check_rmsnorm(mc, max_batch: int, budget: int) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_triton
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    d = mc.d_model
    scale = (1.0 + 0.1 * torch.randn((d,), generator=g, device=dev)) \
        .to(torch.bfloat16)
    worst, xs = 0.0, {}
    for shape in ((max_batch, 1, d), (budget, d)):
        x = (3.0 * torch.randn(shape, generator=g, device=dev)) \
            .to(torch.bfloat16)
        got = rmsnorm_triton(x, scale)
        want = rmsnorm_ref(x, scale)
        assert_close(f"rmsnorm {shape}", got, want, 2e-2, 2e-2)
        worst = max(worst, max_err(got, want))
        xs[shape] = x
    x = xs[(max_batch, 1, d)]
    library = None
    if hasattr(F, "rms_norm"):
        library = time_ms(lambda: F.rms_norm(x, (d,), scale, 1e-5),
                          iters=200)
    b_ms, b_by = bound(x.numel() * 2 * 2 + d * 2, 4.0 * x.numel())
    return {"name": "rmsnorm", "route": "triton",
            "source": "src/repro_torch/kernels/rmsnorm/rmsnorm.py",
            "replaces": "src/repro/kernels/rmsnorm/rmsnorm.py:24",
            "max_abs_err": worst,
            "ms": time_ms(lambda: rmsnorm_triton(x, scale), iters=200),
            "plain_ms": time_ms(lambda: rmsnorm_ref(x, scale), iters=200),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library,
            "shape": f"x {tuple(x.shape)} bf16"}


def check_pmf_conv(n: int = 32, length: int = 64) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.pmf_conv.ops import pmf_conv_cuda
    from repro_torch.kernels.pmf_conv.ref import pmf_conv_ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    pet = rng.random((n, length)).astype(np.float32)
    pet /= pet.sum(axis=1, keepdims=True)
    pct = rng.random((n, length)).astype(np.float32)
    pct /= pct.sum(axis=1, keepdims=True)
    lo = 2 * length - 1
    # below the grid, inside it (both halves) and above it
    dl = np.concatenate([np.full(4, -1.0), rng.integers(0, length, n // 2),
                         rng.integers(length, lo, n // 4 - 4),
                         np.full(n - 4 - n // 2 - (n // 4 - 4), lo + 5.0)])
    pet_t, pct_t = torch.from_numpy(pet).to(dev), torch.from_numpy(pct).to(dev)
    dl_t = torch.from_numpy(dl.astype(np.float32)).to(dev)
    out_k, suc_k = pmf_conv_cuda(pet_t, pct_t, dl_t)
    out_r, suc_r = pmf_conv_ref(pet_t, pct_t, dl_t)
    assert_close("pmf_conv out", out_k, out_r, 1e-6, 1e-5)
    assert_close("pmf_conv success", suc_k, suc_r, 1e-6, 1e-5)
    worst = max(max_err(out_k, out_r), max_err(suc_k, suc_r))
    # yardstick: the convolution alone as one grouped conv1d call
    torch.backends.cudnn.allow_tf32 = False
    w = torch.flip(pet_t, dims=[1])[:, None, :].contiguous()
    xin = pct_t[None]
    library = time_ms(lambda: F.conv1d(xin, w, padding=length - 1, groups=n),
                      iters=200)
    nbytes = 4 * (pet.size + pct.size + n + n * lo + n)
    b_ms, b_by = bound(nbytes, 2.0 * n * length * length)
    return {"name": "pmf_conv", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/pmf_conv.cu",
            "replaces": "src/repro/kernels/pmf_conv/pmf_conv.py:74",
            "max_abs_err": worst,
            "ms": time_ms(lambda: pmf_conv_cuda(pet_t, pct_t, dl_t),
                          iters=200),
            "plain_ms": time_ms(lambda: pmf_conv_ref(pet_t, pct_t, dl_t),
                                iters=20),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library,
            "shape": f"pet/pct ({n}, {length}) f32"}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def make_requests(vocab: int, spacing: float, deadline: float):
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(SEED + 3)
    systems = [tuple(int(x) for x in rng.integers(1, vocab, SYS_LEN))
               for _ in range(N_SYS)]
    trace = []
    for i in range(N_REQ):
        suffix = tuple(int(x) for x in rng.integers(1, vocab, SUFFIX_LEN))
        # two waves of 8: the second finds the first wave's prefixes cached
        t = (i % 8) * 0.5 + (i // 8) * 1000.0 if spacing == 0 \
            else i * spacing
        trace.append((t, Request(prompt=systems[i % N_SYS] + suffix,
                                 n_new=N_NEW, deadline=t + deadline)))
    return trace


def make_engine(mc, params):
    from repro_torch.core.pruning import PruningConfig
    from repro_torch.serving.autoscale import ElasticityConfig
    from repro_torch.serving.batching import StepBatchingConfig
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    return ServingEngine(mc, params, EngineConfig(
        n_units=1,
        batching=StepBatchingConfig(max_batch=8, step_token_budget=64),
        max_len=1024,
        pruning=PruningConfig(initial_defer_threshold=0.1,
                              base_drop_threshold=0.05),
        elasticity=ElasticityConfig(policy="success-chance", max_extra=1,
                                    cooldown=100.0)), device="cuda")


def serve(mc, params):
    from repro_torch import kernels
    from repro_torch.obs import KernelProfiler, install

    eng = make_engine(mc, params)
    trace = make_requests(mc.vocab, 0.0, 600.0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stats = eng.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    reqs = [r for _, r in trace]
    done = [r for r in reqs if r.status == "done"]
    # every deadline is 600 ticks away, which this load meets with room to
    # spare: a request the pruner drops here was dropped wrongly
    for r in reqs:
        if r.status != "done":
            raise AssertionError(f"request {r.rid} ended as {r.status}, "
                                 f"want done")
        if len(r.tokens) != N_NEW:
            raise AssertionError(f"request {r.rid}: {len(r.tokens)} "
                                 f"tokens, want {N_NEW}")
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"the main path never launched {name}")
    # decode walls of the units still in the pool at the end of the run
    walls = [w for run in eng._runners.values() for w in run.decode_walls]

    # the same requests, one at a time, under the kernel profiler
    seq = make_engine(mc, params)
    strace = make_requests(mc.vocab, 5000.0, 600.0)
    prof = KernelProfiler()
    install(prof)
    try:
        sstats = seq.run(strace)
    finally:
        install(None)
    compared = 0
    for (_, a), (_, b) in zip(trace, strace):
        if b.status != "done":
            raise AssertionError(f"request {b.rid} ended as {b.status} when "
                                 f"run one at a time, want done")
        if a.tokens != b.tokens:
            raise AssertionError(
                f"request {a.rid}: batched {a.tokens} != one at a time "
                f"{b.tokens}")
        compared += 1
    hits = stats["prefix_hits"] + sstats["prefix_hits"]
    if sstats["prefix_hits"] == 0:
        raise AssertionError("the prefix cache recorded no hits")
    n_tok = sum(len(r.tokens) for r in done)
    return {"stats": stats, "wall_s": wall, "tokens": n_tok,
            "tokens_per_s": n_tok / wall,
            "median_decode_step_ms": 1e3 * statistics.median(walls),
            "decode_steps": len(walls), "counts": counts,
            "completed": len(done),
            "dropped": sum(r.status == "dropped" for r in reqs),
            "compared": compared, "prefix_hits_batched": stats["prefix_hits"],
            "prefix_hits_sequential": sstats["prefix_hits"],
            "prefix_hits": hits, "profile": prof.summary()}


def check_small_input(mc, params, n_steps: int = 4):
    """The full-width model on the card against its plain versions on the
    CPU, teacher-forced on the card's greedy tokens: one 38-token chunk
    prefill then ``n_steps`` batched paged decode steps."""
    from repro_torch.models import transformer as T
    rng = np.random.default_rng(SEED + 4)
    prompt = rng.integers(1, mc.vocab, SYS_LEN + SUFFIX_LEN)
    ps, mp = 16, 64
    cpu_params = _tree_to(params, "cpu")
    out = {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        toks = torch.as_tensor(prompt[None], device=dev)
        empty = torch.zeros((mc.n_layers, 1, 0, mc.n_kv_heads,
                             mc.resolved_head_dim), dtype=torch.bfloat16,
                            device=dev)
        logits, kn, vn = T.chunk_prefill_fn(mc)(p, toks, empty, empty)
        out[dev] = [logits[0].float().cpu()]
        pages = T.init_paged_cache(mc, mp + 1, ps, dev)
        n = len(prompt)
        npg = -(-(n + n_steps) // ps)
        tab = torch.zeros((1, mp), dtype=torch.int32, device=dev)
        tab[0, :npg] = torch.arange(1, npg + 1)
        kk = torch.nn.functional.pad(kn[:, 0], (0, 0, 0, 0, 0, npg * ps - n))
        vv = torch.nn.functional.pad(vn[:, 0], (0, 0, 0, 0, 0, npg * ps - n))
        shape = (mc.n_layers, npg, ps, mc.n_kv_heads, mc.resolved_head_dim)
        pages["kp"][:, 1:npg + 1] = kk.reshape(shape)
        pages["vp"][:, 1:npg + 1] = vv.reshape(shape)
        if dev == "cuda":
            forced = [int(torch.argmax(logits[0]))]
        cur = forced[0]
        for s in range(n_steps):
            lg, _, _ = T.paged_decode_fn(mc)(
                p, pages["kp"], pages["vp"], tab,
                torch.tensor([n + s], dtype=torch.int32, device=dev),
                torch.tensor([cur], device=dev))
            out[dev].append(lg[0].float().cpu())
            if dev == "cuda":
                forced.append(int(torch.argmax(lg[0])))
            cur = forced[s + 1]
    errs = []
    for a, b in zip(out["cuda"], out["cpu"]):
        if a.shape != (mc.vocab,) or not torch.isfinite(a).all():
            raise AssertionError("card logits are not finite or misshaped")
        errs.append(float((a - b).abs().max()))
        top5 = torch.topk(b, 5).indices.tolist()
        if int(torch.argmax(a)) not in top5:
            raise AssertionError("card's greedy token is not in the CPU "
                                 "reference's top 5")
    # measured on an H100: 0.094 at a logit scale of 4.56 (2%); the limit
    # is 5% of the scale
    scale = max(float(t.abs().max()) for t in out["cpu"])
    if max(errs) > 0.05 * scale:
        raise AssertionError(f"card vs CPU logits differ by {max(errs)} "
                             f"(scale {scale})")
    return {"max_abs_err": max(errs), "logit_scale": scale, "steps": n_steps}


def decode_step_profile(mc, params, n_steps: int = 10) -> dict:
    """Device busy time of steady batched decode steps at the smoke's
    shapes (B=8, a 1024-token page table, 38-47 keys a sequence): the wall
    per step with the profiler off, and the summed kernel time per step
    from a second window under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    ps, mp, b = 16, 64, 8
    pages = T.init_paged_cache(mc, b * mp + 1, ps, "cuda")
    tabs = (torch.arange(b * mp, device="cuda", dtype=torch.int32) + 1) \
        .reshape(b, mp)
    lens = torch.full((b,), SYS_LEN + SUFFIX_LEN, dtype=torch.int32,
                      device="cuda")
    toks = torch.zeros((b,), dtype=torch.long, device="cuda")
    step = T.paged_decode_fn(mc)

    def run(n):
        for i in range(n):
            step(params, pages["kp"], pages["vp"], tabs, lens + i, toks)
        torch.cuda.synchronize()

    run(3)
    t0 = time.perf_counter()
    run(n_steps)
    wall = (time.perf_counter() - t0) / n_steps     # profiler off
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(n_steps)
    per_kernel: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / n_steps
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": 1e3 * wall, "busy_ms": busy or None, "top": top}


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401 — fails outside a checkout of the repo
    from repro_torch.bridge import init_params
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.build import BUILD_DIR, library
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_triton

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    library()
    x = torch.ones((1, 8), dtype=torch.bfloat16, device="cuda")
    rmsnorm_triton(x, torch.ones((8,), dtype=torch.bfloat16, device="cuda"))
    torch.cuda.synchronize()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s")
    for line in (BUILD_DIR / "ptxas.log").read_text().splitlines():
        if "Used" in line or "==" in line:
            log(f"  ptxas: {line.strip()}")

    mc = get_arch("smollm-360m")
    t0 = time.perf_counter()
    rows = [check_paged_attention(mc, 1024, 8, 16),
            check_rmsnorm(mc, 8, 64), check_pmf_conv()]
    log(f"phase 2: kernels agree with their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    for r in rows:
        log(f"  {r['name']:24s} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}), library {r['library_ms']}, "
            f"max|err| {r['max_abs_err']:.3g}")

    t0 = time.perf_counter()
    params = init_params(mc, torch.Generator(device="cuda").manual_seed(SEED),
                         "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"phase 3: smollm-360m at full width, {n_params / 1e6:.1f} M "
        f"parameters, random init in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res = serve(mc, params)
    log(f"  served {N_REQ} requests in {time.perf_counter() - t0:.1f} s "
        f"(both runs, engine set-up included)")
    small = check_small_input(mc, params)
    log(f"  small input vs CPU plain versions: max |logit err| "
        f"{small['max_abs_err']:.4g} (logit scale {small['logit_scale']:.3g})")

    prof = decode_step_profile(mc, params)
    if prof["busy_ms"] is None:
        log("  decode step device time: not measured (the profiler "
            "recorded no device events)")
    else:
        log(f"  decode step (B=8): wall {prof['wall_ms']:.3f} ms, device "
            f"busy {prof['busy_ms']:.3f} ms (torch.profiler), idle share "
            f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f}")
        for name, ms in prof["top"]:
            log(f"    {ms:8.4f} ms/step  {name[:90]}")

    st = res["stats"]
    log(f"phase 4 ({smi}):")
    log(f"  completed {res['completed']}, dropped {res['dropped']}, "
        f"batched == one at a time on {res['compared']} requests")
    log(f"  prefix hits: batched {res['prefix_hits_batched']}, one at a "
        f"time {res['prefix_hits_sequential']}; scale-ups "
        f"{st['scale_ups']}, merges {st['merges']}")
    log(f"  tokens/s {res['tokens_per_s']:.2f} ({res['tokens']} tokens in "
        f"{res['wall_s']:.3f} s wall, batched run)")
    log(f"  median decode step {res['median_decode_step_ms']:.3f} ms over "
        f"{res['decode_steps']} steps (batched run)")
    log(f"  main-path kernel launches: {res['counts']}")
    for name, s in sorted(res["profile"].items()):
        log(f"  profiler (one at a time) {name:24s} launches "
            f"{s['launches']:5d} execute {1e3 * s['execute_s']:.2f} ms "
            f"dispatch {1e3 * s['dispatch_s']:.2f} ms")
    for r in rows:
        r["launches"] = res["counts"][r["name"]]
        r.pop("shape")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
