#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Print the card's name and power limit; build the five CUDA C++ sources
   in the checkout with nvcc (one library, loaded with ctypes).
2. Hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes, and time kernel, plain version and the one-call
   PyTorch yardstick where there is one (device time a call from
   ``torch.profiler``, each call after a 256 MB write that evicts the 50
   MB L2, the JSON line's ms, which must not fall under the row's bound;
   the same back to back without it, the warm ``warm_ms``; and the wall
   time a call of back-to-back calls, which for short kernels is the
   host's launch rate):
   * contiguous decode attention, B in {1, 8}, lengths 38-50 in a
     ``max_len`` = 64 cache (the one-at-a-time path) and up to 1024 in a
     1024-key cache.  Against the plain version on the inputs cast to f32
     (f32 scores, like the kernel): atol 1e-4 / rtol 4e-3.  Against the
     layer's plain version on the bf16 inputs (bf16 scores): atol 1e-2 /
     rtol 1e-2.  Bit-exact when keys and values past each row's length
     are set to +-99, and bit-exact for each row alone against the same
     row in the batch.  Against the plain model of its split-key algorithm
     (``decode_attention_split_ref``: the same 16-key granules dealt to 8
     ranks, the same rank-order combine, on the inputs cast to f32) at
     lengths 0, 1, 15, 16, 17, 127, 128, 129 and 1024: atol 1e-4 / rtol
     4e-3.  Two calls give the same bits.  Under a sliding window of 1,
     15, 16, 17, 100 and 2048 keys at each of those lengths: against the
     windowed split model (the row's origin at its first attended key) at
     the same bars, two calls bit-equal, against the layer's windowed
     plain version at 1e-2 wherever a key is left (a row with none gets
     zeros), and a window covering every row gives the bits of no
     window.  Then at every registered arch's (G, Hkv, hd), B in {1, 8}:
     38-50 keys of a 64-key cache, and the enc-dec cross-attention over 8
     frames of one, against both plain versions and the split model, keys
     past the length never read, and the same under a 17-key window.  The
     windowed kernel is timed at B=1, 15/5 heads, hd 64, the last 1024 of
     4228 keys, beside its plain version and
     ``scaled_dot_product_attention`` with the same boolean mask (the
     row's ``window_*`` keys in the JSON line);
   * paged decode attention, B in {1, 3, 8}, ragged lengths both at the
     38-47 keys the batched path serves and up to ``max_len``, a poisoned
     pad page 0.  Against the plain version on the bf16 inputs (scores in
     bf16 like the JAX ref): atol 1e-2 / rtol 1e-2, a bf16 ulp of outputs
     up to 2.  Against the plain version on the same inputs cast to f32
     (scores in f32 like the kernel and the Pallas kernel): atol 1e-4 /
     rtol 4e-3, the kernel's own bf16 rounding of its output.  One key too
     many or too few moves some output by far more than either limit.
     Against ``paged_decode_attention_split_ref`` on the f32 inputs at the
     boundary lengths above (atol 1e-4 / rtol 4e-3), with every table entry past a
     sequence's last page set to an id that indexes no page (bit-exact
     against the clean table), and two calls give the same bits.  Timed at
     the long shape (the JSON row) and at the served one (B=8, 38-46
     keys); ``scaled_dot_product_attention`` over the same keys gathered
     into a contiguous cache is printed beside it, but is not the same
     function (no block table), so the row's ``library_ms`` stays null;
   * RMSNorm on (8, 1, 960), (1, 1, 960) and (64, 960) bf16, on (1, 1, D),
     (8, 1, D) and (1, 38, D) at every registered width D and the reduced
     configs' 128, and at one shape for each instantiation of its kernel,
     bf16 and f32: against the
     plain version at one bf16 ulp (atol 1e-5 / rtol 8e-3) or, in f32, at
     1e-5; at most 1e-3 of the bf16 outputs not bit-equal (the kernel
     rounds x * r to bf16 before the scale, as the plain version does;
     rounding once changes about a quarter of them); each row alone
     bit-equal to the same row in the batch, and two calls bit-equal;
   * the PMF convolution on (32, 64) and (32, 128), deadlines below, inside
     and above the grid, the PEND cut at the success index and apart from
     it (f32, atol 1e-6 / rtol 1e-5), and its front door
     ``batched_success`` at (32, 64) against ``chance_of_success`` (1e-5),
     with its wall a call;
   * the chunked prefill's causal attention at smollm-360m's widths, a
     2,048-row chunk with 1,000 real rows after a 1,900-token prefix (the
     JSON row) and with 2,048 after 4,096: against its plain version (f32)
     over the real rows at 2^-8 of the largest |v| + rtol 2^-7 (the kernel
     rounds the probabilities and its output to bf16), the padding rows
     zeros; timed beside ``scaled_dot_product_attention`` over the real
     rows and their keys with the causal mask at the prefix's offset;
   * the chunk kernel's latent instance (DeepSeek-V2-Lite: 16 heads, keys
     192, values 128, its YaRN softmax scale) at the cell's chunk, 2,048
     real rows after a 4,096-token prefix, and 1,000 after 11,000, the
     chunk's K/V holding its real rows only: against its plain version in
     f32, each element within twice its bf16 roundings, the padding rows
     zeros; timed beside its plain version and
     ``scaled_dot_product_attention`` with the same scale;
   * the paged decode kernel's latent instance (``paged_decode_kernel
     <Mla576>``: 16 heads over 576-wide latent rows, values their first
     512) at the cell's decode step, B = 32 rows of 2,048-12,800 keys in
     16-key pages dealt at random, page 0 poisoned: against
     ``paged_mla_decode_attention_ref`` in f32, each element within twice
     its bf16 roundings; table entries past a row's last page never read;
     each row alone with the bits it has in the batch; timed beside its
     plain version (no PyTorch call attends through block tables);
   * the floor of a launch: the library's empty kernel through the same
     ctypes route, device time and back-to-back wall a call.
3. The batched path: a full-width smollm-360m ``ServingEngine`` with
   continuous batching, pruning and success-chance elasticity serves 16
   greedy requests (4 shared 32-token system prompts + 6-token suffixes,
   8 new tokens each) with the kernel launch counters zeroed just before
   and read just after.  The same requests then run one at a time on a
   second engine, under the kernel profiler, and must give the same tokens.
   A small input is checked against the plain versions on the CPU.
4. The one-at-a-time path behind the front door: the port's ``Router``
   over two full-width smollm-360m engine planes with ``examples/
   serve_smse.py``'s engine settings (2 units, EDF, adaptive merging,
   pruning, elasticity, no step batching) serves serve_smse's traffic
   (4 shared 32-token system prompts + 6-token suffixes, 4 new tokens,
   temperatures from {0, 0, 0.7}), with the counters zeroed just before
   and read just after.  Every greedy request completes, the decode
   kernel launches 32 times per decode step, the prefix cache hits, and
   the greedy tokens equal those of the same trace with the prefix cache
   off.  A small input is checked against the plain versions on the CPU.
   4b. Sliding-window decode at full width: smollm-360m with
   ``sliding_window`` 24 serves one 32-token greedy prompt for 32 decode
   steps through ``prefill_fn`` + ``decode_fn``, the counters zeroed just
   before and read just after: every step launches ``decode_attention``
   32 times.  The same run with the attention through
   ``decode_attention_plain`` on the card: step-1 logits within phase 5's
   bf16 tolerance, greedy tokens equal (where they part, the twin's
   top-2 margin is printed and must be within twice that tolerance).
   4c. The success-chance signal of the simulator's and the Router's
   scalers on the caller's device (stub substrates, no model): (a)
   ``tests/test_autoscale.py``'s cross-substrate trace with success-chance
   elasticity, the port's ``Simulator`` and stub engine on the card
   (``device="cuda"``) and on the host (``device="cpu"``): simulator ==
   stub engine on each, card == host, and each card run launches
   ``pmf_conv`` once for each decision its host run scored (counted on the
   host), the host runs none; (b) that file's stub-plane ``Router`` under
   sustained overload, its planes on the card: it adds and retires a plane
   and launches the kernel once for each plane the host run scored; (c)
   the same Router on ``"cpu"`` launches nothing and takes (b)'s routing
   decisions and plane accounting; (d) the launcher as a subprocess with
   ``--autoscale success-chance --extra-planes 1`` on the card exits 0
   and reports its plane decisions.  The counters are zeroed just before
   and read just after each card run of (a) and (b).
   4d. The disaggregated handoff and the closed-loop sessions, smollm-360m
   at full width (phase 3's weights), every run with the counters zeroed
   just before and read just after: (a) phase 3's 16 requests with phase
   3's step batching (no elasticity, merging, pruning or result cache) on
   the unified one-unit engine, then on a prefill unit and a decode unit
   (``m0@prefill:1,m0@decode:1``): every request done, 16 ``handoff``
   events in the control plane's trace, blocks migrated in = out > 0, the
   decode unit's cache reused tokens (the migrated blocks were attached),
   the prefill:decode block budgets 1:3, ``paged_decode_attention`` and
   ``rmsnorm`` launched, and greedy tokens bitwise equal to the unified
   run's; (b) one engine plane with that batching and the prefix cache
   (16-token blocks) behind a ``Router``, driven by ``WorkloadDriver``
   over 4 sessions of 4 turns (32-token opening prompts, 8-token
   follow-ups, 4 new tokens, the launcher's tenants ``gold:1:0.5:1,
   free:3``): every session done, the per-turn mean prefix hit depth
   non-decreasing and > 0 at the last turn, the hit rate above that of 16
   single-turn sessions (which hit nothing), and the same sessions with
   the cache off give the same tokens turn by turn; (c) the phase's wall,
   its launches and the decode unit's median decode step are printed.
5. Every model family (the smollm weights freed first, and re-made from
   the same seed for phase 7):
   * deepseek-moe-16b at full width (28 layers, 64 experts top-6 plus 2
     shared, 16.4 B parameters, random init) behind the ``Router`` on two
     planes sharing one copy of the weights, with phase 4's engine
     settings, serves 8 requests of phase 4's traffic.  Every decode step
     launches ``decode_attention`` 28 and ``rmsnorm`` 57 times; every
     greedy request completes; every greedy request that ran alone
     (bucket 1) gives the tokens of a direct ``prefill_fn`` +
     ``decode_fn`` greedy run.  Median decode-step wall, peak
     ``torch.cuda.max_memory_allocated`` and the launches are printed;
   * every registered arch, one at a time on the card (full width, but
     llava-next-34b at 30 of 60 layers and llama4-maverick at one dense +
     MoE unit, printed as cut): a 38-token prompt (the embedding rows of
     one for vlm; 8 encoder frames beside it for enc-dec), 8 greedy decode
     steps with finite logits and the launches a step of its layers; its
     weight bytes, the bytes a step reads and their bound at 3.35 TB/s,
     the median step wall, the device's busy share of 10 steady steps
     under the profiler, and its seconds;
   * every reduced config on the card against the same weights on the CPU,
     the CPU fed the card's greedy tokens over a prefill and 8 steps:
     logits within the larger of 5e-2 and the CPU's own movement under one
     bf16 ulp on the embedding table; the card's token the CPU's wherever
     the CPU's top-2 margin exceeds twice that.
   5b. DeepSeek-V2-Lite at its published size (the benchmark cell
   ``dsv2lite.longdoc16k.backlog``'s configuration and seeded weights:
   27 layers, latent attention, 64 experts top-6 plus 2 shared) behind
   the ``Router`` over one plane of the batched engine (chunked prefill,
   paged decode, prefix cache) serves 8 prompts of 300-12,288 tokens and
   a ninth repeating the first's first 1,600, 16 greedy tokens each, the
   counters zeroed just before and read just after: every request done;
   ``chunk_attention`` launched once a layer a chunk and
   ``paged_mla_decode_attention`` once a layer a decode step, the dense
   paged decode never; the prefix cache hits; the longest request's and
   the hit's served tokens within the cell's limit of the plain f32
   reference's best logits.
6. The port's launcher, ``python -m repro_torch.launch.serve``, runs as a
   subprocess on the card with ``--record-out`` and must exit 0 and print
   a summary with completed > 0.
7. The record → fit → replay loop and the Ch. 3 predictor:
   * the launcher's flight record is loaded (which validates it against
     ``obs.schema``), fitted (``fit_oracle``) and replayed
     (``drift_report``): the fitted table, decisions recorded and
     replayed, completed recorded and replayed, the first recorded span
     beside the median one, and the per-stage drift beside the
     reference's 15% bound (reported, not a check);
   * the live calibration row: a full-width smollm-360m ``ServingEngine``
     (one unit, EDF, no merging, pruning or caches, bucket 1: the
     one-at-a-time path) with warmed units serves 24 recorded requests far
     apart, with the counters zeroed just before and read just after; its
     record is fitted and replayed the same way;
   * the control replay: a stub-oracle engine recording replayed under its
     own oracle must match every recorded decision, at 0.0 drift;
   * the predictor at ``benchmarks/predictor.py``'s sizes: GBDT, Naive and
     the MLP trained on the card; accuracies at tau 0.12 and the
     benchmark's three checks (reported); the MLP trained on the card and
     on the host from the same initial parameters must predict within
     ``MLP_CARD_ATOL``; its fit wall on each.
8. Training on the card (the serving weights freed first):
   * the RMSNorm backward kernel against its plain version
     (``rmsnorm_bwd_ref``) in f32 and bf16 at a training step's rows
     (8192, 960), a decode step's (8, 1, 960) and 3 rows of every width
     ``check_width`` takes: dx at the forward's bar, dscale (a sum over
     every row) within 2^-20 of each column's sum of |terms| plus what
     moving 1 / rms by 2^-20 moves its bf16 terms by, plus one bf16 ulp;
     two calls give the same bits.  Timed at (8192, 960) bf16 beside
     its bound and ``torch.autograd.grad`` through ``F.rms_norm``;
   * every reduced config's ``loss_fn`` and every gradient on the card
     against the same weights and batch on the CPU (8 encoder frames for
     enc-dec), within the larger of 5e-2 and the CPU's own movement under
     one bf16 ulp on the embedding table (phase 5's rule; gradients
     relative to their norm), printed per family;
   * full-width smollm-360m (remat on) trained by ``python -m
     repro_torch.launch.train --arch smollm-360m --steps 30 --batch 8
     --seq 1024 --ckpt-every 30`` as a subprocess: exit 0, every logged
     loss finite, the last below the first.  The same command in this
     process, with the launch counters zeroed just before and read just
     after: 129 ``rmsnorm`` launches a step (65 + 64 recomputed) and 65
     ``rmsnorm_bwd``; its params and optimizer state equal the launcher's
     restored final checkpoint bit for bit.  Printed: the median step wall
     over steps 5-30, tokens/s, the device's busy share of 3 profiled
     steps, peak ``max_memory_allocated``, and MFU as a reading (6 N
     tokens / wall / 989 TFLOP/s, N without the embedding);
   * the restart check at ``tests/test_substrate.py``'s tiny trainer: a
     crash at step 4 resumes from step 3 and ends within 2e-2 of an
     uninterrupted run (the max |diff| printed).
10. ``parallel/`` on ``torch.distributed`` and the counted bounds (after
   phase 8; the serving and training weights freed), with the launch
   counters zeroed just before (a) and (b) and read just after:
   * (a) NCCL at world size 1 (a ``FileStore`` under ``build/``): the
     gradients of one full-width smollm-360m training step (8 x 1024
     tokens, remat on: the RMSNorm forward and backward kernels) through
     ``compressed_psum_grads``: the mean equals dequantize(quantize(g +
     r)) and the residual g + r minus it, bit for bit; the wall of one
     call.  ``pipeline_apply`` with one stage holding all 32 layers equals
     the stack run microbatch by microbatch, bit for bit;
   * (b) ``roofline.analyze`` over the B=1 decode step at phase 5's shape
     and the training step at phase 8's: counted dot FLOPs, bytes,
     t_compute and t_memory beside PERF.md's hand counts and this run's
     measured device busy time (phases 5 and 8); the kernels' credits
     must equal the launches a step makes (32 ``decode_attention`` and 65
     ``rmsnorm`` a decode step, 129 ``rmsnorm`` and 65 ``rmsnorm_bwd`` a
     training step);
   * (c) ``python -m repro_torch.launch.dryrun`` on the fake 16 x 16
     mesh for smollm-360m decode_32k, llama3-8b train_4k, xlstm-125m
     train_4k and prefill_32k (traced with their scans cut to 2 and 3
     trips), and zamba2-2.7b decode_32k (its Mamba2 update on each rank's
     (batch, head) shards), and ``python -m repro_torch.launch.perf
     --cell xlstm`` there (one process a variant); on the fake 4 x 2 mesh,
     smollm-360m's and zamba2-2.7b's decode_32k at cache lengths 16384
     and 32768 (``--seq-len``), whose collective bytes must be equal
     (decode attention combines its softmax across the sequence's
     shards), and zamba2-2.7b train_4k, whose collective bytes must lie
     within 1% of the count on torch 2.13 written here (every layout of
     the Mamba2 block is pinned, none left to DTensor's version); all as
     concurrent subprocesses on the host: each exits 0
     with an ``ok`` row; each row's terms and wall are printed, and the
     ladder's order by bytes.
11. The port's examples on the card, each a subprocess that zeroes the
   launch counters before its run and prints them after:
   ``python -m repro_torch.examples.serve_smse`` (80 requests, 2 planes,
   the one-at-a-time path: ``decode_attention`` and ``rmsnorm`` launched,
   no ``pmf_conv`` under its queue-length autoscaler), all 80 submitted
   requests accounted for, each completed or dropped; ``train_100m
   --full-width --steps 20`` (12 layers of smollm-360m, 8 x 512
   tokens): every logged loss finite, the last below the first, 25
   ``rmsnorm`` and 25 ``rmsnorm_bwd`` launches a step.
9. Print tokens/s, decode-step walls, per-kernel launches and times, the
   kernel JSON line (with each kernel's back-to-back wall a call,
   ``wall_ms``; launches summed over phases 3-8, 4b-4d, 10 and 11), and
   last the device JSON line.
"""

from __future__ import annotations

import ctypes
import gc
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12             # f32 outside the tensor cores

SEED = 0
N_SYS, SYS_LEN, SUFFIX_LEN, N_NEW, N_REQ = 4, 32, 6, 8, 16
# the one-at-a-time path: serve_smse's traffic and engine settings
ROUTER_REQ, ROUTER_NEW, ROUTER_MAX_LEN, ROUTER_DEADLINE = 24, 4, 64, 1000.0


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Wall time per call of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events: for a call whose kernels are short this is the
    host's launch rate, not the device's time."""
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


#: bytes rewritten before each cold call (a bitwise not of int16): over
#: twice the H100's 50 MB L2, so the call finds its operands in HBM, and
#: the L2 full of another kernel's dirty lines, as a layer of a step finds
#: them after the layers between
L2_FLUSH_BYTES = 256 * 2 ** 20
#: parts of that kernel's name (ATen's ``bitwise_not_kernel_cuda`` on
#: int16; a mask's ``~`` is the same kernel on bool)
MARK_KERNEL = ("bitwise_not", "(short)")


def profiled_calls(fn, n: int, mark) -> tuple[list[dict], int]:
    """``fn(i)`` for i < ``n`` under ``torch.profiler``, a bitwise not of
    the int16 buffer ``mark`` before each call and after the last: each
    call's device time by kernel name (us) for the calls the session kept
    whole, and the number of device events it recorded.  A session may
    drop events (one in phase 8 kept 15 of 20 calls): a call is whole
    when both its marks were recorded and it holds as many events as the
    most calls do (a call that lost events holds fewer, two calls that
    lost the mark between them more).  The marks are left out, and no
    profiled function may launch their kernel."""
    from collections import Counter
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            mark.bitwise_not_()
            fn(i)
        mark.bitwise_not_()
        torch.cuda.synchronize()
    events = sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    calls, current = [], None           # each call: its events by kernel
    for _, kernel, us in events:
        if all(part in kernel for part in MARK_KERNEL):
            if current is not None:
                calls.append(current)
            current = []
        elif current is not None:
            current.append((kernel, us))
    if len(calls) > n:
        raise AssertionError(f"{getattr(fn, '__name__', fn)} launches the "
                             f"marks' kernel")
    if not calls:
        return [], len(events)
    usual = Counter(len(c) for c in calls).most_common(1)[0][0]
    whole = []
    for c in calls:
        if len(c) == usual:
            per: dict = {}
            for kernel, us in c:
                per[kernel] = per.get(kernel, 0.0) + us
            whole.append(per)
    return whole, len(events)


def per_call_ms(calls: list[dict]) -> dict:
    """Device ms a call by kernel name, the mean over ``calls``."""
    out: dict = {}
    for c in calls:
        for kernel, us in c.items():
            out[kernel] = out.get(kernel, 0.0) + us / 1e3 / len(calls)
    return out


def device_ms(fn, iters: int = 20, warmup: int = 3,
              cold: bool = False) -> float:
    """Device time per call of ``fn``: the summed durations of the kernels
    (and copies) it launches, from ``torch.profiler``, over the calls the
    profiler kept whole (``profiled_calls``); ``cold`` makes the marks'
    buffer ``L2_FLUSH_BYTES``, which evicts the L2 before each call, else
    it is 2 bytes."""
    mark = torch.zeros((L2_FLUSH_BYTES if cold else 2) // 2,
                       dtype=torch.int16, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    name = getattr(fn, "__name__", fn)
    # a profiler session now and then records no device event at all
    # (seen once in phase 2 on an H100); such a session is taken again
    for attempt in range(3):
        calls, n_events = profiled_calls(lambda i: fn(), iters, mark)
        if calls:
            if len(calls) < iters:
                log(f"  (the profiler kept {len(calls)} of {iters} calls of "
                    f"{name} whole)")
            return sum(per_call_ms(calls).values())
        log(f"  (profiler session {attempt + 1} of {name} recorded "
            f"{n_events} device events and no whole call; taken again)")
    raise AssertionError(f"the profiler recorded no whole call of {name}")


def timings(kern, plain, library=None, iters: int = 64) -> dict:
    """Device time per call (the row's ms, plain_ms, library_ms), each
    call with a cold L2 (``device_ms(cold=True)``); under "warm" the same
    back to back on operands the L2 may hold; and under "wall", the
    back-to-back wall time per call of kernel, plain version and
    yardstick."""
    calls = {"ms": kern, "plain_ms": plain, "library_ms": library}
    row = {k: None if f is None else device_ms(f, cold=True)
           for k, f in calls.items()}
    row["warm"] = {k: None if f is None else device_ms(f)
                   for k, f in calls.items()}
    row["wall"] = {k: None if f is None else time_ms(f, iters=iters)
                   for k, f in calls.items()}
    return row


def cold_and_warm(row: dict, library: str = "library") -> str:
    """A kernel row's device times a call, cold L2 and [warm], beside its
    bound; a cold time under the bound fails (operands found in the L2
    are not a kernel's speed)."""
    if row["ms"] < row["bound_ms"]:
        raise AssertionError(f"{row.get('name', library)}: {row['ms']:.6f} "
                             f"ms with a cold L2, under its bound "
                             f"{row['bound_ms']:.6f} ms")

    def both(k):
        return ("none" if row[k] is None else
                f"{row[k]:.5f} [{row['warm'][k]:.5f}]")
    return (f"device time a call, cold L2 [warm]: kernel {both('ms')} ms, "
            f"plain {both('plain_ms')} ms, {library} {both('library_ms')}"
            f"; bound {row['bound_ms']:.6f} ms ({row['bound_by']})")


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

#: lengths that start, fill and cross a 16-key granule (one page) and the
#: 8-rank deal (128 keys), and the capacity
BOUNDARY_LENGTHS = (0, 1, 15, 16, 17, 127, 128, 129, 1024)
#: sliding windows that cut those rows, and one at least as long as any
#: row (the bits of no window)
WINDOWS = (1, 15, 16, 17, 100, 2048)
#: the windowed kernel's timed shape: B = 1, one row of this many keys in
#: a cache as long, attending to the last WINDOW_TIMED of them
WINDOW_TIMED_KEYS, WINDOW_TIMED = 4228, 1024


def check_split(name, kern, split, args, lens) -> float:
    """The kernel against the plain model of its split-key algorithm, fed
    the same inputs in f32 and so not rounded to bf16 at its end (atol 1e-4
    / rtol 4e-3: half a bf16 ulp is at most 2^-8 of a value, the kernel's
    rounding of its output), and two calls against each other, bit for
    bit; returns the max |err|."""
    got = kern(*args)
    want = split(*(a.float() if a.dtype == torch.bfloat16 else a
                   for a in args))
    assert_close(f"{name} lens {lens} (split model)", got, want, 1e-4, 4e-3)
    if not torch.equal(got, kern(*args)):
        raise AssertionError(f"{name} lens {lens}: two calls differ")
    return max_err(got, want)


def check_window(name, q, k, v, ln, lens, window: int) -> float:
    """The windowed kernel on (q, k, v, ln) against the windowed split
    model (f32 inputs; ``check_split``'s bars, two calls bit-equal) and
    the layer's windowed plain version on the bf16 inputs (1e-2, the rows
    that attend to a key: the formula gives NaN where none is left, the
    kernel 0); a window at least as long as every row gives the bits of
    no window.  Returns the max |err| against the split model."""
    from repro_torch.kernels.decode_attention.ops import decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import (
        attended_keys, decode_attention_split_ref)
    from repro_torch.models.layers import decode_attention_plain
    kern = lambda *a: decode_attention_cuda(*a, window=window)  # noqa: E731
    split = lambda *a: decode_attention_split_ref(  # noqa: E731
        *a, window=window)
    what = f"{name} window {window}"
    err = check_split(what, kern, split, (q, k, v, ln), lens)
    got = kern(q, k, v, ln)
    live = attended_keys(ln.long(), k.shape[1], window) > 0
    if not torch.equal(got[~live], torch.zeros_like(got[~live])):
        raise AssertionError(f"{what}: a row with no key is not zero")
    want = decode_attention_plain(q, k, v, ln, window)
    assert_close(f"{what} (bf16 layer plain)", got[live], want[live], 1e-2,
                 1e-2)
    if window >= max(int(n) for n in lens) and not torch.equal(
            got, decode_attention_cuda(q, k, v, ln)):
        raise AssertionError(f"{what}: a window covering every row differs "
                             f"from no window")
    return err


def check_decode_attention(mc, max_len: int) -> dict:
    """The contiguous-cache kernel at the one-at-a-time path's shapes (a
    ``max_len`` cache, 38-50 keys) and at long lengths (up to 1024), with
    and without a sliding window.  The JSON row times the path's shape,
    B = 1; the long shape and the windowed one are timed too."""
    from repro_torch.kernels.decode_attention.ops import decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, decode_attention_split_ref)
    from repro_torch.models.layers import decode_attention_plain
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED + 5)
    hkv, hd, h, layers = (mc.n_kv_heads, mc.resolved_head_dim, mc.n_heads,
                          mc.n_layers)
    served = (SYS_LEN + SUFFIX_LEN, SYS_LEN + SUFFIX_LEN + 2 * ROUTER_NEW + 5)
    worst, worst_f32, timed = 0.0, 0.0, {}
    for s, (lo, hi) in ((max_len, served), (1024, (1, 1025))):
        for b in (1, 8):
            # one cache per layer, walked by the timing as a decode step
            # walks them, so K/V come from device memory and not from L2
            shape = (layers, b, s, hkv, hd)
            k = torch.randn(shape, generator=g, device=dev).bfloat16()
            v = torch.randn(shape, generator=g, device=dev).bfloat16()
            q = torch.randn((b, h, hd), generator=g, device=dev).bfloat16()
            lens = rng.integers(lo, hi, size=b)
            if s == 1024 and b > 1:
                lens[0] = s
            ln = torch.from_numpy(lens.astype(np.int32)).to(dev)
            name = f"decode_attention B={b} S={s} lens {lens.tolist()}"
            got = decode_attention_cuda(q, k[0], v[0], ln)
            want32 = decode_attention_ref(q.float(), k[0].float(),
                                          v[0].float(), ln)
            assert_close(f"{name} (f32 plain)", got, want32, 1e-4, 4e-3)
            want = decode_attention_plain(q, k[0], v[0], ln)
            assert_close(f"{name} (bf16 layer plain)", got, want, 1e-2, 1e-2)
            worst = max(worst, max_err(got, want))
            worst_f32 = max(worst_f32, max_err(got, want32))
            k2, v2 = k[0].clone(), v[0].clone()
            for i, n in enumerate(lens.tolist()):
                k2[i, n:], v2[i, n:] = 99.0, -99.0
            if not torch.equal(decode_attention_cuda(q, k2, v2, ln), got):
                raise AssertionError(f"{name}: keys past the length leak "
                                     f"into the output")
            for i in range(b):
                one = decode_attention_cuda(
                    q[i:i + 1].contiguous(), k[0, i:i + 1].contiguous(),
                    v[0, i:i + 1].contiguous(), ln[i:i + 1].contiguous())
                if not torch.equal(one[0], got[i]):
                    raise AssertionError(f"{name}: row {i} alone differs "
                                         f"from row {i} in the batch")
            if (s, b) in ((max_len, 1), (1024, 8)):
                timed[(s, b)] = (q, k, v, ln, lens)

    worst_split = worst_window = 0.0
    for n in BOUNDARY_LENGTHS:
        shape = (3, 1024, hkv, hd)
        k = torch.randn(shape, generator=g, device=dev).bfloat16()
        v = torch.randn(shape, generator=g, device=dev).bfloat16()
        q = torch.randn((3, h, hd), generator=g, device=dev).bfloat16()
        lens = [n, 1024, 45]
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        worst_split = max(worst_split, check_split(
            "decode_attention B=3 S=1024", decode_attention_cuda,
            decode_attention_split_ref, (q, k, v, ln), lens))
        for w in WINDOWS:
            worst_window = max(worst_window, check_window(
                "decode_attention B=3 S=1024", q, k, v, ln, lens, w))

    def times(s, b):
        q, k, v, ln, lens = timed[(s, b)]
        it = iter(range(10 ** 9))
        kt = k.transpose(2, 3).contiguous()       # (L, B, Hkv, S, hd)
        vt = v.transpose(2, 3).contiguous()
        q4 = q[:, :, None, :]
        mask = (torch.arange(s, device=dev)[None, :] < ln[:, None]) \
            [:, None, None, :]

        def kern():
            i = next(it) % layers
            decode_attention_cuda(q, k[i], v[i], ln)

        def plain():
            i = next(it) % layers
            decode_attention_ref(q, k[i], v[i], ln)

        def library():
            i = next(it) % layers
            F.scaled_dot_product_attention(q4, kt[i], vt[i], attn_mask=mask,
                                           enable_gqa=True)

        n_keys = int(lens.sum())
        nbytes = (q.numel() * 2 * 2 + 2 * n_keys * hkv * hd * 2
                  + ln.numel() * 4)
        b_ms, b_by = bound(nbytes, 4.0 * n_keys * h * hd)
        return {**timings(kern, plain, library), "bound_ms": b_ms,
                "bound_by": b_by, "keys": n_keys}

    main, long = times(max_len, 1), times(1024, 8)
    win = window_times(hkv, hd, h, layers, g)
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/"
                        "decode_attention.py:86",
            "max_abs_err": worst, **{k: main[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "warm", "wall")},
            "shape": f"B=1 H={h} Hkv={hkv} hd={hd} S={max_len} "
                     f"keys={main['keys']}; max|err| vs f32 plain "
                     f"{worst_f32:.3g}, vs split model {worst_split:.3g}; "
                     f"long B=8 S=1024 keys={long['keys']}:"
                     f" kernel {long['ms']:.4f} ms, plain "
                     f"{long['plain_ms']:.4f} ms, bound "
                     f"{long['bound_ms']:.5f} ms, sdpa "
                     f"{long['library_ms']:.4f} ms (device); wall "
                     f"{long['wall']}; windowed: max|err| vs split model "
                     f"{worst_window:.3g} at windows {WINDOWS}",
            **{f"window_{k}": win[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "keys", "warm")}, "window_wall_ms": win["wall"]["ms"]}


def window_times(hkv: int, hd: int, h: int, layers: int, g) -> dict:
    """The windowed kernel timed at B = 1: one row of
    ``WINDOW_TIMED_KEYS`` keys in a cache as long, attending to its last
    ``WINDOW_TIMED``; one cache a layer, walked as a decode step walks
    them.  Beside it the windowed plain version (f32) and
    ``scaled_dot_product_attention`` with the same boolean mask; the
    bound is the window's K and V bytes (and q, out, the length) over the
    card's memory rate."""
    from repro_torch.kernels.decode_attention.ops import decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    dev = torch.device("cuda")
    s, w = WINDOW_TIMED_KEYS, WINDOW_TIMED
    k = torch.randn((layers, 1, s, hkv, hd), generator=g,
                    device=dev).bfloat16()
    v = torch.randn((layers, 1, s, hkv, hd), generator=g,
                    device=dev).bfloat16()
    q = torch.randn((1, h, hd), generator=g, device=dev).bfloat16()
    ln = torch.tensor([s], dtype=torch.int32, device=dev)
    assert_close("decode_attention window timed shape (f32 plain)",
                 decode_attention_cuda(q, k[0], v[0], ln, window=w),
                 decode_attention_ref(q.float(), k[0].float(), v[0].float(),
                                      ln, window=w), 1e-4, 4e-3)
    kt = k.transpose(2, 3).contiguous()           # (L, 1, Hkv, S, hd)
    vt = v.transpose(2, 3).contiguous()
    q4 = q[:, :, None, :]
    pos = torch.arange(s, device=dev)[None, :]
    mask = ((pos < ln[:, None]) & (pos >= ln[:, None] - w))[:, None, None, :]
    it = iter(range(10 ** 9))

    def kern():
        i = next(it) % layers
        decode_attention_cuda(q, k[i], v[i], ln, window=w)

    def plain():
        i = next(it) % layers
        decode_attention_ref(q, k[i], v[i], ln, window=w)

    def library():
        i = next(it) % layers
        F.scaled_dot_product_attention(q4, kt[i], vt[i], attn_mask=mask,
                                       enable_gqa=True)

    nbytes = q.numel() * 2 * 2 + 2 * w * hkv * hd * 2 + ln.numel() * 4
    b_ms, b_by = bound(nbytes, 4.0 * w * h * hd)
    return {**timings(kern, plain, library), "bound_ms": b_ms,
            "bound_by": b_by, "keys": w}


def family_attention_shapes() -> list[tuple]:
    """(arch, query rows a kv head, kv heads, head dim, cross) of every
    attention a registered arch decodes with, and the enc-dec model's
    cross-attention."""
    from repro_torch.configs.registry import ARCHS
    out = []
    for name, cfg in ARCHS.items():
        if cfg.family == "ssm":
            continue
        shape = (cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        out.append((name,) + shape + (False,))
        if cfg.family == "encdec":
            out.append((name,) + shape + (True,))
    return out


#: the window every family's shape is checked under: it cuts the 38-50
#: keys of the self-attention rows mid-granule, and covers the
#: cross-attention's frames
FAMILY_WINDOW = 17


def check_family_attention(max_len: int) -> dict:
    """The contiguous-cache kernel at every served (G, Hkv, hd), B in
    {1, 8}: self-attention over 38-50 keys of a ``max_len`` cache, and the
    enc-dec cross-attention over its ``ENC_FRAMES`` frames of a
    ``max_len`` cache.  Against the plain version on the inputs cast to f32
    (atol 1e-4 / rtol 4e-3), the layer's bf16 plain version (1e-2) and the
    split model (1e-4 / 4e-3); keys past each row's length are never
    read (set to +-99, the same bits); and under a sliding window of
    ``FAMILY_WINDOW`` keys (``check_window``)."""
    from repro_torch.kernels.decode_attention.ops import decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, decode_attention_split_ref)
    from repro_torch.models.layers import decode_attention_plain
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    rng = np.random.default_rng(SEED + 13)
    worst, worst_f32, names = 0.0, 0.0, []
    for arch, group, hkv, hd, cross in family_attention_shapes():
        for b in (1, 8):
            shape = (b, max_len, hkv, hd)
            k = torch.randn(shape, generator=g, device=dev).bfloat16()
            v = torch.randn(shape, generator=g, device=dev).bfloat16()
            q = torch.randn((b, group * hkv, hd), generator=g,
                            device=dev).bfloat16()
            lens = (np.full(b, ENC_FRAMES) if cross else
                    rng.integers(SYS_LEN + SUFFIX_LEN, 51, size=b))
            ln = torch.from_numpy(lens.astype(np.int32)).to(dev)
            name = (f"decode_attention {arch} {'cross' if cross else 'self'}"
                    f" G={group} Hkv={hkv} hd={hd} B={b} lens "
                    f"{lens.tolist()}")
            got = decode_attention_cuda(q, k, v, ln)
            want32 = decode_attention_ref(q.float(), k.float(), v.float(), ln)
            assert_close(f"{name} (f32 plain)", got, want32, 1e-4, 4e-3)
            want = decode_attention_plain(q, k, v, ln)
            assert_close(f"{name} (bf16 layer plain)", got, want, 1e-2, 1e-2)
            worst = max(worst, max_err(got, want))
            worst_f32 = max(worst_f32, max_err(got, want32),
                            check_split(name, decode_attention_cuda,
                                        decode_attention_split_ref,
                                        (q, k, v, ln), lens.tolist()))
            k2, v2 = k.clone(), v.clone()
            for i, n in enumerate(lens.tolist()):
                k2[i, n:], v2[i, n:] = 99.0, -99.0
            if not torch.equal(decode_attention_cuda(q, k2, v2, ln), got):
                raise AssertionError(f"{name}: keys past the length leak "
                                     f"into the output")
            worst_f32 = max(worst_f32, check_window(
                name, q, k, v, ln, lens.tolist(), FAMILY_WINDOW))
        names.append(f"{arch}{' cross' if cross else ''} "
                     f"({group}, {hkv}, {hd})")
    return {"max_abs_err": worst, "max_abs_err_f32": worst_f32,
            "shapes": names}


def check_paged_attention(mc, max_len: int, max_batch: int, ps: int) -> dict:
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref, paged_decode_attention_split_ref)
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
    def table(lens):
        perm = rng.permutation(np.arange(1, n_pages))
        tables = np.zeros((len(lens), mp), np.int32)
        for i, n in enumerate(lens):
            npg = -(-int(n) // ps)
            tables[i, :npg] = perm[i * mp:i * mp + npg]
        return torch.from_numpy(tables).to(dev)

    worst, worst_f32, rows = 0.0, 0.0, {}
    for (lo, hi), b in [(r, b) for r in ((1, max_len + 1), served)
                        for b in (1, 3, 8)]:
        lens = rng.integers(lo, hi, size=b)
        if hi > max_len and b > 1:
            lens[0] = max_len
        tab = table(lens)
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
        rows["long" if hi > max_len else "served", b] = (q, tab, ln, lens)
    worst_split = 0.0
    for n in BOUNDARY_LENGTHS:
        lens = [n, max_len, 45]
        tab, ln = table(lens), torch.tensor(lens, dtype=torch.int32,
                                            device=dev)
        q = torch.randn((3, h, hd), generator=g, device=dev).bfloat16()
        args = (q, kp[0], vp[0], tab, ln)
        worst_split = max(worst_split, check_split(
            "paged_decode_attention B=3", paged_decode_attention_cuda,
            paged_decode_attention_split_ref, args, lens))
        # entries past each sequence's last page index no page at all
        poisoned = tab.clone()
        for i, m in enumerate(lens):
            poisoned[i, -(-m // ps):] = 2 ** 30
        if not torch.equal(paged_decode_attention_cuda(q, kp[0], vp[0],
                                                       poisoned, ln),
                           paged_decode_attention_cuda(*args)):
            raise AssertionError(f"paged_decode_attention lens {lens}: "
                                 f"table entries past the length leak")

    def times(kind):
        q, tab, ln, lens = rows[kind, max_batch]
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
        b_ms, b_by = bound(nbytes, 4.0 * n_keys * h * hd)
        return {**timings(kern, plain), "bound_ms": b_ms, "bound_by": b_by,
                "keys": n_keys, "lens": lens}

    long, served_t = times("long"), times("served")
    # yardstick, not the same function: SDPA over the long shape's keys
    # gathered into a contiguous cache (the gather is outside the timing)
    q, tab, ln, lens = rows["long", max_batch]
    gather = tab.long()
    kc = kp[:, gather].reshape(layers, max_batch, mp * ps, hkv, hd) \
        .transpose(2, 3).contiguous()
    vc = vp[:, gather].reshape(layers, max_batch, mp * ps, hkv, hd) \
        .transpose(2, 3).contiguous()
    mask = (torch.arange(mp * ps, device=dev)[None, :] < ln[:, None]) \
        [:, None, None, :]
    it = iter(range(10 ** 9))

    def sdpa():
        i = next(it) % layers
        F.scaled_dot_product_attention(q[:, :, None], kc[i], vc[i],
                                       attn_mask=mask, enable_gqa=True)

    sdpa_ms = device_ms(sdpa, cold=True)
    del kc, vc
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/"
                        "decode_attention.py:166",
            "max_abs_err": worst, **{k: long[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "warm", "wall")},
            "shape": f"B={max_batch} H={h} Hkv={hkv} hd={hd} PS={ps} "
                     f"MP={mp} keys={long['keys']}; max|err| vs f32 plain "
                     f"{worst_f32:.3g}, vs split model {worst_split:.3g}; "
                     f"served B={max_batch} lens {served_t['lens'].tolist()}"
                     f" keys={served_t['keys']}: kernel "
                     f"{served_t['ms']:.5f} ms, plain "
                     f"{served_t['plain_ms']:.5f} ms, bound "
                     f"{served_t['bound_ms']:.7f} ms (device); sdpa over "
                     f"the long keys gathered into a contiguous cache "
                     f"{sdpa_ms:.5f} ms (device; not the same function: "
                     f"no block table)"}


#: one bf16 ulp: the kernel's f32 1 / rms differs from the plain version's
#: in its last bits (another summation order), which moves x * r across a
#: rounding point of the cast to bf16 now and then
RMS_TOL = {torch.bfloat16: (1e-5, 8e-3), torch.float32: (1e-5, 1e-5)}
#: row widths that reach every instantiation of the RMSNorm kernel
RMS_D = (64, 256, 512, 960, 2048, 2560, 4096, 5120, 7168)
#: the largest share of bf16 outputs that may differ from the plain
#: version's bits (0 of 160,192 on the H100): a kernel that rounds x * r
#: times the scale once, skipping the cast of x * r, changes about a quarter
RMS_DIFFER_MAX = 1e-3


def rms_geometry(d: int, dtype) -> tuple[int, int] | None:
    """The (warps, vectors a lane) instantiation the library picks for rows
    of ``d`` elements of ``dtype``, or None if it takes no such row."""
    from repro_torch.kernels.build import library
    warps, vpl = ctypes.c_int(), ctypes.c_int()
    err = library().rmsnorm_geometry(d, dtype.itemsize, ctypes.byref(warps),
                                     ctypes.byref(vpl))
    return None if err else (warps.value, vpl.value)


def check_rmsnorm(mc, max_batch: int, budget: int) -> dict:
    """RMSNorm at the main paths' shapes and at one shape per instantiation
    against the plain version (one bf16 ulp; f32 at 1e-5), each row alone
    against the same row in the batch and two calls against each other, bit
    for bit; timed at the batched path's decode shape."""
    from repro_torch.kernels.rmsnorm.ops import MAX_D, rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    from repro_torch.configs.registry import ARCHS
    d = mc.d_model
    cases = [((max_batch, 1, d), torch.bfloat16), ((1, 1, d), torch.bfloat16),
             ((budget, d), torch.bfloat16)]
    # every family's served rows: a decode step, a bucket of 8, a prompt,
    # at each registered width and the reduced configs'
    for w in sorted({c.d_model for c in ARCHS.values()} | {128}):
        cases += [((1, 1, w), torch.bfloat16), ((8, 1, w), torch.bfloat16),
                  ((1, SYS_LEN + SUFFIX_LEN, w), torch.bfloat16)]
    for dt in (torch.bfloat16, torch.float32):
        per_vec = 16 // dt.itemsize
        every = {rms_geometry(w, dt) for w in range(per_vec, MAX_D + 1,
                                                    per_vec)}
        first = {}
        for w in RMS_D:
            first.setdefault(rms_geometry(w, dt), w)
        if None in every or set(first) != every:
            raise AssertionError(f"rmsnorm {dt}: widths up to {MAX_D} take "
                                 f"{sorted(every, key=str)}, {RMS_D} reach "
                                 f"{sorted(first, key=str)}")
        cases += [((max_batch, w), dt) for w in first.values()]
    worst, differ, total = 0.0, 0, 0
    for shape, dt in cases:
        x = (3.0 * torch.randn(shape, generator=g, device=dev)).to(dt)
        scale = (1.0 + 0.1 * torch.randn(shape[-1:], generator=g,
                                         device=dev)).to(dt)
        got = rmsnorm_cuda(x, scale)
        want = rmsnorm_ref(x, scale)
        name = f"rmsnorm {shape} {dt}"
        assert_close(name, got, want, *RMS_TOL[dt])
        if not torch.equal(got, rmsnorm_cuda(x, scale)):
            raise AssertionError(f"{name}: two calls differ")
        rows = x.reshape(-1, shape[-1])
        for i in range(rows.shape[0]):
            if not torch.equal(rmsnorm_cuda(rows[i:i + 1], scale)[0],
                               got.reshape(rows.shape)[i]):
                raise AssertionError(f"{name}: row {i} alone differs from "
                                     f"row {i} in the batch")
        if dt == torch.bfloat16:
            differ += int((got != want).sum())
            total += got.numel()
        worst = max(worst, max_err(got, want))
        if shape == cases[0][0]:
            timed = x, scale
    if differ > RMS_DIFFER_MAX * total:
        raise AssertionError(f"rmsnorm: {differ} of {total} bf16 outputs "
                             f"not bit-equal to the plain version, more "
                             f"than {RMS_DIFFER_MAX}")
    x, scale = timed
    library = None
    if hasattr(F, "rms_norm"):
        def library():
            F.rms_norm(x, (d,), scale, 1e-5)
    b_ms, b_by = bound(x.numel() * 2 * 2 + d * 2, 4.0 * x.numel())
    return {"name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm/rmsnorm.py:24",
            "max_abs_err": worst,
            **timings(lambda: rmsnorm_cuda(x, scale),
                      lambda: rmsnorm_ref(x, scale), library, iters=200),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"x {tuple(x.shape)} bf16; {len(cases)} shapes, "
                     f"{differ} of {total} bf16 outputs not bit-equal to "
                     f"the plain version ({differ / total:.2e})"}


def pmf_inputs(n: int, length: int, seed: int):
    rng = np.random.default_rng(seed)
    pet = rng.random((n, length)).astype(np.float32)
    pet /= pet.sum(axis=1, keepdims=True)
    pct = rng.random((n, length)).astype(np.float32)
    pct /= pct.sum(axis=1, keepdims=True)
    lo = 2 * length - 1
    # below the grid, inside it (both halves) and above it
    dl = np.concatenate([np.full(4, -1.0), rng.integers(0, length, n // 2),
                         rng.integers(length, lo, n // 4 - 4),
                         np.full(n - 4 - n // 2 - (n // 4 - 4), lo + 5.0)])
    dev = torch.device("cuda")
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev)
                 for a in (pet, pct, dl))


def success_inputs(n: int, seed: int):
    """The scheduler's success-chance call: n (PET, PCT, deadline) from
    normals, PETs clipped at time 1 as short tasks are."""
    from repro_torch.core.pmf import PMF
    rng = np.random.default_rng(seed)
    specs = [(rng.uniform(4, 30), rng.uniform(1, 5), rng.uniform(5, 60),
              rng.uniform(1, 8), int(rng.integers(-10, 15)))
             for _ in range(n)]
    pets = [PMF.from_normal(m, s) for m, s, _, _, _ in specs]
    pcts = [PMF.from_normal(m, s) for _, _, m, s, _ in specs]
    dls = [int(e.mean() + c.mean() + d)
           for e, c, (_, _, _, _, d) in zip(pets, pcts, specs)]
    return pets, pcts, dls


def check_pmf_conv(n: int = 32, length: int = 64) -> dict:
    """The kernel at (n, length) and (n, 2 length) against its plain version
    (f32, atol 1e-6 / rtol 1e-5), with the PEND cut at the success index
    and apart from it, and the front door ``batched_success`` at
    (n, length) against ``chance_of_success`` (1e-5)."""
    from repro_torch.core.pmf import chance_of_success
    from repro_torch.kernels.pmf_conv.ops import batched_success, pmf_conv_cuda
    from repro_torch.kernels.pmf_conv.ref import pmf_conv_ref
    worst = 0.0
    for ln in (length, 2 * length):
        pet, pct, dl = pmf_inputs(n, ln, SEED + 2)
        # the cut one index past, at, and before the success index
        cut = dl + torch.tensor([1.0, 0.0, -3.0], device=dl.device) \
            .repeat(n // 3 + 1)[:n]
        for args in ((pet, pct, dl), (pet, pct, dl, cut)):
            out_k, suc_k = pmf_conv_cuda(*args)
            out_r, suc_r = pmf_conv_ref(*args)
            what = f"pmf_conv ({n}, {ln}){' cut' if len(args) > 3 else ''}"
            assert_close(f"{what} out", out_k, out_r, 1e-6, 1e-5)
            assert_close(f"{what} success", suc_k, suc_r, 1e-6, 1e-5)
            worst = max(worst, max_err(out_k, out_r), max_err(suc_k, suc_r))
    pets, pcts, dls = success_inputs(n, SEED + 7)
    got = batched_success(pets, pcts, dls, length=length)

    want = np.array([chance_of_success(e, c, dl, droppable_prev=True)
                     for e, c, dl in zip(pets, pcts, dls)])
    if not np.allclose(got, want, atol=1e-5, rtol=0):
        raise AssertionError(f"batched_success differs from "
                             f"chance_of_success by "
                             f"{np.abs(got - want).max()}")
    wall = success_wall_ms(n, length)
    pet_t, pct_t, dl_t = pmf_inputs(n, length, SEED + 2)
    # yardstick: the convolution alone as one grouped conv1d call
    torch.backends.cudnn.allow_tf32 = False
    w = torch.flip(pet_t, dims=[1])[:, None, :].contiguous()
    xin = pct_t[None]
    lo = 2 * length - 1
    nbytes = 4 * (2 * n * length + n + n * lo + n)
    b_ms, b_by = bound(nbytes, 2.0 * n * length * length)
    return {"name": "pmf_conv", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/pmf_conv.cu",
            "replaces": "src/repro/kernels/pmf_conv/pmf_conv.py:74",
            "max_abs_err": worst,
            **timings(lambda: pmf_conv_cuda(pet_t, pct_t, dl_t),
                      lambda: pmf_conv_ref(pet_t, pct_t, dl_t),
                      lambda: F.conv1d(xin, w, padding=length - 1, groups=n),
                      iters=20),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"pet/pct ({n}, {length}) f32; batched_success vs "
                     f"chance_of_success max |err| "
                     f"{np.abs(got - want).max():.3g}, wall a call "
                     f"{wall:.5f} ms"}


#: (real rows, prefix) of the chunked prefill's kernel rows: a typical
#: chunk of the longdoc traffic (the JSON row) and a full chunk after a
#: long prefix; the chunk always launches with the step budget's rows
CHUNK_SHAPES = ((1000, 1900), (2048, 4096))
CHUNK_BUDGET = 2048
#: one set of inputs a layer, walked as a chunk walks its layers
CHUNK_LAYERS = 4


def check_chunk_attention(mc) -> dict:
    """The chunked prefill's kernel at smollm-360m's widths, B = 1, the
    unit runner's 2,048-row chunk, at ``CHUNK_SHAPES``: against its plain
    version in f32 over the real rows, each element within twice the most
    the kernel's bf16 roundings can move it (2^-8 of the plain version
    applied to |v|, plus 2^-8 of the output: each probability rounded
    before P.V moves an output by at most 2^-9 sum_j p_j |v_j|, and the
    output's rounding by 2^-9 of it; about 3e-3 here against a typical
    |output| of 0.02-0.03), zeros in the padding rows; ``err_share`` is
    the largest |err| over its element's bound.  Timed beside the plain
    version and ``F.scaled_dot_product_attention`` over the real rows and their
    keys with the causal mask at the prefix's offset (a yardstick the port
    never calls); the bound is the real rows' products at the bf16 tensor
    peak or their bytes at the HBM rate, whichever is longer."""
    from repro_torch.kernels.chunk_attention.ops import chunk_attention_cuda
    from repro_torch.kernels.chunk_attention.ref import (causal_cells,
                                                         chunk_attention_ref)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    h, hkv, hd = mc.n_heads, mc.n_kv_heads, mc.resolved_head_dim
    s = CHUNK_BUDGET
    worst, share, timed = 0.0, 0.0, []
    for c, p in CHUNK_SHAPES:
        def draw(*shape):
            return torch.randn((CHUNK_LAYERS,) + shape, generator=g,
                               device=dev).bfloat16()
        q, k, v = draw(1, s, h, hd), draw(1, s, hkv, hd), draw(1, s, hkv, hd)
        pk, pv = draw(1, p, hkv, hd), draw(1, p, hkv, hd)
        name = f"chunk_attention c={c} P={p}"
        got = chunk_attention_cuda(q[0], pk[0], pv[0], k[0], v[0], c)
        f32 = [t[0].float() for t in (q, pk, pv, k, v)]
        want = chunk_attention_ref(*f32, c)[:, :c]
        tol = 2.0 ** -8 * (chunk_attention_ref(
            f32[0], f32[1], f32[2].abs(), f32[3], f32[4].abs(), c)[:, :c]
            + want.abs())
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: kernel output is not finite")
        err = (got[:, :c].float() - want).abs()
        if not (err <= tol).all():
            raise AssertionError(
                f"{name}: max |err| / bound {float((err / tol).max()):.3g}"
                f" (max |err| {float(err.max()):.3g}, smallest bound "
                f"{float(tol.min()):.3g})")
        if got[:, c:].any():
            raise AssertionError(f"{name}: padding rows are not zeros")
        worst = max(worst, float(err.max()))
        share = max(share, float((err / tol).max()))
        # the yardstick's operands, laid out (B, heads, rows, hd) beforehand
        qt = q[:, :, :c].transpose(2, 3).contiguous()
        kt = torch.cat([pk, k[:, :, :c]], 2).transpose(2, 3).contiguous()
        vt = torch.cat([pv, v[:, :, :c]], 2).transpose(2, 3).contiguous()
        mask = (torch.arange(p + c, device=dev)[None, :]
                <= torch.arange(c, device=dev)[:, None] + p)
        it = iter(range(10 ** 9))

        def kern():
            i = next(it) % CHUNK_LAYERS
            chunk_attention_cuda(q[i], pk[i], pv[i], k[i], v[i], c)

        def plain():
            i = next(it) % CHUNK_LAYERS
            chunk_attention_ref(q[i], pk[i], pv[i], k[i], v[i], c)

        def library():
            i = next(it) % CHUNK_LAYERS
            F.scaled_dot_product_attention(qt[i], kt[i], vt[i],
                                           attn_mask=mask, enable_gqa=True)

        cells = causal_cells(p, c)
        nbytes = 2 * hd * ((c + s) * h + 2 * (p + c) * hkv)
        flops = 4.0 * h * hd * cells
        t_mem = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / H100_BF16_FLOPS * 1e3
        timed.append({**timings(kern, plain, library, iters=20),
                      "bound_ms": max(t_mem, t_ops),
                      "bound_by": "operations" if t_ops >= t_mem else "bytes",
                      "cells": cells, "c": c, "p": p})
    main, full = timed
    return {"name": "chunk_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      "chunk_prefill_attention.cu",
            "replaces": "none (the JAX cached prefill is jnp full_attention,"
                        " src/repro/models/layers.py)",
            "max_abs_err": worst, "err_share": share,
            **{k: main[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "warm", "wall")},
            "shape": f"B=1 H={h} Hkv={hkv} hd={hd}, {s} rows of which "
                     f"c={main['c']} real after P={main['p']} "
                     f"({main['cells']} causal cells a head); full chunk "
                     f"c={full['c']} P={full['p']}: kernel "
                     f"{full['ms']:.4f} [{full['warm']['ms']:.4f}] ms, plain "
                     f"{full['plain_ms']:.4f} ms, sdpa "
                     f"{full['library_ms']:.4f} ms, bound "
                     f"{full['bound_ms']:.5f} ms ({full['bound_by']}), "
                     f"device cold [warm]; wall {full['wall']}"}


#: DeepSeek-V2-Lite's attention: 16 heads, query/key width 192 (128 + 64),
#: value width 128, latent rows of 576 (512 + 64) whose first 512 columns
#: are the absorbed decode's values; its softmax scale 192^-1/2 times
#: YaRN's mscale(40, 0.707) squared
MLA_HEADS, MLA_QK, MLA_V, MLA_ROW, MLA_VALUES = 16, 192, 128, 576, 512
MLA_SCALE = MLA_QK ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2
#: the latent chunk's timed shape (c real rows after a P-token prefix, as
#: the cell's median prompt gives) and a long prefix near its 12,288 clip
MLA_CHUNK_SHAPES = ((2048, 4096), (1000, 11000))
#: the latent decode step's batch and its rows' key counts: the cell's
#: ``max_batch`` over its prompts' 2,048-12,288 and the answers' 512
MLA_DECODE_B, MLA_DECODE_KEYS = 32, (2048, 12800)


def check_chunk_attention_mla() -> dict:
    """The chunk kernel's latent instance (keys 192, values 128, the scale
    passed in) at the cell's shapes, B = 1, the chunk's K/V holding its
    real rows only (as the latent prefill passes them): against its plain
    version in f32 over the real rows, each element within twice its
    bf16 roundings (``check_chunk_attention``'s bound), zeros in the
    padding rows.  Timed beside the plain version and
    ``F.scaled_dot_product_attention`` with the same scale over the real
    rows and their keys; the bound is the real rows' products at the bf16
    tensor peak or their bytes at the HBM rate, whichever is longer."""
    from repro_torch.kernels.chunk_attention.ops import chunk_attention_cuda
    from repro_torch.kernels.chunk_attention.ref import (causal_cells,
                                                         chunk_attention_ref)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    h, hd, hv, s = MLA_HEADS, MLA_QK, MLA_V, CHUNK_BUDGET
    worst, share, timed = 0.0, 0.0, []
    for c, p in MLA_CHUNK_SHAPES:
        def draw(*shape):
            return torch.randn((CHUNK_LAYERS,) + shape, generator=g,
                               device=dev).bfloat16()
        q = draw(1, s, h, hd)
        pk, pv, k, v = draw(1, p, h, hd), draw(1, p, h, hv), \
            draw(1, c, h, hd), draw(1, c, h, hv)
        name = f"chunk_attention (192, 128) c={c} P={p}"
        got = chunk_attention_cuda(q[0], pk[0], pv[0], k[0], v[0], c,
                                   MLA_SCALE)
        f32 = [t[0].float() for t in (q, pk, pv, k, v)]
        want = chunk_attention_ref(*f32, c, MLA_SCALE)[:, :c]
        tol = 2.0 ** -8 * (chunk_attention_ref(
            f32[0], f32[1], f32[2].abs(), f32[3], f32[4].abs(), c,
            MLA_SCALE)[:, :c] + want.abs())
        torch.cuda.synchronize()
        if got.shape != (1, s, h, hv) or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: output {tuple(got.shape)} is not "
                                 f"(1, {s}, {h}, {hv}) and finite")
        err = (got[:, :c].float() - want).abs()
        if not (err <= tol).all():
            raise AssertionError(
                f"{name}: max |err| / bound {float((err / tol).max()):.3g}"
                f" (max |err| {float(err.max()):.3g})")
        if got[:, c:].any():
            raise AssertionError(f"{name}: padding rows are not zeros")
        worst = max(worst, float(err.max()))
        share = max(share, float((err / tol).max()))
        del want, tol, err, f32
        qt = q[:, :, :c].transpose(2, 3).contiguous()
        kt = torch.cat([pk, k], 2).transpose(2, 3).contiguous()
        vt = torch.cat([pv, v], 2).transpose(2, 3).contiguous()
        mask = (torch.arange(p + c, device=dev)[None, :]
                <= torch.arange(c, device=dev)[:, None] + p)
        it = iter(range(10 ** 9))

        def kern():
            i = next(it) % CHUNK_LAYERS
            chunk_attention_cuda(q[i], pk[i], pv[i], k[i], v[i], c, MLA_SCALE)

        def plain():
            i = next(it) % CHUNK_LAYERS
            chunk_attention_ref(q[i], pk[i], pv[i], k[i], v[i], c, MLA_SCALE)

        def library():
            i = next(it) % CHUNK_LAYERS
            F.scaled_dot_product_attention(qt[i], kt[i], vt[i],
                                           attn_mask=mask, scale=MLA_SCALE)

        cells = causal_cells(p, c)
        nbytes = 2 * h * (c * hd + s * hv + (p + c) * (hd + hv))
        flops = 2.0 * h * (hd + hv) * cells
        t_mem = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / H100_BF16_FLOPS * 1e3
        timed.append({**timings(kern, plain, library, iters=10),
                      "bound_ms": max(t_mem, t_ops),
                      "bound_by": "operations" if t_ops >= t_mem else "bytes",
                      "cells": cells, "c": c, "p": p})
        del q, pk, pv, k, v, qt, kt, vt
    main, long = timed
    return {"name": "chunk_attention_mla", "counter": "chunk_attention",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      "chunk_prefill_attention.cu",
            "replaces": "none (the JAX package has no latent attention)",
            "max_abs_err": worst, "err_share": share,
            **{k: main[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "warm", "wall")},
            "shape": f"B=1 H={h} keys {hd} values {hv} scale "
                     f"{MLA_SCALE:.5f}, {s} rows of which c={main['c']} real "
                     f"after P={main['p']}; long prefix c={long['c']} "
                     f"P={long['p']}: kernel {long['ms']:.4f} "
                     f"[{long['warm']['ms']:.4f}] ms, plain "
                     f"{long['plain_ms']:.4f} ms, sdpa "
                     f"{long['library_ms']:.4f} ms, bound "
                     f"{long['bound_ms']:.5f} ms ({long['bound_by']}), "
                     f"device cold [warm]; wall {long['wall']}"}


def check_paged_mla() -> dict:
    """The paged decode kernel's latent instance ``paged_decode_kernel
    <Mla576>`` at the cell's decode step: B = 32 rows of 2,048-12,800
    keys in 16-key pages dealt at random, page 0 poisoned.  Against
    ``paged_mla_decode_attention_ref`` (f32) each element within twice its
    two bf16 roundings (2^-9 of the attention of |values| for P, 2^-9 of
    the output); each row alone in a batch of empty rows has the bits it
    has in the batch; table entries past a row's last page are never
    read.  Timed beside the plain version; no PyTorch call attends
    through block tables, so the row has no yardstick.  The bound is the
    bytes: each attended 1,152-byte latent row read once, q in, the
    output out, tables and lengths."""
    from repro_torch.kernels.decode_attention.ops import \
        paged_mla_decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import \
        paged_mla_decode_attention_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    rng = np.random.default_rng(SEED + 13)
    b, ps, (lo, hi) = MLA_DECODE_B, 16, MLA_DECODE_KEYS
    lens = rng.integers(lo, hi + 1, size=b)
    lens[0] = hi
    mp = -(-hi // ps)
    n_pages = int(sum(-(-int(n) // ps) for n in lens)) + 1
    layers = 4      # timing walks them: the pages come from device memory
    pages = torch.randn((layers, n_pages, ps, MLA_ROW), generator=g,
                        device=dev).bfloat16()
    pages[:, 0] = 1000.0
    perm = rng.permutation(np.arange(1, n_pages))
    tab = np.zeros((b, mp), np.int32)
    at = 0
    for i, n in enumerate(lens):
        npg = -(-int(n) // ps)
        tab[i, :npg] = perm[at:at + npg]
        at += npg
    tab = torch.from_numpy(tab).to(dev)
    ln = torch.from_numpy(lens.astype(np.int32)).to(dev)
    q = torch.randn((b, MLA_HEADS, MLA_ROW), generator=g,
                    device=dev).bfloat16()
    got = paged_mla_decode_attention_cuda(q, pages[0], tab, ln, MLA_SCALE)
    want = paged_mla_decode_attention_ref(q.float(), pages[0].float(), tab,
                                          ln, MLA_SCALE, MLA_VALUES).float()
    # the attention of |values|: the same probabilities over |rows|
    att_abs = torch.zeros_like(want)
    for i in range(b):
        n = int(lens[i])
        rows = pages[0][tab[i, :-(-n // ps)].long()].reshape(
            -1, MLA_ROW)[:n].float()
        pr = torch.softmax(q[i].float() @ rows.T * MLA_SCALE, dim=-1)
        att_abs[i] = pr @ rows[:, :MLA_VALUES].abs()
    torch.cuda.synchronize()
    tol = 2.0 ** -8 * (att_abs + want.abs())
    err = (got.float() - want).abs()
    if not (err <= tol).all():
        raise AssertionError(f"paged_mla_decode_attention B={b}: max |err| "
                             f"/ bound {float((err / tol).max()):.3g}")
    poisoned = tab.clone()
    for i, n in enumerate(lens):
        poisoned[i, -(-int(n) // ps):] = 2 ** 30
    if not torch.equal(paged_mla_decode_attention_cuda(
            q, pages[0], poisoned, ln, MLA_SCALE), got):
        raise AssertionError("paged_mla_decode_attention: table entries "
                             "past the length leak")
    for i in (0, b // 2, b - 1):
        one = torch.zeros_like(ln)
        one[0] = ln[i]
        t1 = torch.zeros_like(tab)
        t1[0] = tab[i]
        q1 = torch.zeros_like(q)
        q1[0] = q[i]
        alone = paged_mla_decode_attention_cuda(q1, pages[0], t1, one,
                                                MLA_SCALE)
        if not torch.equal(alone[0], got[i]) or alone[1:].any():
            raise AssertionError(f"paged_mla_decode_attention: row {i} "
                                 f"alone differs from the batch")
    it = iter(range(10 ** 9))

    def kern():
        i = next(it) % layers
        paged_mla_decode_attention_cuda(q, pages[i], tab, ln, MLA_SCALE)

    def plain():
        i = next(it) % layers
        paged_mla_decode_attention_ref(q, pages[i], tab, ln, MLA_SCALE,
                                       MLA_VALUES)

    keys = int(lens.sum())
    nbytes = (keys * MLA_ROW * 2 + q.numel() * 2 + b * MLA_HEADS
              * MLA_VALUES * 2 + tab.numel() * 4 + ln.numel() * 4)
    flops = 2.0 * keys * MLA_HEADS * (MLA_ROW + MLA_VALUES)
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    row = timings(kern, plain, iters=20)
    return {"name": "paged_mla_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "replaces": "none (the JAX package has no latent attention)",
            "max_abs_err": float(err.max()),
            "err_share": float((err / tol).max()),
            **{k: row[k] for k in ("ms", "plain_ms", "library_ms", "warm",
                                   "wall")},
            "bound_ms": max(t_mem, t_ops),
            "bound_by": "operations" if t_ops >= t_mem else "bytes",
            "shape": f"B={b} H={MLA_HEADS} rows {MLA_ROW} values "
                     f"{MLA_VALUES} PS={ps} keys {keys} ({int(lens.min())}-"
                     f"{int(lens.max())} a row)"}


def success_wall_ms(n: int = 32, length: int = 64) -> float:
    """Wall ms a call of ``batched_success`` at (n, length), the scheduler's
    call: packing on the host, the copies and the kernel (each call waits
    for its result)."""
    from repro_torch.kernels.pmf_conv.ops import batched_success
    pets, pcts, dls = success_inputs(n, SEED + 7)
    return time_ms(lambda: batched_success(pets, pcts, dls, length=length),
                   iters=200, warmup=10)


def launch_floor() -> dict:
    """The empty kernel of the library through the same ctypes route as
    every kernel: device time a call and back-to-back wall a call, the floor
    no launch-bound kernel can beat."""
    from repro_torch.kernels.build import check, current_stream, library
    lib, dev = library(), torch.device("cuda")

    def floor():
        check(lib.launch_floor(current_stream(dev)), "launch_floor")
    return {"ms": device_ms(floor), "wall_ms": time_ms(floor, iters=200)}


# ---------------------------------------------------------------------------
# phase 3: the batched path
# ---------------------------------------------------------------------------

#: the kernels each main path must launch: the batched path's between
#: smollm-360m's phase 3 and DeepSeek-V2-Lite's phase 5b (the latent
#: instance of the paged decode kernel counts apart)
BATCHED_KERNELS = ("chunk_attention", "paged_decode_attention",
                   "paged_mla_decode_attention", "rmsnorm", "pmf_conv")
#: the latent model's batched path launches no dense paged decode
DSV2_KERNELS = ("chunk_attention", "paged_mla_decode_attention", "rmsnorm")
ROUTER_KERNELS = ("decode_attention", "rmsnorm")

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
    for name in BATCHED_KERNELS:
        if name != "paged_mla_decode_attention" and counts[name] == 0:
            raise AssertionError(f"the batched path never launched {name}")

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
            "decode_steps": stats["decode_launches"], "counts": counts,
            "completed": len(done),
            "dropped": sum(r.status == "dropped" for r in reqs),
            "compared": compared, "prefix_hits_batched": stats["prefix_hits"],
            "prefix_hits_sequential": sstats["prefix_hits"],
            "prefix_hits": hits, "profile": prof.summary()}


def check_small_input(mc, params, n_steps: int = 4, paged: bool = True):
    """The full-width model on the card against its plain versions on the
    CPU, teacher-forced on the card's greedy tokens: one 38-token chunk
    prefill then ``n_steps`` decode steps, batched paged decode
    (``paged``) or contiguous-cache decode (the one-at-a-time path)."""
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
        n = len(prompt)
        if paged:
            pages = T.init_paged_cache(mc, mp + 1, ps, dev)
            npg = -(-(n + n_steps) // ps)
            tab = torch.zeros((1, mp), dtype=torch.int32, device=dev)
            tab[0, :npg] = torch.arange(1, npg + 1)
            pad = (0, 0, 0, 0, 0, npg * ps - n)
            shape = (mc.n_layers, npg, ps, mc.n_kv_heads,
                     mc.resolved_head_dim)
            pages["kp"][:, 1:npg + 1] = F.pad(kn[:, 0], pad).reshape(shape)
            pages["vp"][:, 1:npg + 1] = F.pad(vn[:, 0], pad).reshape(shape)
        else:
            pad = (0, 0, 0, 0, 0, ROUTER_MAX_LEN - n)
            cache = {"k": F.pad(kn, pad), "v": F.pad(vn, pad),
                     "len": torch.full((1,), n, dtype=torch.int32,
                                       device=dev)}
        if dev == "cuda":
            forced = [int(torch.argmax(logits[0]))]
        cur = forced[0]
        for s in range(n_steps):
            tok = torch.tensor([cur], device=dev)
            if paged:
                lg, _, _ = T.paged_decode_fn(mc)(
                    p, pages["kp"], pages["vp"], tab,
                    torch.tensor([n + s], dtype=torch.int32, device=dev), tok)
            else:
                lg, cache = T.decode_fn(mc)(p, cache, tok)
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


# ---------------------------------------------------------------------------
# phase 4: the one-at-a-time path behind the front door
# ---------------------------------------------------------------------------

def make_router_trace(vocab: int, n_req: int = ROUTER_REQ):
    """``examples/serve_smse.py``'s traffic: 4 shared 32-token system
    prompts + 6-token suffixes, 4 new tokens, temperatures from
    {0, 0, 0.7}, exponential gaps of mean 5 ticks (deadlines wider than
    serve_smse's 400 ticks: the full-width model takes longer per task)."""
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(SEED + 6)
    systems = [tuple(int(x) for x in rng.integers(1, vocab, SYS_LEN))
               for _ in range(N_SYS)]
    trace, t = [], 0.0
    for _ in range(n_req):
        prompt = systems[int(rng.integers(0, N_SYS))] + \
            tuple(int(x) for x in rng.integers(1, vocab, SUFFIX_LEN))
        trace.append((t, Request(
            prompt=prompt, n_new=ROUTER_NEW,
            temperature=float(rng.choice([0.0, 0.0, 0.7])),
            seed=int(rng.integers(0, 3)), deadline=t + ROUTER_DEADLINE)))
        t += float(rng.exponential(5))
    return trace


def serve_router(mc, params) -> dict:
    """The port's ``Router`` over two full-width engine planes with
    serve_smse's settings (batching off: every task runs through
    ``ProcessingUnit.execute`` and ``decode_fn``), prefix cache on, then
    the same trace with it off.  Every prefill there is the fixed-shape
    cached prefill, whose attention is the chunk kernel once a layer."""
    from repro_torch import kernels
    from repro_torch.models import transformer as T
    from repro_torch.serving.cluster import Router, make_engine_planes
    from repro_torch.serving.engine import ProcessingUnit

    # count (and time) every decode_fn call: the units build their decode
    # step from T.decode_fn when the planes are made; count every prefill
    calls = {"n": 0, "walls": [], "prefills": 0}
    decode_fn, prefill = T.decode_fn, ProcessingUnit._prefill

    def counted_prefill(self, *a, **kw):
        calls["prefills"] += 1
        return prefill(self, *a, **kw)

    def counted_decode_fn(cfg):
        step = decode_fn(cfg)

        def f(p, cache, tokens):
            t0 = time.perf_counter()
            out = step(p, cache, tokens)
            torch.cuda.synchronize()
            calls["walls"].append(time.perf_counter() - t0)
            calls["n"] += 1
            return out
        return f

    runs = []
    T.decode_fn, ProcessingUnit._prefill = counted_decode_fn, counted_prefill
    try:
        for prefix_cache in (True, False):
            ecfg = router_engine_config()
            ecfg.prefix_cache = prefix_cache
            router = Router(make_engine_planes(mc, params, ecfg, 2,
                                               device="cuda"),
                            policy="affinity")
            trace = make_router_trace(mc.vocab)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            calls["n"], calls["walls"], calls["prefills"] = 0, [], 0
            t0 = time.perf_counter()
            stats = router.run(trace)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs.append({"stats": stats, "wall_s": wall, "trace": trace,
                         "counts": kernels.launch_counts(),
                         "decode_calls": calls["n"],
                         "decode_walls": list(calls["walls"]),
                         "prefills": calls["prefills"]})
    finally:
        T.decode_fn, ProcessingUnit._prefill = decode_fn, prefill
    on, off = runs
    counts, reqs = on["counts"], [r for _, r in on["trace"]]
    for name in ROUTER_KERNELS + ("chunk_attention",):
        if counts[name] == 0:
            raise AssertionError(f"the one-at-a-time path never launched "
                                 f"{name}")
    for run in runs:
        if run["counts"]["chunk_attention"] != mc.n_layers * run["prefills"]:
            raise AssertionError(
                f"chunk_attention launched {run['counts']['chunk_attention']}"
                f" times over {run['prefills']} prefills, want "
                f"{mc.n_layers} per prefill")
    if counts["decode_attention"] != mc.n_layers * on["decode_calls"]:
        raise AssertionError(
            f"decode_attention launched {counts['decode_attention']} times "
            f"over {on['decode_calls']} decode steps, want "
            f"{mc.n_layers} per step")
    greedy = [i for i, r in enumerate(reqs) if r.temperature == 0.0]
    for run in runs:
        for i in greedy:
            r = run["trace"][i][1]
            if r.status != "done" or len(r.tokens) != ROUTER_NEW:
                raise AssertionError(
                    f"greedy request {i} ended as {r.status} with "
                    f"{len(r.tokens)} tokens, want done with {ROUTER_NEW}")
    if on["stats"]["prefix_hits"] == 0:
        raise AssertionError("the prefix cache recorded no hits")
    for i in greedy:
        a, b = on["trace"][i][1], off["trace"][i][1]
        if a.tokens != b.tokens:
            raise AssertionError(f"greedy request {i}: prefix cache on "
                                 f"{a.tokens} != off {b.tokens}")
    done = [r for r in reqs if r.status == "done"]
    n_tok = sum(len(r.tokens) for r in done)
    st = on["stats"]
    return {"counts": counts, "decode_calls": on["decode_calls"],
            "prefills": on["prefills"],
            "median_decode_step_ms":
                1e3 * statistics.median(on["decode_walls"]),
            "tokens": n_tok, "wall_s": on["wall_s"],
            "tokens_per_s": n_tok / on["wall_s"], "completed": len(done),
            "dropped": st["dropped"], "greedy": len(greedy),
            "prefix_hits": st["prefix_hits"],
            "prefix_tokens_reused": st["prefix_tokens_reused"],
            "merges": st["merges"], "scale_ups": st["scale_ups"],
            "routed": st["router"]["routed"],
            "affinity_hits": st["router"]["affinity_hits"]}


# ---------------------------------------------------------------------------
# phase 4b: sliding-window decode at full width
# ---------------------------------------------------------------------------

#: smollm-360m with a sliding window: a 32-token prompt, then 32 greedy
#: decode steps in a 64-key cache, each step's window cut below its
#: length (and across granule edges as the length grows)
WINDOW_MODEL, WINDOW_PROMPT, WINDOW_STEPS = 24, 32, 32


def serve_windowed(mc, params) -> dict:
    """smollm-360m at full width with ``sliding_window`` =
    ``WINDOW_MODEL``: one greedy prompt through ``prefill_fn`` +
    ``decode_fn`` for ``WINDOW_STEPS`` steps through the kernel, with the
    launch counters zeroed just before and read just after (every step
    launches ``decode_attention`` once a layer).  Its twin runs the same
    prompt with the layers' attention through ``decode_attention_plain``
    on the card (bf16 scores, the JAX layer's formula).  The logits of
    step 1 agree within the larger of ``CARD_LOGIT_TOL`` and the plain
    twin's own movement under one bf16 ulp on the embedding table
    (phase 5's rule); the greedy tokens are equal, or part only where the
    twin's top-2 margin is within twice that (a near tie, printed)."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(mc, sliding_window=WINDOW_MODEL)
    prompt = np.random.default_rng(SEED + 21).integers(1, cfg.vocab,
                                                       WINDOW_PROMPT)
    batch = family_inputs(cfg, params, prompt, "cuda")
    if WINDOW_PROMPT + WINDOW_STEPS > ROUTER_MAX_LEN:
        raise AssertionError("the windowed run outgrows its cache")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    kern = greedy_run(cfg, params, batch, WINDOW_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for i, c in enumerate(kern["launches"]):
        if c["decode_attention"] != cfg.n_layers:
            raise AssertionError(f"windowed step {i + 1} launched "
                                 f"decode_attention {c['decode_attention']}"
                                 f" times, not {cfg.n_layers}")
    kernel = L._decode_attention_kernel
    L._decode_attention_kernel = (
        lambda q, k, v, ln, window: L.decode_attention_plain(q, k, v, ln,
                                                            window))
    try:
        plain = greedy_run(cfg, params, batch, WINDOW_STEPS)
        emb = params["embed"]["emb"]
        sign = torch.where(torch.rand(emb.shape, generator=torch.Generator(
            device="cuda").manual_seed(SEED + 11), device="cuda") < 0.5,
            -1.0, 1.0)
        moved = dict(params, embed={"emb": (emb.float() * (
            1 + sign * 2.0 ** -8)).to(emb.dtype)})
        ref = greedy_run(cfg, moved, batch, 1, feed=plain["fed"][:1])
    finally:
        L._decode_attention_kernel = kernel
    lk, lp = (r["logits"][1].float() for r in (kern, plain))
    tol = max(CARD_LOGIT_TOL,
              float((ref["logits"][1].float() - lp).abs().max()))
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError("windowed run: logits are not finite")
    err = float((lk - lp).abs().max())
    if not torch.allclose(lk, lp, atol=tol, rtol=tol):
        raise AssertionError(f"windowed run: step-1 logits of the kernel and "
                             f"the plain twin differ by {err}, beyond {tol}")
    picks = [[int(x.argmax(-1)) for x in r["logits"]] for r in (kern, plain)]
    parted = next((i for i, (a, b) in enumerate(zip(*picks)) if a != b),
                  None)
    margin = None
    if parted is not None:
        top2 = torch.topk(plain["logits"][parted].float()[0], 2).values
        margin = float(top2[0] - top2[1])
        log(f"  windowed run: tokens part at step {parted} (kernel "
            f"{picks[0][parted]}, plain {picks[1][parted]}); the plain "
            f"twin's top-2 margin there {margin:.4g}, limit {2 * tol:.4g}")
        if margin > 2 * tol:
            raise AssertionError("windowed run: the kernel's greedy token "
                                 "parts from the plain twin's beyond a tie")
    steps = len(kern["walls"])
    return {"counts": counts, "steps": steps, "max_abs_err": err, "tol": tol,
            "parted": parted, "margin": margin, "wall_s": wall,
            "picks": len(picks[0]),
            "median_step_ms": 1e3 * statistics.median(kern["walls"]),
            "launches_a_step": kern["launches"][-1]["decode_attention"]}


# ---------------------------------------------------------------------------
# phase 4c: the success-chance signal of the simulator's and the Router's
# scalers on the caller's device
# ---------------------------------------------------------------------------

#: the launcher's plane-scaling run (phase 4c (d)): one base plane, one
#: plane the scaler may add, 40 requests at 4 a tick
SCALER_LAUNCHER_ARGV = ("--arch", "smollm-360m", "--requests", "40",
                        "--units", "1", "--planes", "1", "--autoscale",
                        "success-chance", "--extra-planes", "1", "--rate",
                        "4")


def scaler_pet():
    from repro_torch.core.tasks import PETMatrix
    return PETMatrix.generate(["generate"], ["m0"],
                              np.random.default_rng(3), mean_range=(8, 16))


def scaler_trace():
    """``tests/test_autoscale.py``'s cross-substrate trace: 40 requests,
    mean gap 1 tick, deadlines 60 ticks out."""
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(1)
    out, t = [], 0.0
    for _ in range(40):
        out.append((t, Request(
            prompt=tuple(rng.integers(1, 1000, size=8).tolist()),
            op="generate", n_new=int(rng.integers(1, 4)), deadline=t + 60.0)))
        t += float(rng.exponential(1.0))
    return out


class HostSignalCalls:
    """Counts the batched success-chance calls of a host run (one for each
    scored decision of each scored plane), the launches the same run on the
    card must make."""

    def __init__(self):
        from repro_torch.serving.autoscale import signals
        self.signals, self.inner, self.n = signals, signals._kernel_success, 0

    def __enter__(self):
        def counted(*a, **kw):
            self.n += 1
            return self.inner(*a, **kw)
        self.signals._kernel_success = counted
        return self

    def __exit__(self, *exc):
        self.signals._kernel_success = self.inner


def cross_substrate(device) -> dict:
    """The stub engine and the simulator on ``scaler_trace`` with
    success-chance elasticity on ``device``: both traces, the simulator's
    counts, and the ``pmf_conv`` launches of each run (zeroed just before
    and read just after it)."""
    from repro_torch import kernels
    from repro_torch.core.fleet import FleetSpec
    from repro_torch.core.simulation import PETOracle, SimConfig, Simulator
    from repro_torch.serving.autoscale import ElasticityConfig
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    el = ElasticityConfig(policy="success-chance", max_extra=2,
                          scale_up_queue=6, scale_down_queue=1,
                          low_chance=0.6)
    trace = scaler_trace()
    sim = Simulator([r.to_task(t, i) for i, (t, r) in enumerate(trace)],
                    FleetSpec.homogeneous(1), PETOracle(scaler_pet(), seed=11),
                    SimConfig(heuristic="EDF", merging="none", elasticity=el),
                    device=device)
    eng = ServingEngine(None, None, EngineConfig(
        n_units=1, heuristic="EDF", merging="none", result_cache=False,
        prefix_cache=False, elasticity=el),
        stub_oracle=PETOracle(scaler_pet(), seed=11), device=device)
    sim.cp.trace, eng.cp.trace = [], []
    out = {}
    for name, run in (("sim", sim.run), ("engine", lambda: eng.run(trace))):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with HostSignalCalls() as calls:
            t0 = time.perf_counter()
            out[name] = run()
            torch.cuda.synchronize()
            out[f"{name}_wall_s"] = time.perf_counter() - t0
        out[f"{name}_counts"] = kernels.launch_counts()
        out[f"{name}_scored"] = calls.n
    st = out["sim"]
    out.update(sim_trace=sim.cp.trace, engine_trace=eng.cp.trace,
               scale=(st.scale_ups, st.scale_downs, st.on_time, st.missed,
                      st.dropped, st.machine_seconds),
               decisions=st.scale_decisions,
               scaler_device=str(sim.scaler.device))
    return out


def plane_router(device) -> dict:
    """``tests/test_autoscale.py``'s sustained overload: a stub-plane
    ``Router`` (1 base plane, up to 3 more, success-chance) with its planes
    on ``device``, 80 requests; the ``pmf_conv`` launches of the run
    (zeroed just before, read just after)."""
    from repro_torch import kernels
    from repro_torch.core.simulation import PETOracle
    from repro_torch.core.tasks import PETMatrix
    from repro_torch.serving.autoscale import ElasticityConfig
    from repro_torch.serving.cluster import (Router,
                                             make_engine_plane_factory,
                                             make_engine_planes)
    from repro_torch.serving.engine import EngineConfig, Request
    ecfg = EngineConfig(n_units=1, elasticity=None, result_cache=False,
                        prefix_cache=False, heuristic="EDF", merging="none")
    pet = PETMatrix.generate(["generate"], ["m0"], np.random.default_rng(3),
                             mean_range=(10, 20))
    router = Router(
        make_engine_planes(None, None, ecfg, 1,
                           stub_oracles=[PETOracle(pet, seed=11)],
                           device=device),
        policy="least-loaded",
        autoscale=ElasticityConfig(policy="success-chance", max_extra=3,
                                   cooldown=30.0, low_chance=0.5),
        plane_factory=make_engine_plane_factory(
            None, None, ecfg, device=device,
            stub_oracle_fn=lambda pid: PETOracle(pet, seed=11 + pid)))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with HostSignalCalls() as calls:
        t0 = time.perf_counter()
        t, rng = 0.0, np.random.default_rng(9)
        for i in range(80):
            router.submit(Request(prompt=(i, 2, 3), op="generate", n_new=2,
                                  deadline=t + 80.0), t)
            t += float(rng.exponential(4.0))
        stats = router.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"counts": kernels.launch_counts(), "scored": calls.n,
            "wall_s": wall, "decisions": router.decisions,
            "auto": stats["router"]["autoscale"],
            "scaler_device": str(router.plane_scaler.device),
            "completed": stats["completed"], "dropped": stats["dropped"]}


def scaler_phase() -> dict:
    """Phase 4c: (a) the cross-substrate trace on the card and on the host
    (simulator == stub engine on each, card == host, every scored decision
    one ``pmf_conv`` launch on the card and none on the host); (b) the
    stub-plane Router on the card adds and retires planes, launching the
    kernel once for each scored plane; (c) the same Router on ``"cpu"``
    launches nothing and routes as (b); (d) the launcher with
    ``--extra-planes`` on the card."""
    card, host = cross_substrate("cuda"), cross_substrate("cpu")
    for side, run in (("card", card), ("host", host)):
        if run["sim_trace"] != run["engine_trace"]:
            raise AssertionError(f"phase 4c: the simulator's trace on the "
                                 f"{side} differs from the stub engine's")
    if card["sim_trace"] != host["sim_trace"] or \
            card["scale"] != host["scale"]:
        raise AssertionError(f"phase 4c: card {card['scale']} != host "
                             f"{host['scale']}")
    for name in ("sim", "engine"):
        got = card[f"{name}_counts"]["pmf_conv"]
        if got != host[f"{name}_scored"] or got == 0:
            raise AssertionError(
                f"phase 4c: the {name} launched pmf_conv {got} times on the "
                f"card, the host run scored {host[name + '_scored']} "
                f"decisions")
        if host[f"{name}_counts"]["pmf_conv"] != 0:
            raise AssertionError(f"phase 4c: the {name} on the host "
                                 f"launched pmf_conv")
    pc, ph = plane_router("cuda"), plane_router("cpu")
    if not (pc["auto"]["plane_scale_ups"] > 0
            and pc["auto"]["plane_scale_downs"] > 0):
        raise AssertionError(f"phase 4c: the Router on the card did not add "
                             f"and retire a plane: {pc['auto']}")
    if pc["counts"]["pmf_conv"] != ph["scored"] or ph["scored"] == 0:
        raise AssertionError(
            f"phase 4c: the Router launched pmf_conv "
            f"{pc['counts']['pmf_conv']} times, the host run scored "
            f"{ph['scored']} planes")
    if ph["counts"]["pmf_conv"] != 0:
        raise AssertionError("phase 4c: the Router on 'cpu' launched pmf_conv")
    if pc["decisions"] != ph["decisions"] or pc["auto"] != ph["auto"]:
        raise AssertionError("phase 4c: the Router's decisions on the card "
                             "differ from the host's")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *SCALER_LAUNCHER_ARGV], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    lwall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"phase 4c: the launcher exited "
                             f"{res.returncode}:\n{res.stderr[-3000:]}")
    launcher = json.loads(res.stdout)
    lauto = launcher["router"]["autoscale"]
    if not lauto["scale_decisions"] > 0:
        raise AssertionError(f"phase 4c: the launcher reports no plane "
                             f"decisions: {lauto}")
    counts = {k: card["sim_counts"][k] + card["engine_counts"][k]
              + pc["counts"][k] for k in pc["counts"]}
    return {"card": card, "host": host, "router": pc, "router_host": ph,
            "launcher": lauto, "launcher_wall_s": lwall,
            "launcher_completed": launcher["completed"],
            "launcher_dropped": launcher["dropped"], "counts": counts}


def router_engine_config():
    """Phase 4's engine settings: serve_smse's, with no step batching."""
    from repro_torch.core.pruning import PruningConfig
    from repro_torch.serving.autoscale import ElasticityConfig
    from repro_torch.serving.engine import EngineConfig
    return EngineConfig(
        n_units=2, elasticity=ElasticityConfig(max_extra=2, cooldown=100.0),
        heuristic="EDF", merging="adaptive",
        pruning=PruningConfig(initial_defer_threshold=0.1,
                              base_drop_threshold=0.05),
        max_len=ROUTER_MAX_LEN, batch_buckets=(1, 2, 4, 8))


# ---------------------------------------------------------------------------
# phase 4d: the disaggregated handoff and the closed-loop sessions
# ---------------------------------------------------------------------------

#: (a): one prefill unit and one decode unit of one machine type
HANDOFF_FLEET = "m0@prefill:1,m0@decode:1"
#: (b): the launcher's SLO tiers and vocab (``launch/serve.py``) over
#: ``tests/test_workload.py``'s multi-turn sessions at full width
SESSION_TENANTS = "gold:1:0.5:1,free:3"
SESSION_USERS, SESSION_TURNS, SESSION_NEW = 4, 4, 4
SESSION_BASE, SESSION_FOLLOWUP, SESSION_VOCAB = 32, 8, 250


def batched_config(**kw):
    """Phase 3's step batching (``max_batch`` 8, budget 64, page 16,
    ``max_len`` 1024) on one unit, with no elasticity, merging, pruning
    or result cache (``tests/test_disaggregation.py``'s live settings)."""
    from repro_torch.serving.batching import StepBatchingConfig
    from repro_torch.serving.engine import EngineConfig
    kw = {"n_units": 1, "elasticity": None, "merging": "none",
          "pruning": None, "result_cache": False, "max_len": 1024,
          "kv_block_size": 16, **kw}
    return EngineConfig(batching=StepBatchingConfig(max_batch=8,
                                                    step_token_budget=64),
                        **kw)


def serve_handoff(mc, params) -> dict:
    """(a) Phase 3's 16 requests on the unified one-unit engine, then on
    a prefill unit and a decode unit: every request done, one handoff
    each, the migrated blocks attached on the decode unit, the 1:3 block
    budgets, the kernels launched, and greedy tokens bitwise equal."""
    from repro_torch import kernels
    from repro_torch.core.fleet import FleetSpec
    from repro_torch.serving.engine import ServingEngine
    runs = {}
    for name, fleet in (("unified", None), ("disaggregated", HANDOFF_FLEET)):
        eng = ServingEngine(mc, params, batched_config(
            fleet=FleetSpec.parse(fleet) if fleet else None), device="cuda")
        eng.cp.trace = []
        trace = make_requests(mc.vocab, 0.0, 600.0)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        stats = eng.run(trace)
        torch.cuda.synchronize()
        runs[name] = {"eng": eng, "stats": stats,
                      "wall_s": time.perf_counter() - t0,
                      "counts": kernels.launch_counts(),
                      "reqs": [r for _, r in trace]}
    uni, dis = runs["unified"], runs["disaggregated"]
    for name, run in runs.items():
        for r in run["reqs"]:
            if r.status != "done" or len(r.tokens) != N_NEW:
                raise AssertionError(
                    f"phase 4d (a) {name}: request {r.rid} ended as "
                    f"{r.status} with {len(r.tokens)} tokens, want done "
                    f"with {N_NEW}")
        for k in ("paged_decode_attention", "rmsnorm"):
            if run["counts"][k] == 0:
                raise AssertionError(f"phase 4d (a) {name}: {k} was never "
                                     f"launched")
    eng = dis["eng"]
    handoffs = sum(e[0] == "handoff" for e in eng.cp.trace)
    if handoffs != N_REQ:
        raise AssertionError(f"phase 4d (a): {handoffs} handoffs in the "
                             f"control plane's trace, want {N_REQ}")
    mids = {m.phase: m.mid for m in eng.machines}
    src, dst = eng.kvcaches[mids["prefill"]], eng.kvcaches[mids["decode"]]
    moved = (src.stats["migrated_out"], dst.stats["migrated_in"])
    if not moved[0] > 0 or moved[0] != moved[1]:
        raise AssertionError(f"phase 4d (a): blocks migrated out / in "
                             f"{moved}, want equal and > 0")
    if not dst.stats["tokens_reused"] > 0:
        raise AssertionError("phase 4d (a): the decode unit attached no "
                             "migrated block")
    budgets = (src.pool.n_blocks, dst.pool.n_blocks)
    if budgets[0] * 3 != budgets[1]:
        raise AssertionError(f"phase 4d (a): prefill / decode block "
                             f"budgets {budgets}, want 1:3")
    parted = [(r.rid, a.tokens, r.tokens)
              for a, r in zip(uni["reqs"], dis["reqs"])
              if a.tokens != r.tokens]
    if parted:
        raise AssertionError(
            f"phase 4d (a): {len(parted)} of {N_REQ} requests part from "
            f"the unified run (rid, unified, disaggregated): {parted}")
    # the prefill unit stops at the boundary token: every decode launch
    # of the disaggregated run is the decode unit's
    return {"handoffs": handoffs, "migrated": moved[0],
            "tokens_reused": dst.stats["tokens_reused"],
            "budgets": budgets,
            "decode_steps": dis["stats"]["decode_launches"],
            "wall_s": {k: run["wall_s"] for k, run in runs.items()},
            "counts": {k: uni["counts"][k] + dis["counts"][k]
                       for k in uni["counts"]}}


def run_sessions(mc, params, users: int, turns: int,
                 prefix_cache: bool = True) -> dict:
    """One full-width engine plane behind a ``Router``, driven by
    ``WorkloadDriver`` over a ``SessionPool``; every submitted request
    kept by (session, turn)."""
    from repro_torch import kernels
    from repro_torch.serving.cluster import Plane, Router
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.workload import (SessionConfig, SessionPool,
                                              WorkloadDriver, parse_tenants)
    eng = ServingEngine(mc, params, batched_config(
        heuristic="EDF", prefix_cache=prefix_cache), device="cuda")
    router = Router([Plane(eng, pid=0)], policy="round-robin",
                    shared_detector=False)
    pool = SessionPool(SessionConfig(
        users=users, turns=turns, base_prompt=SESSION_BASE,
        followup=SESSION_FOLLOWUP, n_new=SESSION_NEW, vocab=SESSION_VOCAB,
        seed=SEED), tenants=parse_tenants(SESSION_TENANTS))
    items, pop = {}, pool.pop

    def recorded_pop():
        t, item = pop()
        items[(item.session, item.turn)] = item
        return t, item

    pool.pop = recorded_pop
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stats = WorkloadDriver(router, pool, record_hit_depth=True).run()
    torch.cuda.synchronize()
    summary = pool.summary()
    if summary["sessions_done"] != users or len(items) != users * turns:
        raise AssertionError(f"phase 4d (b): {summary['sessions_done']} of "
                             f"{users} sessions done, {len(items)} of "
                             f"{users * turns} turns submitted")
    for key, r in items.items():
        if r.status != "done" or len(r.tokens) != SESSION_NEW:
            raise AssertionError(f"phase 4d (b): session turn {key} ended "
                                 f"as {r.status} with {len(r.tokens)} "
                                 f"tokens, want done with {SESSION_NEW}")
    return {"stats": stats, "summary": summary,
            "wall_s": time.perf_counter() - t0,
            "counts": kernels.launch_counts(),
            "tokens": {k: list(r.tokens) for k, r in items.items()},
            "hit_rate": stats["prefix_hits"] / max(1, stats["executions"])}


def serve_sessions(mc, params) -> dict:
    """(b) Multi-turn sessions with the prefix cache on, the single-shot
    baseline (as many sessions of one turn), and the sessions again with
    the cache off (``tests/test_workload.py``'s checks, at full width)."""
    multi = run_sessions(mc, params, SESSION_USERS, SESSION_TURNS)
    single = run_sessions(mc, params, SESSION_USERS * SESSION_TURNS, 1)
    off = run_sessions(mc, params, SESSION_USERS, SESSION_TURNS,
                       prefix_cache=False)
    depths = [t["mean_hit_depth"] for t in multi["summary"]["per_turn"]]
    if not (all(b >= a for a, b in zip(depths, depths[1:]))
            and depths[-1] > 0):
        raise AssertionError(f"phase 4d (b): per-turn hit depth {depths}, "
                             f"want non-decreasing and > 0 at the last")
    if single["stats"]["prefix_hits"] != 0 or \
            not multi["hit_rate"] > single["hit_rate"]:
        raise AssertionError(
            f"phase 4d (b): hit rate multi-turn {multi['hit_rate']} vs "
            f"single-shot {single['hit_rate']} "
            f"({single['stats']['prefix_hits']} hits), want above a "
            f"baseline of 0")
    if off["stats"]["prefix_hits"] != 0:
        raise AssertionError("phase 4d (b): the cache-off run hit a prefix")
    parted = sorted(k for k in multi["tokens"]
                    if multi["tokens"][k] != off["tokens"][k])
    if parted:
        raise AssertionError(
            f"phase 4d (b): (session, turn) {parted} part with the prefix "
            f"cache off: "
            + "; ".join(f"{k} {multi['tokens'][k]} != {off['tokens'][k]}"
                        for k in parted))
    runs = (multi, single, off)
    for k in ("paged_decode_attention", "rmsnorm"):
        if any(run["counts"][k] == 0 for run in runs):
            raise AssertionError(f"phase 4d (b): a session run never "
                                 f"launched {k}")
    return {"depths": depths, "hit_rate": multi["hit_rate"],
            "single_hit_rate": single["hit_rate"],
            "hits": multi["stats"]["prefix_hits"],
            "reused": multi["stats"]["prefix_tokens_reused"],
            "saved": off["stats"]["prefill_tokens"]
            - multi["stats"]["prefill_tokens"],
            "prefill_tokens": multi["stats"]["prefill_tokens"],
            "turns": len(multi["tokens"]),
            "tenants": multi["summary"]["tenants"],
            "wall_s": [run["wall_s"] for run in runs],
            "counts": {k: sum(run["counts"][k] for run in runs)
                       for k in multi["counts"]}}


def handoff_phase(mc, params, smi: str) -> dict:
    """Phase 4d: (a) the handoff, (b) the sessions, (c) their launches."""
    t0 = time.perf_counter()
    ho = serve_handoff(mc, params)
    log(f"phase 4d: the disaggregated handoff and the closed-loop "
        f"sessions, smollm-360m at full width ({smi})")
    log(f"  (a) {N_REQ} requests on {HANDOFF_FLEET}: {N_REQ} done, "
        f"{ho['handoffs']} handoffs, {ho['migrated']} blocks migrated out "
        f"= in, {ho['tokens_reused']} tokens reused on the decode unit, "
        f"block budgets prefill:decode {ho['budgets'][0]}:"
        f"{ho['budgets'][1]}; greedy tokens bitwise equal to the unified "
        f"run on all {N_REQ}; walls unified {ho['wall_s']['unified']:.3f} "
        f"s, disaggregated {ho['wall_s']['disaggregated']:.3f} s; decode "
        f"unit's {ho['decode_steps']} decode steps")
    se = serve_sessions(mc, params)
    log(f"  (b) {SESSION_USERS} sessions x {SESSION_TURNS} turns, tenants "
        f"{SESSION_TENANTS}: per-turn mean hit depth {se['depths']}; hit "
        f"rate {se['hit_rate']:.4f} ({se['hits']} hits, {se['reused']} "
        f"tokens reused) against the single-shot baseline's "
        f"{se['single_hit_rate']:.4f}; prefill tokens {se['prefill_tokens']}"
        f", {se['saved']} saved against the cache-off run, whose tokens "
        f"equal on all {se['turns']} turns; walls (multi-turn, single-shot,"
        f" cache off) {', '.join(f'{w:.3f}' for w in se['wall_s'])} s")
    for name, row in sorted(se["tenants"].items()):
        log(f"    tenant {name}: {row}")
    counts = {k: ho["counts"][k] + se["counts"][k] for k in ho["counts"]}
    wall = time.perf_counter() - t0
    log(f"  (c) phase 4d took {wall:.1f} s with its engines' set-up; "
        f"kernel launches (a) {ho['counts']}, (b) {se['counts']}")
    return {"handoff": ho, "sessions": se, "counts": counts, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 5: every model family; deepseek-moe-16b served at full width
# ---------------------------------------------------------------------------

MOE_ARCH = "deepseek-moe-16b"
FAMILY_REQ = 8
#: the arch table: a 38-token prompt, then greedy decode steps in a cache
#: of ROUTER_MAX_LEN; steady steps under the profiler for the busy share
ARCH_STEPS, PROFILE_STEPS, ENC_FRAMES = 8, 10, 8
#: layers kept where the whole model does not fit beside the phase's state
#: (llava-next-34b: 30 of 60, about 36 GB; llama4: one dense + MoE unit,
#: about 37 GB)
CUT_DEPTH = {"llava-next-34b": 30, "llama4-maverick-400b-a17b": 2}
#: card against CPU on the reduced configs: logits within the larger of
#: this and the CPU's own movement under one bf16 ulp on the embedding
#: table (tests/test_torch_families.py's rule, which zamba2 and seamless
#: need there too)
CARD_LOGIT_TOL = 5e-2


def expected_launches(cfg) -> tuple[int, int]:
    """(decode_attention, rmsnorm) launches of one decode step: a
    self-attention per attention layer (and a cross-attention per enc-dec
    decoder layer), two norms per block (three in an enc-dec decoder block,
    one per Mamba2 block) and the final norm."""
    n = cfg.n_layers
    if cfg.family == "hybrid":
        groups = n // cfg.ssm.attn_period
        return groups, n + 2 * groups + 1
    if cfg.family == "ssm":
        return 0, n + 1
    if cfg.family == "encdec":
        return 2 * n, 3 * n + 1
    return n, 2 * n + 1


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def decode_weight_bytes(cfg, params) -> int:
    """Weight bytes one B=1 decode step reads: everything but the embedding
    table (one row) and the encoder; the hybrid's shared block once per
    group; every expert of a MoE layer (the dispatch einsum reads them
    all)."""
    total = nbytes(params) - nbytes(params["embed"])
    if cfg.family == "encdec":
        total -= nbytes(params["encoder"])
    if cfg.family == "hybrid":
        total += (cfg.n_layers // cfg.ssm.attn_period - 1) * \
            nbytes(params["shared_attn"])
    return total


def family_inputs(cfg, params, prompt, dev):
    """A prefill batch for ``cfg``: tokens, the embedding rows of the
    prompt in their place for vlm, and ``ENC_FRAMES`` unit-normal frames
    beside them for enc-dec."""
    from repro_torch.models import layers as L
    toks = torch.as_tensor(np.asarray(prompt, np.int64), device=dev)[None]
    if cfg.family == "encdec":
        g = torch.Generator(device=dev).manual_seed(SEED + 9)
        enc = torch.randn((1, ENC_FRAMES, cfg.d_model), generator=g,
                          device=dev).to(torch.bfloat16)
        return {"tokens": toks, "enc_embeds": enc}
    if not cfg.embed_inputs:
        return {"embeds": L.embed(params["embed"], toks)}
    return {"tokens": toks}


def greedy_run(cfg, params, batch, n_steps, feed=None):
    """Prefill then ``n_steps`` decode steps, greedy (or fed ``feed``):
    the logits of each and per step its wall and kernel launches."""
    from repro_torch import kernels
    from repro_torch.models import transformer as T
    logits, cache = T.prefill_fn(cfg)(params, batch, ROUTER_MAX_LEN)
    dec = T.decode_fn(cfg)
    out, walls, launches, fed = [logits], [], [], []
    for i in range(n_steps):
        cur = logits.argmax(-1) if feed is None else feed[i]
        fed.append(cur)
        if logits.is_cuda:
            torch.cuda.synchronize()
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        logits, cache = dec(params, cache, cur.to(logits.device))
        if logits.is_cuda:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        after = kernels.launch_counts()
        launches.append({k: after[k] - before[k] for k in after})
        out.append(logits)
    return {"logits": out, "walls": walls, "launches": launches,
            "fed": fed}


def serve_moe_router(mc, params) -> dict:
    """deepseek-moe-16b at full width behind the port's Router: two planes
    over one copy of the weights with phase 4's engine settings, serving
    ``FAMILY_REQ`` requests of serve_smse's traffic.  Every decode step's
    launches and wall are recorded (warm-ups aside), and every greedy
    request that ran alone (bucket 1) is replayed as a direct
    ``prefill_fn`` + ``decode_fn`` greedy run at the same shapes."""
    from repro_torch import kernels
    from repro_torch.models import transformer as T
    from repro_torch.serving.cluster import Router, make_engine_planes
    from repro_torch.serving.engine import ProcessingUnit

    steps, alone, warming = [], [], [False]
    decode_fn, execute, warmup = (T.decode_fn, ProcessingUnit.execute,
                                  ProcessingUnit.warmup)

    def counted_decode_fn(cfg):
        step = decode_fn(cfg)

        def f(p, cache, tokens):
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            out = step(p, cache, tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if not warming[0]:
                after = kernels.launch_counts()
                steps.append((wall, {k: after[k] - before[k]
                                     for k in after}))
            return out
        return f

    def recorded_execute(self, task, requests, rng, **kw):
        out = execute(self, task, requests, rng, **kw)
        if not warming[0] and len(requests) == 1:
            alone.append(requests[0])
        return out

    def flagged_warmup(self, *a, **kw):
        warming[0] = True
        try:
            return warmup(self, *a, **kw)
        finally:
            warming[0] = False

    T.decode_fn, ProcessingUnit.execute, ProcessingUnit.warmup = (
        counted_decode_fn, recorded_execute, flagged_warmup)
    try:
        router = Router(make_engine_planes(mc, params, router_engine_config(),
                                           2, device="cuda"),
                        policy="affinity")
        trace = make_router_trace(mc.vocab, FAMILY_REQ)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        steps.clear()
        t0 = time.perf_counter()
        stats = router.run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    finally:
        T.decode_fn, ProcessingUnit.execute, ProcessingUnit.warmup = (
            decode_fn, execute, warmup)
    for name in ROUTER_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"the {MOE_ARCH} path never launched {name}")
    want = dict(zip(ROUTER_KERNELS, expected_launches(mc)))
    for wall_s, c in steps:
        if any(c[k] != want[k] for k in want):
            raise AssertionError(f"a {MOE_ARCH} decode step launched {c}, "
                                 f"want {want}")
    reqs = [r for _, r in trace]
    greedy = [r for r in reqs if r.temperature == 0.0]
    for r in greedy:
        if r.status != "done" or len(r.tokens) != ROUTER_NEW:
            raise AssertionError(f"greedy request {r.rid} ended as "
                                 f"{r.status} with {len(r.tokens)} tokens")
    compared = 0
    for r in alone:
        if r.temperature != 0.0:
            continue
        batch = {"tokens": torch.tensor([r.prompt], device="cuda")}
        run = greedy_run(mc, params, batch, ROUTER_NEW - 1)
        direct = [int(lg.argmax(-1)[0]) for lg in run["logits"]]
        if direct != r.tokens:
            raise AssertionError(f"request {r.rid} served alone gave "
                                 f"{r.tokens}, a direct run {direct}")
        compared += 1
    if compared == 0:
        raise AssertionError(f"no greedy {MOE_ARCH} request ran alone")
    done = [r for r in reqs if r.status == "done"]
    n_tok = sum(len(r.tokens) for r in done)
    return {"counts": counts, "stats": stats, "wall_s": wall,
            "decode_steps": len(steps),
            "median_decode_step_ms":
                1e3 * statistics.median(w for w, _ in steps),
            "per_step": want, "compared": compared, "alone": len(alone),
            "completed": len(done), "tokens": n_tok,
            "tokens_per_s": n_tok / wall, "greedy": len(greedy)}


def arch_row(name, cfg, params, cut: str) -> dict:
    """One row of the arch table: a 38-token prompt and ``ARCH_STEPS``
    greedy decode steps (finite logits, launches a step as
    ``expected_launches``), the median step wall, and the device's busy
    share of steady steps under the profiler."""
    rng = np.random.default_rng(SEED + 10)
    prompt = rng.integers(1, cfg.vocab, SYS_LEN + SUFFIX_LEN)
    run = greedy_run(cfg, params, family_inputs(cfg, params, prompt, "cuda"),
                     ARCH_STEPS)
    for lg in run["logits"]:
        if lg.shape != (1, cfg.vocab) or not torch.isfinite(lg).all():
            raise AssertionError(f"{name}: logits not finite or misshaped")
    want = dict(zip(ROUTER_KERNELS, expected_launches(cfg)))
    for c in run["launches"]:
        if any(c[k] != want[k] for k in want):
            raise AssertionError(f"{name}: a decode step launched {c}, "
                                 f"want {want}")
    prof = decode_step_profile(cfg, params, n_steps=PROFILE_STEPS,
                               paged=False)
    wb = decode_weight_bytes(cfg, params)
    return {"arch": name, "family": cfg.family, "cut": cut,
            "weight_bytes": nbytes(params), "read_bytes": wb,
            "bound_ms": wb / HBM_BYTES_PER_S * 1e3,
            "step_ms": 1e3 * statistics.median(run["walls"]),
            "profile": prof, "per_step": want}


def card_vs_cpu(name) -> dict:
    """The reduced config with the same weights on the card and on the CPU
    (the kernels' plain versions): prefill and ``ARCH_STEPS`` greedy decode
    steps on the card, the CPU fed the card's tokens.  Logits within the
    larger of ``CARD_LOGIT_TOL`` and the CPU's own movement under one bf16
    ulp on the embedding table (atol and rtol); the card's greedy token is
    the CPU's wherever the CPU's top-2 margin exceeds twice that, and
    scores within twice that of the CPU's best where it does not."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as T
    cfg = get_arch(name).reduced()
    cpu = T.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    emb = cpu["embed"]["emb"]
    sign = torch.where(torch.rand(emb.shape, generator=torch.Generator()
                                  .manual_seed(SEED + 11)) < 0.5, -1.0, 1.0)
    moved = dict(cpu, embed={"emb": (emb.float() * (1 + sign * 2.0 ** -8))
                             .to(emb.dtype)})
    prompt = np.random.default_rng(SEED + 12).integers(
        1, cfg.vocab, SYS_LEN + SUFFIX_LEN)
    batch = family_inputs(cfg, cpu, prompt, "cpu")
    card = greedy_run(cfg, _tree_to(cpu, "cuda"), _tree_to(batch, "cuda"),
                      ARCH_STEPS)
    fed = [t.cpu() for t in card["fed"]]
    host = greedy_run(cfg, cpu, batch, ARCH_STEPS, feed=fed)
    ref = greedy_run(cfg, moved, family_inputs(cfg, moved, prompt, "cpu")
                     if not cfg.embed_inputs else batch, ARCH_STEPS,
                     feed=fed)
    worst, equal, tols = 0.0, 0, []
    for lc, lh, lr in zip(card["logits"], host["logits"], ref["logits"]):
        lc, lh, lr = lc.float().cpu(), lh.float(), lr.float()
        if not torch.isfinite(lc).all():
            raise AssertionError(f"{name}: card logits are not finite")
        tol = max(CARD_LOGIT_TOL, float((lr - lh).abs().max()))
        tols.append(tol)
        if not torch.allclose(lc, lh, atol=tol, rtol=tol):
            raise AssertionError(f"{name}: card and CPU logits differ by "
                                 f"{float((lc - lh).abs().max())}, beyond "
                                 f"{tol}")
        worst = max(worst, float((lc - lh).abs().max()))
        pick, want = int(lc.argmax()), int(lh.argmax())
        top2 = torch.topk(lh[0], 2).values
        if pick != want and (float(top2[0] - top2[1]) > 2 * tol
                             or float(lh[0, want] - lh[0, pick]) > 2 * tol):
            raise AssertionError(f"{name}: card picked {pick}, CPU {want} "
                                 f"(top-2 margin {float(top2[0] - top2[1])})")
        equal += pick == want
    return {"arch": name, "family": cfg.family, "max_abs_err": worst,
            "tol": max(tols), "equal": equal, "tokens": len(tols)}


def family_phase(smi: str) -> dict:
    """Phase 5: deepseek-moe-16b behind the Router at full width, the arch
    table, and every reduced config on the card against the CPU."""
    from repro_torch.bridge import init_params
    from repro_torch.configs.registry import ARCHS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mc = ARCHS[MOE_ARCH]
    params = init_params(mc, torch.Generator(device="cuda").manual_seed(SEED),
                         "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"phase 5: every family ({smi})")
    log(f"  {MOE_ARCH} at full width: {nbytes(params) / 1e9:.3f} GB of bf16 "
        f"weights ({sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B "
        f"parameters), random init in {init_s:.1f} s")
    t0 = time.perf_counter()
    moe = serve_moe_router(mc, params)
    peak = torch.cuda.max_memory_allocated()
    st = moe["stats"]
    log(f"  Router, 2 planes on one copy of the weights, phase 4's engine "
        f"settings: {FAMILY_REQ} requests in {moe['wall_s']:.2f} s "
        f"(phase part {time.perf_counter() - t0:.1f} s with set-up)")
    log(f"    completed {moe['completed']}, dropped {st['dropped']}, merges "
        f"{st['merges']}, scale-ups {st['scale_ups']}; tokens/s "
        f"{moe['tokens_per_s']:.2f}; {moe['compared']} greedy requests "
        f"served alone equal a direct prefill_fn + decode_fn run")
    log(f"    median decode step {moe['median_decode_step_ms']:.3f} ms over "
        f"{moe['decode_steps']} steps; launches a step: decode_attention "
        f"{moe['per_step']['decode_attention']}, rmsnorm "
        f"{moe['per_step']['rmsnorm']}")
    log(f"    torch.cuda.max_memory_allocated {peak / 2 ** 30:.3f} GiB")
    log(f"    main-path kernel launches: {moe['counts']}")
    rows = [arch_row(MOE_ARCH, mc, params, "full width")]
    log_profile(rows[0]["profile"], f"{MOE_ARCH} decode step (B=1, "
                f"contiguous cache)", mc.n_layers)
    del params
    torch.cuda.empty_cache()

    for name, cfg in ARCHS.items():
        if name == MOE_ARCH:
            continue
        t0 = time.perf_counter()
        cut = "full width"
        if name in CUT_DEPTH:
            cut = f"cut depth: {CUT_DEPTH[name]} of {cfg.n_layers} layers"
            cfg = cfg.scaled(n_layers=CUT_DEPTH[name])
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(SEED), "cuda")
        row = arch_row(name, cfg, params, cut)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        del params
        torch.cuda.empty_cache()
    log(f"  every registered arch: a {SYS_LEN + SUFFIX_LEN}-token prompt, "
        f"{ARCH_STEPS} greedy decode steps (finite logits), B=1, a "
        f"{ROUTER_MAX_LEN}-position cache; bound = weight bytes a step "
        f"reads / {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    for r in rows:
        p = r["profile"]
        busy = ("not measured" if p["busy_ms"] is None else
                f"{p['busy_ms']:.3f} ms busy of {p['wall_ms']:.3f} ms "
                f"({p['busy_ms'] / p['wall_ms']:.3f}; {p['kept']} of "
                f"{p['steps']} profiled steps kept whole)")
        log(f"    {r['arch']:26s} {r['family']:6s} {r['cut']}: weights "
            f"{r['weight_bytes'] / 1e9:.3f} GB, a step reads "
            f"{r['read_bytes'] / 1e9:.3f} GB, bound {r['bound_ms']:.3f} ms; "
            f"step wall {r['step_ms']:.3f} ms (median of {ARCH_STEPS}); "
            f"device {busy}; launches a step {r['per_step']}"
            + (f"; {r['seconds']:.1f} s" if "seconds" in r else ""))
    t0 = time.perf_counter()
    pairs = [card_vs_cpu(name) for name in ARCHS]
    log(f"  card vs CPU on every reduced config ({time.perf_counter() - t0:.1f}"
        f" s): prefill + {ARCH_STEPS} greedy decode steps, the CPU fed the "
        f"card's tokens")
    for c in pairs:
        log(f"    {c['arch']:26s} {c['family']:6s} max |logit err| "
            f"{c['max_abs_err']:.4g} (limit {c['tol']:.4g}); greedy tokens "
            f"equal {c['equal']} of {c['tokens']}")
    return {"moe": moe, "rows": rows, "pairs": pairs, "peak": peak}


# ---------------------------------------------------------------------------
# phase 5b: DeepSeek-V2-Lite through the batched Router at full size
# ---------------------------------------------------------------------------

#: the benchmark's DeepSeek-V2-Lite cell: its configuration, weights, plain
#: reference and correctness limit
DSV2_CELL = "dsv2lite.longdoc16k.backlog"
#: phase 5b's prompts (the cell's 2,048-12,288 and a short one), each
#: DSV2_NEW greedy tokens; one more request repeats the first prompt's
#: first DSV2_SHARED tokens after it completes, so the prefix cache hits
DSV2_PROMPTS = (2048, 12288, 300, 4100, 7000, 1500, 3000, 9000)
DSV2_NEW, DSV2_SHARED = 16, 1600
#: the prefix cache's blocks: every prompt of the phase, so none of the
#: first prompt's blocks is evicted before the hit
DSV2_CACHE_BLOCKS = 4096


def dsv2_phase(smi: str) -> dict:
    """Phase 5b: DeepSeek-V2-Lite at its published size (the benchmark
    cell's configuration and seeded weights, 27 layers, 64 experts)
    behind the ``Router`` over one plane of the batched engine
    (``make_engine_planes``, ``StepBatchingConfig``, chunked prefill and
    paged decode, the prefix cache on), the launch counters zeroed just
    before and read just after: every request done with its tokens; each
    chunk launches ``chunk_attention`` (its (192, 128) instance) once a
    layer and each decode step the latent ``paged_mla_decode_attention``
    once a layer, and no dense paged decode; the prefix cache hits; and
    the served tokens of the longest request and the prefix hit lie within
    the cell's limit of the plain f32 reference's best logits (its
    check)."""
    from repro_torch import kernels
    from repro_torch.serving.batching import StepBatchingConfig
    from repro_torch.serving.cluster import Router, make_engine_planes
    from repro_torch.serving.engine import EngineConfig, Request

    sys.path.insert(0, str(ROOT))
    from perfbench import bench
    cell = bench.Cell(bench.load_json(ROOT / "BENCHMARK.json"), DSV2_CELL)
    limit = cell.settings["check"]["limit"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = cell.family.make_weights(cell.conf, SEED, torch.device("cuda"))
    mc = cell.family.port_config(cell.conf)
    torch.cuda.synchronize()
    log(f"phase 5b: {mc.name} through the batched Router ({smi}): "
        f"{nbytes(params) / 1e9:.3f} GB of bf16 weights, "
        f"{mc.n_layers} layers, drawn in {time.perf_counter() - t0:.1f} s")
    max_len = max(DSV2_PROMPTS) + DSV2_NEW
    ecfg = EngineConfig(
        n_units=1, heuristic="EDF", merging="none", pruning=None,
        result_cache=False, elasticity=None, max_len=max_len,
        batch_buckets=(1,), prefix_cache=True, kv_block_size=16,
        kv_cache_blocks=DSV2_CACHE_BLOCKS, prefix_max_prompt=max_len,
        batching=StepBatchingConfig(max_batch=8, step_token_budget=2048))
    router = Router(make_engine_planes(mc, params, ecfg, 1, device="cuda"),
                    policy="least-loaded")
    rng = np.random.default_rng(SEED + 5)
    prompts = [tuple(int(x) for x in rng.integers(1, mc.vocab, n))
               for n in DSV2_PROMPTS]
    prompts.append(prompts[0][:DSV2_SHARED]
                   + tuple(int(x) for x in rng.integers(1, mc.vocab, 200)))
    trace = [(float(i), Request(prompt=p, n_new=DSV2_NEW, deadline=1e12))
             for i, p in enumerate(prompts[:-1])]
    trace.append((1e6, Request(prompt=prompts[-1], n_new=DSV2_NEW,
                               deadline=1e12)))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    router.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    st = router.collect_stats()
    reqs = [r for _, r in trace]
    for r in reqs:
        if r.status != "done" or len(r.tokens) != DSV2_NEW:
            raise AssertionError(f"phase 5b: request {r.rid} ended as "
                                 f"{r.status} with {len(r.tokens)} tokens, "
                                 f"want done with {DSV2_NEW}")
    for name in DSV2_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"phase 5b: the batched path never "
                                 f"launched {name}")
    if counts["chunk_attention"] != mc.n_layers * st["chunk_launches"]:
        raise AssertionError(
            f"phase 5b: chunk_attention launched {counts['chunk_attention']}"
            f" times over {st['chunk_launches']} chunks, want {mc.n_layers}"
            f" a chunk")
    if counts["paged_mla_decode_attention"] != \
            mc.n_layers * st["decode_launches"]:
        raise AssertionError(
            f"phase 5b: paged_mla_decode_attention launched "
            f"{counts['paged_mla_decode_attention']} times over "
            f"{st['decode_launches']} decode steps, want {mc.n_layers} a step")
    if counts["paged_decode_attention"]:
        raise AssertionError(f"phase 5b: the latent model launched the dense "
                             f"paged decode {counts['paged_decode_attention']}"
                             f" times")
    if st["prefix_hits"] == 0:
        raise AssertionError("phase 5b: the prefix cache recorded no hits")
    peak = torch.cuda.max_memory_allocated()
    del router
    gc.collect()
    t1 = time.perf_counter()
    judged = [reqs[1], reqs[-1]]
    with torch.no_grad():
        gaps, _ = bench.logit_gaps(cell.reference, cell.conf, params,
                                   [(r.prompt, r.tokens) for r in judged])
    if max(gaps) > limit:
        raise AssertionError(f"phase 5b: served tokens' logit gaps {gaps} "
                             f"against the f32 reference, over the cell's "
                             f"limit {limit}")
    n_tok = sum(len(r.tokens) for r in reqs)
    res = {"counts": counts, "wall_s": wall, "tokens_per_s": n_tok / wall,
           "chunks": st["chunk_launches"], "decode_steps":
           st["decode_launches"], "prefix_hits": st["prefix_hits"],
           "prefix_tokens_reused": st["prefix_tokens_reused"],
           "moe_real_rows": st["moe_real_rows"],
           "mla_expand_tokens": st["mla_expand_tokens"], "gaps": gaps,
           "limit": limit, "peak": peak,
           "reference_s": time.perf_counter() - t1}
    log(f"  {len(reqs)} requests (prompts {min(DSV2_PROMPTS)}-"
        f"{max(DSV2_PROMPTS)} and a {len(prompts[-1])}-token prefix hit), "
        f"{DSV2_NEW} greedy tokens each, in {wall:.2f} s: {res['chunks']} "
        f"chunks, {res['decode_steps']} decode steps; launches "
        f"chunk_attention {counts['chunk_attention']} = {mc.n_layers} x "
        f"{res['chunks']}, paged_mla_decode_attention "
        f"{counts['paged_mla_decode_attention']} = {mc.n_layers} x "
        f"{res['decode_steps']}; prefix hits {res['prefix_hits']} "
        f"({res['prefix_tokens_reused']} tokens reused); expert rows "
        f"{res['moe_real_rows']}, latent tokens expanded "
        f"{res['mla_expand_tokens']}")
    log(f"  logit gaps of the longest request and the prefix hit against "
        f"the f32 reference {', '.join(f'{x:.4f}' for x in gaps)} (limit "
        f"{limit}; reference {res['reference_s']:.1f} s); "
        f"torch.cuda.max_memory_allocated {peak / 2 ** 30:.3f} GiB")
    log(f"  main-path kernel launches: {counts}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_launcher() -> dict:
    """The port's launcher on the card, as a user runs it, recording its
    run to ``LAUNCHER_RECORD``."""
    LAUNCHER_RECORD.parent.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--requests",
           "12", "--units", "1", "--merging", "adaptive", "--pruning",
           "--rate", "0.5", "--record-out", str(LAUNCHER_RECORD)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"the launcher exited {res.returncode}:\n"
                             f"{res.stderr[-3000:]}")
    stats = json.loads(res.stdout)
    if not stats["completed"] > 0:
        raise AssertionError(f"the launcher completed {stats['completed']}"
                             f" requests")
    return {"wall_s": wall, "completed": stats["completed"],
            "dropped": stats["dropped"], "n_requests": stats["n_requests"]}


# ---------------------------------------------------------------------------
# phase 7: record -> fit -> replay, and the Ch. 3 predictor
# ---------------------------------------------------------------------------

LAUNCHER_RECORD = ROOT / "build" / "calibration" / "launcher_record.json"
#: the reference's bound on a fitted replay's per-stage drift
#: (``benchmarks/serving.py`` calibration), printed beside each reading
DRIFT_BOUND_PCT = 15.0
#: the live row: 24 requests of 10-token prompts and 8 new tokens.  A
#: decode step took 35-57 ms (3.5-5.7 ticks) on an NVIDIA H100 80GB HBM3 at
#: 700 W (PERF.md section 5), so a span is about 30-50 ticks, far above the
#: 1-tick floor below which a stage is not scored, with no need for the JAX
#: row's 24-token decodes.  Gaps have a mean of 600 ticks, 12-20 spans, the
#: JAX row's ratio (40-tick gaps, ~3-tick spans): queueing collisions stay
#: rare, so the latency drift measures the oracle's fit and not collision
#: luck.
CAL_REQ, CAL_PLEN, CAL_NEW, CAL_GAP, CAL_DEADLINE = 24, 10, 8, 600.0, 5000.0
#: the MLP trained on the card against the same training on the host, on
#: its predictions: ``tests/test_torch_cuda.py``'s ``MLP_CARD_ATOL``
MLP_CARD_ATOL = 1e-4


def record_run(eng, trace) -> tuple[dict, dict]:
    """Run ``eng`` over ``trace`` under a flight recorder with every side
    channel filled (the launcher's ``--record-out`` wiring); returns the
    record, JSON round-tripped, and the run's stats."""
    from repro_torch.obs import FlightRecorder
    rec = FlightRecorder(capacity=1 << 15)
    for t, item in trace:
        rec.note_arrival(t, item)
    eng.attach_telemetry(rec)
    stats = eng.run(trace)
    rec.snapshot_estimator(0.0, eng.estimator)
    rec.note_machines(eng.machines)
    rec.note_engine_config(eng.cfg)
    rec.note_stats(stats)
    return json.loads(json.dumps(rec.to_artifact())), stats


def fit_and_replay(record: dict) -> dict:
    """Fit an oracle from a flight record and replay the record under it;
    also the recorded exec spans, in the order they ended."""
    from repro_torch.obs import (drift_report, fit_oracle,
                                 validate_drift_report)
    report = drift_report(record)
    validate_drift_report(report)
    open_at, spans = {}, []
    for e in record["events"]:
        key = (e.get("machine"), e.get("task"))
        if e["kind"] == "exec_start":
            open_at[key] = e["t"]
        elif e["kind"] == "exec_end" and key in open_at:
            spans.append(e["t"] - open_at.pop(key))
    return {"table": fit_oracle(record).summary(), "report": report,
            "spans": spans}


def calibration_row(mc, params, dev) -> dict:
    """The live engine on ``dev`` through the record -> fit -> replay loop
    (``benchmarks/serving.py``'s live row at full width): one unit, EDF, no
    merging, pruning or caches, bucket 1, units warmed at the prompt
    length, ``CAL_REQ`` requests far apart."""
    from repro_torch import kernels
    from repro_torch.serving.engine import (EngineConfig, Request,
                                            ServingEngine)
    eng = ServingEngine(mc, params, EngineConfig(
        n_units=1, elasticity=None, heuristic="EDF", merging="none",
        pruning=None, result_cache=False, prefix_cache=False,
        max_len=ROUTER_MAX_LEN, batch_buckets=(1,)), device=dev)
    for u in eng.units:
        u.warmup(prompt_len=CAL_PLEN, buckets=(1,))
    rng = np.random.default_rng(SEED + 8)
    prompts = [tuple(int(x) for x in rng.integers(1, mc.vocab, CAL_PLEN))
               for _ in range(4)]
    trace, t = [], 0.0
    for _ in range(CAL_REQ):
        trace.append((t, Request(prompt=prompts[int(rng.integers(0, 4))],
                                 n_new=CAL_NEW, seed=int(rng.integers(0, 2)),
                                 deadline=t + CAL_DEADLINE)))
        t += float(rng.exponential(CAL_GAP))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    record, stats = record_run(eng, trace)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    if stats["completed"] != CAL_REQ:
        raise AssertionError(f"the calibration row completed "
                             f"{stats['completed']} of {CAL_REQ}")
    return {**fit_and_replay(record), "counts": counts, "wall_s": wall}


def control_replay() -> list[dict]:
    """A stub-oracle engine recording replayed under its own oracle:
    every recorded decision must come back, at 0.0 drift (trace
    equivalence), for an adaptive-merging and a pruning configuration."""
    from repro_torch.core.pruning import PruningConfig
    from repro_torch.core.simulation import PETOracle
    from repro_torch.core.tasks import PETMatrix
    from repro_torch.obs import drift_report, validate_drift_report
    from repro_torch.serving.engine import (EngineConfig, Request,
                                            ServingEngine)

    def oracle():
        return PETOracle(PETMatrix.generate(
            ["generate"], ["m0"], np.random.default_rng(3),
            mean_range=(8, 16)), seed=11)
    out = []
    for name, kw in (
            ("edf-adaptive", dict(heuristic="EDF", merging="adaptive")),
            ("msd-pruned", dict(heuristic="MSD", merging="conservative",
                                pruning=PruningConfig(
                                    initial_defer_threshold=0.1,
                                    base_drop_threshold=0.3,
                                    dynamic_defer=True)))):
        rng = np.random.default_rng(1)
        prompts = [tuple(rng.integers(1, 1000, size=8).tolist())
                   for _ in range(5)]
        trace, t = [], 0.0
        for _ in range(40):
            trace.append((t, Request(
                prompt=prompts[int(rng.integers(0, 5))], n_new=int(
                    rng.integers(1, 4)), seed=int(rng.integers(0, 2)),
                deadline=t + 20.0)))
            t += float(rng.exponential(0.5))
        eng = ServingEngine(None, None, EngineConfig(
            n_units=1, elasticity=None, result_cache=False,
            prefix_cache=False, **kw), stub_oracle=oracle(), device="cpu")
        record, _ = record_run(eng, trace)
        report = drift_report(record, oracle=oracle(), control=True)
        validate_drift_report(report)
        dec = report["decisions"]
        if not (dec["match"] and dec["recorded"] == dec["replayed"] > 0
                and report["max_stage_drift_pct"] == 0.0
                and all(c["gap"] == 0 for c in report["counters"].values())):
            raise AssertionError(f"control replay {name} does not match its "
                                 f"recording: {json.dumps(report)}")
        out.append({"name": name, "decisions": dec["recorded"],
                    "completed": report["counters"]["completed"]["recorded"],
                    "dropped": report["counters"]["dropped"]["recorded"]})
    return out


def predictor_phase(dev) -> dict:
    """``benchmarks/predictor.py``'s Fig. 3.5 comparison with the MLP on
    ``dev``, and the same MLP fit on the host: both start from the same
    seeded initial parameters (drawn on the host), and their predictions
    are held to ``MLP_CARD_ATOL``."""
    from repro_torch.core.merge_model import VideoExecModel
    from repro_torch.core.predictor import (GBDT, MLPPredictor,
                                            NaivePredictor, accuracy)
    model = VideoExecModel(seed=1)
    X, y = model.make_dataset(5000, np.random.default_rng(0))
    Xt, yt = model.make_dataset(1200, np.random.default_rng(99))
    t0 = time.perf_counter()
    gbdt = GBDT(n_estimators=80, max_depth=8, min_samples_split=30,
                min_samples_leaf=2).fit(X, y)
    gbdt_s = time.perf_counter() - t0
    naive = NaivePredictor().fit(X, y)
    mlps, walls = {}, {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        mlps[d] = MLPPredictor(steps=500, device=d).fit(X, y)
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize()
        walls[d] = time.perf_counter() - t0
    pred = mlps[dev].predict(Xt)
    diff = float(np.abs(pred - mlps["cpu"].predict(Xt)).max())
    if not diff <= MLP_CARD_ATOL:
        raise AssertionError(f"the MLP trained on {dev} predicts {diff} away "
                             f"from the same training on the host, above "
                             f"{MLP_CARD_ATOL}")
    acc = {"GBDT": accuracy(gbdt.predict(Xt), yt, 0.12),
           "MLP": accuracy(pred, yt, 0.12),
           "Naive": accuracy(naive.predict(Xt), yt, 0.12)}
    checks = {"gbdt_beats_naive": acc["GBDT"] > acc["Naive"],
              "gbdt_matches_or_beats_mlp": acc["GBDT"] >= acc["MLP"] - 0.5,
              "gbdt_90plus": acc["GBDT"] >= 90.0}
    return {"accuracy": acc, "checks": checks, "mlp_max_diff": diff,
            "mlp_fit_s": walls, "gbdt_fit_s": gbdt_s}


def log_calibration(what: str, res: dict) -> None:
    rep = res["report"]
    dec, cnt = rep["decisions"], rep["counters"]
    log(f"  {what}: fitted table {res['table']}")
    log(f"    decisions recorded {dec['recorded']}, replayed "
        f"{dec['replayed']} (first divergence {dec['divergence_index']}); "
        f"completed recorded {cnt['completed']['recorded']}, replayed "
        f"{cnt['completed']['replayed']}; dropped recorded "
        f"{cnt['dropped']['recorded']}, replayed {cnt['dropped']['replayed']}")
    spans = res["spans"]
    if spans:
        log(f"    recorded exec spans: {len(spans)}; the first "
            f"{spans[0]:.3f} beside the median {statistics.median(spans):.3f}"
            f"; min {min(spans):.3f}, max {max(spans):.3f} (exec "
            f"#{spans.index(max(spans))}) ticks")
    for name, row in rep["stages"].items():
        log(f"    {name:8s} recorded {row['recorded_mean']:10.4f} replayed "
            f"{row['replayed_mean']:10.4f} ticks, drift "
            f"{row['drift_pct']:8.4f}%"
            f"{'' if row['scored'] else ' (unscored)'}")
    log(f"    max_stage_drift_pct {rep['max_stage_drift_pct']} (the "
        f"reference's bound: {DRIFT_BOUND_PCT}%; reported, not checked)")


# ---------------------------------------------------------------------------
# phase 8: training on the card
# ---------------------------------------------------------------------------

#: the full-width training run, as a user types it (the checkpoint
#: directory is added per run)
TRAIN_STEPS = 30
TRAIN_ARGV = ("--arch", "smollm-360m", "--steps", str(TRAIN_STEPS),
              "--batch", "8", "--seq", "1024", "--ckpt-every",
              str(TRAIN_STEPS))
TRAIN_DIR = ROOT / "build" / "train_full"
#: steps whose wall the median is taken over (steps 5-30), and the steps
#: profiled for the device's busy share
TRAIN_STEADY, TRAIN_PROFILED = 4, 3
#: the losses recorded in PERF.md (NVIDIA H100 80GB HBM3, torch 2.11),
#: printed beside this run's: the launcher's at steps 1/10/20/30, and
#: ``train_100m --full-width``'s (phase 11) at steps 1/10/20
RECORDED_TRAIN_LOSSES = {1: 11.1826, 10: 6.4652, 20: 5.6753, 30: 5.6651}
RECORDED_EXAMPLE_LOSSES = {1: 11.3063, 10: 6.7104, 20: 5.8443}
H100_BF16_FLOPS = 989e12      # dense, NVIDIA data sheet
#: a training step's rows at smollm's width (batch 8 x seq 1024), and the
#: input sets its timing takes in turn (4 x 31.5 MB of x and g)
BWD_SHAPE, BWD_SETS = (8192, 960), 4


#: how far the kernel's f32 1 / rms may sit from the plain version's,
#: relatively (it sums x * x in another order: a few f32 ulps)
R_SLACK = 2.0 ** -20


def dscale_room(x, g):
    """Room for each column of dscale: R_SLACK of the sum of |g * n| over
    the rows (n = cast(x * r), the sum taken in another order), plus, for
    every term, |g| times how far n moves when r moves by R_SLACK either
    way: where x * r lies that close to a bf16 rounding point, the
    kernel's r may round it the other way.  Not one term more: one missing
    or doubled row moves a column by far more."""
    d = x.shape[-1]
    xf, ga = x.float(), g.float().abs()
    v = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-5)
    n = v.to(x.dtype).float()
    flips = sum(((v * (1 + t)).to(x.dtype).float() - n).abs()
                for t in (R_SLACK, -R_SLACK))
    return (ga * (R_SLACK * n.abs() + flips)).reshape(-1, d).sum(0)


def bwd_close(name, got, want, x, s, g) -> float:
    """The backward kernel against its plain version: dx at the forward's
    bar (``RMS_TOL``); dscale within ``dscale_room`` plus, in bf16, one
    ulp of the result (8e-3).  Returns the larger max |err|."""
    assert_close(f"{name} dx", got[0], want[0], *RMS_TOL[x.dtype])
    room = dscale_room(x, g)
    if x.dtype == torch.bfloat16:
        room = room + 8e-3 * want[1].float().abs()
    err = (got[1].float() - want[1].float()).abs()
    if not torch.isfinite(got[1].float()).all() or bool((err > room + 1e-6)
                                                        .any()):
        raise AssertionError(f"{name} dscale: max |err| {float(err.max())}"
                             f", {float((err - room).max())} beyond its "
                             f"bound")
    return max(max_err(got[0], want[0]), float(err.max()))


def check_rmsnorm_bwd() -> dict:
    """The RMSNorm backward kernel against ``rmsnorm_bwd_ref`` in f32 and
    bf16 at a training step's rows (8192, 960), a decode step's (8, 1,
    960) and 3 rows of every width ``check_width`` takes; two calls give
    the same bits.  Timed at (8192, 960) bf16 against autograd through
    ``F.rms_norm``."""
    from repro_torch.kernels.rmsnorm.ops import MAX_D, rmsnorm_bwd_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)

    def inputs(shape, dt):
        x = (3.0 * torch.randn(shape, generator=gen, device=dev)).to(dt)
        s = (1.0 + 0.1 * torch.randn(shape[-1:], generator=gen,
                                     device=dev)).to(dt)
        g = torch.randn(shape, generator=gen, device=dev).to(dt)
        return x, s, g

    worst, n = 0.0, 0
    for dt in (torch.float32, torch.bfloat16):
        per_vec = 16 // dt.itemsize
        shapes = [BWD_SHAPE, (8, 1, 960)] + [
            (3, w) for w in range(per_vec, MAX_D + 1, per_vec)]
        for shape in shapes:
            x, s, g = inputs(shape, dt)
            got = rmsnorm_bwd_cuda(x, s, g)
            again = rmsnorm_bwd_cuda(x, s, g)
            name = f"rmsnorm_bwd {shape} {dt}"
            if not (torch.equal(got[0], again[0])
                    and torch.equal(got[1], again[1])):
                raise AssertionError(f"{name}: two calls differ")
            err = bwd_close(name, got, rmsnorm_bwd_ref(x, s, g), x, s, g)
            if shape in (BWD_SHAPE, (8, 1, 960)):
                worst = max(worst, err)
            n += 1
    # timed on BWD_SETS input sets in turn, 126 MB in all (the warm
    # figure: a set's 47 MB may still sit in the 50 MB L2 in part); the
    # cold figure flushes the L2 before each call, as a training step's
    # backward finds the norm's saved input
    sets = itertools.cycle([inputs(BWD_SHAPE, torch.bfloat16)
                            for _ in range(BWD_SETS)])

    def kernel():
        rmsnorm_bwd_cuda(*next(sets))

    def plain():
        rmsnorm_bwd_ref(*next(sets))

    def library():
        x, s, g = next(sets)
        xr, sr = x.detach().requires_grad_(), s.detach().requires_grad_()
        torch.autograd.grad(F.rms_norm(xr, (x.shape[-1],), sr, 1e-5),
                            (xr, sr), g)
    rows, d = BWD_SHAPE
    b_ms, b_by = bound(3 * rows * d * 2 + 2 * d * 2, 10.0 * rows * d)
    return {"name": "rmsnorm_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm/rmsnorm.py:24",
            "max_abs_err": worst,
            **timings(kernel, plain,
                      library if hasattr(F, "rms_norm") else None,
                      iters=200),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"x, g {BWD_SHAPE} bf16 (the backward of a training "
                     f"step's norm; {BWD_SETS} input sets in turn, out of "
                     f"L2); {n} shapes checked, every one deterministic"}


def _loss_grads(cfg, params, batch) -> tuple[float, dict]:
    """``loss_fn`` and the gradient of every parameter (None where the
    loss does not reach it), on fresh leaves of ``params``."""
    from repro_torch.models import transformer as T
    leaves = {}

    def leaf(path, t):
        leaves[path] = t.detach().clone().requires_grad_()
        return leaves[path]

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        return leaf(path, tree)
    loss = T.loss_fn(cfg)(walk(params), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return float(loss.detach()), dict(zip(leaves, grads))


def train_card_vs_cpu(name) -> dict:
    """``loss_fn`` and every gradient of the reduced config on the card
    against the same weights and batch on the CPU (the kernels' plain
    versions), prompt tokens as in phase 5 and their successors as labels.
    The loss within the larger of ``CARD_LOGIT_TOL`` and the CPU's own
    movement under one bf16 ulp on the embedding table (phase 5's rule for
    logits, as atol and rtol);
    each gradient within the larger of ``CARD_LOGIT_TOL`` and that
    movement, both relative to the CPU gradient's norm."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as T
    cfg = get_arch(name).reduced()
    cpu = T.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    emb = cpu["embed"]["emb"]
    sign = torch.where(torch.rand(emb.shape, generator=torch.Generator()
                                  .manual_seed(SEED + 11)) < 0.5, -1.0, 1.0)
    moved = dict(cpu, embed={"emb": (emb.float() * (1 + sign * 2.0 ** -8))
                             .to(emb.dtype)})
    seq = np.random.default_rng(SEED + 12).integers(
        1, cfg.vocab, SYS_LEN + SUFFIX_LEN + 1)
    labels = torch.as_tensor(seq[1:][None], dtype=torch.int64)

    def batch(params):
        return dict(family_inputs(cfg, params, seq[:-1], "cpu"),
                    labels=labels)
    card_loss, card = _loss_grads(cfg, _tree_to(cpu, "cuda"),
                                  _tree_to(batch(cpu), "cuda"))
    host_loss, host = _loss_grads(cfg, cpu, batch(cpu))
    ref_loss, ref = _loss_grads(cfg, moved, batch(moved))
    if not np.isfinite(card_loss):
        raise AssertionError(f"{name}: the card's loss is not finite")
    loss_tol = max(CARD_LOGIT_TOL, abs(ref_loss - host_loss))
    if abs(card_loss - host_loss) > loss_tol * (1 + abs(host_loss)):
        raise AssertionError(f"{name}: card loss {card_loss}, CPU "
                             f"{host_loss}, beyond {loss_tol}")
    worst, tol = 0.0, CARD_LOGIT_TOL
    for path, h in host.items():
        c = card[path]
        if h is None or c is None:
            if (h is None) != (c is None):
                raise AssertionError(f"{name} {path}: a gradient on one "
                                     f"side only")
            continue
        c = c.float().cpu()
        if not torch.isfinite(c).all():
            raise AssertionError(f"{name} {path}: gradient not finite")
        norm = max(float(h.float().norm()), 1e-12)
        lim = max(CARD_LOGIT_TOL, float((ref[path].float() - h.float())
                                        .norm()) / norm)
        err = float((c - h.float()).norm()) / norm
        if err > lim:
            raise AssertionError(f"{name} {path}: gradient off by {err:.4g}"
                                 f" of its norm, beyond {lim:.4g}")
        worst, tol = max(worst, err), max(tol, lim)
    return {"arch": name, "family": cfg.family, "loss_err":
            abs(card_loss - host_loss), "loss_tol": loss_tol,
            "grad_err": worst, "grad_tol": tol, "leaves": len(host)}


def beside_record(got: dict, recorded: dict) -> str:
    """A run's losses by step beside the recorded ones, to the 4 places
    both are printed with (a reading, not a check)."""
    moved = [k for k, v in recorded.items() if round(got.get(k, -1.0), 4)
             != v]
    return (f"recorded losses at steps {'/'.join(map(str, recorded))}: "
            + ", ".join(f"{v:.4f}" for v in recorded.values()) + "; this run "
            + ("equal to 4 places" if not moved else
               "differs at steps " + ", ".join(map(str, moved))))


def train_full() -> dict:
    """Full-width smollm-360m trained by the launcher as a subprocess and
    by the same command in this process (launch counters zeroed just
    before, read just after); the launcher's final checkpoint restores to
    the in-process state bit for bit; then 3 steps under the profiler."""
    import shutil
    from repro_torch import kernels
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.launch.train import build_trainer, parse_args
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *TRAIN_ARGV, "--ckpt-dir", str(TRAIN_DIR)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    sub_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"the train launcher exited {res.returncode}:"
                             f"\n{res.stderr[-3000:]}")
    body, last = res.stdout.rstrip().rsplit("\n", 1)
    logged = json.loads(body)
    losses = [m["loss"] for m in logged]
    if not (losses and all(np.isfinite(losses))
            and losses[-1] < losses[0]):
        raise AssertionError(f"the launcher's losses {losses}: not finite "
                             f"and falling")
    if not last.startswith(f"finished at step {TRAIN_STEPS};"):
        raise AssertionError(f"the launcher ended with {last!r}")

    inproc = ROOT / "build" / "train_full_inproc"
    shutil.rmtree(inproc, ignore_errors=True)
    tr = build_trainer(parse_args([*TRAIN_ARGV, "--ckpt-dir", str(inproc)]))
    walls = []
    track = tr._track_stragglers

    def timed(dt):
        walls.append(dt)
        track(dt)
    tr._track_stragglers = timed
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    state = tr.run()
    counts = kernels.launch_counts()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(inproc, ignore_errors=True)

    t0 = time.perf_counter()
    like = {"params": state.params, "opt_state": state.opt_state}
    tree, manifest = CheckpointManager(str(TRAIN_DIR)).restore(like)
    restore_s = time.perf_counter() - t0
    mine, theirs = list(_leaves(like)), list(_leaves(tree))
    differ = sum(not torch.equal(a, b) for a, b in zip(mine, theirs))
    if manifest["step"] != TRAIN_STEPS or len(mine) != len(theirs) \
            or differ:
        raise AssertionError(f"the launcher's checkpoint (step "
                             f"{manifest['step']}) differs from the "
                             f"in-process state in {differ} of "
                             f"{len(mine)} leaves")
    del tree
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    step = tr.step_fn

    def run(n, first):
        for i in range(n):
            step(state.params, state.opt_state, tr._batch(first + i))
        torch.cuda.synchronize()
    run(1, TRAIN_STEPS)
    mark = torch.zeros((1,), dtype=torch.int16, device="cuda")
    calls, _ = profiled_calls(
        lambda i: run(1, TRAIN_STEPS + 1 + i), TRAIN_PROFILED, mark)
    per_kernel = per_call_ms(calls)
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    cfg = tr.model_cfg
    n_params = sum(t.numel() for t in _leaves(state.params))
    n_body = n_params - cfg.vocab * cfg.d_model      # all but the embedding
    tokens = tr.data_cfg.global_batch * tr.data_cfg.seq_len
    median = statistics.median(walls[TRAIN_STEADY:])
    return {"sub_s": sub_s, "run_s": run_s, "restore_s": restore_s,
            "losses": losses, "logged": [m["step"] for m in logged],
            "leaves": len(mine), "median_ms": 1e3 * median,
            "tokens_per_s": tokens / median, "busy_ms": busy or None,
            "kept": len(calls), "top": top, "n_kernels": len(per_kernel),
            "peak": peak, "counts": counts, "steps": len(walls),
            "n_params": n_params, "n_body": n_body,
            "mfu": 6 * n_body * tokens / median / H100_BF16_FLOPS}


def train_restart() -> dict:
    """``tests/test_substrate.py``'s tiny trainer on the card: a crash at
    step 4, a resume from step 3's checkpoint, against an uninterrupted
    run (JAX's 2e-2); prints the max |diff| (0 when both runs are
    bit-equal)."""
    import shutil
    import tempfile
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = get_arch("smollm-360m").reduced().scaled(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab=256,
        head_dim=32, remat=False)
    root = Path(tempfile.mkdtemp(dir=ROOT / "build"))

    def trainer(d):
        return Trainer(cfg, OptConfig(lr=1e-3, warmup_steps=2,
                                      decay_steps=6),
                       DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=2),
                       TrainConfig(steps=6, ckpt_dir=str(root / d),
                                   ckpt_every=3, log_every=2), device="cuda")
    try:
        a = trainer("a").run()
        crashed = trainer("b")
        try:
            crashed.run(fail_at_step=4)
            raise AssertionError("the injected failure did not fire")
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        # step 3's checkpoint is written by a thread the crash leaves
        # running; a process that died would leave it whole or absent
        crashed.ckpt.wait()
        resumed = trainer("b")
        start = resumed._restore_or_init().step
        b = resumed.run()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    diff = max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in zip(_leaves(a.params), _leaves(b.params)))
    if start != 3 or b.step != 6 or diff > 2e-2:
        raise AssertionError(f"resumed at {start}, ended at {b.step}, max "
                             f"|diff| {diff} against the uninterrupted run")
    return {"resumed_at": start, "max_diff": diff}


def train_phase(smi: str) -> dict:
    """Phase 8: the backward kernel, every reduced config's gradients on
    the card against the CPU, full-width smollm-360m trained through the
    launcher, and the restart check."""
    t0 = time.perf_counter()
    row = check_rmsnorm_bwd()
    log(f"phase 8: training on the card ({smi})")
    log(f"  rmsnorm_bwd {row['shape']} ({time.perf_counter() - t0:.1f} s):"
        f" {cold_and_warm(row, 'autograd through F.rms_norm')}; "
        f"back-to-back wall a call {row['wall']}; "
        f"max|err| {row['max_abs_err']:.3g}")
    from repro_torch.configs.registry import ARCHS
    t0 = time.perf_counter()
    pairs = [train_card_vs_cpu(name) for name in ARCHS]
    log(f"  card vs CPU, loss_fn and every gradient of every reduced config"
        f" ({time.perf_counter() - t0:.1f} s; gradient errors relative to "
        f"the CPU gradient's norm):")
    for c in pairs:
        log(f"    {c['arch']:26s} {c['family']:6s} |loss err| "
            f"{c['loss_err']:.4g} (limit {c['loss_tol']:.4g}); worst of "
            f"{c['leaves']} gradients {c['grad_err']:.4g} (limit "
            f"{c['grad_tol']:.4g})")
    t0 = time.perf_counter()
    full = train_full()
    n_layers = 32
    per_step = {k: full["counts"][k] / full["steps"]
                for k in ("rmsnorm", "rmsnorm_bwd")}
    want = {"rmsnorm": 4 * n_layers + 1, "rmsnorm_bwd": 2 * n_layers + 1}
    if per_step != want:
        raise AssertionError(f"rmsnorm launches a step {per_step}, not "
                             f"{want}")
    busy = ("not measured" if full["busy_ms"] is None else
            f"{full['busy_ms']:.3f} ms busy a step "
            f"({full['busy_ms'] / full['median_ms']:.3f} of the median; "
            f"{full['kept']} of {TRAIN_PROFILED} profiled steps kept whole)")
    log(f"  smollm-360m at full width ({full['n_params'] / 1e6:.1f} M "
        f"parameters, remat on), {' '.join(TRAIN_ARGV)}: the launcher "
        f"exited 0 in {full['sub_s']:.1f} s, losses at steps "
        f"{full['logged']}: {[round(v, 4) for v in full['losses']]}")
    log("    " + beside_record(dict(zip(full["logged"], full["losses"])),
                              RECORDED_TRAIN_LOSSES))
    log(f"    the same command in this process ({full['run_s']:.1f} s): "
        f"its {full['leaves']} params and optimizer-state leaves equal the "
        f"launcher's final checkpoint bit for bit (restored in "
        f"{full['restore_s']:.1f} s)")
    log(f"    median step wall (steps {TRAIN_STEADY + 1}-{full['steps']}) "
        f"{full['median_ms']:.3f} ms, {full['tokens_per_s']:.0f} tokens/s, "
        f"device {busy} (torch.profiler, {TRAIN_PROFILED} steps); "
        f"MFU {full['mfu']:.4f} (6 x {full['n_body'] / 1e6:.1f} M "
        f"non-embedding parameters x tokens / wall / 989 TFLOP/s)")
    log(f"    device time a step by kernel (the top 12 of "
        f"{full['n_kernels']} kernel names):")
    for kname, ms in full["top"]:
        log(f"      {ms:9.3f} ms  {kname[:100]}")
    log(f"    torch.cuda.max_memory_allocated {full['peak'] / 2 ** 30:.3f} "
        f"GiB; rmsnorm launches a step: {per_step['rmsnorm']:.0f} forward "
        f"(65 + 64 recomputed), {per_step['rmsnorm_bwd']:.0f} backward")
    log(f"    main-path kernel launches: {full['counts']}")
    rs = train_restart()
    log(f"  restart on the card (tiny config): crashed at step 4, resumed "
        f"at step {rs['resumed_at']}; max |param diff| against the "
        f"uninterrupted run {rs['max_diff']:.3g} (limit 2e-2)"
        + (" — the two runs are bit-equal" if rs["max_diff"] == 0 else ""))
    log(f"  phase 8 took {time.perf_counter() - t0:.1f} s after the kernel "
        f"checks")
    return {"row": row, "pairs": pairs, "full": full, "restart": rs}


# ---------------------------------------------------------------------------
# phase 10: parallel/ on torch.distributed, the counted bounds, the dry-run
# ---------------------------------------------------------------------------

PARALLEL_STORE = ROOT / "build" / "phase10_store"
DRYRUN_OUT = ROOT / "build" / "dryrun_phase10"
#: the dry-run cells the card's host traces on the fake 256-rank mesh
DRYRUN_CELLS = (("smollm-360m", "decode_32k"), ("llama3-8b", "train_4k"),
                ("xlstm-125m", "train_4k"), ("xlstm-125m", "prefill_32k"),
                ("zamba2-2.7b", "decode_32k"))
#: the decode cells traced on the fake 4 x 2 mesh at two cache lengths
#: each: a rank's collective bytes must not depend on the length
LENGTH_CELLS, LENGTHS = ("smollm-360m", "zamba2-2.7b"), (16384, 32768)
#: a train cell traced on the fake 4 x 2 mesh, and rank 0's collective
#: bytes there as torch 2.13 counts them (a CPU host, ``python -m
#: repro_torch.launch.dryrun``): ``parallel/ctx.py`` pins every layout of
#: the Mamba2 block, so the card's host, on another torch, must count
#: within ``VERSION_TOL`` of it
VERSION_CELL, VERSION_BYTES, VERSION_TOL = (
    ("zamba2-2.7b", "train_4k"), 1196375745812.0, 0.01)
SMALL_MESH = {"DRYRUN_DEVICES": "8", "DRYRUN_MESH": "4,2"}
#: the hillclimb cell ``launch.perf`` traces there, one process a variant
PERF_CELL = "xlstm"
#: PERF.md's hand counts (PR 17): the weight bytes a B=1 smollm-360m
#: decode step reads, and the bf16 products of a training step
HAND_DECODE_BYTES, HAND_TRAIN_FLOPS = 0.724e9, 27e12
PIPE_MICRO, PIPE_SEQ = 4, 64


def _pairs(a, b):
    """(leaf of a, leaf of b) at every path of the nested dict a."""
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k])
    else:
        yield a, b


def _train_inputs(cfg, seed: int):
    """Full-width params that require gradients and a phase-8-shaped
    batch (8 x 1024 tokens), on the card."""
    from repro_torch.bridge import init_params
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), "cuda")
    for t in _leaves(params):
        t.requires_grad_()
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab, (8, 1025), device="cuda",
                         generator=gen)
    return params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def compression_check(cfg) -> dict:
    """One full-width training step's gradients through
    ``compressed_psum_grads`` over NCCL at world size 1: the mean equals
    dequantize(quantize(g + r)) bit for bit and the residual g + r minus
    it exactly; the wall of one call over every gradient."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import compression as C
    params, batch = _train_inputs(cfg, SEED)
    T.loss_fn(cfg)(params, batch).backward()

    def take(tree):
        return {k: take(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else tree.grad
    grads = take(params)
    del params
    resid = _zero_like_f32(grads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, new_r = C.compressed_psum_grads(grads, resid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n, differ = 0, 0
    for (g, m), (_, r) in zip(_pairs(grads, mean), _pairs(grads, new_r)):
        q, scale = C._quantize(g.float())
        want = C._dequantize(q, scale)
        differ += not (torch.equal(m, want)
                       and torch.equal(r, g.float() - want))
        n += g.numel()
    if differ:
        raise AssertionError(f"compressed_psum_grads at world size 1 "
                             f"differs from dequantize(quantize(g)) in "
                             f"{differ} leaves")
    return {"n": n, "leaves": len(list(_leaves(grads))), "wall_s": wall}


def _zero_like_f32(tree):
    if isinstance(tree, dict):
        return {k: _zero_like_f32(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def pipeline_check(cfg, params) -> dict:
    """``pipeline_apply`` with one stage holding every layer of the stack
    against the stack run microbatch by microbatch: bit for bit."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel.pipeline import pipeline_apply
    blk = T._dense_block(cfg)

    def stack(stage, x):
        for lp in T._unstack(stage):
            x = blk(x, lp)
        return x

    def one_stage(tree):
        return {k: one_stage(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else tree[None]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    xs = torch.randn((PIPE_MICRO, 1, PIPE_SEQ, cfg.d_model), device="cuda",
                     generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        got = pipeline_apply(stack, one_stage(params["layers"]), xs)
        want = torch.stack([stack(params["layers"], x) for x in xs])
    if not torch.equal(got, want):
        raise AssertionError(f"pipeline_apply (one stage) differs from the "
                             f"stack: max |err| {max_err(got, want):.3g}")
    return {"shape": tuple(xs.shape)}


def counted_bounds(cfg) -> dict:
    """``roofline.analyze`` over a B=1 decode step at phase 5's shape and a
    training step at phase 8's, on the card; each kernel credited by its
    wrapper, as many launches as the step makes."""
    from repro_torch.bridge import init_params
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import OptConfig, opt_init
    from repro_torch.parallel import roofline as RL
    from repro_torch.train.trainer import make_train_step
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(SEED + 10)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab, SYS_LEN
                                           + SUFFIX_LEN)).cuda()[None]
    step = T.decode_fn(cfg)
    with torch.no_grad():
        _, cache = T.prefill_fn(cfg)(params, {"tokens": prompt},
                                     ROUTER_MAX_LEN)
        tok = prompt[:, -1]
        step(params, cache, tok)                     # warm
        torch.cuda.synchronize()
        decode = RL.analyze(step, params, cache, tok,
                            model_flops_total=2.0 * n_params, chips=1)
    del params, cache
    torch.cuda.empty_cache()
    params, batch = _train_inputs(cfg, SEED)
    opt_cfg = OptConfig()
    opt_state = opt_init(opt_cfg, params)
    train_step = make_train_step(cfg, opt_cfg)
    train_step(params, opt_state, batch)             # warm
    torch.cuda.synchronize()
    train = RL.analyze(train_step, params, opt_state, batch,
                       model_flops_total=6.0 * n_params * 8 * 1024, chips=1)
    del params, opt_state
    torch.cuda.empty_cache()
    want = {"decode": {"decode_attention": cfg.n_layers,
                       "rmsnorm": 2 * cfg.n_layers + 1},
            "train": {"rmsnorm": 4 * cfg.n_layers + 1,
                      "rmsnorm_bwd": 2 * cfg.n_layers + 1}}
    for name, rl in (("decode", decode), ("train", train)):
        got = {k: rl.kernels.get(k, {}).get("launches", 0)
               for k in want[name]}
        if got != want[name]:
            raise AssertionError(f"the {name} step's kernel credits {got}, "
                                 f"not {want[name]}")
        if not (rl.flops > 0 and rl.bytes_accessed > 0):
            raise AssertionError(f"the {name} step counted nothing")
    return {"decode": decode, "train": train}


def dryrun_cells() -> tuple[list[dict], list[dict], list[dict]]:
    """``python -m repro_torch.launch.dryrun`` on the fake 16 x 16 mesh for
    each of ``DRYRUN_CELLS``, on the fake 4 x 2 mesh for each of
    ``LENGTH_CELLS``' decode_32k at each of ``LENGTHS`` (``--seq-len``)
    and for ``VERSION_CELL``, and ``python -m repro_torch.launch.perf
    --cell PERF_CELL`` for each of
    its variants, as concurrent subprocesses on the host (no card): each
    exits 0, and writes ``ok`` rows; (dry-run rows, 4 x 2 rows, perf
    rows), each with its wall."""
    from repro_torch.launch.perf import CELLS
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    runs = [(f"{arch} {shape}", DRYRUN_OUT / f"{arch}.{shape}.jsonl",
             ["repro_torch.launch.dryrun", "--arch", arch, "--shape", shape],
             {}) for arch, shape in DRYRUN_CELLS]
    runs += [(f"{arch} decode_32k 4x2 S={n}",
              DRYRUN_OUT / f"{arch}.decode_32k.4x2.{n}.jsonl",
              ["repro_torch.launch.dryrun", "--arch", arch, "--shape",
               "decode_32k", "--seq-len", str(n)], SMALL_MESH)
             for arch in LENGTH_CELLS for n in LENGTHS]
    runs.append((f"{' '.join(VERSION_CELL)} 4x2",
                 DRYRUN_OUT / "{}.{}.4x2.jsonl".format(*VERSION_CELL),
                 ["repro_torch.launch.dryrun", "--arch", VERSION_CELL[0],
                  "--shape", VERSION_CELL[1]], SMALL_MESH))
    runs += [(f"perf {PERF_CELL}:{tag}",
              DRYRUN_OUT / f"perf.{PERF_CELL}.{tag}.jsonl",
              ["repro_torch.launch.perf", "--cell", PERF_CELL, "--variant",
               tag], {}) for tag, _ in CELLS[PERF_CELL]["variants"]]
    procs = []
    for what, out, argv, extra in runs:
        out.unlink(missing_ok=True)
        procs.append((what, out, extra, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", *argv, "--out", str(out)], cwd=ROOT,
            env=dict(env, **extra), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    rows = []
    try:
        for what, out, extra, t0, p in procs:
            stdout, stderr = p.communicate(timeout=600)
            wall = time.perf_counter() - t0
            if p.returncode != 0 or not out.exists():
                raise AssertionError(f"{what} exited {p.returncode}:\n"
                                     f"{stderr[-3000:]}")
            row = json.loads(out.read_text().splitlines()[-1])
            if row["status"] != "ok" or row["chips"] != (8 if extra else 256):
                raise AssertionError(f"{what}: {row}")
            if what.startswith("perf") and "roofline_fused" not in row:
                raise AssertionError(f"{what}: no fused-credit roofline")
            rows.append(dict(row, wall_s=wall))
    finally:
        for _, _, _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return ([r for r in rows if "variant" not in r and r["chips"] == 256],
            [r for r in rows if r["chips"] == 8],
            [r for r in rows if "variant" in r])


def length_check(rows: list[dict]) -> dict:
    """Each of ``LENGTH_CELLS``' rank 0 collective bytes on 4 x 2, by
    cache length; the lengths must give equal bytes."""
    got = {arch: {r["seq_len"]: r["roofline"]["collective_bytes_per_chip"]
                  for r in rows
                  if r["arch"] == arch and r["shape"] == "decode_32k"}
           for arch in LENGTH_CELLS}
    for arch, by_len in got.items():
        if sorted(by_len) != sorted(LENGTHS) or len(set(by_len.values())) != 1:
            raise AssertionError(f"{arch} decode on 4 x 2: collective bytes "
                                 f"by cache length {by_len} differ")
    return got


def version_check(rows: list[dict]) -> dict:
    """``VERSION_CELL``'s row on 4 x 2: its collective bytes on this host's
    torch within ``VERSION_TOL`` of ``VERSION_BYTES``."""
    row = next(r for r in rows
               if (r["arch"], r["shape"]) == VERSION_CELL)
    got = row["roofline"]["collective_bytes_per_chip"]
    if abs(got / VERSION_BYTES - 1) > VERSION_TOL:
        raise AssertionError(
            f"{' '.join(VERSION_CELL)} on 4 x 2: {got:.6e} collective bytes "
            f"on torch {torch.__version__}, {VERSION_BYTES:.6e} on torch "
            f"2.13: more than {VERSION_TOL:.0%} apart")
    return row


def parallel_phase(smi: str, measured: dict) -> dict:
    """Phase 10: compression and the one-stage pipeline over NCCL at world
    size 1, the counted bounds of two full-width steps beside the hand
    counts and the measured device time, and the dry-run CLI."""
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.configs.registry import get_arch
    t00 = time.perf_counter()
    mc = get_arch("smollm-360m")
    log(f"phase 10: parallel/ on torch.distributed and the counted bounds "
        f"({smi})")
    PARALLEL_STORE.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(PARALLEL_STORE), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", 0))
    try:
        kernels.reset_launch_counts()
        comp = compression_check(mc)
        from repro_torch.bridge import init_params
        params = init_params(mc, torch.Generator(device="cuda").manual_seed(
            SEED), "cuda")
        pipe = pipeline_check(mc, params)
        del params
        torch.cuda.empty_cache()
        bounds = counted_bounds(mc)
        counts = kernels.launch_counts()
    finally:
        dist.destroy_process_group()
        PARALLEL_STORE.unlink(missing_ok=True)
    for name in ("decode_attention", "rmsnorm", "rmsnorm_bwd"):
        if counts[name] == 0:
            raise AssertionError(f"phase 10 never launched {name}")
    log(f"  (a) NCCL, world size 1: compressed_psum_grads over one "
        f"full-width training step's {comp['n'] / 1e6:.1f} M gradients "
        f"({comp['leaves']} leaves): mean == dequantize(quantize(g + r)) "
        f"and the residual exact, bit for bit; one call "
        f"{1e3 * comp['wall_s']:.3f} ms wall")
    log(f"      pipeline_apply, one stage holding all {mc.n_layers} layers, "
        f"{PIPE_MICRO} microbatches {pipe['shape'][1:]}: equal to the stack "
        f"bit for bit")
    hand = {"decode": (None, HAND_DECODE_BYTES), "train": (HAND_TRAIN_FLOPS,
                                                           None)}
    for name, rl in bounds.items():
        hf, hb = hand[name]
        busy = measured.get(name)
        log(f"  (b) {name} step (smollm-360m, full width"
            + (", B=1, a 38-token prompt in a 64-position cache)"
               if name == "decode" else ", 8 x 1024 tokens, remat on, "
               "AdamW)")
            + f": counted {rl.flops / 1e12:.6f} TFLOP (dot), "
            f"{rl.bytes_accessed / 1e9:.6f} GB; t_compute "
            f"{1e3 * rl.t_compute:.6f} ms, t_memory "
            f"{1e3 * rl.t_memory:.6f} ms (bound {1e3 * rl.step_time:.6f} "
            f"ms, {rl.bottleneck})")
        log(f"      hand count (PERF.md): "
            + (f"{hf / 1e12:.0f} TFLOP, {hf / H100_BF16_FLOPS * 1e3:.3f} ms"
               if hf else f"{hb / 1e9:.3f} GB, "
               f"{hb / HBM_BYTES_PER_S * 1e3:.3f} ms")
            + "; measured device busy this run "
            + ("not measured" if busy is None else f"{busy:.3f} ms"))
        log(f"      kernel credits: " + ", ".join(
            f"{k} {v['launches']} launches, {v['bytes'] / 1e6:.3f} MB, "
            f"{v['flops'] / 1e9:.4f} GFLOP" for k, v in
            sorted(rl.kernels.items())))
    t0 = time.perf_counter()
    rows, small, perf = dryrun_cells()
    log(f"  (c) python -m repro_torch.launch.dryrun and launch.perf --cell "
        f"{PERF_CELL} on the fake 16 x 16 mesh, and the decode length "
        f"check on 4 x 2 (host only, torch {torch.__version__}, "
        f"{len(rows) + len(small) + len(perf)} concurrent processes, "
        f"{time.perf_counter() - t0:.1f} s):")
    lengths = length_check(small)
    for arch, by_len in lengths.items():
        log(f"      {arch} decode on the fake 4 x 2 mesh, rank 0's "
            f"collective bytes by cache length: " + ", ".join(
                f"S={n} {b:.6e}" for n, b in sorted(by_len.items()))
            + " (equal)")
    vrow = version_check(small)
    rl = vrow["roofline"]
    log(f"      {' '.join(VERSION_CELL)} on the fake 4 x 2 mesh: rank 0's "
        f"collective bytes {rl['collective_bytes_per_chip']:.6e} on torch "
        f"{torch.__version__} against {VERSION_BYTES:.6e} on torch 2.13 "
        f"({rl['collective_bytes_per_chip'] / VERSION_BYTES - 1:+.4%}, "
        f"within {VERSION_TOL:.0%}); {rl['flops_per_chip']:.6e} FLOP; "
        f"{rl['collectives']} in {rl['collective_counts']}; ok in "
        f"{vrow['wall_s']:.1f} s")
    for r in sorted((r for r in small if r is not vrow),
                    key=lambda r: (r["arch"], r["seq_len"])):
        rl = r["roofline"]
        log(f"      {r['arch']} decode 4 x 2 S={r['seq_len']}: "
            f"{rl['flops_per_chip']:.6e} FLOP, {rl['bytes_per_chip']:.6e} "
            f"B, collectives {rl['collective_bytes_per_chip']:.6e} B in "
            f"{sum(rl['collective_counts'].values()):.0f} "
            f"({rl['collectives']}); ok in {r['wall_s']:.1f} s")
    for r in rows + perf:
        rl = r["roofline"]
        what = (f"perf {r['cell']}:{r['variant']} ({r['arch']} "
                f"{r['shape']})" if "variant" in r
                else f"{r['arch']} {r['shape']}")
        log(f"      {what}: ok in {r['wall_s']:.1f} s (trace {r['trace_s']} "
            f"s, units {r['traced_units']}"
            + (f", scan trips {r['traced_trips']}" if "traced_trips" in r
               else "")
            + f"); per rank {rl['flops_per_chip'] / 1e12:.4f} TFLOP, "
            f"{rl['bytes_per_chip'] / 1e9:.3f} GB, collectives "
            f"{rl['collective_bytes_per_chip'] / 1e9:.3f} GB; t_compute "
            f"{1e3 * rl['t_compute_s']:.3f} ms, t_memory "
            f"{1e3 * rl['t_memory_s']:.3f} ms, t_collective "
            f"{1e3 * rl['t_collective_s']:.3f} ms ({rl['bottleneck']})"
            + (f", fused t_memory "
               f"{1e3 * r['roofline_fused']['t_memory_s']:.3f} ms"
               if "roofline_fused" in r else "")
            + f"; memory {r['memory']}")
    ladder = sorted(perf, key=lambda r: -r["roofline"]["bytes_per_chip"])
    log(f"      perf {PERF_CELL} ladder by bytes a rank, most first: "
        + " > ".join(r["variant"] for r in ladder))
    log(f"    main-path kernel launches: {counts}")
    log(f"  phase 10 took {time.perf_counter() - t00:.1f} s")
    return {"counts": counts, "bounds": bounds, "dryrun": rows,
            "lengths": lengths, "perf": perf, "compression": comp}


# ---------------------------------------------------------------------------
# phase 11: the port's examples on the card
# ---------------------------------------------------------------------------

EXAMPLE_SERVE_REQUESTS = 80        # serve_smse's default
EXAMPLE_TRAIN_DIR = ROOT / "build" / "example_train_100m"
EXAMPLE_TRAIN_STEPS = 20
EXAMPLE_TRAIN_LAYERS = 12          # train_100m --full-width's depth


def run_example(name: str, *argv: str) -> tuple[str, float, dict]:
    """``python -m repro_torch.examples.<name> *argv`` on the card (its
    default device): (stdout, wall, the kernel launches it printed)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m",
                          f"repro_torch.examples.{name}", *argv],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"examples.{name} exited {res.returncode}:\n"
                             f"{res.stderr[-3000:]}")
    m = re.search(r"^kernel launches\s+(\{.*\})$", res.stdout, re.M)
    if m is None:
        raise AssertionError(f"examples.{name} printed no kernel launches:"
                             f"\n{res.stdout[-2000:]}")
    return res.stdout, wall, json.loads(m.group(1))


def examples_phase(smi: str) -> dict:
    """Phase 11: ``serve_smse`` (``EXAMPLE_SERVE_REQUESTS``, 2 planes) and
    ``train_100m --full-width`` for ``EXAMPLE_TRAIN_STEPS`` steps, each a
    subprocess on the card, each reading its own kernel launches (zeroed
    just before its run)."""
    log(f"phase 11: the port's examples on the card ({smi})")
    out, serve_wall, serve = run_example("serve_smse", "--requests",
                                         str(EXAMPLE_SERVE_REQUESTS))
    field = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^(submitted|requests|completed|dropped \(pruned\))\s+(\d+)", out,
        re.M)}
    n = EXAMPLE_SERVE_REQUESTS
    if field.get("submitted") != n or field.get("requests") != n \
            or field["completed"] + field["dropped (pruned)"] != n \
            or not field["completed"]:
        raise AssertionError(f"serve_smse submitted {n} requests and "
                             f"accounted for {field}")
    for name in ("decode_attention", "rmsnorm"):
        if serve[name] == 0:
            raise AssertionError(f"serve_smse never launched {name}")
    if serve["pmf_conv"] or serve["paged_decode_attention"]:
        raise AssertionError(f"serve_smse's queue-policy, one-at-a-time "
                             f"path launched {serve}")
    log(f"  python -m repro_torch.examples.serve_smse: {n} requests "
        f"submitted, {field['requests']} accounted for, completed "
        f"{field['completed']}, dropped {field['dropped (pruned)']}, in "
        f"{serve_wall:.1f} s (process and planes set-up included); kernel "
        f"launches {serve}")
    shutil.rmtree(EXAMPLE_TRAIN_DIR, ignore_errors=True)
    try:
        out, wall, train = run_example(
            "train_100m", "--full-width", "--steps",
            str(EXAMPLE_TRAIN_STEPS), "--ckpt-dir", str(EXAMPLE_TRAIN_DIR))
    finally:
        shutil.rmtree(EXAMPLE_TRAIN_DIR, ignore_errors=True)
    steps = [(int(a), float(b), float(c)) for a, b, c in re.findall(
        r"^step\s+(\d+)\s+loss (\S+)\s+lr \S+\s+(\d+) ms$", out, re.M)]
    losses = [x for _, x, _ in steps]
    if not (len(losses) >= 2 and all(np.isfinite(losses))
            and losses[-1] < losses[0]):
        raise AssertionError(f"train_100m's losses {losses}: not finite "
                             f"or not falling")
    want = EXAMPLE_TRAIN_STEPS * (2 * EXAMPLE_TRAIN_LAYERS + 1)
    if train["rmsnorm"] != want or train["rmsnorm_bwd"] != want:
        raise AssertionError(f"train_100m launched {train}: not {want} "
                             f"rmsnorm and rmsnorm_bwd")
    log(f"  python -m repro_torch.examples.train_100m --full-width "
        f"--steps {EXAMPLE_TRAIN_STEPS} (12 layers of smollm-360m, 8 x 512 "
        f"tokens): loss " + ", ".join(f"step {i} {x:.4f}" for i, x, _ in
                                      steps)
        + f"; step walls (ms) " + ", ".join(f"{d:.0f}" for _, _, d in steps)
        + f"; {wall:.1f} s in all; kernel launches {train}")
    log("    " + beside_record({i: x for i, x, _ in steps},
                              RECORDED_EXAMPLE_LOSSES))
    return {"serve": {"wall_s": serve_wall, "counts": serve, **field},
            "train": {"wall_s": wall, "losses": losses, "counts": train},
            "counts": {k: serve[k] + train[k] for k in serve}}


def decode_step_profile(mc, params, n_steps: int = 10,
                        paged: bool = True) -> dict:
    """Device busy time of steady decode steps at the smoke's shapes: the
    wall per step with the profiler off, and the summed kernel time per
    step from a second window under ``torch.profiler``, over the steps
    the session kept whole (``profiled_calls``: ``kept`` of ``steps``).
    ``paged``: the batched step (B=8, a 1024-token page table, 38-47 keys
    a sequence); else the one-at-a-time path's contiguous step (B=1, a
    ``max_len`` = 64 cache, 38 keys)."""
    from repro_torch.models import transformer as T
    n0 = SYS_LEN + SUFFIX_LEN
    if paged:
        ps, mp, b = 16, 64, 8
        pages = T.init_paged_cache(mc, b * mp + 1, ps, "cuda")
        tabs = (torch.arange(b * mp, device="cuda", dtype=torch.int32) + 1) \
            .reshape(b, mp)
        lens = torch.full((b,), n0, dtype=torch.int32, device="cuda")
        toks = torch.zeros((b,), dtype=torch.long, device="cuda")
        step = T.paged_decode_fn(mc)

        def one(i):
            step(params, pages["kp"], pages["vp"], tabs, lens + i, toks)
    else:
        cache = T.init_cache(mc, 1, ROUTER_MAX_LEN, "cuda")
        toks = torch.zeros((1,), dtype=torch.long, device="cuda")
        step = T.decode_fn(mc)

        def one(i):
            cache["len"].fill_(n0 + i % (ROUTER_MAX_LEN - n0))
            step(params, cache, toks)

    def run(n):
        for i in range(n):
            one(i)
        torch.cuda.synchronize()

    run(3)
    t0 = time.perf_counter()
    run(n_steps)
    wall = (time.perf_counter() - t0) / n_steps     # profiler off
    mark = torch.zeros((1,), dtype=torch.int16, device="cuda")
    calls, _ = profiled_calls(one, n_steps, mark)
    per_kernel = per_call_ms(calls)
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    attn = sum(ms for name, ms in per_kernel.items()
               if "decode_kernel" in name)
    return {"wall_ms": 1e3 * wall, "busy_ms": busy or None, "top": top,
            "attention_ms": attn, "kept": len(calls), "steps": n_steps}


def log_profile(prof: dict, what: str, n_layers: int) -> None:
    if prof["busy_ms"] is None:
        log(f"  {what} device time: not measured (the profiler recorded "
            f"no device events)")
        return
    log(f"  {what}: wall {prof['wall_ms']:.3f} ms, device busy "
        f"{prof['busy_ms']:.3f} ms (torch.profiler), idle share "
        f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f} ({prof['kept']} of "
        f"{prof['steps']} profiled steps kept whole); attention kernel "
        f"{prof['attention_ms']:.4f} ms/step = "
        f"{1e3 * prof['attention_ms'] / n_layers:.2f} us/launch")
    for name, ms in prof["top"]:
        log(f"    {ms:8.4f} ms/step  {name[:90]}")


def log_ptxas(text: str) -> None:
    """Each kernel's registers, static shared memory, stack frame and
    spills from the build's ``-Xptxas -v`` report, under its name and
    template arguments."""
    name = "?"
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)", line)
        if entry:
            m = re.search(r"(paged_decode_kernel|decode_kernel|"
                          r"pmf_conv_kernel|rmsnorm_kernel|empty_kernel)"
                          r"(I(?:13__nv_bfloat16|f)?(?:Li\d+E)+E)?",
                          entry.group(1))
            name = m.group(1) if m else entry.group(1)
            if m and m.group(2):
                args = re.findall(r"Li(\d+)E", m.group(2))
                if "__nv_bfloat16" in m.group(2):
                    args.insert(0, "bf16")
                elif m.group(2).startswith("If"):
                    args.insert(0, "f32")
                name += "<" + ", ".join(args) + ">"
        elif "Used" in line:
            log(f"  ptxas: {name}: {line.split(':', 1)[1].strip()}")
        elif "spill" in line:
            log(f"  ptxas: {name}: {line.strip()}")


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

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    library()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s")
    log_ptxas((BUILD_DIR / "ptxas.log").read_text())

    mc = get_arch("smollm-360m")
    t0 = time.perf_counter()
    rows = [check_decode_attention(mc, ROUTER_MAX_LEN),
            check_paged_attention(mc, 1024, 8, 16),
            check_rmsnorm(mc, 8, 64), check_pmf_conv(),
            check_chunk_attention(mc), check_chunk_attention_mla(),
            check_paged_mla()]
    fa = check_family_attention(ROUTER_MAX_LEN)
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"], fa["max_abs_err"])
    log(f"phase 2: kernels agree with their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"  decode_attention at every family's (G, Hkv, hd), B 1 and 8: "
        f"{', '.join(fa['shapes'])}; max|err| vs bf16 plain "
        f"{fa['max_abs_err']:.3g}, vs f32 plain and split model "
        f"{fa['max_abs_err_f32']:.3g}")
    for r in rows:
        log(f"  {r['name']:24s} {r['shape']}: {cold_and_warm(r)}; "
            f"back-to-back wall a call {r['wall']}; "
            f"max|err| {r['max_abs_err']:.3g}"
            + (f" ({r['err_share']:.3g} of its bound)" if "err_share" in r
               else ""))
    w = rows[0]
    log(f"  decode_attention windowed (B=1, {w['window_keys']} of "
        f"{WINDOW_TIMED_KEYS} keys): " + cold_and_warm(
            {"name": "decode_attention windowed",
             **{k[7:]: v for k, v in w.items() if k.startswith("window_")}},
            "sdpa with the mask")
        + f"; back-to-back wall a call {w['window_wall_ms']:.5f} ms")
    fl = launch_floor()
    log(f"  launch floor (empty kernel, ctypes): device {fl['ms']:.5f} ms, "
        f"back-to-back wall {fl['wall_ms']:.5f} ms a call")

    t0 = time.perf_counter()
    params = init_params(mc, torch.Generator(device="cuda").manual_seed(SEED),
                         "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"phase 3: batched path, smollm-360m at full width, "
        f"{n_params / 1e6:.1f} M parameters, random init in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res = serve(mc, params)
    log(f"  served {N_REQ} requests in {time.perf_counter() - t0:.1f} s "
        f"(both runs, engine set-up included)")
    small = check_small_input(mc, params)
    log(f"  small input vs CPU plain versions: max |logit err| "
        f"{small['max_abs_err']:.4g} (logit scale {small['logit_scale']:.3g})")

    log_profile(decode_step_profile(mc, params), "decode step (B=8)",
                mc.n_layers)

    t0 = time.perf_counter()
    rr = serve_router(mc, params)
    log(f"phase 4: one-at-a-time path, 2-plane Router, {ROUTER_REQ} "
        f"requests, prefix cache on then off, in "
        f"{time.perf_counter() - t0:.1f} s (plane set-up included)")
    small_c = check_small_input(mc, params, paged=False)
    log(f"  small input vs CPU plain versions (contiguous decode): max "
        f"|logit err| {small_c['max_abs_err']:.4g} (logit scale "
        f"{small_c['logit_scale']:.3g})")
    log_profile(decode_step_profile(mc, params, paged=False),
                "decode step (B=1, contiguous cache)", mc.n_layers)

    t0 = time.perf_counter()
    wr = serve_windowed(mc, params)
    log(f"phase 4b: sliding window {WINDOW_MODEL}, smollm-360m at full "
        f"width, a {WINDOW_PROMPT}-token prompt and {wr['steps']} greedy "
        f"decode steps in {time.perf_counter() - t0:.1f} s (with the plain "
        f"twin): decode_attention {wr['launches_a_step']} launches a step, "
        f"median step {wr['median_step_ms']:.3f} ms; step-1 logits vs the "
        f"plain twin max |err| {wr['max_abs_err']:.4g} (limit "
        f"{wr['tol']:.4g}); greedy tokens "
        + (f"equal at all {wr['picks']} picks" if wr["parted"] is None else
           f"equal at the first {wr['parted']} of {wr['picks']} picks, "
           f"then parted at a near tie (top-2 margin {wr['margin']:.4g})"))
    log(f"  main-path kernel launches: {wr['counts']}")

    t0 = time.perf_counter()
    sc = scaler_phase()
    card, host, pc = sc["card"], sc["host"], sc["router"]
    log(f"phase 4c: the scalers' success-chance signal on the caller's "
        f"device, in {time.perf_counter() - t0:.1f} s ({smi})")
    log(f"  (a) cross-substrate trace, success-chance: simulator == stub "
        f"engine on the card and on the host, card == host; (scale-ups, "
        f"scale-downs, on time, missed, dropped, machine-seconds) "
        f"{card['scale']}, {card['decisions']} decisions; pmf_conv "
        f"launches on the card: simulator {card['sim_counts']['pmf_conv']},"
        f" stub engine {card['engine_counts']['pmf_conv']} (= the host "
        f"runs' scored decisions {host['sim_scored']}, "
        f"{host['engine_scored']}; 0 launches on the host); simulator wall "
        f"card {card['sim_wall_s']:.3f} s, host {host['sim_wall_s']:.3f} s"
        f"; scaler device {card['scaler_device']} / "
        f"{host['scaler_device']}")
    log(f"  (b) stub-plane Router on the card: {pc['auto']}; pmf_conv "
        f"launches {pc['counts']['pmf_conv']} (= scored planes on the host "
        f"{sc['router_host']['scored']}); completed {pc['completed']}, "
        f"dropped {pc['dropped']}; wall {pc['wall_s']:.3f} s (host "
        f"{sc['router_host']['wall_s']:.3f} s); plane scaler device "
        f"{pc['scaler_device']}")
    log(f"  (c) the same Router on 'cpu': pmf_conv launches "
        f"{sc['router_host']['counts']['pmf_conv']}, its "
        f"{len(pc['decisions'])} routing decisions and plane accounting "
        f"equal the card's")
    log(f"  (d) python -m repro_torch.launch.serve "
        f"{' '.join(SCALER_LAUNCHER_ARGV)} exited 0 in "
        f"{sc['launcher_wall_s']:.1f} s: completed "
        f"{sc['launcher_completed']}, dropped {sc['launcher_dropped']}, "
        f"router.autoscale {sc['launcher']}")
    log(f"  main-path kernel launches (a) and (b) on the card: "
        f"{sc['counts']}")

    hp = handoff_phase(mc, params, smi)

    # the smollm weights make way for the full-width families, and come
    # back (the same seed) for the calibration row
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fam = family_phase(smi)
    log(f"  phase 5 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ds = dsv2_phase(smi)
    log(f"  phase 5b took {time.perf_counter() - t0:.1f} s")
    params = init_params(mc, torch.Generator(device="cuda").manual_seed(SEED),
                         "cuda")

    t0 = time.perf_counter()
    lr = run_launcher()
    log(f"phase 6: python -m repro_torch.launch.serve exited 0 in "
        f"{lr['wall_s']:.1f} s: completed {lr['completed']} of "
        f"{lr['n_requests']}, dropped {lr['dropped']}")

    from repro_torch.obs import load_record
    t0 = time.perf_counter()
    log(f"phase 7: record -> fit -> replay ({smi})")
    log_calibration("launcher record (--record-out, schema valid)",
                    fit_and_replay(load_record(str(LAUNCHER_RECORD))))
    cal = calibration_row(mc, params, "cuda")
    for name in ROUTER_KERNELS:
        if cal["counts"][name] == 0:
            raise AssertionError(f"the calibration row never launched {name}")
    log_calibration(f"live row, smollm-360m at full width, {CAL_REQ} "
                    f"requests ({CAL_PLEN}-token prompts, {CAL_NEW} new "
                    f"tokens, mean gap {CAL_GAP:g} ticks), served in "
                    f"{cal['wall_s']:.1f} s", cal)
    log(f"    main-path kernel launches: {cal['counts']}")
    for c in control_replay():
        log(f"  control replay {c['name']}: {c['decisions']} decisions "
            f"matched exactly, 0.0 drift (completed {c['completed']}, "
            f"dropped {c['dropped']})")
    pr = predictor_phase("cuda")
    log(f"  predictor (n_train 5000, n_test 1200): accuracy at tau 0.12 "
        + ", ".join(f"{k} {v:.2f}%" for k, v in pr["accuracy"].items()))
    log("    checks (reported): " + ", ".join(
        f"{k} {'PASS' if v else 'FAIL'}" for k, v in pr["checks"].items()))
    log(f"    MLP trained on the card vs on the host from the same initial "
        f"parameters: max |prediction diff| {pr['mlp_max_diff']:.3g} (limit "
        f"{MLP_CARD_ATOL})")
    log(f"    MLP fit (500 steps) wall: card {pr['mlp_fit_s']['cuda']:.3f} s,"
        f" host CPU {pr['mlp_fit_s']['cpu']:.3f} s; GBDT fit (host) "
        f"{pr['gbdt_fit_s']:.2f} s")
    log(f"  phase 7 took {time.perf_counter() - t0:.1f} s")

    # the serving weights make way for the training state
    del params
    gc.collect()
    torch.cuda.empty_cache()
    train = train_phase(smi)
    rows.append(train["row"])
    smollm = next(r for r in fam["rows"] if r["arch"] == "smollm-360m")
    par = parallel_phase(smi, {"decode": smollm["profile"]["busy_ms"],
                               "train": train["full"]["busy_ms"]})
    t0 = time.perf_counter()
    ex = examples_phase(smi)
    log(f"  phase 11 took {time.perf_counter() - t0:.1f} s")

    st = res["stats"]
    log(f"phase 9 ({smi}):")
    log("  batched path:")
    log(f"  completed {res['completed']}, dropped {res['dropped']}, "
        f"batched == one at a time on {res['compared']} requests")
    log(f"  prefix hits: batched {res['prefix_hits_batched']}, one at a "
        f"time {res['prefix_hits_sequential']}; scale-ups "
        f"{st['scale_ups']}, merges {st['merges']}")
    log(f"  tokens/s {res['tokens_per_s']:.2f} ({res['tokens']} tokens in "
        f"{res['wall_s']:.3f} s wall, batched run)")
    log(f"  {res['decode_steps']} decode steps (batched run)")
    log(f"  main-path kernel launches: {res['counts']}")
    for name, s in sorted(res["profile"].items()):
        log(f"  profiler (one at a time) {name:24s} launches "
            f"{s['launches']:5d} execute {1e3 * s['execute_s']:.2f} ms "
            f"dispatch {1e3 * s['dispatch_s']:.2f} ms")
    log(f"  one-at-a-time path: completed {rr['completed']} of "
        f"{ROUTER_REQ} ({rr['greedy']} greedy, every one done), dropped "
        f"{rr['dropped']}; greedy tokens equal with the prefix cache on "
        f"and off")
    log(f"  prefix hits {rr['prefix_hits']} ({rr['prefix_tokens_reused']} "
        f"tokens reused), merges {rr['merges']}, scale-ups "
        f"{rr['scale_ups']}, routed {rr['routed']}, affinity hits "
        f"{rr['affinity_hits']}")
    log(f"  tokens/s {rr['tokens_per_s']:.2f} ({rr['tokens']} tokens in "
        f"{rr['wall_s']:.3f} s wall, prefix cache on)")
    log(f"  median decode step {rr['median_decode_step_ms']:.3f} ms over "
        f"{rr['decode_calls']} decode_fn calls; decode_attention launches "
        f"{rr['counts']['decode_attention']} = {mc.n_layers} x "
        f"{rr['decode_calls']}; chunk_attention launches "
        f"{rr['counts']['chunk_attention']} = {mc.n_layers} x "
        f"{rr['prefills']} prefills")
    log(f"  main-path kernel launches: {rr['counts']}")
    ho, se = hp["handoff"], hp["sessions"]
    log(f"  handoff (phase 4d (a)): {ho['handoffs']} handoffs, greedy "
        f"tokens equal to the unified run on {N_REQ} requests, decode "
        f"unit's {ho['decode_steps']} decode steps; "
        f"sessions (b): hit rate {se['hit_rate']:.4f} against "
        f"{se['single_hit_rate']:.4f}, cache-off tokens equal on "
        f"{se['turns']} turns; phase 4d {hp['wall_s']:.1f} s, launches "
        f"{hp['counts']}")
    moe = fam["moe"]
    log(f"  {MOE_ARCH} behind the Router: completed {moe['completed']} of "
        f"{FAMILY_REQ}, tokens/s {moe['tokens_per_s']:.2f}, median decode "
        f"step {moe['median_decode_step_ms']:.3f} ms, peak memory "
        f"{fam['peak'] / 2 ** 30:.3f} GiB; launches {moe['counts']}")
    log(f"  {DSV2_CELL}'s model through the batched Router (phase 5b): "
        f"{ds['chunks']} chunks, {ds['decode_steps']} decode steps, "
        f"tokens/s {ds['tokens_per_s']:.2f}, logit gaps {ds['gaps']} (limit "
        f"{ds['limit']}), peak memory {ds['peak'] / 2 ** 30:.3f} GiB; "
        f"launches {ds['counts']}")
    phases = (res["counts"], rr["counts"], wr["counts"], sc["counts"],
              hp["counts"], moe["counts"], cal["counts"],
              train["full"]["counts"], par["counts"], ex["counts"])
    for r in rows:
        if r.pop("counter", None):
            # the chunk kernel's latent instance: phase 5b's chunks
            r["launches"] = ds["counts"]["chunk_attention"]
        else:
            r["launches"] = sum(c[r["name"]] for c in phases) + (
                0 if r["name"] == "chunk_attention"
                else ds["counts"][r["name"]])
        r.pop("shape")
        r["wall_ms"] = r.pop("wall")["ms"]
        r["warm_ms"] = r.pop("warm")["ms"]
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
