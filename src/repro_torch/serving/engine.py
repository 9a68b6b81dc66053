"""SMSE — Serverless Model Serving Engine (dissertation Ch. 6, adapted),
PyTorch/CUDA port of ``repro.serving.engine``.

The media-processing engine's architecture mapped onto LM inference
(DESIGN.md §2): request ingestion, a result cache (the paper's "stream
cachine"), real PyTorch model steps on processing units (the port's
Hopper kernels on the card), a
roofline-calibrated time estimator, and an elasticity manager.  Everything
*scheduling* — admission control (similarity detection + merge
appropriateness + position finding), the batch queue, the pluggable mapping
heuristic, probabilistic pruning, and the event-driven clock — lives in the
unified control plane (``core.controlplane``) shared verbatim with the
discrete-event simulator; the engine is the control plane's live-execution
substrate.

Execution model: processing units are logical workers with independent
timelines (the thesis's *emulation mode*): model steps run for real and are
timed; unit clocks advance by the measured durations, so an 8-unit engine
behaves like 8 parallel units even on one device.  Cold-starting a unit
costs its measured warm-up time — the serverless cold-start analogue.
The engine clock is event-driven: it jumps from arrival to completion to
warm-up boundary with no fixed-tick polling, so sparse/bursty traces cost
O(events), not O(idle ticks).

Request ops:
  * ``generate``: prefill + n new tokens (greedy/temperature per request)
  * ``score``:    prefill, return last-token logprobs

Merge levels (Section 4.2 mapped):
  * TASK      — identical (prompt, op, params): one execution, fanned out
  * DATA_OP   — same prompt+op, different params: shared prefill, batched
                decode with per-request sampling
  * DATA_ONLY — same prompt: shared prefill cache across ops
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..core.controlplane import ControlConfig, ControlPlane, Substrate
from ..core.fleet import DEFAULT_MTYPE, FleetSpec, MachineSpec
from ..core.pmf import PMF
from ..core.pruning import PruningConfig
from ..core.tasks import Machine, Task
from ..device import resolve_device
from ..models import transformer as T
from ..obs.profiling import profiled
from .autoscale import ElasticityConfig, PoolScaler
from .batching import (SeqState, StepBatchingConfig, UnitBatch, step_cost,
                       task_dims)
from .kvcache import (CombinedPrefixIndex, PrefixKVCache, TransferCostModel,
                      migrate)


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (where the JAX engine calls
    ``jax.block_until_ready``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

@dataclass
class Request:
    prompt: tuple                  # token ids
    op: str = "generate"           # generate | score
    n_new: int = 8
    temperature: float = 0.0
    seed: int = 0
    deadline: float = float("inf")  # engine ticks (10 ms units)
    rid: int = 0
    # workload identity (serving.workload) — defaults mean open-loop -------
    tenant: str | None = None      # SLO tier name (obs label via Task)
    session: int | None = None     # closed-loop session / DAG uid
    turn: int = 0                  # conversation turn / DAG stage ordinal
    priority: int = 0              # tenant priority tie-break
    # results ---------------------------------------------------------------
    tokens: list = field(default_factory=list)
    logprobs: float | None = None
    status: str = "queued"
    completed_at: float | None = None

    @property
    def params_sig(self) -> tuple:
        # greedy decoding ignores the sampling seed: normalize it out so
        # identical greedy requests hit the result cache and TASK-level
        # merging instead of being split by an irrelevant parameter
        seed = self.seed if self.temperature > 0.0 else 0
        return (self.n_new, round(self.temperature, 4), seed)

    def to_task(self, arrival: float, ordinal: int) -> Task:
        """The scheduling-core view of this request — the single source of
        the similarity-key scheme, shared by engine admission, the front
        door's routing probes, and simulator-plane adaptation."""
        return Task(ttype=self.op, data_id=str(hash(self.prompt)),
                    op=self.op, params=self.params_sig, arrival=arrival,
                    deadline=self.deadline, user=f"u{ordinal % 8}",
                    priority=self.priority, tokens=self.prompt,
                    tenant=self.tenant, session=self.session, turn=self.turn)


# ---------------------------------------------------------------------------
# time estimator (roofline-calibrated, then EWMA-corrected)
# ---------------------------------------------------------------------------

class TimeEstimator:
    """mean/std execution-time estimates per (op, len-bucket, batch)."""

    def __init__(self, rel_std: float = 0.15):
        self.rel_std = rel_std
        self._ewma: dict = {}
        # cold per-token rates in ticks: prefill and decode priced
        # *separately* (a chunked prefill is linear in prompt tokens; decode
        # steps carry their own per-token rate — the old formula conflated
        # them into one blob).  Defaults reproduce the historical
        # "~5 ticks per 64 prompt tokens, 4x per decoded token" exactly;
        # ``calibrate`` replaces them with measured step-executable rates.
        self.prefill_rate = 5.0 / 64.0
        self.decode_rate = 20.0 / 64.0

    def calibrate(self, prefill_rate: float, decode_rate: float) -> None:
        """Pin the cold-estimate rates to measured per-token step costs
        (ticks/token at speed 1), from a unit's compiled step executables."""
        self.prefill_rate = max(prefill_rate, 1e-6)
        self.decode_rate = max(decode_rate, 1e-6)

    @staticmethod
    def _bucket(n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return b

    def key(self, op: str, prompt_len: int, n_new: int, batch: int):
        return (op, self._bucket(prompt_len), self._bucket(max(n_new, 1)),
                batch)

    def observe(self, key, dt: float):
        mu = self._ewma.get(key)
        self._ewma[key] = dt if mu is None else 0.7 * mu + 0.3 * dt

    def mean_std(self, op: str, prompt_len: int, n_new: int,
                 batch: int = 1) -> tuple[float, float]:
        key = self.key(op, prompt_len, n_new, batch)
        if key in self._ewma:
            mu = self._ewma[key]
        else:
            # nearest recorded bucket, scaled linearly in tokens
            candidates = [(k, v) for k, v in self._ewma.items()
                          if k[0] == op]
            if candidates:
                k0, v0 = candidates[0]
                mu = v0 * (self._bucket(prompt_len) + self._bucket(n_new)) \
                    / (k0[1] + k0[2])
            else:
                # cold estimate from the (possibly calibrated) per-token
                # rates: prompt tokens at the chunk-prefill rate plus decode
                # steps at the decode-step rate
                mu = prompt_len * self.prefill_rate + n_new * self.decode_rate
        return max(mu, 1.0), max(self.rel_std * mu, 0.5)

    def dump(self) -> dict:
        """JSON-safe snapshot of the learned state — calibrated per-token
        rates plus every EWMA cell.  Consumed by the flight recorder
        (``obs.recorder``) and restored by ``load`` for offline oracle
        fitting (``obs.fit``)."""
        return {"rel_std": self.rel_std,
                "prefill_rate": self.prefill_rate,
                "decode_rate": self.decode_rate,
                "ewma": [[op, bp, bn, batch, mu] for (op, bp, bn, batch), mu
                         in sorted(self._ewma.items())]}

    @classmethod
    def load(cls, blob: dict) -> "TimeEstimator":
        """Inverse of ``dump``: rebuild an estimator from a snapshot."""
        est = cls(rel_std=float(blob.get("rel_std", 0.15)))
        est.prefill_rate = float(blob.get("prefill_rate", est.prefill_rate))
        est.decode_rate = float(blob.get("decode_rate", est.decode_rate))
        for op, bp, bn, batch, mu in blob.get("ewma", []):
            est._ewma[(str(op), int(bp), int(bn), int(batch))] = float(mu)
        return est


# ---------------------------------------------------------------------------
# processing unit — real model steps, virtual timeline
# ---------------------------------------------------------------------------

class ProcessingUnit:
    COLD_START = None     # measured once, shared across units

    def __init__(self, uid: int, model_cfg, params, max_len: int = 256,
                 speed: float = 1.0, shared_fns=None,
                 spec: MachineSpec | None = None, device=None):
        self.uid = uid
        self.cfg = model_cfg
        self.params = params
        self.max_len = max_len
        self.device = resolve_device(device)
        # "emulated" runs the same model steps on a deliberately slow
        # virtual timeline (spec.speed < 1): the thesis's emulation mode
        # standing in for a slower accelerator in a mixed pool
        self.kind = ("emulated" if spec is not None
                     and spec.backend == "emulated" else "compiled")
        self.machine = (spec.build_machine(uid) if spec is not None
                        else Machine(mid=uid, mtype=DEFAULT_MTYPE,
                                     speed=speed, queue_size=4))
        if shared_fns is not None:
            # warm start: reuse the engine's step functions (the paper's
            # warm container)
            self._chunk, self._decode = shared_fns
        else:
            self._chunk = T.chunk_prefill_fn(model_cfg)
            self._decode = T.decode_fn(model_cfg)
        self.warm = False

    @property
    def fns(self):
        return (self._chunk, self._decode)

    def warmup(self, prompt_len: int = 16, buckets=(1,)) -> float:
        """Run prefill+decode once per batch bucket (the cold start: it
        builds the kernels and warms the allocator)."""
        t0 = time.perf_counter()
        for b in buckets:
            logits, cache = self._prefill(
                (0,) * min(prompt_len, self.max_len - 1), b)
            self._decode(self.params, cache,
                         torch.zeros((b,), dtype=torch.long,
                                     device=self.device))
            _sync(self.device)
        self.warm = True
        return time.perf_counter() - t0

    def _prefill(self, prompt, bucket: int, prefix=None):
        """Prefill ``bucket`` copies of ``prompt`` into a contiguous cache
        of ``max_len`` positions; returns (last-token logits, cache).

        ``prefix=(pk, pv)`` (L, P, Hkv, hd) holds the KV of the first P
        prompt tokens: only the rest is prefilled, attached to it.  Every
        prefill has one shape per unit, whatever P and the prompt length:
        the new tokens are padded to ``max_len`` rows (pad rows trail every
        real one, so the causal mask hides them from the real rows) and the
        attended keys to ``2 * max_len``.  On the card cuBLAS picks its
        kernel, and so its summation order, by shape; with one shape a
        prompt's tokens are the same whether or not its prefix came from
        the cache."""
        mc, dev, cap = self.cfg, self.device, self.max_len
        if prefix is None:
            pk = pv = torch.zeros((mc.n_layers, 0, mc.n_kv_heads,
                                   mc.resolved_head_dim), dtype=torch.bfloat16)
        else:
            pk, pv = prefix
        plen = pk.shape[1]
        n = len(prompt) - plen
        if n < 1 or plen + n > cap:
            raise ValueError(f"a prompt of {len(prompt)} tokens after a "
                             f"{plen}-token prefix does not fit max_len "
                             f"{cap}")
        toks = torch.zeros((bucket, cap), dtype=torch.long)
        toks[:, :n] = torch.as_tensor(np.asarray(prompt[plen:], np.int64))
        pkb = pk.to(dev)[:, None].expand(
            (pk.shape[0], bucket) + tuple(pk.shape[1:]))
        pvb = pv.to(dev)[:, None].expand(
            (pv.shape[0], bucket) + tuple(pv.shape[1:]))
        logits, kn, vn = self._chunk(self.params, toks.to(dev), pkb, pvb,
                                     last=n - 1, kv_len=2 * cap)
        pad = (0, 0, 0, 0, 0, cap - plen - n)
        cache = {"k": F.pad(torch.cat([pkb, kn[:, :, :n]], dim=2), pad),
                 "v": F.pad(torch.cat([pvb, vn[:, :, :n]], dim=2), pad),
                 "len": torch.full((bucket,), plen + n, dtype=torch.int32,
                                   device=dev)}
        return logits, cache

    def execute(self, task: Task, requests: list[Request],
                rng: np.random.Generator, buckets=(1, 2, 4, 8),
                prefix=None):
        """Run the (possibly merged) task; returns (wall seconds, kv cache).

        Batch sizes are padded to fixed buckets, as in the JAX engine, and
        the prefill to one shape per unit (``_prefill``).

        ``prefix=(pk, pv)`` — host KV tensors (L, P, Hkv, hd) for the first P
        prompt tokens from the paged prefix cache: only ``prompt[P:]`` is
        prefilled, attached to the cached blocks (DESIGN.md §2.4).  The
        returned cache dict lets the engine admit this prompt's KV back into
        the cache."""
        t0 = time.perf_counter()
        dev = self.device
        batch = len(requests)
        bucket = next((b for b in buckets if b >= batch), batch)
        logits, cache = self._prefill(requests[0].prompt, bucket, prefix)
        n_new = max((r.n_new for r in requests if r.op == "generate"),
                    default=0)
        cur = torch.argmax(logits, dim=-1)
        outs = [[] for _ in requests]
        temps = torch.tensor([max(r.temperature, 1e-6) for r in requests]
                             + [1e-6] * (bucket - batch),
                             device=dev)[:, None]
        sample = any(r.temperature > 0 for r in requests)
        for step in range(n_new):
            cur_host = cur.tolist()
            for i, r in enumerate(requests):
                if r.op == "generate" and step < r.n_new:
                    outs[i].append(int(cur_host[i]))
            logits, cache = self._decode(self.params, cache, cur)
            if sample:
                g = torch.as_tensor(rng.gumbel(size=tuple(logits.shape)),
                                    dtype=logits.dtype, device=dev)
                cur = torch.argmax(logits / temps + g, dim=-1)
            else:
                cur = torch.argmax(logits, dim=-1)
        _sync(dev)
        lp = torch.log_softmax(logits.float(), dim=-1)
        for i, r in enumerate(requests):
            if r.op == "generate":
                r.tokens = outs[i]
            else:
                r.logprobs = float(lp[i].max())
        return time.perf_counter() - t0, cache


class _StubUnit:
    """Oracle-timed stand-in for ``ProcessingUnit`` (no model): every unit of
    a stub-execution engine, or a ``backend="stub"`` fleet row inside a
    live pool (a remote-endpoint stand-in: oracle-sampled duration, no
    token payload).  Its machine shares ``DEFAULT_MTYPE`` with the live
    unit default, so engine/simulator trace-equivalence tests exercise the
    same PET keys by construction."""

    fns = ("stub",)   # non-None sentinel: clones count as warm starts
    kind = "stub"

    def __init__(self, uid: int, spec: MachineSpec | None = None,
                 speed: float = 1.0):
        self.uid = uid
        self.machine = (spec.build_machine(uid) if spec is not None
                        else Machine(mid=uid, mtype=DEFAULT_MTYPE,
                                     speed=speed, queue_size=4))
        self.warm = True

    def warmup(self, prompt_len: int = 16, buckets=(1,)) -> float:
        return 0.0


class _UnitRunner:
    """Live step executor for one unit under continuous batching
    (DESIGN.md §2.10).

    Owns the unit's paged KV arena and the two step functions — chunked
    prefill (``chunk_prefill_fn``) and batched paged decode
    (``paged_decode_fn``) — and runs the launches behind a ``UnitBatch``
    plan: every planned chunk is one prefill launch, all planned decodes
    are ONE batched launch over the page tables.  Virtual step costs come
    from calibrated per-token rates through the same fused-step formula as
    the analytic substrates (``step_cost``); the rates are EWMA-corrected
    from real walls.

    Every launch has one fixed shape per unit: a chunk is padded to the
    step token budget and attends over a key axis padded to the arena's
    capacity plus that budget, and a decode step is padded to
    ``max_batch`` rows.  On the card cuBLAS picks its kernel, and so its
    summation order, by shape; with fixed shapes each sequence's tokens
    cannot depend on what it shares a step with, so batched greedy output
    equals sequential output token for token.

    *Batchable* = greedy ``generate`` (all merged requests greedy — one
    trajectory fanned out, truncated per request).  Everything else
    (sampling, ``score``, over-long prompts) runs *exclusive*: the legacy
    ``ProcessingUnit.execute`` as one opaque step monopolizing the unit.
    """

    def __init__(self, engine: "ServingEngine", unit: ProcessingUnit,
                 cfgb: StepBatchingConfig):
        self.eng = engine
        self.unit = unit
        self.m = unit.machine
        self.cfgb = cfgb
        self.dev = unit.device
        mc = engine.model_cfg
        self.ps = engine.cfg.kv_block_size
        self.mp = -(-engine.cfg.max_len // self.ps)     # pages per sequence
        n_pages = cfgb.max_batch * self.mp + 1          # page 0: pad scratch
        self.pages = T.init_paged_cache(mc, n_pages, self.ps, self.dev)
        self.free = list(range(1, n_pages))
        self._chunk = T.chunk_prefill_fn(mc)
        self._pdec = T.paged_decode_fn(mc)
        self.c_pad = cfgb.step_token_budget             # chunk rows
        self.kv_len = self.mp * self.ps + self.c_pad    # chunk key axis
        self.states: dict[int, dict] = {}               # id(SeqState) -> state
        self._ticks = engine.cfg.time_scale / self.m.speed
        self.rp = 0.0   # wall seconds per prefill token
        self.rd = 0.0   # wall seconds per batch-1 decode step
        #: wall seconds of every batched decode launch (argmax included)
        self.decode_walls: list[float] = []
        self.setup_wall = self._calibrate()

    def _empty_kv(self):
        mc = self.eng.model_cfg
        return torch.zeros((mc.n_layers, 1, 0, mc.n_kv_heads,
                            mc.resolved_head_dim), dtype=torch.bfloat16,
                           device=self.dev)

    def _calibrate(self) -> float:
        """Run both step functions at their fixed shapes and measure the
        steady per-token rates; the total wall is the unit's cold-start
        charge (the step launches *are* the cold start under batching)."""
        t0 = time.perf_counter()
        eng = self.eng
        c = max(1, min(self.c_pad, eng.cfg.max_len - 1))
        toks = torch.zeros((1, self.c_pad), dtype=torch.long, device=self.dev)
        pk = self._empty_kv()
        for rep in range(2):
            t1 = time.perf_counter()
            profiled("chunk_prefill", self._chunk, eng.params, toks, pk, pk,
                     last=c - 1, kv_len=self.kv_len)
            _sync(self.dev)
        self.rp = max(time.perf_counter() - t1, 1e-9) / c
        b = self.cfgb.max_batch
        tabs = torch.zeros((b, self.mp), dtype=torch.int32, device=self.dev)
        lens = torch.zeros((b,), dtype=torch.int32, device=self.dev)
        tk = torch.zeros((b,), dtype=torch.long, device=self.dev)
        args = (eng.params, self.pages["kp"], self.pages["vp"], tabs, lens,
                tk)
        for rep in range(2):
            t2 = time.perf_counter()
            profiled("paged_decode_step", self._pdec, *args)
            _sync(self.dev)
        self.rd = max(time.perf_counter() - t2, 1e-9)
        return time.perf_counter() - t0

    def _obs_rate(self, name: str, val: float) -> None:
        cur = getattr(self, name)
        if val > 8.0 * cur:
            return      # a first-use kernel build rode this launch
        setattr(self, name, 0.7 * cur + 0.3 * val)

    @staticmethod
    def _batchable(reqs: list[Request]) -> bool:
        return bool(reqs) and all(r.op == "generate" and r.temperature <= 0.0
                                  and r.n_new >= 1 for r in reqs)

    # -- membership -----------------------------------------------------------
    def join(self, task: Task, reqs: list[Request], now: float,
             ub: UnitBatch) -> None:
        eng = self.eng
        cont = eng._handoff_cont.pop(task.tid, None)
        first = cont.get("first") if cont is not None else None
        ptoks = tuple(reqs[0].prompt) if reqs else ()
        n_new = max((r.n_new for r in reqs), default=0)
        if first is not None:
            # decode continuation after a prefill-plane handoff (§2.13):
            # the boundary token extends the prompt and the remaining
            # decode budget runs here, attaching the migrated KV blocks
            # through the normal cached-prefill path below
            ptoks = ptoks + (first,)
            n_new -= 1
        prompt = np.asarray(ptoks, np.int32)
        plen = len(prompt)
        if (not self._batchable(reqs)
                or plen < 1 or plen + n_new > self.mp * self.ps):
            # legacy exclusive execution, priced exactly as the sequential
            # path (measured wall, TPU batch discount for merged requests)
            dur = 0.0
            if reqs:
                wall, _ = self.unit.execute(task, reqs, eng._rng,
                                            buckets=eng.cfg.batch_buckets)
                dur = wall * self._ticks
                k = len(reqs)
                if k > 1:
                    dur *= (1.0 + eng.cfg.batch_marginal_cost * (k - 1)) / k
                eng.estimator.observe(
                    eng.estimator.key(task.op, plen,
                                      max(r.n_new for r in reqs), k), dur)
                eng.stats["cost"] += dur * self.m.cost_rate
            ub.join(SeqState(task=task, plen=max(plen, 1), n_new=n_new,
                             exclusive=True, excl_left=dur), now)
            return
        run_new = n_new
        if (first is None and self.m.phase == "prefill" and n_new > 1
                and any(x.phase != "prefill" for x in eng.machines)):
            # prefill plane (§2.13): run to the boundary token only; the
            # walker completing there triggers the control plane's handoff
            eng._handoff_pending[task.tid] = True
            run_new = 1
        # prefix-cache seeding: cached KV blocks stand in for the first P
        # prompt tokens, pinned until the sequence completes
        cache = eng.kvcaches.get(self.m.mid)
        hit, p0, ks, vs = None, 0, [], []
        if cache is not None and plen > 1 \
                and plen <= eng.cfg.prefix_max_prompt:
            hit = cache.lookup(ptoks, max_tokens=plen - 1)
            if hit:
                pfx_k, pfx_v = eng._gather_prefix(hit)
                p0 = pfx_k.shape[1]
                ks, vs = [pfx_k], [pfx_v]
        eng.stats["prefill_tokens"] += plen - p0
        npg = -(-(plen + run_new) // self.ps)
        tab = np.zeros((self.mp,), np.int32)
        pids = [self.free.pop() for _ in range(npg)]
        tab[:npg] = pids
        seq = SeqState(task=task, plen=plen, n_new=run_new, prefill_done=p0)
        self.states[id(seq)] = {
            "prompt": prompt, "ptoks": ptoks, "tab": tab,
            "pids": pids, "hit": hit, "k": ks, "v": vs,
            "out": [], "cur": -1, "len": 0,
            "pre": [first] if first is not None else []}
        ub.join(seq, now)

    def release(self, seq: SeqState | None) -> None:
        """Eviction cleanup: unpin and free the sequence's pages."""
        st = self.states.pop(id(seq), None) if seq is not None else None
        if st is None:
            return
        if st["hit"]:
            self.eng.kvcaches[self.m.mid].release(st["hit"])
        self.free.extend(st["pids"])

    # -- step execution -------------------------------------------------------
    def exec_step(self, plan) -> float:
        if plan.exclusive is not None:
            return plan.exclusive.excl_left
        eng = self.eng
        vc = 0.0
        for s, c in plan.chunks:
            st = self.states[id(s)]
            t0 = time.perf_counter()
            toks = np.zeros((1, self.c_pad), np.int64)
            toks[0, :c] = st["prompt"][s.prefill_done:s.prefill_done + c]
            toks = torch.from_numpy(toks).to(self.dev)
            if st["k"]:
                pk = torch.cat(st["k"], dim=1)[:, None].to(self.dev)
                pv = torch.cat(st["v"], dim=1)[:, None].to(self.dev)
            else:
                pk = pv = self._empty_kv()
            logits, kn, vn = profiled("chunk_prefill", self._chunk,
                                      eng.params, toks, pk, pv, last=c - 1,
                                      kv_len=self.kv_len)
            _sync(self.dev)
            st["k"].append(kn[:, 0, :c].cpu())
            st["v"].append(vn[:, 0, :c].cpu())
            self._obs_rate("rp", (time.perf_counter() - t0) / c)
            if s.prefill_done + c >= s.plen:
                # final chunk: its last-position logits yield the first new
                # token (what the sequential prefill's argmax produces) and
                # the accumulated KV commits to this sequence's pages
                st["cur"] = int(torch.argmax(logits[0]))
                st["out"].append(st["cur"])
                self._commit(s, st)
            vc += c * self.rp * self._ticks
        vd = 0.0
        k = len(plan.decode)
        if k:
            t0 = time.perf_counter()
            bucket = self.cfgb.max_batch        # fixed shape (class doc)
            toks = np.zeros((bucket,), np.int64)
            tabs = np.zeros((bucket, self.mp), np.int32)
            lens = np.zeros((bucket,), np.int32)
            sts = [self.states[id(s)] for s in plan.decode]
            for i, st in enumerate(sts):
                toks[i] = st["cur"]
                tabs[i] = st["tab"]
                lens[i] = st["len"]
            logits, kp, vp = profiled(
                "paged_decode_step", self._pdec,
                eng.params, self.pages["kp"], self.pages["vp"],
                torch.from_numpy(tabs).to(self.dev),
                torch.from_numpy(lens).to(self.dev),
                torch.from_numpy(toks).to(self.dev))
            _sync(self.dev)
            self.pages = {"kp": kp, "vp": vp}
            nxt = torch.argmax(logits, dim=-1).tolist()
            for i, st in enumerate(sts):
                st["len"] += 1
                st["cur"] = int(nxt[i])
                st["out"].append(st["cur"])
            wall = time.perf_counter() - t0
            self.decode_walls.append(wall)
            self._obs_rate("rd", wall / k)
            vd = (1.0 + self.cfgb.batch_marginal_cost * (k - 1)) \
                * self.rd * self._ticks
        dt = step_cost(vc, vd, self.cfgb.fused_step_overlap)
        eng.stats["cost"] += dt * self.m.cost_rate
        return dt

    def _commit(self, s: SeqState, st: dict) -> None:
        """Scatter the sequence's accumulated prefill KV into its pages."""
        kk = torch.cat(st["k"], dim=1)           # (L, plen, Hkv, hd)
        vv = torch.cat(st["v"], dim=1)
        st["k"], st["v"] = [kk], [vv]
        npg = -(-s.plen // self.ps)
        pad = (0, 0, 0, 0, 0, npg * self.ps - s.plen)
        shape = (kk.shape[0], npg, self.ps) + tuple(kk.shape[2:])
        pids = torch.as_tensor(st["pids"][:npg], device=self.dev)
        # in place: the arena is the unit's own, written only here and by
        # the decode step
        self.pages["kp"][:, pids] = F.pad(kk, pad).reshape(shape).to(
            self.dev, self.pages["kp"].dtype)
        self.pages["vp"][:, pids] = F.pad(vv, pad).reshape(shape).to(
            self.dev, self.pages["vp"].dtype)
        st["len"] = s.plen

    # -- completion -----------------------------------------------------------
    def complete(self, s: SeqState) -> None:
        st = self.states.pop(id(s), None)
        if st is None:
            return      # exclusive: ``execute`` already wrote the results
        eng = self.eng
        # a continuation carries the boundary token produced on the prefill
        # plane; the full output is that token plus this plane's decodes
        out = st.get("pre", []) + st["out"]
        for r in eng._inflight.get(s.task.tid, []):
            r.tokens = list(out[:r.n_new])
        cache = eng.kvcaches.get(self.m.mid)
        if cache is not None and s.plen > 1 \
                and s.plen <= eng.cfg.prefix_max_prompt:
            kk, vv = st["k"][0], st["v"][0]
            cache.insert(st["ptoks"],
                         lambda s0, s1: (kk[:, s0:s1], vv[:, s0:s1]))
            if st["hit"]:
                cache.release(st["hit"])
        self.free.extend(st["pids"])
        # keep the scheduler's estimates aligned with the step model: the
        # sequence's batch-1 virtual duration under calibrated rates
        mu = (s.plen * self.rp + s.n_new * self.rd) * eng.cfg.time_scale
        eng.estimator.observe(
            eng.estimator.key("generate", s.plen, s.n_new, 1), mu)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

TICKS_PER_SEC = 100     # engine time unit: 1 tick = 10 ms


@dataclass
class EngineConfig:
    n_units: int = 2
    # heterogeneous fleet catalog (DESIGN.md §2.8): machine types, speeds,
    # per-machine cost rates and unit backends, shared verbatim with the
    # simulator.  None reproduces today's pool: ``n_units`` identical
    # default-spec units (when set, ``fleet.total`` overrides ``n_units``).
    fleet: FleetSpec | None = None
    heuristic: str = "EDF"
    merging: str = "adaptive"          # none|conservative|aggressive|adaptive
    position_finder: str | None = None  # None|"linear"|"log" (Section 4.4.5)
    pruning: PruningConfig | None = None
    alpha: float = 2.0                 # base worst-case coefficient (Eq. 4.1)
    result_cache: bool = True
    # autoscale subsystem (DESIGN.md §2.7): policy-driven elasticity of the
    # unit pool above the ``n_units`` base (None or max_extra==0 disables).
    # The default reproduces the legacy queue hysteresis at the default
    # pool (n_units=2 + 6 extra = the old 8-unit ceiling; 12/2 thresholds,
    # 100-tick cooldown).  Note the ceiling is *relative* now: a
    # non-default n_units shifts it, so pin max_extra when that matters.
    elasticity: ElasticityConfig | None = field(
        default_factory=lambda: ElasticityConfig(
            policy="queue", max_extra=6, cooldown=100.0))
    max_len: int = 128
    merge_degree_cap: int = 5
    time_scale: float = float(TICKS_PER_SEC)  # virtual ticks per wall second
    # TPU batching economics (hardware adaptation, DESIGN.md §2): decode is
    # HBM-bandwidth-bound, weight traffic dominates, so a batch of k costs
    # (1 + marginal*(k-1)) of a single request rather than k.  The CPU
    # emulation measures ~linear wall time; virtual time applies the TPU
    # model.  marginal=1.0 recovers raw CPU timing.
    batch_marginal_cost: float = 0.15
    batch_buckets: tuple = (1, 2, 4, 8)
    # paged KV prefix cache (DESIGN.md §2.4): cross-request computational
    # reuse — new requests prefill only the uncached suffix of their prompt.
    # Sequence-local attention families only; silently off otherwise.
    prefix_cache: bool = True
    kv_block_size: int = 16            # tokens per cache block
    kv_cache_blocks: int = 512         # preallocated pool slots
    # cached-path prompt cap: the suffix prefill attends via reference
    # full_attention (O(S^2) score tile per layer), which is fine at serving
    # context lengths but a memory cliff at multi-k prompts — longer prompts
    # take the cold tiled-flash path instead
    prefix_max_prompt: int = 1024
    # step-level continuous batching (DESIGN.md §2.10): units co-run up to
    # ``batching.max_batch`` sequences under a per-step token budget —
    # chunked prefills coexist with batched paged decodes instead of
    # head-of-line blocking them.  None keeps the run-to-completion path
    # (and every existing trace) bit-identical.
    batching: StepBatchingConfig | None = None
    # prefill/decode disaggregation (DESIGN.md §2.13): the KV transfer
    # pricing used for handoff scheduling when the fleet declares phase
    # roles.  None -> TransferCostModel() defaults; must match the
    # simulator's for decision-trace equivalence.
    kv_transfer: "object | None" = None

    def control(self) -> ControlConfig:
        # the hard-deadline regime rides with pruning: infeasible tasks are
        # culled (the viewer already received the low-quality fallback — §5
        # intro); without a pruner late tasks still run (Ch. 4 regime)
        return ControlConfig(
            heuristic=self.heuristic, merging=self.merging,
            position_finder=self.position_finder, pruning=self.pruning,
            hard_deadlines=self.pruning is not None, alpha=self.alpha,
            merge_degree_cap=self.merge_degree_cap)


class ServingEngine(Substrate):
    """Single-process SMSE: the control plane's live-execution substrate.

    ``device`` is where the model runs: None means CUDA (raising when no
    card is present); pass ``"cpu"`` to run the kernels' plain versions.

    ``stub_oracle`` switches the engine to *stub-execution mode*: no model,
    no processing-unit warm-up — execution durations are sampled from
    the given oracle (which also drives the admission/pruning math), so the
    full engine code path can be replayed against the simulator's analytical
    model for decision-sequence equivalence."""

    def __init__(self, model_cfg, params, cfg: EngineConfig,
                 stub_oracle=None, warm_fns=None, device=None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.params = params
        self.device = resolve_device(device)
        if warm_fns is not None:
            # cross-engine warm start: another engine's compiled executables
            # (the warm-container ladder extended across planes — the first
            # unit here warm-starts instead of compiling)
            self._warm_fns = warm_fns
        self.estimator = TimeEstimator()
        self._stub = stub_oracle is not None
        self.oracle = (stub_oracle if self._stub
                       else _EngineOracle(self.estimator,
                                          np.random.default_rng(1)))
        self.fleet = (cfg.fleet if cfg.fleet is not None
                      else FleetSpec.homogeneous(cfg.n_units))
        self.units: list = []
        self.requests: dict[int, list[Request]] = {}   # task id -> requests
        self._inflight: dict[int, list[Request]] = {}  # executing task -> reqs
        self.cache: dict[tuple, list] = {}
        self.stats = {"completed": 0, "on_time": 0, "missed": 0, "merges": 0,
                      "merge_rejected": 0, "cache_hits": 0, "dropped": 0,
                      "cold_starts": 0, "warm_starts": 0, "scale_ups": 0,
                      "scale_downs": 0, "scale_decisions": 0,
                      "machine_seconds": 0.0, "extra_machine_seconds": 0.0,
                      "cost": 0.0, "pool_cost": 0.0, "extra_pool_cost": 0.0,
                      "warmup_ticks": 0.0, "executions": 0,
                      "mapping_events": 0, "deferred": 0,
                      "deadlock_breaks": 0, "mapping_wall_s": 0.0,
                      "pruning_wall_s": 0.0,
                      "prefix_hits": 0, "prefix_candidates": 0,
                      "prefix_tokens_reused": 0,
                      "prefill_tokens": 0}  # prefix_* mirrored from kvcache
        self._tel = None                    # obs.Telemetry once attached
        self.cp = ControlPlane(self, cfg.control())
        #: per-unit paged KV caches, mid -> PrefixKVCache (DESIGN.md §2.4 /
        #: §2.8): each compiled unit owns its blocks, so the mapping layer's
        #: ``MappingContext.prefix_overlap`` discriminates *within* the
        #: engine — a shared-prefix task is steered to the unit that
        #: actually holds the KV, not merely to the right plane
        self.kvcaches: dict[int, PrefixKVCache] = {}
        #: counters carried over from scaler-retired units' caches, so
        #: end-of-run prefix stats never shrink when a unit retires
        self._retired_kv = {"hits": 0, "tokens_reused": 0, "lookups": 0,
                            "inserts": 0, "evictions": 0}
        self._kv_enabled = (cfg.prefix_cache and not self._stub
                            and model_cfg.family in ("dense", "vlm"))
        if self._kv_enabled:
            # PREFIX-level similarity scoring reads the best match across
            # every unit's trie (admission accounting + cross-plane routing)
            self.cp.detector.prefix_index = CombinedPrefixIndex(self.kvcaches)
            self.cp.prefix_fn = self._prefix_locality
        self._rng = np.random.default_rng(0)
        self._rid = 0
        self._batches: dict[int, UnitBatch] = {}    # mid -> step walker
        self._runners: dict[int, _UnitRunner] = {}  # mid -> live executor
        # prefill/decode disaggregation state (DESIGN.md §2.13)
        self._handoff_pending: dict[int, bool] = {}  # tid clipped at boundary
        self._handoff_cont: dict[int, dict] = {}     # tid -> {left, first}
        self._xfer = None
        if cfg.batching is not None and cfg.batching.max_batch > 1:
            self._xfer = cfg.kv_transfer or TransferCostModel()
            self.cp.migrate_cost_fn = self._migrate_cost
        for spec in self.fleet.expand():
            self._add_unit(spec)
        self.scaler = None
        if cfg.elasticity is not None and cfg.elasticity.max_extra > 0:
            self.scaler = PoolScaler(cfg.elasticity, _EngineUnitPool(self),
                                     len(self.units))
            self.scaler.device = self.device

    # -- control-plane delegation --------------------------------------------
    @property
    def clock(self) -> float:
        return self.cp.now

    @property
    def machines(self) -> list[Machine]:
        return [u.machine for u in self.units]

    @property
    def detector(self):
        return self.cp.detector

    @property
    def pruner(self):
        return self.cp.pruner

    @property
    def batch(self) -> list[Task]:
        return self.cp.batch

    def _unit(self, mid: int):
        return next(u for u in self.units if u.machine.mid == mid)

    @property
    def kvcache(self):
        """The single per-unit cache when exactly one unit owns one — the
        pre-fleet engine-wide attribute kept for single-unit callers; None
        otherwise (multi-unit introspection goes through ``kvcaches``)."""
        if len(self.kvcaches) == 1:
            return next(iter(self.kvcaches.values()))
        return None

    def _prefix_locality(self, task: Task, machine: Machine) -> int:
        """Per-unit KV locality: prompt tokens *this* machine's own cache
        holds (0 for stub-backed units, which keep no KV)."""
        cache = self.kvcaches.get(machine.mid)
        if cache is None or task.tokens is None or len(task.tokens) < 2:
            return 0
        return cache.index.match_len(task.tokens, len(task.tokens) - 1)

    @property
    def warm_fns(self):
        """Compiled executables for warm-starting sibling engines/planes."""
        return getattr(self, "_warm_fns", None)

    # -- elasticity -----------------------------------------------------------
    def _add_unit(self, spec: MachineSpec | None = None) -> float:
        """Start one unit of ``spec`` (default: the fleet's cheapest row —
        elastic scale-up is cheapest-first, which on a homogeneous fleet is
        the legacy clone); returns its warm-up charge in virtual ticks."""
        if spec is None:
            spec = self.fleet.cheapest()
        uid = self._next_uid = getattr(self, "_next_uid", 0) + 1
        stub = self._stub or spec.backend == "stub"
        # warm start from the first *compiled* unit's executables (a stub's
        # sentinel fns must never leak into a ProcessingUnit), else from
        # another engine's warm_fns (the cross-plane warm-container ladder)
        shared = next((u.fns for u in self.units if u.kind != "stub"), None)
        if shared is None and getattr(self, "_warm_fns", None) is not None:
            shared = self._warm_fns
        if stub:
            if self._stub and self.units:
                shared = self.units[0].fns   # stub clones count as warm
            unit = _StubUnit(uid, spec)
        else:
            unit = ProcessingUnit(
                uid, self.model_cfg, self.params, self.cfg.max_len,
                spec=spec, device=self.device,
                shared_fns=None if shared == _StubUnit.fns else shared)
        cold = unit.warmup(buckets=self.cfg.batch_buckets)
        bat = self.cfg.batching
        if bat is not None and bat.max_batch > 1:
            unit.machine.max_batch = bat.max_batch
            if unit.kind != "stub":
                # the step executables (chunk prefill + per-bucket paged
                # decode) are the cold start under batching: their compile
                # wall joins the warm-up charge, and the measured rates
                # recalibrate the estimator's cold formula
                runner = _UnitRunner(self, unit, bat)
                self._runners[unit.machine.mid] = runner
                cold += runner.setup_wall
                self.estimator.calibrate(
                    runner.rp * self.cfg.time_scale,
                    runner.rd * self.cfg.time_scale)
        if not stub or self._stub:
            self._warm_fns = unit.fns
        if shared is None:
            self.stats["cold_starts"] += 1
        else:
            self.stats["warm_starts"] += 1
        if self._kv_enabled and unit.kind != "stub":
            # admission-aware per-unit budget (§2.13): the spec's phase
            # role and speed size this unit's block pool
            cache = PrefixKVCache(
                spec.kv_blocks(self.cfg.kv_cache_blocks),
                self.cfg.kv_block_size,
                value_fn=self._block_value, clock_fn=lambda: self.clock)
            if self._tel is not None:
                cache.tel = self._tel
                cache.tel_attrs = {"plane": self.cp.plane_id,
                                   "machine": unit.machine.mid}
            self.kvcaches[unit.machine.mid] = cache
        # initial units are pre-warmed before traffic opens (the thesis's
        # SMSE starts its processing units ahead of the stream); cold/warm
        # start-up charges virtual time only for mid-run elastic scale-ups
        charge = 0.0
        if self.clock > 0 and cold > 0:
            charge = cold * self.cfg.time_scale
            self.cp.note_warmup(unit.machine, self.clock + charge)
        self.units.append(unit)
        return charge

    def before_mapping(self, now: float) -> None:
        if self.scaler is not None:
            self.scaler.step_substrate(now, self.cp, self.machines,
                                       self.oracle)

    # -- observability ---------------------------------------------------------
    def attach_telemetry(self, tel, plane: int | None = None) -> None:
        """Wire one ``repro.obs.Telemetry`` through every layer of this
        engine: lifecycle events from the control plane, hit/miss/evict
        events from the per-unit KV caches (including units added later by
        the scaler), scale events from the autoscaler.  Recording only —
        no decision path reads the recorder."""
        self._tel = tel
        if plane is not None:
            self.cp.plane_id = plane
        self.cp.tel = tel
        for mid, cache in self.kvcaches.items():
            cache.tel = tel
            cache.tel_attrs = {"plane": self.cp.plane_id, "machine": mid}
        if self.scaler is not None:
            self.scaler.tel = tel
            self.scaler.scope = "units"

    # -- QoS accounting (one path for every completion/drop) -------------------
    def _account_completed(self, req: Request, now: float,
                           ttype: str | None = None) -> int:
        """Single completion-accounting path, shared by result-cache hits
        and real executions; returns 1 when the request missed its
        deadline (the pruner-EWMA signal)."""
        req.status = "done"
        req.completed_at = now
        self.stats["completed"] += 1
        if now <= req.deadline:
            self.stats["on_time"] += 1
            if ttype is not None and self.pruner is not None:
                self.pruner.fairness.note_served(ttype)
            return 0
        self.stats["missed"] += 1
        return 1

    def _account_dropped(self, req: Request, now: float) -> None:
        req.status = "dropped"
        req.completed_at = now
        self.stats["dropped"] += 1

    # -- ingestion (Ch. 4 front door) ----------------------------------------
    def ingest(self, req: Request, now: float) -> Task | None:
        req.rid = self._rid
        self._rid += 1
        sig = (req.prompt, req.op, req.params_sig)
        if self.cfg.result_cache and req.op == "generate" and sig in self.cache:
            req.tokens = list(self.cache[sig])
            self.stats["cache_hits"] += 1
            # same accounting path as a real execution: a hit served past
            # its deadline counts as missed (simulator semantics)
            self._account_completed(req, now)
            return None

        task = req.to_task(now, req.rid)
        # PREFIX-level admission scoring: partial overlap with cached KV is
        # reuse the hash-identity levels below cannot see (best match over
        # every unit's cache)
        if self._kv_enabled and \
                self.detector.find_prefix_overlap(req.prompt) > 0:
            self.stats["prefix_candidates"] += 1
        self.requests[task.tid] = [req]
        self._oracle_note(task.tid, len(req.prompt), req.n_new)
        return task

    def _oracle_note(self, tid: int, plen: int, n_new: int) -> None:
        note = getattr(self.oracle, "note_task", None)
        if note is not None:
            note(tid, plen, n_new)

    def _oracle_forget(self, tid: int) -> None:
        forget = getattr(self.oracle, "forget", None)
        if forget is not None:
            forget(tid)

    # -- merge bookkeeping ----------------------------------------------------
    def merge_viable(self, existing: Task) -> bool:
        return existing.tid in self.requests

    def on_merge(self, existing: Task, arriving: Task, level) -> None:
        self.requests[existing.tid] += self.requests.pop(arriving.tid)

    # -- paged KV prefix cache (DESIGN.md §2.4) --------------------------------
    def _block_value(self, blk, now: float) -> float:
        """Expected residency value of a cached block: the TimeEstimator's
        prefill-time estimate for the *prefix this block completes*
        (depth * block_size tokens — what a hit that reaches it saves; a
        deep block implies its whole ancestor chain got reused), weighted
        by observed reuse and decayed by idle age — the pruning chapter's
        "not worth pursuing" economics applied to cache eviction."""
        mu, _ = self.estimator.mean_std(
            "generate", max(blk.depth, 1) * blk.n_tokens, 1)
        age = max(now - blk.last_used, 1.0)
        return mu * (1.0 + blk.hits) / age

    def _gather_prefix(self, hit):
        """Concatenate pinned block payloads into (L, P, Hkv, hd) host KV."""
        ks = [b.payload[0] for b in hit.blocks]
        vs = [b.payload[1] for b in hit.blocks]
        return torch.cat(ks, dim=1), torch.cat(vs, dim=1)

    # -- step-level batching substrate (DESIGN.md §2.10) -----------------------
    def _unit_batch(self, m: Machine) -> UnitBatch:
        ub = self._batches.get(m.mid)
        if ub is None:
            def on_step(t, dt, plan):
                tel = self.cp.tel
                if tel.enabled:
                    tel.event(t, "batch_step", machine=m.mid,
                              plane=self.cp.plane_id, dt=round(dt, 9),
                              tokens=plan.tokens, decode=len(plan.decode),
                              chunks=len(plan.chunks))
                    tel.metrics.observe("step_ticks", dt)

            ub = self._batches[m.mid] = UnitBatch(self.cfg.batching,
                                                  on_step=on_step)
        return ub

    def join_batch(self, task: Task, m: Machine, now: float) -> None:
        """Admit a mapped task into the unit's step batch.  Stub-backed
        units take the analytic path — oracle-sampled duration split into
        per-token rates, *identically* to the simulator's ``join_batch`` —
        so stub-engine ↔ simulator decision traces stay equivalent under
        batching; compiled units hand off to their live runner."""
        reqs = []
        for t in task.all_requests():
            reqs += self.requests.pop(t.tid, [])
            self._oracle_forget(t.tid)
        if task.tid in self._handoff_cont:
            # handoff continuation: the requests moved to _inflight at the
            # prefill-plane dispatch and must survive this second join
            reqs = self._inflight.get(task.tid, reqs)
        else:
            self._inflight[task.tid] = reqs
        self.stats["executions"] += 1
        ub = self._unit_batch(m)
        unit = self._unit(m.mid)
        if self._stub or unit.kind == "stub":
            task._stub_backend = not self._stub
            cfgb = self.cfg.batching
            cont = self._handoff_cont.pop(task.tid, None)
            dur = self.oracle.sample(task, m)
            plen, n_new = task_dims(task, cfgb)
            wp = dur * cfgb.prefill_fraction
            step = (dur - wp) / max(n_new, 1)
            if cont is not None:
                # decode continuation after a prefill-plane handoff
                # (§2.13): only the remaining decode steps are billed here
                left = cont["left"]
                span = step * left
                seq = SeqState(task=task, plen=plen, n_new=n_new,
                               prefill_done=plen, decoded=n_new - left,
                               prefill_rate=wp / plen, decode_step=step)
            elif (m.phase == "prefill" and n_new > 1
                  and any(x.phase != "prefill" for x in self.machines)):
                # prefill plane: run to the boundary token only, identical
                # to the simulator's clip
                self._handoff_pending[task.tid] = True
                span = wp + step
                seq = SeqState(task=task, plen=plen, n_new=1,
                               prefill_rate=wp / plen, decode_step=step)
            else:
                span = dur
                seq = SeqState(task=task, plen=plen, n_new=n_new,
                               prefill_rate=wp / plen, decode_step=step)
            self.stats["cost"] += span * m.cost_rate
            ub.join(seq, now)
            return
        self._runners[m.mid].join(task, reqs, now, ub)

    def run_quantum(self, m: Machine, now: float):
        ub = self._batches.get(m.mid)
        if ub is None or ub.empty:
            return None, []
        runner = self._runners.get(m.mid)
        t_end, completed = ub.run_quantum(
            now, exec_fn=runner.exec_step if runner is not None else None)
        if t_end is None:
            return None, []
        if runner is not None:
            for s in completed:
                runner.complete(s)
        return t_end, [s.task for s in completed]

    def evict_from_batch(self, task: Task, m: Machine, now: float) -> None:
        ub = self._batches.get(m.mid)
        if ub is None:
            return
        seq = ub.evict(task)
        runner = self._runners.get(m.mid)
        if runner is not None:
            runner.release(seq)

    # -- prefill/decode disaggregation (DESIGN.md §2.13) -----------------------
    def handoff_ready(self, task: Task, machine: Machine) -> bool:
        return task.tid in self._handoff_pending

    def on_handoff(self, task: Task, src_mid: int, dst_mid: int,
                   now: float) -> None:
        """The prefill→decode boundary: record the continuation (boundary
        token + remaining budget) and move the sequence's KV blocks from
        the source unit's arena-backed cache to the destination's.  The
        payloads are host arrays owned by the blocks, so migration moves
        references; the destination runner re-attaches them through its
        normal lookup→gather→cached-prefill path."""
        self._handoff_pending.pop(task.tid, None)
        _, n_new = task_dims(task, self.cfg.batching)
        reqs = self._inflight.get(task.tid, [])
        first = None
        if reqs and reqs[0].tokens:
            first = int(reqs[0].tokens[0])
        self._handoff_cont[task.tid] = {"left": n_new - 1, "first": first}
        src = self.kvcaches.get(src_mid)
        dst = self.kvcaches.get(dst_mid)
        if src is not None and dst is not None and task.tokens:
            sm = next(u.machine for u in self.units
                      if u.machine.mid == src_mid)
            dm = next(u.machine for u in self.units
                      if u.machine.mid == dst_mid)
            migrate(src, dst, task.tokens, cost_model=self._xfer,
                    src_speed=sm.speed, dst_speed=dm.speed, now=now,
                    src_mid=src_mid, dst_mid=dst_mid, tel=self._tel)

    def _migrate_cost(self, task: Task, src: Machine, dst: Machine) -> float:
        """Modeled KV transfer cost for handoff scheduling: the prompt's
        block count minus the destination's already-resident prefix.
        Substrate-identical with ``Simulator._migrate_cost`` (a stub
        engine's caches are empty, matching the batched sim's)."""
        plen, _ = task_dims(task, self.cfg.batching)
        bs = self.cfg.kv_block_size
        have = 0
        cache = self.kvcaches.get(dst.mid)
        if cache is not None and task.tokens:
            have = cache.peek(task.tokens) // bs
        n_blocks = max(0, plen // bs - have)
        return self._xfer.cost(n_blocks, bs, src.speed, dst.speed)

    # -- execution substrate ---------------------------------------------------
    def begin_execution(self, task: Task, m: Machine, now: float) -> float:
        """Run the (possibly merged) task for real; return its duration in
        virtual ticks.  The control plane owns the completion event."""
        reqs = []
        for t in task.all_requests():
            reqs += self.requests.pop(t.tid, [])
            self._oracle_forget(t.tid)
        self._inflight[task.tid] = reqs
        if not reqs:
            return 0.0
        unit = self._unit(m.mid)
        if self._stub or unit.kind == "stub":
            # per-unit backend dispatch: a stub-backed unit in a live pool
            # is the remote-endpoint stand-in — its duration is sampled
            # from the oracle and it produces no token payload, so its
            # results must never enter the result cache
            task._stub_backend = not self._stub
            self.stats["executions"] += 1
            dur = self.oracle.sample(task, m)
            self.stats["cost"] += dur * m.cost_rate
            return dur

        prompt = reqs[0].prompt
        cache = self.kvcaches.get(m.mid)
        prefix, hit = None, None
        reusable = (cache is not None and len(prompt) > 1
                    and len(prompt) <= self.cfg.prefix_max_prompt)
        if reusable:
            # pin the cached prefix for the whole execution: blocks can
            # never be evicted out from under a running prefill
            hit = cache.lookup(prompt, max_tokens=len(prompt) - 1)
            if hit:
                prefix = self._gather_prefix(hit)
        self.stats["prefill_tokens"] += \
            len(prompt) - (hit.n_tokens if hit else 0)
        wall, kv_out = unit.execute(task, reqs, self._rng,
                                    buckets=self.cfg.batch_buckets,
                                    prefix=prefix)
        if reusable and kv_out is not None and "k" in kv_out:
            kk, vv = kv_out["k"], kv_out["v"]
            cache.insert(
                prompt,
                lambda s0, s1: (kk[:, 0, s0:s1].cpu(),
                                vv[:, 0, s0:s1].cpu()))
        if hit is not None and hit:
            cache.release(hit)
        self.stats["executions"] += 1
        dur = wall * self.cfg.time_scale / m.speed
        # TPU batching economics: batch-k costs (1 + marginal*(k-1)),
        # not k (decode is HBM-bound; see EngineConfig)
        k = len(reqs)
        if k > 1:
            dur *= (1.0 + self.cfg.batch_marginal_cost * (k - 1)) / k
        key = self.estimator.key(task.op, len(reqs[0].prompt),
                                 max(r.n_new for r in reqs), len(reqs))
        self.estimator.observe(key, dur)
        self.stats["cost"] += dur * m.cost_rate
        return dur

    def finish_execution(self, task: Task, m: Machine, now: float) -> int:
        reqs = self._inflight.pop(task.tid, [])
        self._handoff_pending.pop(task.tid, None)   # no-dst fallback path
        self._handoff_cont.pop(task.tid, None)
        # stub-backed units in a live pool return no token payload — their
        # empty results must not poison the result cache
        cacheable = (self.cfg.result_cache
                     and not getattr(task, "_stub_backend", False))
        missed = 0
        for r in reqs:
            missed += self._account_completed(r, now, ttype=task.ttype)
            if cacheable and r.op == "generate":
                self.cache[(r.prompt, r.op, r.params_sig)] = list(r.tokens)
        return missed

    def on_drop(self, task: Task, now: float) -> None:
        # an EVICT-mode drop can name an *executing* task, whose requests
        # already moved from ``requests`` to ``_inflight`` at dispatch
        reqs = self._inflight.pop(task.tid, [])
        for t in task.all_requests():
            reqs += self.requests.pop(t.tid, [])
            self._oracle_forget(t.tid)
        # dropped is its own bucket (simulator semantics): "missed" counts
        # only tasks that *ran* late, so miss-rate consumers combine
        # missed + dropped — exactly like SimStats.miss_rate
        for r in reqs:
            self._account_dropped(r, now)

    # -- driving ---------------------------------------------------------------
    def run(self, requests: list[tuple[float, Request]]) -> dict:
        """Drive the engine over a virtual-time request trace (event-driven:
        wall cost scales with events, not with idle virtual time).

        Closed-trace convenience over the streaming control plane — the
        cluster front door (``serving.cluster.Router``) drives the same
        ``cp`` incrementally via ``schedule_arrival`` + ``cp.run(until)``
        and reads ``collect_stats()`` directly."""
        for t, req in requests:
            self.cp.schedule_arrival(t, req)
        self.cp.run()
        return self.collect_stats()

    def collect_stats(self) -> dict:
        """Sync control-plane and kv-cache counters into one stats dict
        (idempotent; callable mid-stream between ``cp.run(until)`` steps)."""
        c = self.cp.stats
        self.stats["merges"] = c["merges"]
        self.stats["merge_rejected"] = c["merge_rejected"]
        self.stats["mapping_events"] = c["mapping_events"]
        self.stats["deferred"] = c["deferred"]
        self.stats["deadlock_breaks"] = c["deadlock_breaks"]
        self.stats["mapping_wall_s"] = c["mapping_wall_s"]
        self.stats["pruning_wall_s"] = c["pruning_wall_s"]
        if self.scaler is not None:
            self.scaler.sync(self.cp.now)
            self.stats.update({k: self.scaler.stats[k] for k in (
                "scale_ups", "scale_downs", "scale_decisions",
                "machine_seconds", "extra_machine_seconds",
                "pool_cost", "extra_pool_cost", "warmup_ticks")})
        else:
            # fixed pool: the integrals degenerate to pool x makespan,
            # billed per machine type through each unit's cost rate
            self.stats["machine_seconds"] = \
                len(self.units) * c["last_completion"]
            self.stats["pool_cost"] = c["last_completion"] * \
                sum(m.cost_rate for m in self.machines)
        out = dict(self.stats)
        if self.kvcaches or any(self._retired_kv.values()):
            # the caches' own counters are authoritative — the engine only
            # hand-maintains what they cannot see (prefill_tokens,
            # prefix_candidates); per-unit caches aggregate by sum, plus
            # the carried-over counters of scaler-retired units
            kvs = list(self.kvcaches.values())
            ret = self._retired_kv
            out.update(
                prefix_hits=ret["hits"] +
                sum(c.stats["hits"] for c in kvs),
                prefix_tokens_reused=ret["tokens_reused"] +
                sum(c.stats["tokens_reused"] for c in kvs),
                prefix_lookups=ret["lookups"] +
                sum(c.stats["lookups"] for c in kvs),
                prefix_inserts=ret["inserts"] +
                sum(c.stats["inserts"] for c in kvs),
                prefix_evictions=ret["evictions"] +
                sum(c.stats["evictions"] for c in kvs),
                prefix_blocks_used=sum(c.pool.n_used for c in kvs))
        return out


class _EngineOracle:
    """ExecOracle over the TimeEstimator (drives merging + pruning math).

    ``mean_std``/``pmf`` dispatch per machine through ``machine.speed``
    (consistent heterogeneity: an emulated accelerator at speed s is 1/s
    slower across the board); ``sample`` times stub-backed units in a
    mixed live pool, so the estimates the scheduler plans with and the
    durations the remote-endpoint stand-ins report come from one model."""

    def __init__(self, estimator: TimeEstimator, rng=None):
        self.est = estimator
        self._rng = rng if rng is not None else np.random.default_rng(1)
        self.dims: dict[int, tuple[int, int]] = {}   # tid -> (plen, n_new)

    def note_task(self, tid: int, prompt_len: int, n_new: int) -> None:
        self.dims[tid] = (prompt_len, n_new)

    def forget(self, tid: int) -> None:
        """Drop a completed/dropped task's entry so ``dims`` stays bounded
        by the number of *live* tasks over arbitrarily long traces."""
        self.dims.pop(tid, None)

    def _task_dims(self, task: Task) -> tuple[int, int, int]:
        reqs = task.all_requests()
        dims = [self.dims.get(t.tid, (64, 8)) for t in reqs]
        return (max(d[0] for d in dims), max(d[1] for d in dims), len(reqs))

    def mean_std(self, task: Task, machine) -> tuple[float, float]:
        pl, nn, batch = self._task_dims(task)
        mu, sd = self.est.mean_std(task.op, pl, nn, batch)
        return mu / machine.speed, sd / machine.speed

    def pmf(self, task: Task, machine) -> PMF:
        mu, sd = self.mean_std(task, machine)   # already in integer ticks
        return PMF.from_normal(max(mu, 1.0), max(sd, 0.5))

    def sample(self, task: Task, machine) -> float:
        """Ground-truth duration for a stub-backed unit in a live pool."""
        mu, sd = self.mean_std(task, machine)
        return float(max(1.0, self._rng.normal(mu, sd)))


class _EngineUnitPool:
    """Autoscale pool adapter over the engine's processing units: grows
    through ``_add_unit`` (cheapest fleet row first, warm-starting from the
    shared executables and charging compile time via ``note_warmup``) and
    retires the priciest idle, empty unit — never losing queued work.  On
    a homogeneous fleet both rules collapse to the legacy behavior: the
    one spec grows, the last idle unit retires.

    Like the pre-subsystem engine (and unlike the simulator's extras-only
    pool), shrink considers *every* idle unit — the PoolScaler enforces
    only the pool-size floor, so on a heterogeneous fleet an expensive
    idle base unit can retire while a cheap extra keeps working.  The
    billing consequence is deliberate: `extra_machine_seconds` /
    `extra_pool_cost` measure *net* spend above the base pool (count and
    summed rate respectively), so swapping a pricey base unit for a cheap
    extra is not billed as extra spend."""

    def __init__(self, eng: ServingEngine):
        self.eng = eng

    def size(self) -> int:
        return len(self.eng.units)

    def cost_rate(self) -> float:
        """Summed per-machine cost rate of the live pool (the per-mtype
        billing integrand, Fig. 5.19)."""
        return sum(u.machine.cost_rate for u in self.eng.units)

    def grow(self, now: float) -> float:
        return self.eng._add_unit()

    def shrink(self, now: float) -> bool:
        units = self.eng.units
        idle = [i for i, u in enumerate(units)
                if not u.machine.queue and u.machine.running is None
                and u.machine.busy_until <= now]
        if not idle:
            return False
        # priciest-first retirement; the last-added unit breaks cost ties
        # (identical to the legacy last-idle scan on a homogeneous pool)
        i = max(idle, key=lambda j: (units[j].machine.cost_rate, j))
        unit = units.pop(i)
        self.eng._batches.pop(unit.machine.mid, None)
        self.eng._runners.pop(unit.machine.mid, None)
        cache = self.eng.kvcaches.pop(unit.machine.mid, None)
        if cache is not None:
            # retire-migrates-blocks (§2.13): hand the retiring unit's
            # trie to the cheapest surviving decode-capable cache instead
            # of dropping warm prefixes on the floor
            heirs = [u.machine for u in units
                     if u.machine.mid in self.eng.kvcaches]
            if heirs and len(cache.index):
                heir = min(heirs, key=lambda x: (x.phase == "prefill",
                                                 x.cost_rate, x.mid))
                migrate(cache, self.eng.kvcaches[heir.mid],
                        cost_model=self.eng._xfer,
                        src_speed=unit.machine.speed, dst_speed=heir.speed,
                        now=now, src_mid=unit.machine.mid,
                        dst_mid=heir.mid, tel=self.eng._tel)
            # carry the retired cache's counters so end-of-run prefix
            # stats never shrink (mirrors the simulator's bookkeeping)
            for k in self.eng._retired_kv:
                self.eng._retired_kv[k] += cache.stats[k]
        return True
