"""One run of one cell of the benchmark of ``repro_torch``.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix; everything else is found by name under
``perfbench/``:

* ``configs/<config>.json``: the model's sizes; its ``family`` names
  ``families/<family>.py`` (the port mapping, the weights, the FLOP and
  byte counts) and ``reference/<family>.py`` (the plain reference);
* ``traffic/<traffic>.json``: the mix's parameters (``traffic.py``);
* ``cells/<cell>.json``: the cell's engine settings, client count, ramp
  and the limit of its correctness check;
* ``metrics/<metric>.py``: one reader per per-layer metric, ``read(ctx)``,
  which returns a number or None (nothing to read: the metric is left
  out).  ``ctx`` holds the window (``w0``, ``w1``, ``window_s``), every
  request's record (``records``, see ``stats.py``), the engine's counters at both ends of the window (``stats0``, ``stats1``),
  requests submitted in it, the config and its family module, the unit's
  ``max_batch`` and chunk rows (``unit``), the card's ``peaks`` and, in a
  traced run, the step spans (``steps``), the kernels' counted work
  (``kernels``) and the device trace's summary (``trace``).

The timed path is the port's front door, ``repro_torch.serving.cluster
.Router`` over one engine plane (``make_engine_planes``) with one unit
under continuous batching, driven through ``submit`` / ``step`` and the
control plane's ``on_complete`` hook.  The harness hands each request to
the Router when it is due on the wall clock (open loop) or when its
client got its previous answer (closed loop), stamped with the plane's
own clock, and steps the plane one event instant at a time as fast as
the host runs it.  A deadline is set that many ticks after the stamp, so
the pruner sees the same slack that the harness judges on the wall clock.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

from . import stats
from .probe import Marks
from .traffic import Traffic, mix64

PB = Path(__file__).resolve().parent
ROOT = PB.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the longest span of a traced window that the device trace covers
TRACE_SPAN_S = 5.0
#: how long after the window a deadline cell waits for the answers due in it
RESOLVE_S = 60.0
EPS = 1e-9


def load_json(path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


class Cell:
    """A cell and every file it names, found by name under ``base``."""

    def __init__(self, bench: dict, name: str, base: Path = PB):
        w = next((w for w in bench["workloads"] if w["name"] == name), None)
        if w is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.chips = name, int(w["chips"])
        self.conf = load_json(base / "configs" / f"{w['config']}.json")
        self.mix = load_json(base / "traffic" / f"{w['traffic']}.json")
        self.settings = load_json(base / "cells" / f"{name}.json")
        fam = self.conf["family"]
        self.family = load_module(base / "families" / f"{fam}.py",
                                  f"perfbench_family_{fam}")
        self.reference = load_module(base / "reference" / f"{fam}.py",
                                     f"perfbench_reference_{fam}")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.readers = {m["name"]: load_module(
            base / "metrics" / f"{m['name']}.py",
            "perfbench_metric_" + m["name"].replace(".", "_"))
            for m in self.per_layer}
        self.peaks = load_json(base / "peaks.json")


def build_router(cell: Cell, conf: dict, params, device):
    """The port's Router over one engine plane with one unit, as the cell
    configures it."""
    from repro_torch.core.pruning import PruningConfig
    from repro_torch.serving.batching import StepBatchingConfig
    from repro_torch.serving.cluster import Router, make_engine_planes
    from repro_torch.serving.engine import EngineConfig
    e = cell.settings["engine"]
    pr = e.get("pruning")
    ecfg = EngineConfig(
        n_units=1, heuristic=e["heuristic"], merging=e["merging"],
        pruning=PruningConfig(**pr) if pr is not None else None,
        result_cache=e["result_cache"], elasticity=None,
        max_len=e["max_len"], batch_buckets=(1,),
        prefix_cache=e["prefix_cache"], kv_block_size=e["kv_block_size"],
        kv_cache_blocks=e["kv_cache_blocks"],
        prefix_max_prompt=e["prefix_max_prompt"],
        batching=StepBatchingConfig(max_batch=e["max_batch"],
                                    step_token_budget=e["step_token_budget"]))
    mc = cell.family.port_config(conf)
    planes = make_engine_planes(mc, params, ecfg, 1, device=device)
    return Router(planes, policy="least-loaded"), planes[0]


class Driver:
    """Feeds the Router the cell's traffic and records every request."""

    def __init__(self, router, plane, traffic: Traffic, clients: int,
                 marks: Marks):
        from repro_torch.serving.engine import TICKS_PER_SEC, Request
        self.Request, self.tps = Request, TICKS_PER_SEC
        self.router, self.plane, self.tr = router, plane, traffic
        self.clients = clients
        self.records: list[dict] = []
        self.reqs: dict = {}
        self.ready: list[float] = []
        self.next_k = 0
        self.t_open = None
        self.setup_left = 0
        self.late_s = 0.0
        self.marks = marks
        plane.cp.on_complete = self.on_complete

    def on_complete(self, r, now, outcome) -> None:
        k = r.session
        if k < 0:
            self.setup_left -= 1
            return
        rec = self.records[k]
        if rec["outcome"] is not None:
            return
        t = time.perf_counter()
        rec["done"], rec["outcome"] = t, outcome
        if outcome != "dropped":
            rec["served"] = len(self.reqs[k].tokens)
            rec["merged"] = (outcome == "served"
                             or getattr(r, "merged_into", None) is not None)
        if self.tr.closed:
            self.ready.append(t)

    def _submit(self, k: int, due: float, spec) -> None:
        t = self.plane.now
        late = time.perf_counter() - due
        dl = (math.inf if spec.deadline_ms is None
              else t + (spec.deadline_ms / 1e3 - late) * self.tps)
        req = self.Request(prompt=spec.prompt, n_new=spec.n_new,
                           deadline=dl, session=k)
        if k >= 0:
            self.records.append({
                "index": k, "due": due, "done": None, "outcome": None,
                "prompt": len(spec.prompt), "n_new": spec.n_new, "served": 0,
                "deadline_ms": spec.deadline_ms, "merged": False})
            self.reqs[k] = req
            self.late_s = max(self.late_s, late)
        self.router.submit(req, t)

    def _feed(self, now: float) -> None:
        if self.t_open is None:
            return
        if self.tr.closed:
            while self.ready:
                due = self.ready.pop(0)
                self._submit(self.next_k, due, self.tr.spec(self.next_k))
                self.next_k += 1
            return
        while self.t_open + self.tr.arrival(self.next_k) <= now:
            due = self.t_open + self.tr.arrival(self.next_k)
            self._submit(self.next_k, due, self.tr.spec(self.next_k))
            self.next_k += 1

    def _next_due(self):
        if self.t_open is None or self.tr.closed:
            return None
        return self.t_open + self.tr.arrival(self.next_k)

    def open(self) -> None:
        """Traffic starts: every closed-loop client asks at once."""
        self.t_open = time.perf_counter()
        if self.tr.closed:
            self.ready = [self.t_open] * self.clients

    def load_documents(self) -> None:
        """Set-up the mix needs: each shared document served once, so its
        blocks sit in the prefix cache before traffic opens."""
        from .traffic import Spec
        self.setup_left = len(self.tr.docs)
        for i, doc in enumerate(self.tr.docs):
            self._submit(-1 - i, time.perf_counter(), Spec(-1 - i, doc, 1))
        self.pump(math.inf, stop=lambda now: self.setup_left <= 0)

    def pump(self, until: float, stop=None) -> None:
        while True:
            now = time.perf_counter()
            if now >= until or (stop is not None and stop(now)):
                return
            with self.marks("harness.submit"):
                self._feed(now)
            te = self.router.next_event_time()
            if te is not None:
                with self.marks("harness.router_step"):
                    self.router.step(te + EPS)
                continue
            nxt = self._next_due()
            wait = (min(nxt, until) if nxt is not None else now + 1e-3) - now
            if wait > 0:
                time.sleep(wait)


def _unit_runner(plane):
    return next(iter(plane.sub._runners.values()))


def meter_steps(runner, marks: Marks) -> list:
    """Wrap the unit runner's step from outside and record, for every step
    it runs, its start and end on the wall clock, its chunk launches and
    its decoding rows (for the run's log; no metric reads them), and mark
    it for the device trace's idle gaps."""
    steps: list = []
    inner = runner.exec_step

    def exec_step(plan):
        t0 = time.perf_counter()
        with marks("engine.exec_step"):
            dt = inner(plan)
        steps.append((t0, time.perf_counter(), len(plan.chunks),
                      len(plan.decode)))
        return dt
    runner.exec_step = exec_step
    return steps


def apply_fault(runner, fault: str) -> None:
    """Break the timed path underneath the harness (for the tests that show
    the correctness check fails): ``stale_state`` leaves the cache as each
    step found it (a chunk hands back no new K/V, a decode step's writes
    are undone); ``half_batch`` leaves the second half of each decode
    batch out, giving those rows the mean of the first half's logits;
    ``token_altered`` moves every produced token to the next id."""
    import torch
    chunk, pdec = runner._chunk, runner._pdec

    def bump(logits):
        idx = logits.argmax(-1, keepdim=True)
        top = logits.gather(-1, idx)
        logits.scatter_(-1, (idx + 1) % logits.shape[-1], top + 1.0)
        return logits

    if fault == "stale_state":
        def c(*args, **kw):
            logits, kn, vn = chunk(*args, **kw)
            return logits, torch.zeros_like(kn), torch.zeros_like(vn)

        def f(params, kp, vp, tabs, lens, toks):
            k0, v0 = kp.clone(), vp.clone()
            logits, _, _ = pdec(params, kp, vp, tabs, lens, toks)
            kp.copy_(k0)
            vp.copy_(v0)
            return logits, kp, vp
        runner._chunk, runner._pdec = c, f
    elif fault == "half_batch":
        def f(params, kp, vp, tabs, lens, toks):
            logits, kp, vp = pdec(params, kp, vp, tabs, lens, toks)
            half = (logits.shape[0] + 1) // 2
            logits[half:] = logits[:half].mean(0)
            return logits, kp, vp
        runner._pdec = f
    elif fault == "token_altered":
        def c(*args, **kw):
            logits, kn, vn = chunk(*args, **kw)
            return bump(logits), kn, vn

        def f(*args):
            logits, kp, vp = pdec(*args)
            return bump(logits), kp, vp
        runner._chunk, runner._pdec = c, f
    else:
        raise ValueError(f"unknown fault {fault!r}")


def pick_sample(done: list, seed: int, tokens: int, most: int) -> list:
    """Requests to judge, drawn from the seed among those answered in the
    window: the longest, one answered by a merge or the result cache if
    any was, then others until ``tokens`` served tokens or ``most``
    requests."""
    import numpy as np
    if not done:
        return []
    longest = max(done, key=lambda r: (r["prompt"] + r["served"],
                                       -r["index"]))
    pick = [longest]
    rng = np.random.default_rng(mix64(seed, 5))
    rest = [done[i] for i in rng.permutation(len(done))
            if done[i] is not longest]
    merged = [r for r in rest if r["merged"]]
    if merged:
        pick.append(merged[0])
    for r in rest:
        if sum(p["served"] for p in pick) >= tokens or len(pick) >= most:
            break
        if r not in pick:
            pick.append(r)
    return pick


def logit_gaps(reference, conf: dict, params, items, quant=None,
               judge=None) -> list:
    """For each (prompt, tokens): the largest amount by which a served
    token's reference logit lies below the reference's best at its
    position.  With ``quant`` the reference in that precision picks the
    tokens (the control) and ``judge`` holds the float32 reference's
    logits they are judged by."""
    import torch
    seqs = [tuple(p) + tuple(t[:-1]) for p, t in items]
    starts = [len(p) - 1 for p, _ in items]
    lg = reference.logits(conf, params, seqs, starts, quant=quant)
    gaps = []
    for i, (p, t) in enumerate(items):
        ref = lg[i] if judge is None else judge[i]
        if judge is None:
            tok = torch.as_tensor(t, device=ref.device)[:, None]
        else:
            tok = lg[i].argmax(-1, keepdim=True)
        gaps.append(float((ref.max(-1).values
                           - ref.gather(-1, tok)[:, 0]).max()))
    return gaps, lg


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, fault: str | None = None,
             conf: dict | None = None, log=None, keep=False) -> dict:
    """One run: set-up, the window, the per-layer readings, the check.
    Returns the result line's fields (``keep`` adds what a control needs:
    the weights and the judged requests)."""
    import torch
    from repro_torch.obs import profiling

    from .probe import DeviceTrace, StepProbe
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    conf = conf or cell.conf
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    st = cell.settings
    params = cell.family.make_weights(conf, seed, dev)
    router, plane = build_router(cell, conf, params, dev)
    runner = _unit_runner(plane)
    if fault is not None:
        apply_fault(runner, fault)
    marks = Marks()
    metered = meter_steps(runner, marks)
    tr = Traffic(cell.mix, seed, conf["vocab_size"])
    drv = Driver(router, plane, tr, int(st.get("clients", 0)), marks)
    if tr.docs:
        drv.load_documents()
    drv.open()
    drv.pump(time.perf_counter() + float(st.get("ramp_s", 0.0)))
    probe = None
    if trace:
        probe = StepProbe(conf, cell.family, runner.mp)
        profiling.install(probe)
    if cuda:
        torch.cuda.synchronize(dev)
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    s0 = plane.sub.collect_stats()
    sub0 = router.stats["submitted"]
    w1 = w0 + seconds
    dtrace = None
    if trace and cuda:
        span = min(TRACE_SPAN_S, seconds / 2)
        drv.pump(w0 + (seconds - span) / 2)
        dtrace = DeviceTrace(ROOT / "build" / "perfbench" / "trace.json")
        probe.tracing = marks.on = True
        dtrace.start()
        drv.pump(time.perf_counter() + span)
        dtrace.stop()
        probe.tracing = marks.on = False
    drv.pump(w1)
    s1 = plane.sub.collect_stats()
    sub1 = router.stats["submitted"]
    if tr.mix.get("deadline_ms") is not None:
        due = stats.due_in(drv.records, w0, w1)
        drv.pump(w1 + RESOLVE_S, stop=lambda now: all(
            stats.resolved(r, now) for r in due))
    if trace:
        profiling.install(None)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    records, reqs = drv.records, drv.reqs
    unit = {"max_batch": runner.cfgb.max_batch, "c_pad": runner.c_pad}
    late = drv.late_s
    del router, plane, runner, drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the check: served tokens against the plain reference -------------
    chk = st["check"]
    done = stats.completed_in(records, w0, w1)
    sample = pick_sample(done, seed, int(chk["tokens"]), int(chk["most"]))
    items = [(reqs[r["index"]].prompt, reqs[r["index"]].tokens)
             for r in sample]
    short = sum(len(t) != reqs[r["index"]].n_new
                for r, (_, t) in zip(sample, items))
    gaps, ref_logits = (logit_gaps(cell.reference, conf, params, items)
                        if items else ([], None))
    gap = max(gaps) if gaps else None
    checks = {"max_logit_gap": {"value": gap, "limit": chk["limit"]},
              "short_answers": {"value": short, "limit": 0},
              "judged_requests": {"value": len(items), "limit": 1}}
    correct = bool(items) and gap <= chk["limit"] and short == 0

    # -- metrics -------------------------------------------------------------
    due = stats.due_in(records, w0, w1)
    attempted = len(due)
    failed = sum(r["outcome"] == "dropped" for r in due)
    ctx = {"window_s": seconds, "w0": w0, "w1": w1, "records": records,
           "stats0": s0, "stats1": s1, "submitted": sub1 - sub0,
           "conf": conf, "family": cell.family, "unit": unit,
           "peaks": cell.peaks.get(kind), "device_kind": kind,
           "steps": probe.steps if probe else [],
           "kernels": probe.kernels if probe else {},
           "trace": dtrace.summary if dtrace else None}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else E2E[m["name"]](ctx)
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if dtrace is not None:
        sm = dtrace.summary
        device["busy_s"] = sm["busy_s"]
        device["window_s"] = sm["window_s"]
        out["breakdown"] = {"device_ops": sm["device_ops"],
                            "idle_gaps": sm["idle_gaps"]}
    out["checks"] = checks
    log(f"requests: due in window {attempted}, answered in window "
        f"{len(done)}, dropped {failed}, submitted {sub1 - sub0}, "
        f"handed over at most {late:.3f} s after due")
    ws = [x for x in metered if w0 <= x[0] and x[1] <= w1]
    log("steps in window: " + json.dumps({
        "steps": len(ws), "chunk_launches": sum(x[2] for x in ws),
        "decode_launches": sum(x[3] > 0 for x in ws),
        "decode_rows": sum(x[3] for x in ws),
        "step_wall_s": round(sum(x[1] - x[0] for x in ws), 3),
        "answered_tokens": sum(r["prompt"] + r["served"] for r in done),
        **{k: s1.get(k, 0) - s0.get(k, 0) for k in (
            "merges", "cache_hits", "prefix_hits", "prefix_tokens_reused",
            "prefix_evictions", "prefill_tokens", "completed")}}))
    if dtrace is not None:
        # launches the hook saw, launches whose work was counted, and
        # launches the device trace kept, by kernel
        log("kernels in the traced span: " + json.dumps({
            k: [v["launches"], v["counted"], dtrace.summary["kernel_n"][k]]
            for k, v in probe.kernels.items()}))
    if keep:
        out["_keep"] = {"params": params, "items": items,
                        "ref_logits": ref_logits, "gaps": gaps,
                        "records": records, "w0": w0, "w1": w1}
    return out


#: the end-to-end metrics a cell can report, by name, each from the run's
#: context
E2E = {"tokens_per_s": lambda c: stats.tokens_per_s(
           c["records"], c["w0"], c["w1"]),
       "latency_p90_ms": lambda c: stats.percentile(
           stats.latencies_ms(c["records"], c["w0"], c["w1"]), 90),
       "on_time_share": lambda c: stats.on_time_share(
           c["records"], c["w0"], c["w1"])}
