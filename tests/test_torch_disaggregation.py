"""Prefill/decode disaggregation (DESIGN.md §2.13) in the port, on the CPU,
against the JAX package (the twin of ``tests/test_disaggregation.py``).

* The port's ``Simulator`` and stub engine take JAX's ``Simulator``'s
  decisions, handoffs included, on a phase-role fleet, for each heuristic;
  a unified fleet takes no handoff.
* A retiring simulator machine hands its cached prefixes to a survivor.
* The live engine's handoff telemetry and its flow arrows.
* The decode unit's route: the boundary token the prefill unit picked is
  fed to the decode unit's first paged decode step, at the prompt's
  length, and no chunk prefills it; its K/V there are the unified run's,
  bit for bit.
* On JAX-bridged weights the port's disaggregated greedy tokens are JAX's.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.core.fleet import FleetSpec as JaxFleetSpec
from repro.core.simulation import PETOracle as JaxPETOracle
from repro.core.simulation import SimConfig as JaxSimConfig
from repro.core.simulation import Simulator as JaxSimulator
from repro.core.tasks import PETMatrix as JaxPETMatrix
from repro.core.tasks import Task as JaxTask
from repro.models import transformer as JT
from repro.serving.batching import StepBatchingConfig as JaxStepBatching
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs.registry import get_arch
from repro_torch.core.fleet import FleetSpec
from repro_torch.core.simulation import (PETOracle, SimConfig, Simulator,
                                         _SimMachinePool)
from repro_torch.core.tasks import PETMatrix, Task
from repro_torch.models import transformer as T
from repro_torch.obs import Telemetry, validate_chrome_trace
from repro_torch.obs.exporters import chrome_trace
from repro_torch.serving.batching import StepBatchingConfig
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

TINY = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
            vocab=128, head_dim=32, remat=False)
DISAGG = "m0@prefill:1,m0@decode:1"


def _toks(n, base=0):
    return tuple(range(base, base + n))


# ---------------------------------------------------------------------------
# substrate equivalence with disaggregation on, against JAX
# ---------------------------------------------------------------------------

def _pet(cls, mtypes, seed=3):
    return cls.generate(["generate"], mtypes, np.random.default_rng(seed),
                        mean_range=(8, 16))


def _request_trace(req_cls, n=40, seed=1, n_prompts=5, deadline=80.0,
                   rate=0.5):
    rng = np.random.default_rng(seed)
    # prompts longer than one KV block (16 tokens) so handoffs carry a
    # non-zero modeled transfer cost
    prompts = [tuple(rng.integers(1, 1000, size=48).tolist())
               for _ in range(n_prompts)]
    out, t = [], 0.0
    for _ in range(n):
        out.append((t, req_cls(
            prompt=prompts[int(rng.integers(0, n_prompts))], op="generate",
            n_new=int(rng.integers(1, 4)), seed=int(rng.integers(0, 2)),
            deadline=t + deadline)))
        t += float(rng.exponential(1.0 / rate))
    return out


def _mirror_tasks(task_cls, trace):
    return [task_cls(ttype=req.op, data_id=str(hash(req.prompt)), op=req.op,
                     params=req.params_sig, arrival=t, deadline=req.deadline,
                     user=f"u{i % 8}", tokens=req.prompt)
            for i, (t, req) in enumerate(trace)]


class TestDisaggTraceEquivalence:
    @pytest.mark.parametrize("heuristic", ["EDF", "MCMD"])
    def test_same_trace_same_decisions_disaggregated(self, heuristic):
        """The port's stub engine and ``Simulator`` and JAX's
        ``Simulator`` hand the same sequences off to the same machine at
        the same modeled cost, and land every decision bit-equal."""
        fleet = "pre@prefill:1,dec@decode:1"
        bat = dict(max_batch=4, step_token_budget=32)
        kw = dict(heuristic=heuristic, merging="adaptive", pruning=None)

        eng = ServingEngine(None, None, EngineConfig(
            fleet=FleetSpec.parse(fleet), elasticity=None,
            result_cache=False, prefix_cache=False,
            batching=StepBatchingConfig(**bat), **kw),
            stub_oracle=PETOracle(_pet(PETMatrix, ["pre", "dec"]), seed=11),
            device="cpu")
        eng.cp.trace = []
        stats = eng.run(_request_trace(Request))

        sim = Simulator(_mirror_tasks(Task, _request_trace(Request)),
                        FleetSpec.parse(fleet),
                        PETOracle(_pet(PETMatrix, ["pre", "dec"]), seed=11),
                        SimConfig(batching=StepBatchingConfig(**bat), **kw),
                        device="cpu")
        sim.cp.trace = []
        st = sim.run()

        jsim = JaxSimulator(
            _mirror_tasks(JaxTask, _request_trace(JaxRequest)),
            JaxFleetSpec.parse(fleet),
            JaxPETOracle(_pet(JaxPETMatrix, ["pre", "dec"]), seed=11),
            JaxSimConfig(batching=JaxStepBatching(**bat), **kw))
        jsim.cp.trace = []
        jst = jsim.run()

        assert eng.cp.trace == sim.cp.trace == jsim.cp.trace
        hand = [e for e in sim.cp.trace if e[0] == "handoff"]
        assert hand, "a disaggregated fleet must hand sequences off"
        for _, idx, dst, cost in hand:
            assert dst == 1          # the one decode machine (index 1)
            assert cost > 0          # priced by the shared transfer model
        assert (st.on_time, st.missed, st.dropped) == \
            (jst.on_time, jst.missed, jst.dropped) == \
            (stats["on_time"], stats["missed"], stats["dropped"])
        assert st.cost == pytest.approx(stats["cost"], abs=1e-9)
        assert st.cost == pytest.approx(jst.cost, abs=1e-9)

    def test_unified_fleet_traces_unchanged(self):
        """A fleet with no phase roles takes no handoff, and its trace is
        the homogeneous fleet's, in both packages."""
        bat = dict(max_batch=4, step_token_budget=32)

        def run(side, fleet):
            if side == "jax":
                sim = JaxSimulator(
                    _mirror_tasks(JaxTask, _request_trace(JaxRequest, n=25)),
                    fleet, JaxPETOracle(_pet(JaxPETMatrix, ["m0"]), seed=11),
                    JaxSimConfig(batching=JaxStepBatching(**bat),
                                 merging="adaptive"))
            else:
                sim = Simulator(
                    _mirror_tasks(Task, _request_trace(Request, n=25)),
                    fleet, PETOracle(_pet(PETMatrix, ["m0"]), seed=11),
                    SimConfig(batching=StepBatchingConfig(**bat),
                              merging="adaptive"), device="cpu")
            sim.cp.trace = []
            sim.run()
            return sim.cp.trace

        a = run("torch", FleetSpec.homogeneous(2))
        b = run("torch", FleetSpec.parse("m0:2"))
        assert a == b == run("jax", JaxFleetSpec.parse("m0:2"))
        assert not any(e[0] == "handoff" for e in a)


# ---------------------------------------------------------------------------
# retirement migrates blocks (the port's simulator pool)
# ---------------------------------------------------------------------------

def _sim(**cfg):
    return Simulator(
        [], FleetSpec.homogeneous(1),
        PETOracle(PETMatrix.generate(["generate"], ["m0"],
                                     np.random.default_rng(0))),
        SimConfig(**cfg), device="cpu")


class TestRetireMigratesBlocks:
    def test_sim_pool_shrink_rescues_cached_prefixes(self):
        sim = _sim(prefix_cache_blocks=32, kv_per_machine=True)
        pool = _SimMachinePool(sim)
        pool.grow(0.0)
        extra = sim.machines[-1]
        toks = _toks(64)
        sim.kvcaches[extra.mid].insert(toks)
        base_mid = sim.machines[0].mid
        assert sim.kvcaches[base_mid].peek(toks) == 0
        assert pool.shrink(1.0)
        # the survivor now serves the retired machine's prefix
        assert sim.kvcaches[base_mid].peek(toks) == 64
        assert extra.mid not in sim.kvcaches

    def test_sim_pool_shrink_without_survivor_caches_still_works(self):
        pool = _SimMachinePool(_sim())
        pool.grow(0.0)
        assert pool.shrink(1.0)     # no kvcaches at all: plain retire


# ---------------------------------------------------------------------------
# the live engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_model():
    cfg = get_arch("smollm-360m").reduced().scaled(**{**TINY, "n_layers": 2})
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def bridged_model():
    """The same weights in both frameworks: JAX init, bridged to torch."""
    jcfg = JAX_ARCHS["smollm-360m"].reduced().scaled(**TINY)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_arch("smollm-360m").reduced().scaled(**TINY)
    return (cfg, params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
            jcfg, jparams)


def _prompts(n, seed=7, lo=4, hi=60):
    rng = np.random.default_rng(seed)
    return [tuple(int(x) for x in
                  rng.integers(1, 127, size=rng.integers(lo, hi)))
            for _ in range(n)]


def _live_cfg(cls=EngineConfig, bat=StepBatchingConfig, fleet=None,
              max_batch=4, buckets=(1, 2, 4)):
    return cls(n_units=1, fleet=fleet, elasticity=None, merging="none",
               pruning=None, result_cache=False, max_len=96,
               batch_buckets=buckets,
               batching=bat(max_batch=max_batch, step_token_budget=16))


def test_handoff_telemetry_and_flow_arrows(tiny_model):
    cfg, params = tiny_model
    reqs = [Request(prompt=p, n_new=3, deadline=1e9)
            for p in _prompts(3, seed=5)]
    eng = ServingEngine(cfg, params, _live_cfg(
        fleet=FleetSpec.parse(DISAGG), max_batch=2, buckets=(1, 2)),
        device="cpu")
    tel = Telemetry()
    eng.attach_telemetry(tel)
    eng.run([(float(i), r) for i, r in enumerate(reqs)])
    hand = tel.events_of("handoff")
    migs = tel.events_of("kv_migrate")
    assert hand and migs
    for ev in hand:
        assert {"task", "src", "dst", "cost"} <= set(ev)
    snap = tel.metrics.snapshot()
    assert snap["counters"]["handoffs"] == len(hand)
    assert snap["counters"]["kv_migrations"] >= len(migs)
    trace = chrome_trace(tel.events)
    validate_chrome_trace(trace)
    assert any(e["ph"] == "s" for e in trace["traceEvents"])


def _recorded_run(model, reqs, fleet=None):
    """Run ``reqs`` one a tick; record, on the unit that decodes (the
    decode unit of a phase-role fleet), each chunk's (prefix length,
    tokens) and each decode row's K/V written at (length, token)."""
    cfg, params = model
    eng = ServingEngine(cfg, params, _live_cfg(
        fleet=FleetSpec.parse(fleet) if fleet else None), device="cpu")
    mid = next(m.mid for m in eng.machines if m.phase != "prefill")
    run = eng._runners[mid]
    chunks, rows = [], {}
    chunk, pdec = run._chunk, run._pdec

    def rec_chunk(p, toks, pk, pv, last=-1, kv_len=None):
        chunks.append((pk.shape[2], tuple(toks[0, :last + 1].tolist())))
        return chunk(p, toks, pk, pv, last=last, kv_len=kv_len)

    def rec_pdec(p, kp, vp, tabs, lens, toks):
        out = pdec(p, kp, vp, tabs, lens, toks)
        ps = kp.shape[2]
        for i, (n, t) in enumerate(zip(lens.tolist(), toks.tolist())):
            if tabs[i, 0] == 0:
                continue                # a pad row
            page = int(tabs[i, n // ps])
            rows[(n, t)] = (out[1][:, page, n % ps].clone(),
                            out[2][:, page, n % ps].clone())
        return out

    run._chunk, run._pdec = rec_chunk, rec_pdec
    eng.cp.trace = []
    stats = eng.run([(float(i), r) for i, r in enumerate(reqs)])
    return eng, stats, chunks, rows


class TestLiveHandoffRoute:
    def test_boundary_token_runs_through_the_paged_decode_step(
            self, tiny_model):
        """The decode unit prefills only prompt tokens (on top of the
        migrated blocks) and feeds the boundary token to its first paged
        decode step at the prompt's length; the K/V that step writes for
        it, and for every later token, are the unified run's bit for
        bit, and so are the greedy tokens."""
        prompts = _prompts(6)
        uni = [Request(prompt=p, n_new=4, deadline=1e9) for p in prompts]
        dis = [Request(prompt=p, n_new=4, deadline=1e9) for p in prompts]
        _, s0, _, urows = _recorded_run(tiny_model, uni)
        eng, s1, chunks, drows = _recorded_run(tiny_model, dis, DISAGG)
        assert s0["completed"] == s1["completed"] == len(prompts)
        assert len([e for e in eng.cp.trace if e[0] == "handoff"]) == \
            len(prompts)
        assert [r.tokens for r in dis] == [r.tokens for r in uni]
        for p0, toks in chunks:
            # every chunk on the decode unit is a run of one prompt
            assert any(p[p0:p0 + len(toks)] == toks for p in prompts), \
                (p0, toks)
        assert drows
        for p, r in zip(prompts, dis):
            fed = [(len(p) + j, t) for j, t in enumerate(r.tokens[:-1])]
            assert fed[0] in drows, "the boundary token skipped the decode"
            for key in fed:
                for got, want in zip(drows[key], urows[key]):
                    assert torch.equal(got, want), key

    def test_disaggregated_tokens_equal_jax(self, bridged_model):
        """The same phase-role fleet and trace in both packages on the
        same weights: the same greedy tokens and the same handoffs."""
        cfg, params, jcfg, jparams = bridged_model
        prompts = _prompts(6, seed=21)
        reqs = [Request(prompt=p, n_new=4, deadline=1e9) for p in prompts]
        jreqs = [JaxRequest(prompt=p, n_new=4, deadline=1e9)
                 for p in prompts]
        eng = ServingEngine(cfg, params, _live_cfg(
            fleet=FleetSpec.parse(DISAGG)), device="cpu")
        jeng = JaxServingEngine(jcfg, jparams, _live_cfg(
            JaxEngineConfig, JaxStepBatching,
            fleet=JaxFleetSpec.parse(DISAGG)))
        eng.cp.trace, jeng.cp.trace = [], []
        s = eng.run([(float(i), r) for i, r in enumerate(reqs)])
        js = jeng.run([(float(i), r) for i, r in enumerate(jreqs)])
        assert s["completed"] == js["completed"] == len(prompts)
        assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
        hand = [e[:3] for e in eng.cp.trace if e[0] == "handoff"]
        assert hand == [e[:3] for e in jeng.cp.trace if e[0] == "handoff"]
        assert len(hand) == len(prompts)
