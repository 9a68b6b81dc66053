"""The port's front door (``repro_torch.serving.cluster``) and simulator
(``repro_torch.core.simulation``) on the CPU, against the JAX package.

* A 1-plane port ``Router`` reproduces the port's bare engine for every
  policy (the twin of ``tests/test_cluster.py``'s single-plane oracle).
* Port and JAX routers over stub planes take the same routing and control
  decisions.
* The port's ``Simulator`` yields the JAX ``Simulator``'s decision trace on
  the same ``PETMatrix`` draws and trace, and the port's stub engine yields
  the port ``Simulator``'s (the twin of ``tests/test_controlplane.py``).
* Live 2-plane routers of both packages serve a tiny model with bridged
  weights: the same routing decisions, the same per-plane counters and
  the same greedy tokens up to a near-tie of the logits.
* A disaggregated prefill→decode handoff keeps the port's greedy tokens
  equal to the unified run (the twin of ``tests/test_disaggregation.py``).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.core.fleet import FleetSpec as JaxFleetSpec
from repro.core.pruning import PruningConfig as JaxPruningConfig
from repro.core.simulation import PETOracle as JaxPETOracle
from repro.core.simulation import SimConfig as JaxSimConfig
from repro.core.simulation import Simulator as JaxSimulator
from repro.core.tasks import PETMatrix as JaxPETMatrix
from repro.core.tasks import Task as JaxTask
from repro.models import transformer as JT
from repro.serving.cluster import Router as JaxRouter
from repro.serving.cluster import make_engine_planes as jax_engine_planes
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs.registry import get_arch
from repro_torch.core.fleet import FleetSpec
from repro_torch.core.pruning import PruningConfig
from repro_torch.core.simulation import PETOracle, SimConfig, Simulator
from repro_torch.core.tasks import PETMatrix, Task
from repro_torch.serving.batching import StepBatchingConfig
from repro_torch.serving.cluster import (ROUTER_POLICIES, Plane, Router,
                                         make_engine_plane_factory,
                                         make_engine_planes)
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

TINY = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
            vocab=128, head_dim=32, remat=False)


class _Side:
    """One package's classes, so a test body runs unchanged on both."""

    def __init__(self, side: str):
        if side == "jax":
            self.PETMatrix, self.PETOracle = JaxPETMatrix, JaxPETOracle
            self.Simulator, self.SimConfig = JaxSimulator, JaxSimConfig
            self.Task, self.FleetSpec = JaxTask, JaxFleetSpec
            self.PruningConfig = JaxPruningConfig
            self.EngineConfig, self.Request = JaxEngineConfig, JaxRequest
            self.ServingEngine, self.Router = JaxServingEngine, JaxRouter
            self.extra = {}
        else:
            self.PETMatrix, self.PETOracle = PETMatrix, PETOracle
            self.Simulator, self.SimConfig = Simulator, SimConfig
            self.Task, self.FleetSpec = Task, FleetSpec
            self.PruningConfig = PruningConfig
            self.EngineConfig, self.Request = EngineConfig, Request
            self.ServingEngine, self.Router = ServingEngine, Router
            self.extra = {"device": "cpu"}

    def pet(self, seed=3, mean_range=(8, 16)):
        return self.PETMatrix.generate(["generate"], ["m0"],
                                       np.random.default_rng(seed),
                                       mean_range=mean_range)

    def stub_engine(self, pet, n_units=2, oracle_seed=11, **cfg_kw):
        cfg_kw.setdefault("heuristic", "EDF")
        cfg_kw.setdefault("merging", "adaptive")
        return self.ServingEngine(None, None, self.EngineConfig(
            n_units=n_units, elasticity=None, result_cache=False,
            prefix_cache=False, **cfg_kw),
            stub_oracle=self.PETOracle(pet, seed=oracle_seed), **self.extra)

    def trace(self, n=40, seed=1, n_prompts=4, deadline=200.0, gap=1.0):
        rng = np.random.default_rng(seed)
        prompts = [tuple(rng.integers(1, 1000, size=8).tolist())
                   for _ in range(n_prompts)]
        out, t = [], 0.0
        for _ in range(n):
            out.append((t, self.Request(
                prompt=prompts[int(rng.integers(0, n_prompts))],
                op="generate", n_new=int(rng.integers(1, 4)),
                seed=int(rng.integers(0, 2)), deadline=t + deadline)))
            t += float(rng.exponential(gap))
        return out

    def mirror_tasks(self, trace):
        """Simulator tasks built exactly as the engine's ingest does."""
        return [self.Task(ttype=req.op, data_id=str(hash(req.prompt)),
                          op=req.op, params=req.params_sig, arrival=t,
                          deadline=req.deadline, user=f"u{i % 8}",
                          tokens=req.prompt)
                for i, (t, req) in enumerate(trace)]


PORT, JAX = _Side("torch"), _Side("jax")


# ---------------------------------------------------------------------------
# stub planes
# ---------------------------------------------------------------------------

class TestSinglePlaneEquivalence:
    @pytest.mark.parametrize("policy", sorted(ROUTER_POLICIES))
    def test_router_reproduces_bare_engine(self, policy):
        """Decision trace and QoS of a 1-plane port Router == the port's
        bare stub engine on the same trace and oracle."""
        pet = PORT.pet()
        bare = PORT.stub_engine(pet)
        bare.cp.trace = []
        s_bare = bare.run(PORT.trace())

        eng = PORT.stub_engine(pet)
        eng.cp.trace = []
        s_r = Router([Plane(eng)], policy=policy).run(PORT.trace())

        assert eng.cp.trace == bare.cp.trace
        assert (s_r["on_time"], s_r["missed"], s_r["dropped"]) == \
            (s_bare["on_time"], s_bare["missed"], s_bare["dropped"])
        assert s_r["merges"] == s_bare["merges"] > 0
        assert s_r["merge_rejected"] == s_bare["merge_rejected"]
        assert s_r["executions"] == s_bare["executions"]
        assert s_r["deadlock_breaks"] == 0


class TestRouterAgainstJax:
    @pytest.mark.parametrize("policy", sorted(ROUTER_POLICIES))
    def test_two_stub_planes_same_decisions(self, policy):
        """Two stub planes behind each package's Router: the same routing
        decisions, control traces and aggregate counters."""
        runs = []
        for side in (JAX, PORT):
            pet = side.pet()
            engs = [side.stub_engine(pet, n_units=1, oracle_seed=11 + i)
                    for i in range(2)]
            for e in engs:
                e.cp.trace = []
            router = side.Router(engs, policy=policy)
            stats = router.run(side.trace(n=48, gap=0.5))
            runs.append((router.decisions, [e.cp.trace for e in engs],
                         {k: stats[k] for k in (
                             "completed", "on_time", "missed", "dropped",
                             "merges", "executions")},
                         stats["router"]))
        assert runs[0][0], "empty routing trace"
        assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

EQUIV_CONFIGS = [
    dict(heuristic="EDF", merging="adaptive", position_finder=None,
         pruning=None),
    dict(heuristic="FCFS-RR", merging="aggressive", position_finder="linear",
         pruning=None),
    dict(heuristic="MSD", merging="conservative", position_finder=None,
         pruning="msd"),
]
EQUIV_IDS = ["edf-adaptive", "fcfs-aggr-pfind", "msd-conservative-pruned"]


def _cfg_kw(side, kw):
    kw = dict(kw)
    if kw["pruning"] is not None:
        kw["pruning"] = side.PruningConfig(initial_defer_threshold=0.1,
                                           base_drop_threshold=0.05,
                                           dynamic_defer=True)
    return kw


def _simulate(side, kw, trace, n_units=2):
    sim = side.Simulator(side.mirror_tasks(trace),
                         side.FleetSpec.homogeneous(n_units),
                         side.PETOracle(side.pet(), seed=11),
                         side.SimConfig(hard_deadlines=kw["pruning"]
                                        is not None, **kw))
    sim.cp.trace = []
    return sim, sim.run()


class TestSimulator:
    @pytest.mark.parametrize("cfg_kw", EQUIV_CONFIGS, ids=EQUIV_IDS)
    def test_same_decisions_as_jax_simulator(self, cfg_kw):
        out = []
        for side in (JAX, PORT):
            sim, st = _simulate(side, _cfg_kw(side, cfg_kw),
                                side.trace(n=40, deadline=80.0, gap=2.0))
            out.append((sim.cp.trace, (st.on_time, st.missed, st.dropped,
                                       st.merges, st.merge_rejected)))
        assert out[0][0], "empty decision trace"
        assert out[0] == out[1]

    @pytest.mark.parametrize("cfg_kw", EQUIV_CONFIGS, ids=EQUIV_IDS)
    def test_stub_engine_matches_simulator(self, cfg_kw):
        """The port's stub engine and the port's simulator take the same
        decisions on the same trace and oracle."""
        kw = _cfg_kw(PORT, cfg_kw)
        trace = PORT.trace(n=40, deadline=80.0, gap=2.0)
        eng = PORT.ServingEngine(None, None, EngineConfig(
            n_units=2, elasticity=None, result_cache=False,
            prefix_cache=False, **kw),
            stub_oracle=PETOracle(PORT.pet(), seed=11), device="cpu")
        eng.cp.trace = []
        stats = eng.run(trace)
        sim, st = _simulate(PORT, kw, trace)
        assert sim.cp.trace == eng.cp.trace
        assert {e[0] for e in sim.cp.trace} >= {"start", "finish"}
        assert (st.on_time, st.missed, st.dropped, st.merges) == \
            (stats["on_time"], stats["missed"], stats["dropped"],
             stats["merges"])
        assert stats["deadlock_breaks"] == 0 == st.deadlock_breaks


# ---------------------------------------------------------------------------
# live engine planes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bridged_model():
    """The same weights in both frameworks: JAX init, bridged to torch."""
    jcfg = JAX_ARCHS["smollm-360m"].reduced().scaled(**TINY)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_arch("smollm-360m").reduced().scaled(**TINY)
    return (cfg, params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
            jcfg, jparams)


def _waves(req_cls, n_waves=4, seed=5):
    """Waves 1000 ticks apart, each finished before the next arrives, so
    the decisions do not depend on the measured walls: every wave sends
    two identical requests (a merge) and two others, all over two shared
    16-token system prompts (prefix hits from the second wave on)."""
    rng = np.random.default_rng(seed)
    systems = [tuple(int(x) for x in rng.integers(1, 127, 16))
               for _ in range(2)]
    out = []
    for w in range(n_waves):
        t = 1000.0 * w
        prompts = [systems[w % 2] + tuple(int(x) for x in
                                          rng.integers(1, 127, 5))
                   for _ in range(3)]
        for p in (prompts[0], prompts[0], prompts[1], prompts[2]):
            out.append((t, req_cls(prompt=p, n_new=3, deadline=t + 1e6)))
    return out


#: two bf16 ulps of a logit of magnitude 2-4: XLA and PyTorch round bf16
#: at different places, so the two frameworks' logits differ by about one
#: ulp (0.0195 at most on this model) and a top-2 gap below this may flip
NEAR_TIE = 2 ** -5


def _clear_steps(jcfg, jparams, prompt, tokens) -> int:
    """Greedy steps of the JAX model, teacher-forced on ``tokens``, before
    the first whose top-2 logit gap is a near-tie (all of them if none)."""
    logits, cache = JT.prefill_fn(jcfg)(
        jparams, {"tokens": jax.numpy.asarray([prompt])}, len(prompt) + 8)
    for i, tok in enumerate(tokens):
        top2 = np.sort(np.asarray(logits[0], np.float32))[-2:]
        if top2[1] - top2[0] < NEAR_TIE:
            return i
        logits, cache = JT.decode_fn(jcfg)(jparams, cache,
                                           jax.numpy.asarray([tok]))
    return len(tokens)


def _live_cfg(cls):
    return cls(n_units=1, elasticity=None, heuristic="EDF",
               merging="adaptive", pruning=None, result_cache=False,
               max_len=48, batch_buckets=(1, 2, 4), kv_block_size=8)


class TestLivePlanes:
    def test_two_planes_match_jax(self, bridged_model):
        cfg, params, jcfg, jparams = bridged_model
        trace = _waves(Request)
        jtrace = _waves(JaxRequest)
        router = Router(make_engine_planes(cfg, params, _live_cfg(
            EngineConfig), 2, device="cpu"), policy="affinity")
        jrouter = JaxRouter(jax_engine_planes(jcfg, jparams, _live_cfg(
            JaxEngineConfig), 2), policy="affinity")
        s = router.run(trace)
        js = jrouter.run(jtrace)
        assert s["completed"] == js["completed"] == len(trace)
        assert all(len(r.tokens) == 3 for _, r in trace)
        compared = 0
        for (_, r), (_, jr) in zip(trace, jtrace):
            n = _clear_steps(jcfg, jparams, jr.prompt, jr.tokens)
            assert r.tokens[:n] == jr.tokens[:n]
            compared += n
        assert compared >= 0.75 * 3 * len(trace), "near-ties should be rare"
        assert router.decisions == jrouter.decisions
        keys = ("completed", "dropped", "merges", "prefix_hits",
                "prefix_tokens_reused", "executions")
        per = [{k: p[k] for k in keys} for p in s["planes"]]
        assert per == [{k: p[k] for k in keys} for p in js["planes"]]
        assert s["merges"] > 0 and s["prefix_hits"] > 0

    def test_planes_share_step_functions_on_one_device(self, bridged_model):
        """Plane 1 warm-starts from plane 0's step functions, and every
        engine — and every unit a plane factory adds — runs on the device
        the planes were given."""
        cfg, params = bridged_model[:2]
        ecfg = _live_cfg(EngineConfig)
        planes = make_engine_planes(cfg, params, ecfg, 2, device="cpu")
        p0, p1 = (p.sub for p in planes)
        assert p1.stats["warm_starts"] == 1 and p1.stats["cold_starts"] == 0
        assert p1.units[0].fns == p0.units[0].fns
        eng = make_engine_plane_factory(cfg, params, ecfg,
                                        warm_fns=p0.warm_fns,
                                        device="cpu")(2)
        assert eng.units[0].fns == p0.units[0].fns
        for e in (p0, p1, eng):
            assert e.device == torch.device("cpu")
            assert all(u.device == torch.device("cpu") for u in e.units)

    def test_engine_planes_default_to_cuda(self, bridged_model):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device exists")
        cfg, params = bridged_model[:2]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_engine_planes(cfg, params, _live_cfg(EngineConfig), 1)
        factory = make_engine_plane_factory(cfg, params,
                                            _live_cfg(EngineConfig))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            factory(1)

    def test_cache_off_gives_the_same_tokens(self, bridged_model):
        """The one-at-a-time path behind the Router: greedy tokens with the
        prefix cache on equal those with it off."""
        cfg, params = bridged_model[:2]
        runs = []
        for prefix_cache in (True, False):
            ecfg = _live_cfg(EngineConfig)
            ecfg.prefix_cache = prefix_cache
            trace = _waves(Request, n_waves=3, seed=8)
            stats = Router(make_engine_planes(cfg, params, ecfg, 2,
                                              device="cpu"),
                           policy="affinity").run(trace)
            runs.append((stats["prefix_hits"], [r.tokens for _, r in trace]))
        assert runs[0][0] > 0 and runs[1][0] == 0
        assert runs[0][1] == runs[1][1]


def _prompts(n, seed=7, lo=4, hi=60):
    rng = np.random.default_rng(seed)
    return [tuple(int(x) for x in
                  rng.integers(1, 127, size=rng.integers(lo, hi)))
            for _ in range(n)]


class TestLiveHandoffTokenIdentity:
    def test_disaggregated_tokens_bitwise_equal_unified(self, bridged_model):
        """A prefill unit produces the boundary token, the KV blocks
        migrate between page arenas, and the decode unit finishes the
        sequence: greedy tokens equal to the unified single-unit run."""
        cfg, params = bridged_model[:2]

        def run(reqs, fleet=None):
            eng = ServingEngine(cfg, params, EngineConfig(
                n_units=1, fleet=fleet, elasticity=None, merging="none",
                pruning=None, result_cache=False, max_len=96,
                batch_buckets=(1, 2, 4),
                batching=StepBatchingConfig(max_batch=4,
                                            step_token_budget=16)),
                device="cpu")
            eng.cp.trace = []
            return eng, eng.run([(float(i), r) for i, r in enumerate(reqs)])

        prompts = _prompts(6)
        uni = [Request(prompt=p, n_new=4, deadline=1e9) for p in prompts]
        dis = [Request(prompt=p, n_new=4, deadline=1e9) for p in prompts]
        _, s0 = run(uni)
        eng, s1 = run(dis, FleetSpec.parse("m0@prefill:1,m0@decode:1"))
        assert s0["completed"] == s1["completed"] == len(prompts)
        for a, b in zip(uni, dis):
            assert a.tokens == b.tokens
            assert len(b.tokens) == 4
        assert len([e for e in eng.cp.trace if e[0] == "handoff"]) == \
            len(prompts)
        phases = {m.phase: m.mid for m in eng.machines}
        src_c = eng.kvcaches[phases["prefill"]]
        dst_c = eng.kvcaches[phases["decode"]]
        assert src_c.stats["migrated_out"] > 0
        assert dst_c.stats["migrated_in"] == src_c.stats["migrated_out"]
        assert dst_c.stats["tokens_reused"] > 0
