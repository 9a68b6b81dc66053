"""The port's serving engine on the CPU, and against the JAX engine.

* Batched greedy tokens equal sequential ones bitwise (the twin of
  ``test_batching.py::TestTokenIdentity``).
* The port and the JAX engine give equal greedy tokens on the same trace
  and the same (bridged) weights.
* The torch stub engine yields the same ``ControlPlane.trace`` as the JAX
  stub engine (both fed identical PET matrices), with batching off and on.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.core.simulation import PETOracle as JaxPETOracle
from repro.core.tasks import PETMatrix as JaxPETMatrix
from repro.models import transformer as JT
from repro.serving.batching import StepBatchingConfig as JaxStepBatching
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.bridge import params_from_jax, to_tensor
from repro_torch.configs.registry import get_arch
from repro_torch.core.pruning import PruningConfig
from repro_torch.core.simulation import PETOracle
from repro_torch.core.tasks import PETMatrix
from repro_torch.models import transformer as T
from repro_torch.obs import Telemetry
from repro_torch.serving.autoscale import ElasticityConfig
from repro_torch.serving.batching import StepBatchingConfig
from repro_torch.serving.engine import (EngineConfig, Request, ServingEngine,
                                        TimeEstimator)

TINY = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
            vocab=128, head_dim=32, remat=False)


@pytest.fixture(scope="module")
def tiny_model():
    cfg = get_arch("smollm-360m").reduced().scaled(**TINY)
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


def _engine_cfg(batching, cls=EngineConfig):
    return cls(n_units=1, elasticity=None, merging="none", pruning=None,
               result_cache=False, max_len=96, batch_buckets=(1, 2, 4),
               batching=batching)


def _run(model, reqs, batching=None, device="cpu"):
    cfg, params = model
    eng = ServingEngine(cfg, params, _engine_cfg(batching), device=device)
    stats = eng.run([(float(i), r) for i, r in enumerate(reqs)])
    return eng, stats


class TestTokenIdentity:
    @pytest.mark.parametrize("budget,max_batch", [(16, 4), (7, 8), (64, 2)])
    def test_batched_equals_sequential_greedy(self, tiny_model, budget,
                                              max_batch):
        prompts = _prompts(8)
        seq_reqs = [Request(prompt=p, n_new=4, deadline=1e9)
                    for p in prompts]
        bat_reqs = [Request(prompt=p, n_new=4, deadline=1e9)
                    for p in prompts]
        _, s0 = _run(tiny_model, seq_reqs)
        _, s1 = _run(tiny_model, bat_reqs,
                     StepBatchingConfig(max_batch=max_batch,
                                        step_token_budget=budget))
        assert s0["completed"] == s1["completed"] == len(prompts)
        for a, b in zip(seq_reqs, bat_reqs):
            assert a.tokens == b.tokens
            assert len(b.tokens) == 4

    @pytest.mark.parametrize("batched", [True, False])
    def test_prefix_hits_keep_tokens(self, tiny_model, batched):
        """Shared system prompts: later requests attach cached KV blocks
        (chunked prefill on a prefix, or ``prefill_from_cache`` on the
        exclusive path) and still produce the tokens of a cache-less run."""
        rng = np.random.default_rng(3)
        sys_p = [tuple(int(x) for x in rng.integers(1, 127, 32))
                 for _ in range(2)]
        prompts = [sys_p[i % 2] + tuple(int(x) for x in
                                        rng.integers(1, 127, 5))
                   for i in range(6)]
        bat = StepBatchingConfig(max_batch=4, step_token_budget=16) \
            if batched else None
        cfg, params = tiny_model
        runs = []
        for prefix_cache in (True, False):
            ec = _engine_cfg(bat)
            ec.prefix_cache = prefix_cache
            eng = ServingEngine(cfg, params, ec, device="cpu")
            reqs = [Request(prompt=p, n_new=3, deadline=1e9)
                    for p in prompts]
            stats = eng.run([(20.0 * i, r) for i, r in enumerate(reqs)])
            runs.append((stats, [r.tokens for r in reqs]))
        assert runs[0][0]["prefix_hits"] > 0
        assert runs[0][1] == runs[1][1]

    def test_sampled_requests_fall_back_to_exclusive(self, tiny_model):
        prompts = _prompts(3, seed=3)
        reqs = [Request(prompt=p, n_new=3, temperature=0.8, seed=i)
                for i, p in enumerate(prompts)]
        _, stats = _run(tiny_model, reqs,
                        StepBatchingConfig(max_batch=4, step_token_budget=16))
        assert stats["completed"] == 3
        assert all(len(r.tokens) == 3 for r in reqs)

    def test_score_requests(self, tiny_model):
        reqs = [Request(prompt=p, op="score") for p in _prompts(2, seed=4)]
        _, stats = _run(tiny_model, reqs)
        assert stats["completed"] == 2
        assert all(r.logprobs is not None and r.logprobs <= 0.0
                   for r in reqs)

    def test_live_engine_calibrates_on_warmup(self, tiny_model):
        cfg, params = tiny_model
        eng = ServingEngine(cfg, params, _engine_cfg(
            StepBatchingConfig(max_batch=2)), device="cpu")
        est = eng.estimator
        assert (est.prefill_rate, est.decode_rate) != \
            (TimeEstimator().prefill_rate, TimeEstimator().decode_rate)
        assert est.prefill_rate > 0 and est.decode_rate > 0

    def test_success_chance_elasticity_runs_pmf_conv(self, tiny_model):
        """The Ch. 5 success-chance signal evaluates through the port's
        ``pmf_conv`` (its plain version on the CPU) under pruning."""
        cfg, params = tiny_model
        eng = ServingEngine(cfg, params, EngineConfig(
            n_units=1, max_len=96, batch_buckets=(1, 2, 4),
            batching=StepBatchingConfig(max_batch=4, step_token_budget=32),
            pruning=PruningConfig(initial_defer_threshold=0.1,
                                  base_drop_threshold=0.05),
            elasticity=ElasticityConfig(policy="success-chance",
                                        max_extra=1, cooldown=50.0)),
            device="cpu")
        reqs = [Request(prompt=p, n_new=4, deadline=float(i) + 300.0)
                for i, p in enumerate(_prompts(10, seed=5))]
        stats = eng.run([(0.5 * i, r) for i, r in enumerate(reqs)])
        assert stats["scale_decisions"] > 0
        assert stats["completed"] + stats["dropped"] == len(reqs)

    def test_model_engine_needs_a_device(self, tiny_model):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device exists")
        cfg, params = tiny_model
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServingEngine(cfg, params, _engine_cfg(None))

    @pytest.mark.parametrize("entry", ["init_params", "init_cache",
                                       "init_paged_cache", "to_tensor",
                                       "params_from_jax"])
    def test_weights_and_caches_need_a_device(self, entry):
        """Without ``device`` these build on CUDA, and raise without a
        card instead of quietly building on the host."""
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device exists")
        cfg = get_arch("smollm-360m").reduced().scaled(**TINY)
        calls = {
            "init_params": lambda: T.init_params(cfg, torch.Generator()),
            "init_cache": lambda: T.init_cache(cfg, 1, 8),
            "init_paged_cache": lambda: T.init_paged_cache(cfg, 3, 4),
            "to_tensor": lambda: to_tensor(np.zeros(3, np.float32)),
            "params_from_jax": lambda: params_from_jax(
                {"w": np.zeros(3, np.float32)}),
        }
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            calls[entry]()


    def test_warmup_runs_whole_executes_and_leaves_no_trace(self,
                                                            tiny_model,
                                                            monkeypatch):
        """The warm-up runs one whole ``execute`` per bucket (prefill,
        decode, token picks, log-softmax, results) and leaves nothing
        behind: no request counted, no prefix-cache entry, no telemetry
        event or metric, no estimator cell, the engine's sampling stream
        untouched."""
        cfg, params = tiny_model
        eng = ServingEngine(cfg, params, EngineConfig(
            n_units=1, elasticity=None, max_len=96,
            batch_buckets=(1, 2, 4)), device="cpu")
        tel = Telemetry()
        eng.attach_telemetry(tel)
        unit = eng.units[0]
        cache = eng.kvcaches[unit.machine.mid]
        stats = eng.collect_stats()
        kv_stats, ewma = dict(cache.stats), dict(eng.estimator._ewma)
        rng_state = eng._rng.bit_generator.state
        seen = []
        execute = unit.execute

        def spy(task, reqs, rng, buckets=(1, 2, 4, 8), prefix=None):
            out = execute(task, reqs, rng, buckets=buckets, prefix=prefix)
            seen.append((len(reqs), [len(r.tokens) for r in reqs]))
            return out
        monkeypatch.setattr(unit, "execute", spy)
        assert unit.warmup(buckets=(1, 2, 4)) > 0
        assert seen == [(1, [2]), (2, [2, 2]), (4, [2, 2, 2, 2])]
        assert eng.collect_stats() == stats
        assert stats["completed"] == stats["executions"] == 0
        assert dict(cache.stats) == kv_stats and cache.pool.n_used == 0
        assert eng.estimator._ewma == ewma == {}
        assert eng._rng.bit_generator.state == rng_state
        assert tel.events == [] and tel.metrics.snapshot() == \
            Telemetry().metrics.snapshot()


# ---------------------------------------------------------------------------
# the other families: one request (or merged task) at a time
# ---------------------------------------------------------------------------

FAMILY_TINY = dict(d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
                   remat=False)
STATEFUL = ["deepseek-moe-16b", "llama4-maverick-400b-a17b", "zamba2-2.7b",
            "xlstm-125m"]


@pytest.fixture(scope="module")
def family_models():
    out = {}
    for name in STATEFUL + ["llava-next-34b", "seamless-m4t-medium"]:
        cfg = get_arch(name).reduced().scaled(**FAMILY_TINY)
        out[name] = (cfg, T.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"))
    return out


class TestFamilies:
    @pytest.mark.parametrize("name", STATEFUL)
    def test_served_alone_equals_a_direct_greedy_run(self, family_models,
                                                     name):
        """moe, hybrid and xLSTM units prefill each prompt at its own
        length (``prefill_fn``), with the prefix cache off; a request
        served alone (bucket 1) gets the tokens of a direct
        ``prefill_fn`` + ``decode_fn`` greedy run at the unit's shapes."""
        cfg, params = family_models[name]
        eng = ServingEngine(cfg, params, EngineConfig(
            n_units=1, elasticity=None, merging="none", pruning=None,
            result_cache=False, max_len=48, batch_buckets=(1, 2),
            prefix_cache=True), device="cpu")
        assert eng.kvcache is None and not eng.kvcaches
        prompts = _prompts(4, seed=11, lo=3, hi=30)
        reqs = [Request(prompt=p, n_new=3, deadline=1e9) for p in prompts]
        stats = eng.run([(100.0 * i, r) for i, r in enumerate(reqs)])
        assert stats["completed"] == len(reqs)
        pre, dec = T.prefill_fn(cfg), T.decode_fn(cfg)
        for r in reqs:
            logits, cache = pre(params, {"tokens": torch.tensor([r.prompt])},
                                48)
            want = []
            for _ in range(3):
                cur = logits.argmax(-1)
                want.append(int(cur[0]))
                logits, cache = dec(params, cache, cur)
            assert r.tokens == want

    def test_vlm_serves_tokens_through_the_fixed_shape_route(
            self, family_models):
        """vlm units take the dense route (``chunk_prefill_fn`` on embedded
        tokens, the prefix cache on), as the JAX unit serves vlm."""
        cfg, params = family_models["llava-next-34b"]
        rng = np.random.default_rng(3)
        sys_p = tuple(int(x) for x in rng.integers(1, 127, 32))
        reqs = [Request(prompt=sys_p + (40 + i, 41 + i), n_new=2,
                        deadline=1e9) for i in range(3)]
        eng = ServingEngine(cfg, params, _engine_cfg(None), device="cpu")
        stats = eng.run([(50.0 * i, r) for i, r in enumerate(reqs)])
        assert stats["completed"] == 3 and stats["prefix_hits"] == 2
        assert all(len(r.tokens) == 2 for r in reqs)

    @pytest.mark.parametrize("name", ["deepseek-moe-16b", "zamba2-2.7b",
                                      "xlstm-125m"])
    def test_step_batching_refuses_as_jax_does(self, family_models, name):
        """Continuous batching needs the paged arena, which these families
        do not have: the unit runner fails on ``init_paged_cache`` with the
        JAX words."""
        cfg, params = family_models[name]
        jcfg = JAX_ARCHS[name].reduced()
        with pytest.raises(ValueError) as theirs:
            JT.init_paged_cache(jcfg, 3, 4)
        with pytest.raises(ValueError, match="paged cache unsupported") \
                as ours:
            ServingEngine(cfg, params, _engine_cfg(
                StepBatchingConfig(max_batch=2)), device="cpu")
        assert str(ours.value) == str(theirs.value)

    def test_encdec_needs_encoder_frames(self, family_models):
        cfg, params = family_models["seamless-m4t-medium"]
        with pytest.raises(ValueError, match="enc_embeds"):
            ServingEngine(cfg, params, _engine_cfg(None), device="cpu")


# ---------------------------------------------------------------------------
# port engine vs JAX engine
# ---------------------------------------------------------------------------

class TestAgainstJax:
    @pytest.mark.parametrize("batched", [False, True])
    def test_same_greedy_tokens(self, bridged_model, batched):
        cfg, params, jcfg, jparams = bridged_model
        prompts = _prompts(6, seed=21)
        reqs = [Request(prompt=p, n_new=4, deadline=1e9) for p in prompts]
        jreqs = [JaxRequest(prompt=p, n_new=4, deadline=1e9)
                 for p in prompts]
        bat = dict(max_batch=4, step_token_budget=16)
        eng = ServingEngine(cfg, params, _engine_cfg(
            StepBatchingConfig(**bat) if batched else None), device="cpu")
        jeng = JaxServingEngine(jcfg, jparams, _engine_cfg(
            JaxStepBatching(**bat) if batched else None, JaxEngineConfig))
        s = eng.run([(float(i), r) for i, r in enumerate(reqs)])
        js = jeng.run([(float(i), r) for i, r in enumerate(jreqs)])
        assert s["completed"] == js["completed"] == len(prompts)
        assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]


# ---------------------------------------------------------------------------
# stub engines: the same decisions in both packages
# ---------------------------------------------------------------------------

def _request_trace(req_cls, n=40, seed=1, n_prompts=5, deadline=80.0,
                   rate=0.5):
    rng = np.random.default_rng(seed)
    prompts = [tuple(rng.integers(1, 1000, size=8).tolist())
               for _ in range(n_prompts)]
    out, t = [], 0.0
    for _ in range(n):
        out.append((t, req_cls(
            prompt=prompts[int(rng.integers(0, n_prompts))], op="generate",
            n_new=int(rng.integers(1, 4)), seed=int(rng.integers(0, 2)),
            deadline=t + deadline)))
        t += float(rng.exponential(1.0 / rate))
    return out


STUB_CFGS = [
    dict(heuristic="EDF", merging="adaptive", pruning=None),
    dict(heuristic="MSD", merging="conservative", pruning="msd"),
]


class TestStubTraceEquivalence:
    @pytest.mark.parametrize("batched", [False, True])
    @pytest.mark.parametrize("kw", STUB_CFGS, ids=["edf-adaptive",
                                                   "msd-pruned"])
    def test_same_control_plane_trace(self, kw, batched):
        from repro.core.pruning import PruningConfig as JaxPruningConfig
        traces = []
        for side in ("jax", "torch"):
            if side == "jax":
                pet = JaxPETMatrix.generate(
                    ["generate"], ["m0"], np.random.default_rng(3),
                    mean_range=(8, 16))
                oracle = JaxPETOracle(pet, seed=11)
                prc, ecfg, eng_cls, req_cls, bat_cls = (
                    JaxPruningConfig, JaxEngineConfig, JaxServingEngine,
                    JaxRequest, JaxStepBatching)
                extra = {}
            else:
                pet = PETMatrix.generate(
                    ["generate"], ["m0"], np.random.default_rng(3),
                    mean_range=(8, 16))
                oracle = PETOracle(pet, seed=11)
                prc, ecfg, eng_cls, req_cls, bat_cls = (
                    PruningConfig, EngineConfig, ServingEngine, Request,
                    StepBatchingConfig)
                extra = {"device": "cpu"}
            pruning = None if kw["pruning"] is None else prc(
                initial_defer_threshold=0.1, base_drop_threshold=0.05,
                dynamic_defer=True)
            eng = eng_cls(None, None, ecfg(
                n_units=2, elasticity=None, result_cache=False,
                prefix_cache=False, heuristic=kw["heuristic"],
                merging=kw["merging"], pruning=pruning,
                batching=bat_cls(max_batch=4, step_token_budget=32)
                if batched else None), stub_oracle=oracle, **extra)
            eng.cp.trace = []
            stats = eng.run(_request_trace(req_cls))
            traces.append((eng.cp.trace, {k: stats[k] for k in (
                "completed", "on_time", "missed", "dropped", "merges")}))
        assert traces[0][0], "empty decision trace"
        assert traces[0] == traces[1]
