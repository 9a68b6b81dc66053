"""The port's serving engine on the CPU: the twin of
``tests/test_serving_engine.py`` (merge-level semantics, the result-cache
path, the paged KV prefix cache end to end and a mixed-backend pool), every
case on ``device="cpu"`` with the port's ``init_params`` from a seeded
``torch.Generator``; and the task-level fan-out on JAX-bridged weights,
whose tokens are the JAX engine's."""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import transformer as JT
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs.registry import get_arch
from repro_torch.core.fleet import FleetSpec
from repro_torch.models import transformer as T
from repro_torch.obs import Telemetry
from repro_torch.serving.batching import StepBatchingConfig
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
            head_dim=32, remat=False)


def _gen():
    return torch.Generator().manual_seed(0)


def _model(vocab=128):
    cfg = get_arch("smollm-360m").reduced().scaled(vocab=vocab, **TINY)
    return cfg, T.init_params(cfg, _gen(), "cpu")


_CFG, _PARAMS = _model()


def _engine_cfg(cls=EngineConfig, **kw):
    kw.setdefault("n_units", 1)
    kw.setdefault("elasticity", None)
    kw.setdefault("merging", "none")
    kw.setdefault("pruning", None)
    kw.setdefault("result_cache", False)
    kw.setdefault("max_len", 96)
    kw.setdefault("batch_buckets", (1, 2, 4))
    return cls(**kw)


def _engine(**kw):
    return ServingEngine(_CFG, _PARAMS, _engine_cfg(**kw), device="cpu")


# ---------------------------------------------------------------------------
# merge levels
# ---------------------------------------------------------------------------

class TestMergeLevels:
    def test_task_level_fanout_identical_tokens(self):
        """Identical (prompt, op, params): one execution serves everyone."""
        eng = _engine(merging="aggressive")
        p = (3, 1, 4, 1, 5, 9, 2, 6)
        reqs = [Request(prompt=p, n_new=3, seed=0, deadline=1e9)
                for _ in range(4)]
        stats = eng.run([(0.0, r) for r in reqs])
        assert stats["executions"] == 1
        assert stats["merges"] == 3
        assert len(reqs[0].tokens) == 3
        assert all(r.tokens == reqs[0].tokens for r in reqs)

    def test_task_level_fanout_equals_jax(self):
        """The same fan-out on JAX-initialised weights bridged to the
        port: one execution each, and JAX's engine's tokens."""
        jcfg = JAX_ARCHS["smollm-360m"].reduced().scaled(vocab=128, **TINY)
        jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
        params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
        p = (3, 1, 4, 1, 5, 9, 2, 6)
        reqs = [Request(prompt=p, n_new=3, seed=0, deadline=1e9)
                for _ in range(4)]
        jreqs = [JaxRequest(prompt=p, n_new=3, seed=0, deadline=1e9)
                 for _ in range(4)]
        eng = ServingEngine(_CFG, params, _engine_cfg(merging="aggressive"),
                            device="cpu")
        jeng = JaxServingEngine(jcfg, jparams, _engine_cfg(
            JaxEngineConfig, merging="aggressive"))
        stats = eng.run([(0.0, r) for r in reqs])
        jstats = jeng.run([(0.0, r) for r in jreqs])
        assert stats["executions"] == jstats["executions"] == 1
        assert stats["merges"] == jstats["merges"] == 3
        assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
        assert len(reqs[0].tokens) == 3

    def test_greedy_seed_normalized_into_task_level(self):
        """temperature==0 decoding ignores the seed, so identical greedy
        requests with different seeds must TASK-merge into one execution."""
        eng = _engine(merging="aggressive")
        p = (2, 7, 1, 8, 2, 8)
        reqs = [Request(prompt=p, n_new=2, temperature=0.0, seed=s,
                        deadline=1e9) for s in (0, 1, 2)]
        stats = eng.run([(0.0, r) for r in reqs])
        assert stats["executions"] == 1
        assert stats["merges"] == 2
        assert all(r.tokens == reqs[0].tokens for r in reqs)
        assert stats["deadlock_breaks"] == 0

    def test_sampled_seed_still_distinguishes(self):
        """temperature>0 requests keep the seed in their signature (they
        are DATA_OP, not TASK, so each gets its own sampled trajectory)."""
        r1 = Request(prompt=(1, 2, 3), n_new=2, temperature=0.8, seed=0)
        r2 = Request(prompt=(1, 2, 3), n_new=2, temperature=0.8, seed=1)
        assert r1.params_sig != r2.params_sig
        g1 = Request(prompt=(1, 2, 3), n_new=2, temperature=0.0, seed=0)
        g2 = Request(prompt=(1, 2, 3), n_new=2, temperature=0.0, seed=1)
        assert g1.params_sig == g2.params_sig

    def test_data_op_respects_per_request_n_new(self):
        """Same prompt + op, different params: shared prefill, each request
        still gets exactly its own n_new tokens."""
        eng = _engine(merging="aggressive")
        p = (7, 8, 9, 10, 11)
        r1 = Request(prompt=p, n_new=4, seed=0, deadline=1e9)
        r2 = Request(prompt=p, n_new=2, seed=1, deadline=1e9)
        r3 = Request(prompt=p, n_new=1, seed=2, deadline=1e9)
        stats = eng.run([(0.0, r1), (0.0, r2), (0.0, r3)])
        assert stats["executions"] == 1
        assert [len(r.tokens) for r in (r1, r2, r3)] == [4, 2, 1]
        # greedy portions agree with the longest request's trajectory
        assert r2.tokens == r1.tokens[:2] and r3.tokens == r1.tokens[:1]


# ---------------------------------------------------------------------------
# result cache
# ---------------------------------------------------------------------------

class TestResultCache:
    def test_hit_path_serves_without_execution(self):
        eng = _engine(result_cache=True)
        p = (1, 2, 3, 4, 5, 6)
        r1 = Request(prompt=p, n_new=2, deadline=1e9)
        eng.run([(0.0, r1)])
        execs = eng.stats["executions"]
        r2 = Request(prompt=p, n_new=2, deadline=1e9)
        eng.run([(eng.clock, r2)])
        assert eng.stats["executions"] == execs      # no new execution
        assert eng.stats["cache_hits"] == 1
        assert r2.status == "done" and r2.tokens == r1.tokens

    def test_greedy_seed_normalized_hits(self):
        """A different seed on a greedy request must not bust the cache."""
        eng = _engine(result_cache=True)
        p = (9, 8, 7, 6, 5)
        r1 = Request(prompt=p, n_new=2, temperature=0.0, seed=3, deadline=1e9)
        eng.run([(0.0, r1)])
        r2 = Request(prompt=p, n_new=2, temperature=0.0, seed=9, deadline=1e9)
        eng.run([(eng.clock, r2)])
        assert eng.stats["cache_hits"] == 1
        assert r2.tokens == r1.tokens

    def test_param_mismatch_misses(self):
        eng = _engine(result_cache=True)
        p = (1, 2, 3, 4, 5, 6)
        r1 = Request(prompt=p, n_new=2, deadline=1e9)
        eng.run([(0.0, r1)])
        r2 = Request(prompt=p, n_new=3, deadline=1e9)   # different params
        eng.run([(eng.clock, r2)])
        assert eng.stats["cache_hits"] == 0
        assert eng.stats["executions"] == 2


# ---------------------------------------------------------------------------
# paged KV prefix cache (the acceptance workload)
# ---------------------------------------------------------------------------

def _shared_prefix_trace(n=64, n_sys=8, sys_len=64, suffix_len=8, seed=0):
    """64 requests over 8 distinct >=64-token system prompts with distinct
    user suffixes — the issue's acceptance workload."""
    rng = np.random.default_rng(seed)
    sys_prompts = [tuple(rng.integers(1, _CFG.vocab, size=sys_len).tolist())
                   for _ in range(n_sys)]
    out = []
    for i in range(n):
        p = sys_prompts[i % n_sys] + \
            tuple(rng.integers(1, _CFG.vocab, size=suffix_len).tolist())
        out.append((0.0, Request(prompt=p, n_new=2, deadline=1e9)))
    return out


class TestPrefixCache:
    def test_acceptance_shared_prefix_workload(self):
        """>0 prefix hits, token-identical to a cache-disabled run, and
        measurably fewer prefill tokens executed."""
        tr_on = _shared_prefix_trace()
        eng_on = _engine(prefix_cache=True, kv_block_size=16,
                         kv_cache_blocks=128)
        s_on = eng_on.run(tr_on)

        tr_off = _shared_prefix_trace()
        eng_off = _engine(prefix_cache=False)
        s_off = eng_off.run(tr_off)

        assert s_on["prefix_hits"] > 0
        assert s_on["prefill_tokens"] < s_off["prefill_tokens"]
        assert s_on["prefix_tokens_reused"] > 0
        assert s_on["completed"] == s_off["completed"] == 64
        # the event-driven loop must never hit the no-progress escape hatch
        assert s_on["deadlock_breaks"] == 0 == s_off["deadlock_breaks"]
        toks_on = [r.tokens for _, r in tr_on]
        toks_off = [r.tokens for _, r in tr_off]
        assert toks_on == toks_off
        # every request after the first per system prompt reuses >= 64 tokens
        assert s_on["prefix_hits"] == 64 - 8
        assert s_on["prefix_tokens_reused"] == (64 - 8) * 64

    def test_eviction_under_tiny_pool_keeps_results_exact(self):
        """A pool far smaller than the working set must evict (never a
        pinned block) and still produce exact results."""
        tr = _shared_prefix_trace(n=24, n_sys=4)
        eng = _engine(prefix_cache=True, kv_block_size=16, kv_cache_blocks=6)
        s = eng.run(tr)
        assert s["prefix_evictions"] > 0
        assert s["completed"] == 24
        assert all(b.refcount == 0 for b in eng.kvcache.pool.blocks)

        tr_off = _shared_prefix_trace(n=24, n_sys=4)
        eng_off = _engine(prefix_cache=False)
        eng_off.run(tr_off)
        assert [r.tokens for _, r in tr] == [r.tokens for _, r in tr_off]

    def test_refcount_invariant_during_run(self):
        """Pool-level guard: freeing a referenced block raises, and the
        engine never trips it across a full eviction-heavy trace."""
        eng = _engine(prefix_cache=True, kv_block_size=16, kv_cache_blocks=4)
        eng.run(_shared_prefix_trace(n=16, n_sys=4))
        pool = eng.kvcache.pool
        blk = next(b for b in pool.blocks if b.in_use)
        pool.incref(blk)
        with pytest.raises(RuntimeError, match="referenced"):
            pool.free(blk)
        pool.decref(blk)

    def test_prefix_candidates_scored_on_submit(self):
        """PREFIX-level similarity is visible to the admission gate once the
        cache holds a matching prefix."""
        sys_p = tuple(range(1, 33))
        eng = _engine(prefix_cache=True, kv_block_size=16,
                      kv_cache_blocks=16)
        r1 = Request(prompt=sys_p + (40, 41), n_new=1, deadline=1e9)
        eng.run([(0.0, r1)])
        r2 = Request(prompt=sys_p + (50, 51), n_new=1, deadline=1e9)
        eng.run([(eng.clock, r2)])
        assert eng.stats["prefix_candidates"] == 1
        assert eng.detector.find_prefix_overlap(sys_p + (60,)) == 32

    def test_per_unit_caches_attribute_hits_to_the_owning_unit(self):
        """Two units, shared-system-prompt traffic arriving one at a time:
        the per-unit locality term (MappingContext.prefix_overlap) steers
        every follow-up onto the unit that cached the prefix, so its cache
        takes all the hits and the other unit's cache stays cold — the
        within-engine discrimination per-unit caches exist for."""
        eng = _engine(n_units=2, prefix_cache=True, kv_block_size=16,
                      kv_cache_blocks=64)
        assert len(eng.kvcaches) == 2
        assert eng.kvcache is None          # no single engine-wide cache
        sys_p = tuple(range(1, 33))
        rng = np.random.default_rng(0)
        n = 6
        for _ in range(n):
            suffix = tuple(rng.integers(40, _CFG.vocab, size=4).tolist())
            r = Request(prompt=sys_p + suffix, n_new=1, deadline=1e9)
            eng.run([(eng.clock, r)])
        stats = eng.collect_stats()
        assert stats["prefix_hits"] == n - 1
        per_unit = sorted(c.stats["hits"] for c in eng.kvcaches.values())
        assert per_unit == [0, n - 1]       # one owner, zero strays
        # and the mapping layer reports the discrimination directly
        probe = Request(prompt=sys_p + (40, 41), deadline=1e9).to_task(0, 0)
        scores = sorted(eng._prefix_locality(probe, m)
                        for m in eng.machines)
        assert scores == [0, 32]

    def test_retired_unit_keeps_its_prefix_counters(self):
        """Retiring an idle unit must carry its cache counters into the
        engine totals — end-of-run prefix stats never shrink (mirrors the
        simulator's retired-eviction bookkeeping)."""
        from repro_torch.serving.engine import _EngineUnitPool
        eng = _engine(n_units=2, prefix_cache=True, kv_block_size=16,
                      kv_cache_blocks=64)
        sys_p = tuple(range(1, 33))
        for i in range(4):
            r = Request(prompt=sys_p + (40 + i, 41 + i), n_new=1,
                        deadline=1e9)
            eng.run([(eng.clock, r)])
        before = eng.collect_stats()
        assert before["prefix_hits"] == 3
        pool = _EngineUnitPool(eng)
        assert pool.shrink(eng.clock) and pool.shrink(eng.clock)
        assert not eng.units
        after = eng.collect_stats()
        for k in ("prefix_hits", "prefix_tokens_reused", "prefix_lookups",
                  "prefix_inserts", "prefix_evictions"):
            assert after[k] == before[k], k

    def test_batched_inserts_count_their_host_seconds(self):
        """A batched unit whose pool fills: its inserts' host seconds
        (``kv_insert_wall_s``) hold the prompt downloads inside them
        (``kv_download_wall_s``), each insert is one ``kv.insert`` span and
        all that ``runner.complete`` nests, ``prefix_insert_share`` reads
        the two counters, and the greedy tokens are a cache-off run's."""
        batching = StepBatchingConfig(max_batch=4, step_token_budget=16)
        rng = np.random.default_rng(3)
        prompts = [tuple(rng.integers(1, _CFG.vocab,
                                      size=int(rng.integers(20, 60)))
                         .tolist()) for _ in range(10)]

        def trace():
            return [(float(i), Request(prompt=p, n_new=3, deadline=1e9))
                    for i, p in enumerate(prompts)]
        eng = _engine(prefix_cache=True, kv_block_size=4, kv_cache_blocks=12,
                      batching=batching)
        tel = Telemetry()
        eng.attach_telemetry(tel)
        s0 = eng.collect_stats()
        tr = trace()
        s = eng.run(tr)
        assert s["completed"] == len(prompts) and s["prefix_evictions"] > 0
        assert s["kv_insert_wall_s"] >= s["kv_download_wall_s"] >= 0.0
        assert s["kv_insert_wall_s"] > 0.0
        spans = tel.span_totals()
        ins, done = spans["kv.insert"], spans["runner.complete"]
        assert ins["span_n"] == len(prompts)
        assert done["span_s"] - done["span_self_s"] == \
            pytest.approx(ins["span_s"], rel=1e-9)
        path = ROOT / "perfbench" / "metrics" / "prefix_insert_share.py"
        spec = importlib.util.spec_from_file_location("prefix_insert_share",
                                                      path)
        reader = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(reader)
        assert reader.read({"stats0": s0, "stats1": s, "window_s": 2.0}) == \
            pytest.approx(50.0 * (s["kv_insert_wall_s"]
                                  - s["kv_download_wall_s"]))
        bare = {k: v for k, v in s.items() if not k.startswith("kv_")}
        assert reader.read({"stats0": bare, "stats1": bare,
                            "window_s": 2.0}) is None
        tr_off = trace()
        s_off = _engine(prefix_cache=False, batching=batching).run(tr_off)
        assert s_off["kv_insert_wall_s"] == 0.0
        assert [r.tokens for _, r in tr] == [r.tokens for _, r in tr_off]
        assert all(len(r.tokens) == 3 for _, r in tr)

    def test_disabled_for_stateful_families(self):
        cfg = get_arch("xlstm-125m").reduced().scaled(
            n_layers=2, d_model=64, n_heads=2, remat=False)
        params = T.init_params(cfg, _gen(), "cpu")
        eng = ServingEngine(cfg, params, EngineConfig(
            n_units=1, elasticity=None, merging="none",
            pruning=None, result_cache=False, max_len=48,
            batch_buckets=(1,), prefix_cache=True), device="cpu")
        assert eng.kvcache is None
        r = Request(prompt=tuple(range(1, 20)), n_new=2, deadline=1e9)
        stats = eng.run([(0.0, r)])
        assert stats["completed"] == 1 and len(r.tokens) == 2


# ---------------------------------------------------------------------------
# heterogeneous fleet: mixed backends in one live pool (DESIGN.md §2.8)
# ---------------------------------------------------------------------------

class TestMixedBackendPool:
    def test_compiled_emulated_and_stub_units_in_one_pool(self):
        """One live pool mixing all three backend kinds: compiled and
        emulated units run real model steps (emulated on a slower virtual
        timeline), the stub row is an oracle-timed remote stand-in, and
        every request is accounted exactly once."""
        fleet = FleetSpec.parse(
            "tpu:1:1.0:1.0:compiled,cpu:1:0.25:0.2:emulated,"
            "remote:1:1.0:0.1:stub")
        eng = ServingEngine(_CFG, _PARAMS, EngineConfig(
            fleet=fleet, elasticity=None, merging="none",
            result_cache=False, prefix_cache=False, max_len=96,
            batch_buckets=(1, 2, 4)), device="cpu")
        assert [u.kind for u in eng.units] == \
            ["compiled", "emulated", "stub"]
        assert [m.speed for m in eng.machines] == [1.0, 0.25, 1.0]
        rng = np.random.default_rng(3)
        n = 9
        trace = [(6.0 * i, Request(
            prompt=tuple(rng.integers(1, _CFG.vocab, size=6).tolist()),
            n_new=2, deadline=1e9)) for i in range(n)]
        stats = eng.run(trace)
        assert stats["completed"] == n
        assert stats["executions"] == n
        assert stats["cost"] > 0.0
        # the model-backed units really produced tokens; a stub-run
        # request (if any landed there) is done with an empty payload
        done = [r for _, r in trace]
        assert all(r.status == "done" for r in done)
        assert any(len(r.tokens) == 2 for r in done)
