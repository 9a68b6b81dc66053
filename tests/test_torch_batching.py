"""The port's twin of ``tests/test_batching.py`` (DESIGN.md §2.10), on
``device="cpu"``: continuous batching + chunked prefill.

* the substrate-independent ``UnitBatch`` step walker of
  ``repro_torch.serving.batching``;
* the live engine's token identity on a tiny port-initialised model
  (weights from a seeded ``torch.Generator``): any chunk/decode
  interleaving under any token budget and batch size yields the greedy
  tokens of the sequential run (the reference's property test with its
  ``settings``);
* ``test_batching_compresses_virtual_time`` with the reference's name and
  workload, its claim held through launch counts.  The live engine's
  virtual time is its measured walls, so the reference's makespan
  comparison compares two wall-clock readings.  At the default 100 ticks
  a second the port serves each of the case's requests in about one
  tick: neither run queues, and how many requests share a batched step
  varies from run to run with the host's load.  At a million ticks a
  second every step outlasts the 1-tick arrival gaps, so the requests
  share the batch on any host and the count of batched decode launches is
  the same on every run;
* simulator <-> stub-engine decision-trace equivalence with batching on,
  each trace also held to JAX's ``repro.core.simulation.Simulator`` on the
  same tasks, fleet, oracle and seed;
* the recalibrated cold-start estimator.

Cases of the reference held elsewhere in the port's tests:

* ``TestPagedDecodeKernel`` (the Pallas kernel against its oracle): the
  port's paged decode kernel and its split model are held in
  ``tests/test_torch_kernels.py``, e.g.
  ``test_pad_page_and_stale_slots_never_leak`` and
  ``test_keys_past_the_length_are_never_read``, and on the card in
  ``tests/test_torch_cuda.py``.
* ``TestBlockTuning``: ``tune_block_s`` and ``interpret_default`` belong to
  the Pallas kernel; the port's counterpart is ``test_tune_block_s_cases``
  in ``tests/test_torch_kernels.py``.
* ``TestTokenIdentity::test_batched_equals_sequential_greedy`` and
  ``::test_sampled_requests_fall_back_to_exclusive``: the cases of the same
  names in ``tests/test_torch_engine.py``.
* ``TestColdEstimate::test_live_engine_calibrates_on_warmup``: the case of
  the same name in ``tests/test_torch_engine.py``.
"""

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # minimal install: keep unit tests, skip property tests
    from conftest import given, settings, st  # noqa: F401

from repro_torch.configs.registry import get_arch
from repro_torch.core.simulation import PETOracle, SimConfig, Simulator
from repro_torch.core.tasks import Machine, Task
from repro_torch.models import transformer as T
from repro_torch.serving.batching import (SeqState, StepBatchingConfig,
                                          StepPlan, UnitBatch,
                                          analytic_cost_fn, step_cost,
                                          task_dims)
from repro_torch.serving.engine import (EngineConfig, Request, ServingEngine,
                                        TimeEstimator)
from torch_jax_side import JAX, MSD_PRUNING, PORT

CPU = "cpu"


def _seq(tid=0, plen=32, n_new=4, rate=0.5, dstep=2.0, **kw):
    task = Task(ttype="generate", data_id=f"d{tid}", op="generate",
                params=(n_new,))
    return SeqState(task=task, plen=plen, n_new=n_new, prefill_rate=rate,
                    decode_step=dstep, **kw)


# ---------------------------------------------------------------------------
# the step walker
# ---------------------------------------------------------------------------

class TestUnitBatch:
    def _ub(self, **kw):
        kw.setdefault("max_batch", 4)
        kw.setdefault("step_token_budget", 16)
        return UnitBatch(StepBatchingConfig(**kw))

    def test_decode_first_then_chunks_within_budget(self):
        ub = self._ub()
        decoding = _seq(0, plen=8, n_new=4)
        decoding.prefill_done = 8       # mid-decode
        decoding.decoded = 1
        prefilling = _seq(1, plen=40, n_new=2)
        ub.join(decoding, 0.0)
        ub.join(prefilling, 0.0)
        ub.seqs.extend(ub.pending)
        ub.pending.clear()
        plan = ub.plan_step()
        assert plan.decode == [decoding]
        # the remaining budget (16 - 1) goes to the prefill chunk
        assert plan.chunks == [(prefilling, 15)]
        assert plan.tokens == 16

    def test_chunks_in_join_order_and_split_across_steps(self):
        ub = self._ub(step_token_budget=24)
        a, b = _seq(0, plen=20, n_new=1), _seq(1, plen=20, n_new=1)
        ub.join(a, 0.0)
        ub.join(b, 0.0)
        t_end, done = ub.run_quantum(0.0)
        # step 1: a (older) gets its full 20-token prefill, b the remaining
        # 4; a's final-chunk logits are its single new token, so a completes
        # and the quantum ends early with b still mid-prefill
        assert [s.task.tid for s in done] == [a.task.tid]
        assert (a.prefill_done, b.prefill_done) == (20, 4)
        t_end2, done2 = ub.run_quantum(t_end)
        assert [s.task.tid for s in done2] == [b.task.tid]
        assert t_end2 > t_end > 0.0

    def test_quantum_stops_at_first_completion(self):
        ub = self._ub(quantum_steps=64)
        fast = _seq(0, plen=4, n_new=1)
        slow = _seq(1, plen=4, n_new=50)
        ub.join(fast, 0.0)
        ub.join(slow, 0.0)
        t_end, done = ub.run_quantum(0.0)
        assert [s.task.tid for s in done] == [fast.task.tid]
        assert slow.decoded < slow.n_new        # still in flight
        assert slow in ub.seqs

    def test_fused_step_cost_overlap(self):
        assert step_cost(10.0, 4.0, 0.35) == pytest.approx(10.0 + 0.35 * 4.0)
        assert step_cost(4.0, 10.0, 0.35) == pytest.approx(10.0 + 0.35 * 4.0)
        cfg = StepBatchingConfig(batch_marginal_cost=0.2,
                                 fused_step_overlap=0.0)
        cost = analytic_cost_fn(cfg)
        d1, d2 = _seq(0, plen=1, n_new=8, dstep=2.0), \
            _seq(1, plen=1, n_new=8, dstep=4.0)
        for s in (d1, d2):
            s.prefill_done = s.plen
        # batch economics: 2 decodes cost (1 + 0.2) * mean(2, 4), not 2 + 4
        assert cost(StepPlan(decode=[d1, d2])) == pytest.approx(1.2 * 3.0)

    def test_eviction_leaves_corunners_untouched(self):
        ub = self._ub(quantum_steps=2)
        a, b = _seq(0, plen=4, n_new=40), _seq(1, plen=4, n_new=40)
        ub.join(a, 0.0)
        ub.join(b, 0.0)
        ub.run_quantum(0.0)
        ub.evict(a.task)
        t_end, done = ub.run_quantum(ub.clock)
        assert a not in ub.seqs
        assert b in ub.seqs and not b.dead

    def test_empty_quantum_returns_none(self):
        ub = self._ub()
        assert ub.run_quantum(5.0) == (None, [])

    def test_task_dims_fallbacks(self):
        cfg = StepBatchingConfig(default_prompt=64, default_n_new=8)
        bare = Task(ttype="t0", data_id="d", op="op")
        assert task_dims(bare, cfg) == (64, 8)
        rich = Task(ttype="generate", data_id="d", op="generate",
                    params=(3, 0.0, 0), tokens=tuple(range(17)))
        assert task_dims(rich, cfg) == (17, 3)


# ---------------------------------------------------------------------------
# live engine: batched == sequential, token for token
# ---------------------------------------------------------------------------

TINY = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
            vocab=128, head_dim=32, remat=False)


@pytest.fixture(scope="module")
def tiny_model():
    cfg = get_arch("smollm-360m").reduced().scaled(**TINY)
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0), CPU)


def _prompts(n, seed=7, lo=4, hi=60):
    rng = np.random.default_rng(seed)
    return [tuple(int(x) for x in
                  rng.integers(1, 127, size=rng.integers(lo, hi)))
            for _ in range(n)]


def _engine(model, batching=None, **cfg_kw):
    cfg, params = model
    return ServingEngine(cfg, params, EngineConfig(
        n_units=1, elasticity=None, merging="none", pruning=None,
        result_cache=False, max_len=96, batch_buckets=(1, 2, 4),
        batching=batching, **cfg_kw), device=CPU)


def _run_engine(model, reqs, batching=None):
    eng = _engine(model, batching)
    stats = eng.run([(float(i), r) for i, r in enumerate(reqs)])
    return eng, stats


class TestTokenIdentity:
    def test_batching_compresses_virtual_time(self, tiny_model):
        """Same workload: the batched engine serves the 8 requests with
        fewer than half the decode launches of run-to-completion, which
        takes one for each new token of each request, and with the same
        greedy tokens.  A tick is a microsecond of wall here, so every
        step outlasts the 1-tick arrival gaps and the 8 requests share
        the batch whatever the host's speed (see the module docstring)."""
        prompts = _prompts(8, seed=11)
        a = [Request(prompt=p, n_new=4, deadline=1e9) for p in prompts]
        b = [Request(prompt=p, n_new=4, deadline=1e9) for p in prompts]
        seq = _engine(tiny_model, time_scale=1e6)
        unit, calls = seq.units[0], []
        decode = unit._decode

        def counted(*args, **kwargs):
            calls.append(1)
            return decode(*args, **kwargs)

        unit._decode = counted
        seq.run([(float(i), r) for i, r in enumerate(a)])
        bat = _engine(tiny_model, StepBatchingConfig(max_batch=8,
                                                     step_token_budget=32),
                      time_scale=1e6)
        bat.run([(float(i), r) for i, r in enumerate(b)])
        launches = bat.collect_stats()["decode_launches"]
        assert len(calls) == sum(r.n_new for r in a) == 32
        assert 0 < launches < len(calls) // 2
        assert [r.tokens for r in a] == [r.tokens for r in b]
        assert all(len(r.tokens) == 4 for r in b)

    @settings(max_examples=5, deadline=None)
    @given(st.integers(2, 64), st.integers(2, 8), st.integers(0, 10_000))
    def test_prop_any_interleaving_token_identical(self, tiny_model, budget,
                                                   max_batch, seed):
        prompts = _prompts(6, seed=seed)
        seq_reqs = [Request(prompt=p, n_new=3, deadline=1e9)
                    for p in prompts]
        bat_reqs = [Request(prompt=p, n_new=3, deadline=1e9)
                    for p in prompts]
        _, _ = _run_engine(tiny_model, seq_reqs)
        _, _ = _run_engine(tiny_model, bat_reqs,
                           StepBatchingConfig(max_batch=max_batch,
                                              step_token_budget=budget))
        for a, b in zip(seq_reqs, bat_reqs):
            assert a.tokens == b.tokens


# ---------------------------------------------------------------------------
# simulator <-> stub-engine decision equivalence under batching
# ---------------------------------------------------------------------------

BATCHED_EQUIV = [
    dict(heuristic="EDF", merging="adaptive", position_finder=None,
         pruning=None),
    dict(heuristic="MSD", merging="conservative", position_finder=None,
         pruning=MSD_PRUNING),
]

#: the step batching of the equivalence cases, built in either package
BAT = dict(max_batch=4, step_token_budget=32)


class TestBatchedDecisionEquivalence:
    @pytest.mark.parametrize("cfg_kw", BATCHED_EQUIV,
                             ids=["edf-adaptive", "msd-pruned"])
    def test_same_trace_same_decisions_batched(self, cfg_kw):
        """The batch-dependent step cost model runs identically on both
        analytic substrates: decision traces stay bit-equal with
        continuous batching turned on, and equal JAX's simulator's."""
        eng = PORT.stub_engine(batching=BAT, **cfg_kw)
        stats = eng.run(PORT.request_trace())
        sim, st = PORT.simulate(PORT.request_trace(), batching=BAT, **cfg_kw)
        jsim, jst = JAX.simulate(JAX.request_trace(), batching=BAT, **cfg_kw)

        assert sim.cp.trace == eng.cp.trace
        assert sim.cp.trace == jsim.cp.trace
        assert (st.on_time, st.missed, st.dropped) == \
            (stats["on_time"], stats["missed"], stats["dropped"]) == \
            (jst.on_time, jst.missed, jst.dropped)
        assert stats["deadlock_breaks"] == 0 == st.deadlock_breaks
        kinds = {e[0] for e in sim.cp.trace}
        assert "start" in kinds and "finish" in kinds

    def test_batched_machines_complete_everything(self):
        """Analytic batching end to end: no task stranded, makespan beats
        run-to-completion on the same oracle draw distribution."""
        pet = PORT.pet()
        n = 30
        tasks = [Task(ttype="generate", data_id=f"d{i}", op="generate",
                      params=(4,), arrival=float(i), deadline=1e9)
                 for i in range(n)]
        seq = Simulator(
            [Task(ttype=t.ttype, data_id=t.data_id, op=t.op,
                  params=t.params, arrival=t.arrival, deadline=t.deadline)
             for t in tasks],
            [Machine(mid=0)], PETOracle(pet, seed=5), SimConfig(),
            device=CPU).run()
        bat = Simulator(
            tasks, [Machine(mid=0)], PETOracle(pet, seed=5),
            SimConfig(batching=StepBatchingConfig(max_batch=8)),
            device=CPU).run()
        assert bat.on_time + bat.missed + bat.dropped == n
        assert bat.makespan < seq.makespan


# ---------------------------------------------------------------------------
# recalibrated cold-start estimator
# ---------------------------------------------------------------------------

class TestColdEstimate:
    def test_default_rates_reproduce_legacy_formula(self):
        est = TimeEstimator()
        for plen, n_new in ((16, 1), (64, 8), (300, 32), (4096, 128)):
            mu, _ = est.mean_std("generate", plen, n_new)
            legacy = max(5.0 * (plen + n_new * 4) / 64.0, 1.0)
            assert mu == legacy

    def test_calibrate_reprices_cold_estimates(self):
        est = TimeEstimator()
        est.calibrate(prefill_rate=0.01, decode_rate=2.0)
        mu, _ = est.mean_std("generate", 1000, 2)
        # decode-dominated now: the old blob formula would say ~85 ticks
        assert mu == pytest.approx(1000 * 0.01 + 2 * 2.0)
