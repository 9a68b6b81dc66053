"""Step-level continuous batching with chunked prefill (DESIGN.md §2.10).

The Sarathi-Serve discipline inside one processing unit: every engine
*step* has a token budget; all in-flight decodes run first (one token
each, batched into a single launch over their paged KV blocks) and the
remaining budget is given to prompt *chunks* of at most that many
tokens, so a long prefill coexists with decodes instead of head-of-line
blocking them.

``UnitBatch`` is the substrate-independent walker: it plans one step at
a time (``plan_step``), applies the token accounting, and advances a
per-unit virtual clock by the step cost.  The cost comes from a
pluggable ``cost_fn(plan)``:

* the **analytic** substrates (simulator, stub-execution engine) use
  ``analytic_cost_fn`` — each task's oracle-sampled total duration is
  split into prefill/decode work (``prefill_fraction``) and a fused
  step costs ``max(chunk, decode) + overlap * min(chunk, decode)``,
  with the decode side carrying the TPU batch economics
  ``(1 + marginal*(k-1))`` — so sim ↔ stub-engine decision traces stay
  bit-identical under batching;
* the **live** engine uses the same formula over *calibrated* per-token
  rates (measured at warmup, EWMA-updated from real launches), so its
  virtual timeline reflects the modeled accelerator rather than the
  host's per-launch overhead.

Scheduling happens in *quanta*: the control plane asks for the next
quantum (at most ``quantum_steps`` steps, ending early at the first
sequence completion) and gets back its end time; admissions and
completions happen only at quantum boundaries, which keeps the
event-driven clock exact — mid-quantum the steps are already costed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..obs.telemetry import NULL

__all__ = ["StepBatchingConfig", "SeqState", "StepPlan", "UnitBatch",
           "analytic_cost_fn", "task_dims", "step_cost"]


@dataclass(frozen=True)
class StepBatchingConfig:
    """Knobs for step-level batching inside engine units."""

    max_batch: int = 8              # concurrent sequences per unit
    step_token_budget: int = 64     # tokens processed per step (decode+chunk)
    quantum_steps: int = 8          # max steps between scheduling boundaries
    prefill_fraction: float = 0.6   # analytic work split (matches SimConfig)
    batch_marginal_cost: float = 0.15   # TPU batch economics, as EngineConfig
    fused_step_overlap: float = 0.35    # fused chunk+decode step: the
    # compute-bound chunk overlaps the memory-bound decode, paying only a
    # fraction of the smaller component on top of the larger one
    default_prompt: int = 64        # task dims when a task carries no tokens
    default_n_new: int = 8          # ... or no (n_new, ...) params


def task_dims(task, cfg: StepBatchingConfig) -> tuple[int, int]:
    """(prompt_len, n_new) for a task, identically derivable on every
    substrate: ``Request.to_task`` stores the prompt in ``task.tokens``
    and ``n_new`` as ``params[0]``; bare simulator tasks fall back to the
    config defaults."""
    plen = len(task.tokens) if getattr(task, "tokens", None) else \
        cfg.default_prompt
    params = getattr(task, "params", None)
    n_new = 0
    if params:
        try:
            n_new = int(params[0])
        except (TypeError, ValueError):
            n_new = cfg.default_n_new
    else:
        n_new = cfg.default_n_new
    return max(1, plen), max(0, n_new)


@dataclass
class SeqState:
    """One sequence (task) inside a unit's step batch."""

    task: object
    plen: int
    n_new: int
    prefill_done: int = 0
    decoded: int = 0
    # analytic per-token costs (virtual ticks); the live engine fills these
    # from calibrated rates, the analytic substrates from the oracle sample
    prefill_rate: float = 0.0       # ticks per prompt token
    decode_step: float = 0.0        # ticks per decode step (batch of 1)
    # live-engine fields
    slot: int = -1                  # page-arena slot
    exclusive: bool = False         # runs via the legacy path, alone
    excl_left: float = 0.0          # remaining exclusive duration (ticks)
    dead: bool = False              # evicted mid-flight
    joined_at: float = 0.0

    @property
    def prefilling(self) -> bool:
        return not self.exclusive and self.prefill_done < self.plen

    @property
    def done(self) -> bool:
        if self.dead:
            return False
        if self.exclusive:
            return self.excl_left <= 0.0
        return self.prefill_done >= self.plen and self.decoded >= self.n_new


@dataclass
class StepPlan:
    """Token allocation for one step."""

    decode: list = field(default_factory=list)          # SeqStates, 1 tok each
    chunks: list = field(default_factory=list)          # (SeqState, n_tokens)
    exclusive: object = None                            # SeqState or None

    @property
    def empty(self) -> bool:
        return not self.decode and not self.chunks and self.exclusive is None

    @property
    def tokens(self) -> int:
        return len(self.decode) + sum(c for _, c in self.chunks)


def step_cost(chunk_cost: float, decode_cost: float,
              overlap: float) -> float:
    """Fused-step cost: the larger component plus ``overlap`` times the
    smaller (roofline overlap of compute-bound chunk and memory-bound
    batched decode)."""
    lo, hi = sorted((chunk_cost, decode_cost))
    return hi + overlap * lo


def analytic_cost_fn(cfg: StepBatchingConfig):
    """Step cost from the sequences' analytic rates (oracle-derived)."""
    def cost(plan: StepPlan) -> float:
        if plan.exclusive is not None:
            return plan.exclusive.excl_left
        vc = sum(c * s.prefill_rate for s, c in plan.chunks)
        k = len(plan.decode)
        vd = 0.0
        if k:
            vd = (1.0 + cfg.batch_marginal_cost * (k - 1)) \
                * (sum(s.decode_step for s in plan.decode) / k)
        return step_cost(vc, vd, cfg.fused_step_overlap)
    return cost


class UnitBatch:
    """Per-unit step scheduler state: active sequences + a virtual clock.

    ``cost_fn(plan) -> dt`` prices a planned step; ``exec_fn(plan)``, when
    given (live engine), actually runs the launches for the step and
    returns the measured-then-modeled dt.  ``on_step`` (telemetry) sees
    ``(t_start, dt, plan)`` for every executed step.
    """

    def __init__(self, cfg: StepBatchingConfig, cost_fn=None, on_step=None):
        self.cfg = cfg
        self.seqs: list[SeqState] = []      # active, join order
        self.pending: list[SeqState] = []   # admitted at the next boundary
        self.clock = 0.0
        self.cost_fn = cost_fn or analytic_cost_fn(cfg)
        self.on_step = on_step
        self.steps = 0                      # lifetime executed steps

    # -- membership -----------------------------------------------------------
    @property
    def empty(self) -> bool:
        return not self.seqs and not self.pending

    def join(self, seq: SeqState, now: float) -> None:
        if self.empty:
            self.clock = now
        seq.joined_at = now
        self.pending.append(seq)

    def evict(self, task) -> SeqState | None:
        for s in self.seqs + self.pending:
            if s.task is task:
                s.dead = True
                if s in self.pending:
                    self.pending.remove(s)
                return s
        return None

    def find(self, task) -> SeqState | None:
        for s in self.seqs + self.pending:
            if s.task is task:
                return s
        return None

    # -- planning -------------------------------------------------------------
    def _alive(self) -> list[SeqState]:
        return [s for s in self.seqs if not s.dead and not s.done]

    def plan_step(self) -> StepPlan:
        alive = self._alive()
        if not alive:
            return StepPlan()
        # an exclusive (legacy-path) task monopolizes the unit: real compute
        # for it is one opaque launch, so co-resident sequences stall
        for s in alive:
            if s.exclusive:
                return StepPlan(exclusive=s)
        plan = StepPlan()
        budget = self.cfg.step_token_budget
        for s in alive:
            if not s.prefilling:
                plan.decode.append(s)
                budget -= 1
        for s in alive:                     # join order: oldest prefill first
            if s.prefilling and budget > 0:
                c = min(budget, s.plen - s.prefill_done)
                plan.chunks.append((s, c))
                budget -= c
        return plan

    def _advance(self, plan: StepPlan, dt: float) -> None:
        if plan.exclusive is not None:
            plan.exclusive.excl_left = 0.0
        for s in plan.decode:
            s.decoded += 1
        for s, c in plan.chunks:
            s.prefill_done += c
            if s.prefill_done >= s.plen and s.n_new > 0:
                # the final prompt chunk's logits yield the first new token,
                # exactly as the sequential path's prefill does
                s.decoded = max(s.decoded, 1)
        if self.on_step is not None:
            self.on_step(self.clock, dt, plan)
        self.clock += dt
        self.steps += 1

    # -- quantum execution ----------------------------------------------------
    def run_quantum(self, now: float, exec_fn=None, tel=NULL):
        """Execute up to ``quantum_steps`` steps from ``now``, stopping at
        the first completion.  Returns ``(t_end, completed SeqStates)`` or
        ``(None, [])`` when there is nothing to run.  ``tel`` (the live
        engine's recorder) times each step's planning."""
        self.seqs.extend(self.pending)
        self.pending.clear()
        self.seqs = [s for s in self.seqs if not s.dead]
        if not self._alive():
            self.seqs = []
            return None, []
        self.clock = max(self.clock, now)
        step = exec_fn or self.cost_fn
        completed: list[SeqState] = []
        for _ in range(self.cfg.quantum_steps):
            with tel.span("runner.plan"):
                plan = self.plan_step()
            if plan.empty:
                break
            dt = step(plan)
            self._advance(plan, dt)
            done = [s for s in self.seqs if s.done and not s.dead]
            if done:
                completed = done
                self.seqs = [s for s in self.seqs
                             if not s.done or s.dead]
                break
        self.seqs = [s for s in self.seqs if not s.dead]
        return self.clock, completed
