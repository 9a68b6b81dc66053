"""Fault-tolerant training loop in PyTorch, the twin of
``repro.train.trainer``.

  * checkpoint/restart: periodic async checkpoints; ``run()`` resumes from
    the latest checkpoint; an injected failure exercises the path.
  * straggler mitigation: per-step wall-time EWMA + spike counter; the
    ``on_straggler`` hook lets deployments act on it (here: counted).
  * preemption handling: SIGTERM sets a flag; the loop checkpoints and
    exits cleanly at the next step boundary.
  * gradient accumulation for large global batches on small devices.

The model's parameters are a nested dict of leaf tensors that require
gradients, drawn by the port's ``init_params`` from a ``torch.Generator``
seeded with ``TrainConfig.seed`` on the trainer's device (CUDA unless
``device="cpu"``).  A step is ``loss.backward()`` and one in-place
``opt_update``; its ``dt`` is the wall time up to a
``torch.cuda.synchronize()``, so a step is not timed as its launches alone.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..data.pipeline import DataConfig, DataPipeline
from ..device import resolve_device
from ..models import transformer as T
from ..optim.optimizers import (OptConfig, opt_init, opt_update, tree_leaves,
                                tree_map)


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: str = "build/repro_ckpt"
    ckpt_every: int = 50
    log_every: int = 10
    grad_accum: int = 1
    straggler_factor: float = 2.5     # step > factor * EWMA => straggler tick
    seed: int = 0


@dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: int = 0


def _take_grads(params, scale=None):
    """The parameters' ``.grad`` in their nesting (zeros for a parameter
    the loss does not reach, as JAX gives), each cleared; divided by
    ``scale`` when given."""
    def take(p):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
        return g if scale is None else g / scale
    return tree_map(take, params)


def make_train_step(model_cfg, opt_cfg: OptConfig, grad_accum: int = 1):
    """Returns f(params, opt_state, batch) -> (params, opt_state, metrics).

    With ``grad_accum`` > 1 the batch's leaves carry a leading microbatch
    axis; each microbatch's gradient is divided by ``grad_accum`` and
    summed in f32, and the loss is the microbatches' mean."""
    lf = T.loss_fn(model_cfg)

    def single(params, opt_state, batch):
        loss = lf(params, batch)
        loss.backward()
        params, opt_state, metrics = opt_update(
            opt_cfg, params, _take_grads(params), opt_state)
        return params, opt_state, dict(metrics, loss=loss.detach())

    if grad_accum == 1:
        return single

    def accum(params, opt_state, batches):
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        losses = []
        for i in range(grad_accum):
            loss = lf(params, {k: v[i] for k, v in batches.items()})
            loss.backward()
            grads = tree_map(torch.add, grads,
                             _take_grads(params, grad_accum))
            losses.append(loss.detach())
        params, opt_state, metrics = opt_update(opt_cfg, params, grads,
                                                opt_state)
        return params, opt_state, dict(metrics,
                                       loss=torch.stack(losses).mean())

    return accum


class Trainer:
    def __init__(self, model_cfg, opt_cfg: OptConfig, data_cfg: DataConfig,
                 train_cfg: TrainConfig, device=None):
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.cfg = train_cfg
        self.device = resolve_device(device)
        self.pipeline = DataPipeline(data_cfg)
        self.ckpt = CheckpointManager(train_cfg.ckpt_dir)
        self.step_fn = make_train_step(model_cfg, opt_cfg,
                                       train_cfg.grad_accum)
        self.metrics_log: list[dict] = []
        self.straggler_ticks = 0
        self._preempted = False
        self._ewma = None

    # -- state ------------------------------------------------------------
    def init_state(self) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        params = T.init_params(self.model_cfg, gen, self.device)
        for p in tree_leaves(params):
            p.requires_grad_()
        return TrainState(params=params,
                          opt_state=opt_init(self.opt_cfg, params), step=0)

    def _restore_or_init(self) -> TrainState:
        latest = self.ckpt.latest_step()
        state = self.init_state()
        if latest is None:
            return state
        like = {"params": state.params, "opt_state": state.opt_state}
        tree, manifest = self.ckpt.restore(like)
        for p in tree_leaves(tree["params"]):
            p.requires_grad_()
        return TrainState(params=tree["params"],
                          opt_state=tree["opt_state"],
                          step=int(manifest["step"]))

    def _save(self, state: TrainState, blocking: bool = False):
        self.ckpt.save(state.step,
                       {"params": state.params, "opt_state": state.opt_state},
                       extra={}, blocking=blocking)

    def install_preemption_handler(self):
        signal.signal(signal.SIGTERM, lambda *_: setattr(self, "_preempted",
                                                         True))

    # -- loop ------------------------------------------------------------
    def _batch(self, step: int):
        if self.cfg.grad_accum == 1:
            b = self.pipeline.batch_at(step)
            return {k: torch.from_numpy(v).to(self.device)
                    for k, v in b.items()}
        micro = [self.pipeline.batch_at(step * self.cfg.grad_accum + i)
                 for i in range(self.cfg.grad_accum)]
        return {k: torch.stack([torch.from_numpy(m[k]) for m in micro])
                .to(self.device) for k in micro[0]}

    def run(self, fail_at_step: int | None = None) -> TrainState:
        """Train to cfg.steps, resuming from the latest checkpoint.

        ``fail_at_step`` injects a crash (for the restart test)."""
        state = self._restore_or_init()
        while state.step < self.cfg.steps and not self._preempted:
            if fail_at_step is not None and state.step == fail_at_step:
                raise RuntimeError(f"injected failure at step {state.step}")
            t0 = time.perf_counter()
            batch = self._batch(state.step)
            params, opt_state, metrics = self.step_fn(state.params,
                                                      state.opt_state, batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            state = TrainState(params, opt_state, state.step + 1)
            dt = time.perf_counter() - t0
            self._track_stragglers(dt)
            if state.step % self.cfg.log_every == 0 or state.step == 1:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=state.step, dt=dt)
                self.metrics_log.append(m)
            if state.step % self.cfg.ckpt_every == 0:
                self._save(state)
        self._save(state, blocking=True)
        self.ckpt.wait()
        return state

    def _track_stragglers(self, dt: float):
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.cfg.straggler_factor * self._ewma:
            self.straggler_ticks += 1
            self.on_straggler(dt, self._ewma)
        self._ewma = 0.9 * self._ewma + 0.1 * dt

    def on_straggler(self, dt: float, ewma: float):  # hook
        pass
