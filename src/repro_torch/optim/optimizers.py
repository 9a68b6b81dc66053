"""Optimizers in PyTorch, the twin of ``repro.optim.optimizers``: AdamW and
Adafactor, plus gradient clipping, over the port's nested dicts of tensors.

The state has the JAX package's keys (``step``, ``m``, ``v``, ``master``;
Adafactor's per-leaf ``vr``/``vc`` or ``v``), so both packages flatten it
to the same checkpoint paths.  The arithmetic is the JAX functions', op for
op, in f32 against an f32 master copy of the parameters.  Where JAX
returns fresh arrays (and the trainer donates the old ones), these update
the parameters and the state in place, under ``torch.no_grad()``, and
return the same tensors: a full-width model's f32 state is not held twice.
Leaves are visited in sorted key order, as ``jax.tree_util`` flattens a
dict, so sums over leaves run in JAX's order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"          # adamw | adafactor | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (a nested dict), each with the
    subtrees of ``rest`` at the same path (which may go deeper)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def lr_schedule(cfg: OptConfig, step):
    """Linear warmup + cosine decay; ``step`` an integer tensor."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """(the f32 gradients scaled to at most ``max_norm``, their norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, tree), norm


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _master(params):
    # f32 master copy: bf16 params would silently swallow updates smaller
    # than one ulp (~0.8% near 1.0)
    return tree_map(lambda p: p.detach().float().clone(), params)


def _step0(params):
    device = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=device)


def _write(p, new_master):
    """The parameter takes the new master value in its own dtype."""
    p.copy_(new_master.to(p.dtype))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params):
    return {"step": _step0(params), "m": tree_map(_zeros_f32, params),
            "v": tree_map(_zeros_f32, params), "master": _master(params)}


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads, state):
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    state["step"].add_(1)
    lr = lr_schedule(cfg, state["step"])
    b1, b2 = cfg.b1, cfg.b2
    t = state["step"].float()
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t

    def upd(p, g, m, v, master):
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        u = u + cfg.weight_decay * master
        master.sub_(lr * u)
        _write(p, master)

    tree_map(upd, params, grads, state["m"], state["v"], state["master"])
    return params, state, {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# Adafactor (factored second moments)
# ---------------------------------------------------------------------------

def _factored(p) -> bool:
    return p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def adafactor_init(params):
    def init_one(p):
        if _factored(p):
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device)}
        return {"v": _zeros_f32(p)}
    return {"step": _step0(params), "v": tree_map(init_one, params),
            "master": _master(params)}


@torch.no_grad()
def adafactor_update(cfg: OptConfig, params, grads, state):
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    state["step"].add_(1)
    lr = lr_schedule(cfg, state["step"])
    t = state["step"].float()
    beta2 = 1.0 - t ** -0.8
    eps = 1e-30

    def upd(p, g, v, master):
        g2 = g * g + eps
        if _factored(p):
            vr = beta2 * v["vr"] + (1 - beta2) * g2.mean(dim=-1)
            vc = beta2 * v["vc"] + (1 - beta2) * g2.mean(dim=-2)
            denom = (vr[..., None] / torch.clamp(
                vr.mean(dim=-1, keepdim=True), min=eps)[..., None]) \
                * vc[..., None, :]
            u = g / torch.sqrt(torch.clamp(denom, min=eps))
            v["vr"].copy_(vr)
            v["vc"].copy_(vc)
        else:
            v["v"].copy_(beta2 * v["v"] + (1 - beta2) * g2)
            u = g / torch.sqrt(torch.clamp(v["v"], min=eps))
        # update clipping (RMS <= 1) per Shazeer & Stern
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms, min=1.0)
        u = u + cfg.weight_decay * master
        master.sub_(lr * u)
        _write(p, master)

    tree_map(upd, params, grads, state["v"], state["master"])
    return params, state, {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# unified front door
# ---------------------------------------------------------------------------

def opt_init(cfg: OptConfig, params):
    if cfg.name == "adamw":
        return adamw_init(params)
    if cfg.name == "adafactor":
        return adafactor_init(params)
    if cfg.name == "sgd":
        return {"step": _step0(params), "master": _master(params)}
    raise ValueError(cfg.name)


@torch.no_grad()
def opt_update(cfg: OptConfig, params, grads, state):
    """One update: (params, state, {"lr", "grad_norm"}), the parameters and
    the state updated in place."""
    if cfg.name == "adamw":
        return adamw_update(cfg, params, grads, state)
    if cfg.name == "adafactor":
        return adafactor_update(cfg, params, grads, state)
    if cfg.name == "sgd":
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        state["step"].add_(1)
        lr = lr_schedule(cfg, state["step"])

        def upd(p, g, master):
            master.sub_(lr * g)
            _write(p, master)
        tree_map(upd, params, grads, state["master"])
        return params, state, {"lr": lr, "grad_norm": gnorm}
    raise ValueError(cfg.name)
