"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 200 --batch 8 --seq 256 --reduced

The port of ``repro.launch.train``: the JAX launcher's flags and output
(the metrics log as JSON, then the final step and the straggler ticks),
plus ``--device`` (CUDA by default; ``--device cpu`` runs the kernels'
plain versions on the host).  Without ``--reduced`` the model is the
registered config at full width.  The loop is fault tolerant: re-running
the same command resumes from the latest checkpoint in ``--ckpt-dir``
(default ``build/repro_train``, under the working directory).
"""

from __future__ import annotations

import argparse
import json

from ..configs.registry import get_arch
from ..data.pipeline import DataConfig
from ..optim.optimizers import OptConfig
from ..train.trainer import TrainConfig, Trainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="build/repro_train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--data-path", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model trains on (cuda, or cpu "
                         "for the kernels' plain versions)")
    return ap.parse_args(argv)


def build_trainer(args: argparse.Namespace) -> Trainer:
    """The ``Trainer`` a command line asks for."""
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt = OptConfig(name=args.optimizer, lr=args.lr,
                    warmup_steps=max(args.steps // 20, 5),
                    decay_steps=args.steps)
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, source=args.data,
                      path=args.data_path)
    tcfg = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every,
                       grad_accum=args.grad_accum)
    return Trainer(cfg, opt, data, tcfg, device=args.device)


def main(argv=None):
    trainer = build_trainer(parse_args(argv))
    trainer.install_preemption_handler()
    state = trainer.run()
    print(json.dumps(trainer.metrics_log, indent=2))
    print(f"finished at step {state.step}; straggler ticks: "
          f"{trainer.straggler_ticks}")


if __name__ == "__main__":
    main()
