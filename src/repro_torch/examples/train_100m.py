"""End-to-end training example: train a ~100M-param smollm-family model for a
few hundred steps on the synthetic pipeline, with checkpoints + resume.

    PYTHONPATH=src python -m repro_torch.examples.train_100m \
        [--steps 300] [--full-width] [--device cuda]

The port of ``examples/train_100m.py``.  The default runs a narrow
variant; ``--full-width`` uses the real ~100M geometry (smollm-360m's at
12 layers, 8 x 512 tokens a step).  Re-running the same command resumes
from the latest checkpoint in ``--ckpt-dir`` (default
``build/repro_train_100m``, under the working directory; kill it mid-run
to see the fault tolerance).  ``--device`` is CUDA by default and raises
without a card: every norm then runs through the RMSNorm kernel and its
gradient through the RMSNorm backward kernel; ``--device cpu`` runs their
plain versions.  On the card the last line is the kernels' launch
counts.
"""

import argparse
import json

from .. import kernels
from ..configs.registry import get_arch
from ..data.pipeline import DataConfig
from ..device import resolve_device
from ..optim.optimizers import OptConfig
from ..train.trainer import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--ckpt-dir", default="build/repro_train_100m")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model trains on (cuda, or cpu "
                         "for the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base = get_arch("smollm-360m")
    if args.full_width:
        # ~107M params: smollm geometry at 12 layers
        cfg = base.scaled(n_layers=12, remat=False)
        seq, batch = 512, 8
    else:
        cfg = base.reduced().scaled(n_layers=4, d_model=256, n_heads=4,
                                    n_kv_heads=2, d_ff=768, vocab=2048,
                                    head_dim=64, remat=False)
        seq, batch = 256, 8

    trainer = Trainer(
        cfg,
        OptConfig(lr=1e-3, warmup_steps=20, decay_steps=args.steps),
        DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch),
        TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                    ckpt_every=50, log_every=10),
        device=device)
    trainer.install_preemption_handler()
    resumed = trainer.ckpt.latest_step()
    if resumed is not None:
        print(f"resuming from the checkpoint at step {resumed}")
    kernels.reset_launch_counts()
    state = trainer.run()
    counts = kernels.launch_counts()
    for m in trainer.metrics_log:
        print(f"step {m['step']:4d}  loss {m['loss']:.4f}  "
              f"lr {m['lr']:.2e}  {m['dt'] * 1e3:.0f} ms")
    if trainer.metrics_log:
        first = trainer.metrics_log[0]["loss"]
        last = trainer.metrics_log[-1]["loss"]
        print(f"\nfinished at step {state.step}: loss {first:.3f} -> "
              f"{last:.3f}")
    else:
        print(f"\nfinished at step {state.step}: no step logged this run")
    if device.type == "cuda":
        print(f"kernel launches {json.dumps(counts)}")


if __name__ == "__main__":
    main()
