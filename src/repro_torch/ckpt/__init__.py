"""Checkpoints of the port's trainer, in ``repro.ckpt``'s on-disk format."""
