"""Optimizers of the port's trainer (the torch twin of ``repro.optim``)."""
