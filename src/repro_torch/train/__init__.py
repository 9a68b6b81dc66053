"""The port's fault-tolerant training loop (``repro.train``'s twin)."""
