"""PyTorch/CUDA port of the serverless serving system (``repro``).

The layout mirrors ``repro`` module for module.  The port imports
``torch`` and never ``jax``, and nothing of ``repro``: the framework-free
scheduling modules are carried over as copies.  Entry points run on CUDA
unless the caller passes ``device="cpu"``; see ``device.resolve_device``.
"""
