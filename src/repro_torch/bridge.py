"""Weights across the framework boundary.

``params_from_jax`` maps the nested dict that ``repro.models.transformer.
init_params`` builds (converted to numpy by the caller, e.g. with
``jax.tree.map(np.asarray, params)``) to the port's tensors:

* layers stay stacked on axis 0 (``transformer.py:37`` ``_stacked``);
* weights stay (d_in, d_out), so ``x @ w`` matches ``layers.dense``;
* bf16 crosses bit for bit (numpy holds it as ``ml_dtypes.bfloat16``,
  which is reinterpreted through its 16-bit pattern, never re-rounded).

Any other dict of arrays crosses the same way, such as the merge-saving
MLP's flat ``w1..b3`` (``repro.core.predictor.MLPPredictor``) in f32.

``init_params`` is the torch-native random init for the card (no JAX, no
download), re-exported from ``models.transformer``.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.transformer import init_params

__all__ = ["params_from_jax", "init_params", "to_tensor"]


def to_tensor(arr, device=None) -> torch.Tensor:
    """One numpy array (bf16 included) -> tensor with identical bits (a
    copy: arrays from JAX are read-only), on ``device`` (CUDA unless
    ``"cpu"`` is passed)."""
    device = resolve_device(device)
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(tree, device=None):
    """Nested dict of numpy arrays -> the same nesting of tensors on
    ``device`` (CUDA unless ``"cpu"`` is passed)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return to_tensor(tree, device)
