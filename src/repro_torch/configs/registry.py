"""Architecture registry: ``get_arch(<id>)`` -> ModelConfig (the dense
architectures the port serves)."""

from __future__ import annotations

from .base import ModelConfig
from .smollm_360m import CONFIG as _smollm

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [_smollm]}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
