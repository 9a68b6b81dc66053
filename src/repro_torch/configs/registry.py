"""Architecture registry: ``--arch <id>`` -> ModelConfig."""

from __future__ import annotations

from .base import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from .deepseek_moe_16b import CONFIG as _deepseek
from .deepseek_v2_lite import CONFIG as _deepseek_v2
from .llama3_8b import CONFIG as _llama3
from .llama4_maverick_400b import CONFIG as _llama4
from .llava_next_34b import CONFIG as _llava
from .qwen15_4b import CONFIG as _qwen
from .seamless_m4t_medium import CONFIG as _seamless
from .smollm_360m import CONFIG as _smollm
from .xlstm_125m import CONFIG as _xlstm
from .yi_9b import CONFIG as _yi
from .zamba2_2p7b import CONFIG as _zamba

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [
    _llava, _yi, _smollm, _qwen, _llama3, _seamless, _zamba, _deepseek,
    _llama4, _xlstm,
]}
#: archs the port serves that the JAX package has no twin of (it has no
#: latent attention); the dry-run cells (``all_cells``) cover ``ARCHS`` only
PORT_ARCHS: dict[str, ModelConfig] = {c.name: c for c in [_deepseek_v2]}


def get_arch(name: str) -> ModelConfig:
    cfg = ARCHS.get(name, PORT_ARCHS.get(name))
    if cfg is None:
        raise KeyError(f"unknown arch {name!r}; have "
                       f"{sorted(ARCHS) + sorted(PORT_ARCHS)}")
    return cfg


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells(include_skipped: bool = False):
    """All (arch, shape) cells, honouring the DESIGN.md §4 skip rules."""
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            ok, why = shape_applicable(arch, shape)
            if ok or include_skipped:
                yield arch, shape, ok, why
