"""Stand-ins for every model input on the ``meta`` device — shapes and
dtypes, no allocation (the dry-run pattern); the twin of
``repro.launch.specs``.

Modality frontends are stubs: [vlm]/[audio] cells receive precomputed
patch/frame embeddings here (one enc-dec frame per 4 target tokens).
"""

from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import transformer as T
from ..optim.optimizers import tree_leaves


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {"labels": _meta((b, s), torch.int32)}
    if cfg.family == "encdec":
        batch["tokens"] = _meta((b, s), torch.int32)
        # audio frontend stub: 1 frame embedding per 4 target tokens
        batch["enc_embeds"] = _meta((b, s // 4, cfg.d_model), torch.bfloat16)
    elif cfg.embed_inputs:
        batch["tokens"] = _meta((b, s), torch.int32)
    else:
        batch["embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
    return batch


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return {"tokens": _meta((b, s), torch.int32),
                "enc_embeds": _meta((b, s // 4, cfg.d_model),
                                    torch.bfloat16)}
    if cfg.embed_inputs:
        return {"tokens": _meta((b, s), torch.int32)}
    return {"embeds": _meta((b, s, cfg.d_model), torch.bfloat16)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(cache, tokens) for a single decode step with a KV cache of
    ``shape.seq_len`` tokens."""
    b, s = shape.global_batch, shape.seq_len
    return T.init_cache(cfg, b, s, "meta"), _meta((b,), torch.int32)


def param_shapes(cfg: ModelConfig) -> dict:
    return T.init_abstract(cfg)


def count_params(shapes) -> int:
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(shapes))


def active_params(cfg: ModelConfig, total: int) -> int:
    """Active parameters per token (MoE discount) for MODEL_FLOPS."""
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff_expert
    n_moe_layers = (cfg.n_layers if m.layer_period == 1 else
                    cfg.n_layers // m.layer_period)
    if m.layer_period == 1:
        n_moe_layers = cfg.n_layers - 1          # layer 0 dense
    routed_total = n_moe_layers * m.n_experts * per_expert
    routed_active = n_moe_layers * m.top_k * per_expert
    return total - routed_total + routed_active
