"""Model/run configuration dataclasses.

One ``ModelConfig`` describes any of the assigned architectures; family-
specific sub-configs (MoE / SSM / xLSTM / enc-dec) are optional.  Configs are
plain frozen dataclasses so they hash (usable as jit static args).
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0            # always-on shared experts (DeepSeek-MoE)
    d_ff_expert: int = 0         # per-expert FFN width
    layer_period: int = 1        # MoE every k-th layer (1 = every layer)
    capacity_factor: float = 1.25
    group_size: int = 256        # GShard-style token group for dispatch


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64          # Mamba2 N
    expand: int = 2              # d_inner = expand * d_model
    conv_width: int = 4
    n_ssm_heads: int = 0         # 0 -> d_inner // 64
    attn_period: int = 0         # zamba2: shared attn block every k blocks
    chunk: int = 128             # SSD chunked-scan length


@dataclass(frozen=True)
class XLSTMConfig:
    pattern: tuple[str, ...] = ("mlstm", "slstm")  # repeating block pattern
    proj_factor: float = 2.0     # mLSTM up-projection
    conv_width: int = 4
    chunk: int = 0               # 0 = sequential scan; >0 = exact
                                 # chunk-parallel mLSTM (see §Perf)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense|moe|hybrid|ssm|encdec|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    xlstm: XLSTMConfig | None = None
    encoder_layers: int = 0      # enc-dec only
    embed_inputs: bool = True    # False: inputs are precomputed embeddings
                                 # (VLM patch / audio frame stubs)
    sliding_window: int = 0      # 0 = full causal
    subquadratic: bool = False   # eligible for long_500k
    remat: bool = True
    dtype: str = "bfloat16"
    # attention blocking for the pure-jnp flash path
    q_block: int = 512
    kv_block: int = 1024

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def scaled(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2 if not self.ssm else 6),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            head_dim=32,
            q_block=64,
            kv_block=64,
        )
        if self.moe:
            kw["moe"] = replace(self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                                d_ff_expert=64, group_size=32)
        if self.ssm:
            kw["ssm"] = replace(self.ssm, state_dim=16, chunk=16,
                                attn_period=min(self.ssm.attn_period, 3)
                                if self.ssm.attn_period else 0)
            kw["n_layers"] = 6
        if self.xlstm:
            kw["n_layers"] = 4
        if self.encoder_layers:
            kw["encoder_layers"] = 2
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Skip rules from the assignment (documented in DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k reserved for sub-quadratic (SSM/hybrid) archs"
    return True, ""
