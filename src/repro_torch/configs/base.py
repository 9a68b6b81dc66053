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
    # port only (no JAX twin): the top-k gates renormalised to sum to 1
    # (DeepSeek-MoE) or left as the softmax gave them (DeepSeek-V2), then
    # scaled by ``routed_scaling_factor``
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434) without a
    query compression, with YaRN RoPE on its rotary part.  Port only: the
    JAX package has no latent attention."""
    kv_lora_rank: int = 512      # the latent c_kv each token caches
    qk_nope_head_dim: int = 128  # per-head query/key width without RoPE
    qk_rope_head_dim: int = 64   # the rotary part, one key head shared
    v_head_dim: int = 128
    # YaRN (the published ``rope_scaling``)
    rope_factor: float = 40.0
    original_max_position: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Width of one cached token of one layer: [c_kv | k_pe]."""
        return self.kv_lora_rank + self.qk_rope_head_dim


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
    mla: MLAConfig | None = None  # port only: latent attention
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
        if self.mla:
            kw["mla"] = replace(self.mla, kv_lora_rank=64, qk_nope_head_dim=32,
                                qk_rope_head_dim=16, v_head_dim=32)
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
