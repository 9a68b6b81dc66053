"""deepseek-v2-lite [moe + MLA]: 27L d_model=2048 16H, multi-head latent
attention (kv_lora_rank 512, no query compression; per head 128 + 64 for
q/k, 128 for v) with YaRN RoPE (factor 40 over 4,096 positions), layer 0
a dense SwiGLU of 10,944, layers 1-26 64 routed experts of 1,408 top-6
(softmax scores, greedy, not renormalised) + 2 shared, vocab=102400,
norms eps 1e-6 [hf:deepseek-ai/DeepSeek-V2-Lite, arXiv:2405.04434].

Total ≈ 15.7B params, ≈2.4B active per token.  Each token of each layer
caches one 576-wide latent row [RMSNorm(c_kv) | RoPE(k_pe)].  Port only:
the JAX package has no latent attention, so this config has no JAX twin
(``registry.PORT_ARCHS``).
"""

from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                  # the dense first layer
    vocab=102400,
    head_dim=192,                # qk_nope_head_dim + qk_rope_head_dim
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
                  layer_period=1, norm_topk_prob=False,
                  routed_scaling_factor=1.0),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128, rope_factor=40.0,
                  original_max_position=4096, beta_fast=32.0, beta_slow=1.0,
                  mscale=0.707, mscale_all_dim=0.707),
    rope_theta=10_000.0,
    norm_eps=1e-6,
)
