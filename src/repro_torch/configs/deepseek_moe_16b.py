"""deepseek-moe-16b [moe]: 28L d_model=2048 16H d_ff=1408(expert)
vocab=102400, 64 routed experts top-6 + 2 shared experts (fine-grained
expert segmentation) [arXiv:2401.06066].

Total ≈ 16.4B params, ≈2.8B active per token.  Expert parallelism shards the
expert axis over the 'model' mesh axis (64/16 = 4 experts per shard) with
GShard-style grouped dispatch/combine einsums (all-to-alls inserted by
GSPMD).
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                  # dense first layer width (layer 0 is dense)
    vocab=102400,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
                  layer_period=1, capacity_factor=1.25, group_size=256),
    rope_theta=10_000.0,
)
