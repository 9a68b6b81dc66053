"""zamba2-2.7b [hybrid]: 54 blocks d_model=2560, Mamba2 backbone (state 64)
+ a *shared* full-attention block (32H, d_ff=10240 MLP) applied every 6
Mamba2 blocks with re-used weights but distinct KV caches [arXiv:2411.15242].

Sub-quadratic: eligible for the long_500k decode shape (the SSM state is
O(1) per step; the shared-attention KV is O(L) but decode attention is a
single-query read).
"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm=SSMConfig(state_dim=64, expand=2, conv_width=4, attn_period=6),
    subquadratic=True,
    rope_theta=10_000.0,
)
