"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192, vocab=202048, 128 routed experts top-1 + 1 shared expert, MoE on
every other layer (interleaved dense/MoE) [hf:meta-llama/Llama-4-Maverick].

Parameter budget derivation (documented per DESIGN.md §4):
  - 24 MoE layers x 128 experts x 3 x 5120 x 8192 ≈ 386.5B routed
  - 24 dense-FFN layers + 24 shared experts x 3 x 5120 x 8192 ≈ 12.9B
  - attention 48 x (5120x5120 + 2x5120x1024 + 5120x5120) ≈ 3.0B
  - embeddings 2 x 202048 x 5120 ≈ 2.1B
  -> ≈ 404B total; active/token ≈ 17B (top-1 + shared + dense + attn).

Default optimizer is Adafactor: Adam f32 states for 400B would not fit a
256-chip v5e pod (4 TB HBM).
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    moe=MoEConfig(n_experts=128, top_k=1, n_shared=1, d_ff_expert=8192,
                  layer_period=2, capacity_factor=1.25, group_size=256),
    rope_theta=500_000.0,
)
