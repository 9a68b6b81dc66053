"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.

Small llama-architecture model [hf:HuggingFaceTB/SmolLM-360M].  Note the
non-power-of-two head count (15 heads, kv=5): on a 16-way tensor axis the
GSPMD partitioner pads the head dimension (see DESIGN.md §3).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
    rope_theta=10_000.0,
)
