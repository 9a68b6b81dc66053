"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

AnyRes tiling VLM [hf:llava-hf/llava-v1.6-34b-hf].  The vision frontend is a
STUB per the assignment: ``input_specs()`` supplies precomputed patch
embeddings (anyres tiles flattened into the sequence) and the backbone
transformer consumes them directly (``embed_inputs=False``).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    embed_inputs=False,
    rope_theta=5_000_000.0,
)
