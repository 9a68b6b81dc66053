"""seamless-m4t-medium [audio]: enc-dec, 12L+12L d_model=1024 16H d_ff=4096
vocab=256206 [arXiv:2308.11596].

Multimodal encoder-decoder.  The speech frontend (conformer feature
extractor) is a STUB: ``input_specs()`` provides precomputed audio frame
embeddings of shape (batch, frames, d_model).  Decode shapes run the text
decoder (causal self-attention + cross-attention over the encoder memory).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,            # decoder layers
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    embed_inputs=False,     # encoder consumes frame embeddings
    rope_theta=10_000.0,
)
