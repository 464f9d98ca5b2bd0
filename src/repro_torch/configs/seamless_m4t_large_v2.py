"""seamless-m4t-large-v2 [audio]: 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206 — encoder-decoder, multimodal [arXiv:2308.11596].

The speech/text modality frontend is a STUB per the assignment:
input_specs() provides precomputed frame embeddings for the encoder; the
enc-dec transformer backbone (bidirectional encoder, causal decoder with
cross-attention) is fully implemented.
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,           # decoder layers
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab=256_206,
    act="gelu",
    unit=(LayerSpec(mixer="attn", mlp="dense"),),
    enc_dec=True,
    supports_long=False,
    notes="enc-dec; frame-embedding frontend stubbed; encoder context "
          "capped at 4096 frames for decode shapes",
)
