"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution [arXiv:2409.12191].

The vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings; the transformer backbone (text+vision
token stream with 3-D M-RoPE positions) is fully implemented.
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151_936,
    act="silu",
    qkv_bias=True,
    unit=(LayerSpec(mixer="attn", mlp="gated"),),
    mrope=True,
    mrope_sections=(16, 24, 24),
    vision_stub=True,
    n_vision_tokens=1024,
    supports_long=False,
    notes="M-RoPE backbone; patch-embed frontend stubbed",
)
