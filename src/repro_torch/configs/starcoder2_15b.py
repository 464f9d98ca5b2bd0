"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE [arXiv:2402.19173]."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab=49_152,
    act="gelu",
    qkv_bias=True,
    unit=(LayerSpec(mixer="attn", mlp="dense"),),
    rope_theta=100_000.0,
    supports_long=False,
    notes="full attention (assignment lists GQA+RoPE only); gelu MLP",
)
