"""qwen1.5-4b [dense]: 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936 — QKV bias [hf:Qwen/Qwen1.5-4B]."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab=151_936,
    act="silu",
    qkv_bias=True,
    unit=(LayerSpec(mixer="attn", mlp="gated"),),
    supports_long=False,
    notes="MHA (kv=heads), SwiGLU, QKV bias",
)
