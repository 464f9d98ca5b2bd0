"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron (squared-ReLU MLP) [arXiv:2407.14679]."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab=256_000,
    act="relu2",
    unit=(LayerSpec(mixer="attn", mlp="dense"),),
    supports_long=False,
    notes="nemotron family: squared-ReLU dense MLP, full attention",
)
