"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 — 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32_000,
    act="silu",
    unit=(LayerSpec(mixer="attn", window=4096, mlp="moe"),),
    n_experts=8,
    top_k=2,
    moe_d_ff=14336,
    supports_long=True,   # SWA: KV bounded by the 4096 window
    notes="SWA keeps the decode KV window-bounded -> long_500k runs",
)
