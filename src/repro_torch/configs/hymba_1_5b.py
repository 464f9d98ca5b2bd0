"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001 ssm_state=16 — parallel attn+mamba heads [arXiv:2411.13676]."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32_001,
    act="silu",
    # parallel attention + mamba heads per layer; attention is sliding
    # window (Hymba uses SWA in all but 3 layers — simplified to all-SWA,
    # recorded in DESIGN.md §4)
    unit=(LayerSpec(mixer="hybrid", window=1024, mlp="gated"),),
    ssm_state=16,
    ssm_headdim=64,
    ssm_expand=1,         # mamba branch matches model width
    supports_long=True,   # SSM state + window-bounded KV
    notes="parallel attn+SSM heads fused by mean; all-SWA simplification",
)
