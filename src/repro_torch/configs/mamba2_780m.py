"""mamba2-780m [ssm]: 48L d_model=1536 (attn-free) vocab=50280
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060]."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,           # attention-free; SSM heads derived from d_inner
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab=50_280,
    unit=(LayerSpec(mixer="ssm", mlp="none"),),
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    supports_long=True,   # O(1) decode state
    notes="pure SSD blocks, no MLP; conv1d omitted (DESIGN.md §3)",
)
