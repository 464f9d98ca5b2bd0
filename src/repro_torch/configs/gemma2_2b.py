"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000 — local+global alternating attention, logit softcapping
[arXiv:2408.00118]."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256_000,
    act="gelu",
    # alternating local (sliding 4096) / global attention
    unit=(LayerSpec(mixer="attn", window=4096, mlp="gated"),
          LayerSpec(mixer="attn", window=None, mlp="gated")),
    attn_softcap=50.0,
    logit_softcap=30.0,
    supports_long=False,   # global layers keep an unbounded KV at 500k
    notes="local+global alternation; GeGLU; attn/logit softcaps",
)
