"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff=1408(expert)
vocab=102400 — MLA kv_lora=512, 2 shared + 64 routed experts top-6,
first layer dense [arXiv:2405.04434].

The assignment header says "MoE 64e top-6" and the inline note
"2 shared+160 routed top-6"; 160 routed belongs to full V2 — V2-Lite has
64 routed experts, which we follow (consistent with the 64e header).
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,          # v_head_dim; attention dims come from MLA fields
    d_ff=10944,            # first dense layer's FFN
    vocab=102_400,
    act="silu",
    pre=(LayerSpec(mixer="mla", mlp="gated"),),   # layer 0: dense FFN
    unit=(LayerSpec(mixer="mla", mlp="moe"),),
    kv_lora=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    n_experts=64,
    top_k=6,
    moe_d_ff=1408,
    n_shared_experts=2,
    supports_long=False,   # MLA cache is compressed but unbounded in S
    notes="MLA with absorbed decode; 2 shared experts",
)
