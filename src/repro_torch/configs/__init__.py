"""Config registry: one module per assigned architecture (--arch <id>).

All hyperparameters follow the assignment table (public-literature
configs); ``reduced(cfg)`` maps any config to a CPU-smoke-test version
of the same family.
"""
from __future__ import annotations

import dataclasses

from .base import (LayerSpec, ModelConfig, ShapeSpec, SHAPES,  # noqa: F401
                   shapes_for)

from . import (gemma2_2b, minitron_4b, starcoder2_15b, qwen1_5_4b,
               mamba2_780m, hymba_1_5b, mixtral_8x7b, deepseek_v2_lite_16b,
               qwen2_vl_2b, seamless_m4t_large_v2)

ARCHS = {
    "gemma2-2b": gemma2_2b.CONFIG,
    "minitron-4b": minitron_4b.CONFIG,
    "starcoder2-15b": starcoder2_15b.CONFIG,
    "qwen1.5-4b": qwen1_5_4b.CONFIG,
    "mamba2-780m": mamba2_780m.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b.CONFIG,
    "qwen2-vl-2b": qwen2_vl_2b.CONFIG,
    "seamless-m4t-large-v2": seamless_m4t_large_v2.CONFIG,
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests: same layer recipe,
    small dims, 2 unit repeats."""
    n_layers = len(cfg.pre) + 2 * len(cfg.unit)
    if cfg.enc_dec:
        n_layers = 2 * len(cfg.unit)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        kv_lora=32,
        qk_rope_dim=8,
        qk_nope_dim=16,
        v_head_dim=16,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else 64,
        ssm_chunk=16,
        n_enc_layers=2 if cfg.enc_dec else 0,
        n_vision_tokens=16 if cfg.vision_stub else 1024,
        mrope_sections=(2, 3, 3) if cfg.mrope else cfg.mrope_sections,
    )
