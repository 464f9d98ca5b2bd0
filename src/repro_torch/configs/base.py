"""Architecture & shape configuration for the assigned model pool.

Every architecture is a ``ModelConfig``; every workload shape is a
``ShapeSpec``.  ``repro.configs.get_config(name)`` returns the full-size
config; ``.reduced()`` returns the CPU-smoke-test version of the same
family (same structure, tiny dims).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer's mixer/MLP recipe (the scan unit repeats a tuple of
    these — e.g. gemma2's (sliding, full) alternation)."""
    mixer: str = "attn"          # attn | mla | ssm | hybrid
    window: Optional[int] = None  # sliding-window size for attn mixers
    mlp: str = "gated"           # gated | dense | moe


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"
    # layer recipe: ``pre`` layers first, then ``unit`` repeated
    pre: Tuple[LayerSpec, ...] = ()
    unit: Tuple[LayerSpec, ...] = (LayerSpec(),)
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # MLA (deepseek-v2)
    kv_lora: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    # SSM
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # enc-dec
    enc_dec: bool = False
    n_enc_layers: int = 0
    # vision stub
    vision_stub: bool = False
    n_vision_tokens: int = 1024
    dtype: torch.dtype = torch.bfloat16
    # does decode state stay bounded at 500k context?
    supports_long: bool = False
    notes: str = ""

    @property
    def n_unit_repeats(self) -> int:
        n = self.n_layers - len(self.pre)
        if self.enc_dec:
            n = self.n_layers  # decoder layers; encoder counted separately
        assert n % len(self.unit) == 0, (self.name, n, len(self.unit))
        return n // len(self.unit)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Approximate parameter count (reported in EXPERIMENTS.md)."""
        from ..models import lm
        from ..models.layers import tree_leaves
        import math
        return sum(math.prod(x.shape)
                   for x in tree_leaves(lm.param_specs(self)))


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def shapes_for(cfg: ModelConfig):
    """The shape cells that apply to this architecture (skips recorded in
    DESIGN.md §4: long_500k only for bounded-state decoders)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.supports_long:
        out.append(SHAPES["long_500k"])
    return out
