"""DeepSeek-V2-Lite (DeepSeek-AI, arXiv:2405.04434; the published
``config.json`` and ``modeling_deepseek.py`` of deepseek-ai/DeepSeek-V2-Lite)
as a CIM computation graph over one prompt's embedding rows.

Each layer is pre-norm multi-head latent attention (MLA) with YaRN
rotary embeddings on its decoupled rope part, then either a dense
SwiGLU (the first ``first_k_dense`` layers) or a mixture of experts: a
router over all ``n_experts`` experts picks the top ``top_k`` of each
token, the experts this chip holds each run a SwiGLU on the tokens
routed to them, and the shared experts run on every token.  Every
weight-stationary projection is a ``Gemm``; the attention products are
activation x activation ``MatMul``s, the rest DCOM operators.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

from ..core.graph import Graph, Node

#: YaRN's rotary parameters: ``rope_theta`` as ``base`` and the
#: published ``rope_scaling``
YARN = dict(base=10000.0, factor=40.0, original_max_position_embeddings=4096,
            beta_fast=32.0, beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707)


def yarn_mscale(factor: float, mscale: float) -> float:
    """``yarn_get_mscale`` of the modeling code."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def softmax_scale(q_head_dim: int, yarn: Dict = YARN) -> float:
    """The attention's score scale: ``q_head_dim ** -0.5`` times the
    square of YaRN's ``mscale_all_dim`` factor."""
    m = yarn_mscale(yarn["factor"], yarn["mscale_all_dim"])
    return q_head_dim ** -0.5 * m * m


def deepseek_v2_lite(seq: int = 2048, d: int = 2048, n_layers: int = 27,
                     n_heads: int = 16, qk_nope: int = 128,
                     qk_rope: int = 64, v_dim: int = 128,
                     kv_lora: int = 512, d_ff: int = 10944,
                     moe_d_ff: int = 1408, n_experts: int = 64,
                     top_k: int = 6, n_shared: int = 2,
                     first_k_dense: int = 1,
                     experts_held: Sequence[int] = tuple(range(64)),
                     vocab: int = 102400, yarn: Dict = YARN) -> Graph:
    """The graph of ``n_layers`` layers over one prompt of ``seq``
    tokens: the int8 embedding rows ``embeds`` (``seq``, ``d``) in,
    clipped to int8 (``embed``), next-token logits ``lm_head.out`` (1,
    ``vocab``) out.

    Attention (MLA, no query compression): ``wq`` gives each head's
    ``qk_nope`` and ``qk_rope`` parts, ``wkva`` the latent ``c_kv``
    (``kv_lora``) and one rope key ``k_pe`` for all heads; ``wkvb``
    expands the RMS-normed latent into each head's key and value.  The
    rope parts take ``RoPE`` with the ``yarn`` parameters at positions
    0..seq-1; the scores are a causal ``Softmax`` scaled by
    ``softmax_scale``.  An MoE layer's
    ``router`` Gemm gives ``n_experts`` logits, ``TopKRouter`` their
    softmax's top ``top_k`` gates, and ``MoE`` sums the gated outputs of
    the experts in ``experts_held`` (this chip's share) for the tokens
    routed to them; the ``n_shared`` shared experts are one SwiGLU of
    ``n_shared * moe_d_ff``.  RMSNorm carries no gain, as the flow's
    norms; biases are absent, as published.

    A Gemm too large for the chip is cut into row chunks that start on
    crossbar boundaries (``aligned_rows``): each analog read then sums
    the rows it would in the whole matrix, as the benchmark's reference
    models them, at 10944 and 2816 rows too."""
    held = tuple(int(e) for e in experts_held)
    if not held or len(set(held)) != len(held) or \
            not all(0 <= e < n_experts for e in held):
        raise ValueError(f"experts_held {held} of {n_experts} experts")
    if top_k > n_experts or seq < 2:
        raise ValueError(f"top_k={top_k} of {n_experts}, seq={seq}")
    dq = qk_nope + qk_rope
    nodes: List[Node] = []

    def add(name, op, inputs, outputs=None, **attrs):
        outs = outputs or [f"{name}.out"]
        nodes.append(Node(name, op, list(inputs), outs, attrs))
        return outs[0] if len(outs) == 1 else outs

    def gemm(name, x, cin, cout):
        return add(name, "Gemm", [x], weight_shape=(cin, cout),
                   aligned_rows=True)

    def rope(name, x):
        return add(name, "RoPE", [x], dim=qk_rope, axis=0,
                   interleaved=True, **yarn)

    def swiglu(p, x, width):
        g = add(f"{p}act", "Silu", [gemm(f"{p}w_gate", x, d, width)])
        u = gemm(f"{p}w_up", x, d, width)
        return gemm(f"{p}w_down", add(f"{p}gu", "Mul", [g, u]), width, d)

    # the chip takes int8 rows: stated, so the first norm's operand is
    # known to be in range, as every later one is
    x = add("embed", "Clip", ["embeds"], min=-128, max=127)
    for i in range(n_layers):
        p = f"l{i}."
        h = add(f"{p}attn_norm", "RMSNorm", [x])
        q = add(f"{p}q.split", "Reshape", [gemm(f"{p}wq", h, d, n_heads * dq)],
                shape=(seq, n_heads, dq))
        q_nope, q_pe = add(f"{p}q", "Split", [q],
                           [f"{p}q.nope", f"{p}q.pe"], axis=-1,
                           parts=(qk_nope, qk_rope))
        q = add(f"{p}q.cat", "Concat", [q_nope, rope(f"{p}q_rope", q_pe)],
                axis=-1)
        q = add(f"{p}q.heads", "Transpose", [q], perm=(1, 0, 2))
        c_kv, k_pe = add(f"{p}kva", "Split",
                         [gemm(f"{p}wkva", h, d, kv_lora + qk_rope)],
                         [f"{p}kva.ckv", f"{p}kva.kpe"], axis=-1,
                         parts=(kv_lora, qk_rope))
        kv = gemm(f"{p}wkvb", add(f"{p}kv_norm", "RMSNorm", [c_kv]),
                  kv_lora, n_heads * (qk_nope + v_dim))
        kv = add(f"{p}kv.split", "Reshape", [kv],
                 shape=(seq, n_heads, qk_nope + v_dim))
        k_nope, v = add(f"{p}kv", "Split", [kv],
                        [f"{p}kv.k", f"{p}kv.v"], axis=-1,
                        parts=(qk_nope, v_dim))
        k_pe = add(f"{p}k_pe.one", "Reshape", [rope(f"{p}k_rope", k_pe)],
                   shape=(seq, 1, qk_rope))
        k_pe = add(f"{p}k_pe.heads", "Concat", [k_pe] * n_heads, axis=1)
        k = add(f"{p}k.cat", "Concat", [k_nope, k_pe], axis=-1)
        k = add(f"{p}k.heads", "Transpose", [k], perm=(1, 0, 2))
        v = add(f"{p}v.heads", "Transpose", [v], perm=(1, 0, 2))
        a = add(f"{p}qkt", "MatMul", [q, k], transpose_b=True)
        a = add(f"{p}smax", "Softmax", [a], scale=softmax_scale(dq, yarn),
                causal=True)
        a = add(f"{p}av", "MatMul", [a, v])
        a = add(f"{p}merge", "Transpose", [a], perm=(1, 0, 2))
        a = add(f"{p}merge.flat", "Reshape", [a], shape=(seq, n_heads * v_dim))
        x = add(f"{p}res1", "Add", [x, gemm(f"{p}wo", a, n_heads * v_dim, d)])
        h = add(f"{p}ffn_norm", "RMSNorm", [x])
        if i < first_k_dense:
            y = swiglu(p, h, d_ff)
        else:
            r = add(f"{p}route", "TopKRouter",
                    [gemm(f"{p}router", h, d, n_experts)],
                    n_experts=n_experts, top_k=top_k, scale=1.0)
            outs = [swiglu(f"{p}e{e}.", h, moe_d_ff) for e in held]
            y = add(f"{p}moe", "MoE", [r] + outs, experts=held)
            y = add(f"{p}ffn", "Add",
                    [y, swiglu(f"{p}shared.", h, n_shared * moe_d_ff)])
        x = add(f"{p}res2", "Add", [x, y])
    x = add("norm", "RMSNorm", [x])
    add("last", "Split", [x], ["last.rest", "last.out"], axis=0,
        parts=(seq - 1, 1))
    gemm("lm_head", "last.out", d, vocab)
    return Graph("deepseek_v2_lite", nodes, {"embeds": (seq, d)},
                 ["lm_head.out"])
