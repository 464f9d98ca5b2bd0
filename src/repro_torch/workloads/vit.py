"""ViT (Dosovitskiy et al.) computation graph — §4.4 sensitivity benchmark.

Transformer blocks expose the CIM-applicability split: Q/K/V/O and MLP
projections are weight-stationary Gemms (crossbar-mappable), while QK^T
and AV are activation x activation MatMuls that execute on the ALU —
exactly the distinction CIM-MLC's meta-operator flow records.
"""
from __future__ import annotations

from typing import List

from ..core.graph import Graph, Node


def vit_base(n_layers: int = 12, d: int = 768, n_heads: int = 12,
             d_ff: int = 3072, n_tokens: int = 197,
             n_classes: int = 1000) -> Graph:
    nodes: List[Node] = []
    t = "tokens"   # (n_tokens, d) patch embeddings

    def gemm(name, tin, cin, cout):
        nodes.append(Node(name, "Gemm", [tin], [f"{name}.out"],
                          {"weight_shape": (cin, cout)}))
        return f"{name}.out"

    for l in range(n_layers):
        p = f"l{l}."
        ln1 = f"{p}ln1.out"
        nodes.append(Node(f"{p}ln1", "LayerNorm", [t], [ln1]))
        q = gemm(f"{p}wq", ln1, d, d)
        k = gemm(f"{p}wk", ln1, d, d)
        v = gemm(f"{p}wv", ln1, d, d)
        nodes.append(Node(f"{p}qkt", "MatMul", [q, k], [f"{p}qkt.out"],
                          {"transpose_b": True}))
        nodes.append(Node(f"{p}smax", "Softmax", [f"{p}qkt.out"],
                          [f"{p}smax.out"]))
        nodes.append(Node(f"{p}av", "MatMul", [f"{p}smax.out", v],
                          [f"{p}av.out"]))
        o = gemm(f"{p}wo", f"{p}av.out", d, d)
        nodes.append(Node(f"{p}res1", "Add", [t, o], [f"{p}res1.out"]))
        t = f"{p}res1.out"
        ln2 = f"{p}ln2.out"
        nodes.append(Node(f"{p}ln2", "LayerNorm", [t], [ln2]))
        h = gemm(f"{p}fc1", ln2, d, d_ff)
        nodes.append(Node(f"{p}gelu", "Gelu", [h], [f"{p}gelu.out"]))
        h2 = gemm(f"{p}fc2", f"{p}gelu.out", d_ff, d)
        nodes.append(Node(f"{p}res2", "Add", [t, h2], [f"{p}res2.out"]))
        t = f"{p}res2.out"

    nodes.append(Node("ln_f", "LayerNorm", [t], ["ln_f.out"]))
    head = Node("head", "Gemm", ["ln_f.out"], ["head.out"],
                {"weight_shape": (d, n_classes)})
    nodes.append(head)
    return Graph("vit", nodes, {"tokens": (n_tokens, d)}, ["head.out"])


def vit_b16(in_hw: int = 224, patch: int = 16, d: int = 768,
            n_layers: int = 12, n_heads: int = 12, d_ff: int = 3072,
            n_classes: int = 1000, param_seed: int = 0) -> Graph:
    """ViT-B/16 as published (Dosovitskiy et al., ICLR 2021,
    arXiv:2010.11929, Eq. 1-4 and Table 1): a ``patch`` x ``patch``
    stride-``patch`` convolution embeds the (3, ``in_hw``, ``in_hw``)
    image, a learned class token is prepended and a learned position
    table added; each of ``n_layers`` pre-norm blocks runs multi-head
    self-attention with ``n_heads`` heads of ``d / n_heads`` (scores
    scaled by ``(d / n_heads) ** -0.5`` inside the Softmax) and a GELU
    MLP; the head classifies the class token after the final LayerNorm.

    The class token and the position table are ``Constant`` nodes whose
    int8 values ``functional.constant_value`` draws from the node name
    and ``param_seed``.  As the flow's other graphs, it has no biases,
    and LayerNorm carries no gain or offset.
    """
    if d % n_heads or in_hw % patch:
        raise ValueError(f"d={d} over {n_heads} heads, image {in_hw} "
                         f"in patches of {patch}")
    dh = d // n_heads
    grid = in_hw // patch
    n_tok = grid * grid + 1
    nodes: List[Node] = []

    def add(name, op, inputs, **attrs):
        nodes.append(Node(name, op, inputs, [f"{name}.out"], attrs))
        return f"{name}.out"

    def gemm(name, tin, cin, cout):
        return add(name, "Gemm", [tin], weight_shape=(cin, cout))

    def heads(name, t):
        """(T, d) -> (H, T, dh)."""
        t = add(f"{name}.split", "Reshape", [t], shape=(n_tok, n_heads, dh))
        return add(f"{name}.heads", "Transpose", [t], perm=(1, 0, 2))

    x = add("patch", "Conv", ["image"], weight_shape=(d, 3, patch, patch),
            stride=patch, pad=0)
    x = add("patch.flat", "Reshape", [x], shape=(d, grid * grid))
    x = add("patch.tokens", "Transpose", [x], perm=(1, 0))
    cls = add("cls", "Constant", [], shape=(1, d), seed=param_seed)
    x = add("tokens", "Concat", [cls, x], axis=0)
    pos = add("pos", "Constant", [], shape=(n_tok, d), seed=param_seed)
    t = add("embed", "Add", [x, pos])

    for l in range(n_layers):
        p = f"l{l}."
        h = add(f"{p}ln1", "LayerNorm", [t])
        q = heads(f"{p}q", gemm(f"{p}wq", h, d, d))
        k = heads(f"{p}k", gemm(f"{p}wk", h, d, d))
        v = heads(f"{p}v", gemm(f"{p}wv", h, d, d))
        a = add(f"{p}qkt", "MatMul", [q, k], transpose_b=True)
        a = add(f"{p}smax", "Softmax", [a], scale=dh ** -0.5)
        a = add(f"{p}av", "MatMul", [a, v])
        a = add(f"{p}merge", "Transpose", [a], perm=(1, 0, 2))
        a = add(f"{p}merge.flat", "Reshape", [a], shape=(n_tok, d))
        t = add(f"{p}res1", "Add", [t, gemm(f"{p}wo", a, d, d)])
        h = add(f"{p}ln2", "LayerNorm", [t])
        h = add(f"{p}gelu", "Gelu", [gemm(f"{p}fc1", h, d, d_ff)])
        t = add(f"{p}res2", "Add", [t, gemm(f"{p}fc2", h, d_ff, d)])

    t = add("ln_f", "LayerNorm", [t])
    nodes.append(Node("cls_token", "Split", [t],
                      ["cls_token.out", "cls_token.rest"],
                      {"axis": 0, "parts": (1, n_tok - 1)}))
    gemm("head", "cls_token.out", d, n_classes)
    return Graph("vit_b16", nodes, {"image": (3, in_hw, in_hw)},
                 ["head.out"])
