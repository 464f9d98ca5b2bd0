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
