"""ONNX-isomorphic computation-graph IR.

The paper ingests DNNs "in ONNX format ... nodes correspond to operators,
and edges denote the data dependency between each operator" (§3.3.1) and
annotates optimization results as node attributes.  This module provides
the same representation without the onnx dependency (offline build):
``Node`` = operator with attrs, tensors are named edges, ``Graph`` keeps a
topological view plus shape inference, and scheduling passes attach their
results to ``node.sched`` (mirroring the paper's "adding attributes to the
nodes in the ONNX graph").

A loader for ONNX-shaped dicts (``Graph.from_dict``) accepts the schema
{"nodes": [{"name","op_type","inputs","outputs","attrs"}], "inputs": ...}
so externally-exported graphs can be ingested.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

# Operator taxonomy ---------------------------------------------------------
# CIM-supported operators are weight-stationary matmul-family ops that map
# onto crossbars (§3.2: cores/crossbars execute conv / MVM).  Everything
# else executes on the tier ALU (DCOM) — including activation x activation
# matmuls (attention QK^T / AV), which cannot be weight-stationary.
CIM_OPS = {"Conv", "Gemm", "Linear"}
ALU_OPS = {
    "Relu", "Gelu", "Silu", "Sigmoid", "Tanh", "Softmax", "LayerNorm",
    "RMSNorm", "BatchNorm", "Add", "Mul", "MaxPool", "AveragePool",
    "GlobalAveragePool", "Flatten", "Reshape", "Concat", "Split",
    "MatMul", "Embedding", "SSMScan", "RoPE", "TopKRouter", "Softcap",
    "Identity", "Transpose", "Constant",
}
KNOWN_OPS = CIM_OPS | ALU_OPS


@dataclasses.dataclass
class Node:
    name: str
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Scheduling results attached by compiler passes (paper: node attributes).
    sched: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.op_type not in KNOWN_OPS:
            raise ValueError(f"unknown op_type {self.op_type!r} in node {self.name!r}")

    @property
    def is_cim(self) -> bool:
        return self.op_type in CIM_OPS

    def __repr__(self) -> str:  # keep pytest output short
        return f"Node({self.name}:{self.op_type})"


@dataclasses.dataclass
class Graph:
    name: str
    nodes: List[Node]
    inputs: Dict[str, Tuple[int, ...]]          # tensor name -> shape
    outputs: List[str]
    shapes: Dict[str, Tuple[int, ...]] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self._producer: Dict[str, Node] = {}
        for n in self.nodes:
            for t in n.outputs:
                if t in self._producer:
                    raise ValueError(f"tensor {t!r} produced twice")
                self._producer[t] = n
        self._toposort()
        if not self.shapes:
            self.infer_shapes()

    # -- structure -------------------------------------------------------
    def _toposort(self) -> None:
        order: List[Node] = []
        seen: set = set()
        temp: set = set()

        def visit(n: Node):
            if n.name in seen:
                return
            if n.name in temp:
                raise ValueError(f"cycle through {n.name}")
            temp.add(n.name)
            for t in n.inputs:
                p = self._producer.get(t)
                if p is not None:
                    visit(p)
            temp.discard(n.name)
            seen.add(n.name)
            order.append(n)

        for n in self.nodes:
            visit(n)
        self.nodes = order

    def producer(self, tensor: str) -> Optional[Node]:
        return self._producer.get(tensor)

    def consumers(self, tensor: str) -> List[Node]:
        return [n for n in self.nodes if tensor in n.inputs]

    def predecessors(self, node: Node) -> List[Node]:
        out, seen = [], set()
        for t in node.inputs:
            p = self._producer.get(t)
            if p is not None and p.name not in seen:
                seen.add(p.name)
                out.append(p)
        return out

    def successors(self, node: Node) -> List[Node]:
        outs = set(node.outputs)
        result, seen = [], set()
        for n in self.nodes:
            if n.name not in seen and outs & set(n.inputs):
                seen.add(n.name)
                result.append(n)
        return result

    @property
    def cim_nodes(self) -> List[Node]:
        return [n for n in self.nodes if n.is_cim]

    def node(self, name: str) -> Node:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    # -- shape inference ---------------------------------------------------
    def infer_shapes(self) -> Dict[str, Tuple[int, ...]]:
        sh: Dict[str, Tuple[int, ...]] = dict(self.inputs)
        for n in self.nodes:
            try:
                infer_node_shape(n, sh)
            except KeyError as e:
                raise ValueError(f"missing shape for input {e} of {n}") from None
        self.shapes = sh
        return sh

    # -- fidelity slicing --------------------------------------------------
    def prefix(self, n_nodes: int) -> "Graph":
        """First ``n_nodes`` nodes (topological order) as a standalone graph.

        The reduced-fidelity proxy of the DSE searcher (dse.search): a
        prefix compiles and simulates like any graph, at a fraction of the
        cost, and its latency ranks design points like the full model does
        (the dropped suffix is built from the same operator population).
        Tensors whose consumers were all dropped become graph outputs, so
        no kept node dangles.  Nodes are copied — compiling a prefix never
        touches this graph's ``sched`` annotations.  ``n_nodes`` at or
        above ``len(self.nodes)`` returns ``self`` unchanged, so full-
        fidelity requests share compile-cache entries with direct compiles.
        """
        if n_nodes < 1:
            raise ValueError("prefix needs at least one node")
        if n_nodes >= len(self.nodes):
            return self
        kept = self.nodes[:n_nodes]
        kept_names = {n.name for n in kept}
        outputs = []
        for n in kept:
            for t in n.outputs:
                consumers = [c for c in self.consumers(t)
                             if c.name in kept_names]
                if t in self.outputs or not consumers:
                    outputs.append(t)
        nodes = [Node(n.name, n.op_type, list(n.inputs), list(n.outputs),
                      dict(n.attrs)) for n in kept]
        consumed = {t for n in kept for t in n.inputs}
        inputs = {t: shp for t, shp in self.inputs.items() if t in consumed}
        return Graph(f"{self.name}.prefix{n_nodes}", nodes, inputs, outputs)

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "nodes": [
                {"name": n.name, "op_type": n.op_type, "inputs": n.inputs,
                 "outputs": n.outputs, "attrs": n.attrs}
                for n in self.nodes
            ],
            "inputs": {k: list(v) for k, v in self.inputs.items()},
            "outputs": self.outputs,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Graph":
        nodes = [Node(x["name"], x["op_type"], list(x["inputs"]),
                      list(x["outputs"]), dict(x.get("attrs", {})))
                 for x in d["nodes"]]
        return cls(d["name"], nodes,
                   {k: tuple(v) for k, v in d["inputs"].items()},
                   list(d["outputs"]))


# ---------------------------------------------------------------------------
# Shape inference (batch=1 inference graphs; conv tensors are CHW).
# ---------------------------------------------------------------------------

def _conv_out_hw(h: int, w: int, k: int, stride: int, pad: int) -> Tuple[int, int]:
    return ((h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1)


def infer_node_shape(n: Node, sh: Dict[str, Tuple[int, ...]]) -> None:
    t = n.op_type
    if t == "Constant":                                 # reads no input
        sh[n.outputs[0]] = tuple(n.attrs["shape"])
        return
    x = sh[n.inputs[0]]
    if t == "Conv":
        cout, _, k, _ = n.attrs["weight_shape"]        # (Cout,Cin,k,k)
        stride, pad = n.attrs.get("stride", 1), n.attrs.get("pad", 0)
        oh, ow = _conv_out_hw(x[1], x[2], k, stride, pad)
        sh[n.outputs[0]] = (cout, oh, ow)
    elif t in ("Gemm", "Linear"):
        cin, cout = n.attrs["weight_shape"][-2:]        # (in,out)
        sh[n.outputs[0]] = tuple(x[:-1]) + (cout,)
    elif t == "MatMul":                                 # act x act
        y = sh[n.inputs[1]]
        last = y[-2] if n.attrs.get("transpose_b") else y[-1]
        sh[n.outputs[0]] = tuple(x[:-1]) + (last,)
    elif t in ("MaxPool", "AveragePool"):
        k = n.attrs.get("kernel", 2)
        stride = n.attrs.get("stride", k)
        pad = n.attrs.get("pad", 0)
        oh, ow = _conv_out_hw(x[1], x[2], k, stride, pad)
        sh[n.outputs[0]] = (x[0], oh, ow)
    elif t == "GlobalAveragePool":
        sh[n.outputs[0]] = (x[0], 1, 1)
    elif t == "Flatten":
        sh[n.outputs[0]] = (int(math.prod(x)),)
    elif t == "Reshape":
        sh[n.outputs[0]] = tuple(n.attrs["shape"])
    elif t == "Transpose":
        perm = n.attrs["perm"]
        sh[n.outputs[0]] = tuple(x[p] for p in perm)
    elif t == "Concat":
        axis = n.attrs.get("axis", -1)
        shapes = [sh[i] for i in n.inputs]
        axis = axis % len(x)
        out = list(x)
        out[axis] = sum(s[axis] for s in shapes)
        sh[n.outputs[0]] = tuple(out)
    elif t == "Split":
        axis = n.attrs.get("axis", -1) % len(x)
        parts = n.attrs["parts"]
        base = list(x)
        for o, p in zip(n.outputs, parts):
            base[axis] = p
            sh[o] = tuple(base)
    elif t == "Embedding":
        sh[n.outputs[0]] = tuple(x) + (n.attrs["weight_shape"][1],)
    elif t == "TopKRouter":
        sh[n.outputs[0]] = tuple(x[:-1]) + (n.attrs["n_experts"],)
    else:  # elementwise / normalization / misc keep shape of first input
        for o in n.outputs:
            sh[o] = x


# ---------------------------------------------------------------------------
# Workload-side queries used by the scheduler & perf model.
# ---------------------------------------------------------------------------

def weight_matrix_shape(n: Node) -> Tuple[int, int]:
    """(R, C): the logical weight matrix a crossbar mapping must hold.

    Conv (Cout,Cin,k,k) unrolls to R = Cin*k*k input rows, C = Cout
    columns (Figure 7's matrix-dimension view); Gemm is (in, out).
    """
    if n.op_type == "Conv":
        cout, cin, k, _ = n.attrs["weight_shape"]
        return cin * k * k, cout
    if n.op_type in ("Gemm", "Linear"):
        cin, cout = n.attrs["weight_shape"][-2:]
        return cin, cout
    raise ValueError(f"{n} has no crossbar weight matrix")


def n_mvm(n: Node, shapes: Dict[str, Tuple[int, ...]]) -> int:
    """Number of MVMs (sliding windows / token rows) one inference needs."""
    if n.op_type == "Conv":
        out = shapes[n.outputs[0]]
        return out[1] * out[2]
    if n.op_type in ("Gemm", "Linear"):
        x = shapes[n.inputs[0]]
        return int(math.prod(x[:-1])) if len(x) > 1 else 1
    raise ValueError(f"{n} is not an MVM-decomposable operator")


def macs(n: Node, shapes: Dict[str, Tuple[int, ...]]) -> int:
    """Multiply-accumulate count of a node (ALU cost for unsupported ops)."""
    if n.is_cim:
        r, c = weight_matrix_shape(n)
        return r * c * n_mvm(n, shapes)
    if n.op_type == "MatMul":
        x = shapes[n.inputs[0]]
        out = shapes[n.outputs[0]]
        return int(math.prod(x)) * out[-1]
    return out_elems(n, shapes)


def out_elems(n: Node, shapes: Dict[str, Tuple[int, ...]]) -> int:
    return int(math.prod(shapes[n.outputs[0]]))


def weight_bits(n: Node, bits: int) -> int:
    if not n.is_cim:
        return 0
    r, c = weight_matrix_shape(n)
    return r * c * bits
