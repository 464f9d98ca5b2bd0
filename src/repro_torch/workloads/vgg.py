"""VGG series (Simonyan & Zisserman) as computation graphs.

VGG16 is the PUMA comparison benchmark (Fig. 20(b)); VGG7 is the Jain et
al. comparison benchmark (Fig. 20(c)).  Graphs are single-image (batch=1,
CHW tensors) 8-bit inference graphs, matching §4.1.
"""
from __future__ import annotations

from typing import List, Tuple

from ..core.graph import Graph, Node


def _conv_block(nodes: List[Node], idx: int, tin: str, cin: int, cout: int,
                k: int = 3, pad: int = 1, stride: int = 1) -> Tuple[int, str]:
    conv = f"conv{idx}"
    nodes.append(Node(conv, "Conv", [tin], [f"{conv}.out"],
                      {"weight_shape": (cout, cin, k, k),
                       "stride": stride, "pad": pad}))
    nodes.append(Node(f"relu{idx}", "Relu", [f"{conv}.out"],
                      [f"relu{idx}.out"]))
    return idx + 1, f"relu{idx}.out"


def _pool(nodes: List[Node], idx: int, tin: str) -> Tuple[int, str]:
    nodes.append(Node(f"pool{idx}", "MaxPool", [tin], [f"pool{idx}.out"],
                      {"kernel": 2, "stride": 2}))
    return idx + 1, f"pool{idx}.out"


def _vgg(name: str, cfg, in_hw: int, fcs, n_classes: int) -> Graph:
    nodes: List[Node] = []
    t = "input"
    cin = 3
    ci, pi = 0, 0
    for entry in cfg:
        if entry == "M":
            pi, t = _pool(nodes, pi, t)
        else:
            ci, t = _conv_block(nodes, ci, t, cin, entry)
            cin = entry
    nodes.append(Node("flatten", "Flatten", [t], ["flat.out"]))
    t = "flat.out"
    for i, width in enumerate(fcs + [n_classes]):
        fc = f"fc{i}"
        # Flatten output dimension is inferred at shape-inference time;
        # record -1 and fix up below.
        nodes.append(Node(fc, "Gemm", [t], [f"{fc}.out"],
                          {"weight_shape": (-1, width)}))
        if i < len(fcs):
            nodes.append(Node(f"fcrelu{i}", "Relu", [f"{fc}.out"],
                              [f"fcrelu{i}.out"]))
            t = f"fcrelu{i}.out"
        else:
            t = f"{fc}.out"

    g = _finalize(name, nodes, (3, in_hw, in_hw), t)
    return g


def _finalize(name: str, nodes: List[Node], in_shape, out_tensor) -> Graph:
    """Resolve -1 Gemm input dims using shape inference."""
    # first pass with placeholder to compute flatten dims
    shapes = {"input": in_shape}
    from ..core.graph import infer_node_shape
    for n in nodes:
        if n.op_type in ("Gemm", "Linear") and n.attrs["weight_shape"][0] == -1:
            cin = shapes[n.inputs[0]][-1]
            n.attrs["weight_shape"] = (cin, n.attrs["weight_shape"][1])
        infer_node_shape(n, shapes)
    return Graph(name, nodes, {"input": tuple(in_shape)}, [out_tensor])


def vgg16(n_classes: int = 1000, in_hw: int = 224) -> Graph:
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
    return _vgg("vgg16", cfg, in_hw, [4096, 4096], n_classes)


def vgg7(n_classes: int = 10, in_hw: int = 32) -> Graph:
    """VGG7 (6 conv + 1 fc), the standard CIFAR-scale benchmark used for
    CIM macro evaluations (Jain et al. comparison)."""
    cfg = [128, 128, "M", 256, 256, "M", 512, 512, "M"]
    return _vgg("vgg7", cfg, in_hw, [1024], n_classes)
