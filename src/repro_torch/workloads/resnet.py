"""ResNet series (He et al.) computation graphs — §4.3 benchmark."""
from __future__ import annotations

from typing import List

from ..core.graph import Graph, Node


class _B:
    def __init__(self):
        self.nodes: List[Node] = []
        self.i = 0

    def conv(self, tin: str, cin: int, cout: int, k: int, stride: int = 1,
             pad: int = None, relu: bool = True) -> str:
        if pad is None:
            pad = k // 2
        self.i += 1
        name = f"conv{self.i}"
        self.nodes.append(Node(name, "Conv", [tin], [f"{name}.out"],
                               {"weight_shape": (cout, cin, k, k),
                                "stride": stride, "pad": pad}))
        t = f"{name}.out"
        if relu:
            self.nodes.append(Node(f"relu{self.i}", "Relu", [t],
                                   [f"relu{self.i}.out"]))
            t = f"relu{self.i}.out"
        return t

    def add(self, a: str, b: str, relu: bool = True) -> str:
        self.i += 1
        name = f"add{self.i}"
        self.nodes.append(Node(name, "Add", [a, b], [f"{name}.out"]))
        t = f"{name}.out"
        if relu:
            self.nodes.append(Node(f"relu{self.i}", "Relu", [t],
                                   [f"relu{self.i}.out"]))
            t = f"relu{self.i}.out"
        return t

    def pool(self, tin: str, kind: str = "MaxPool", k: int = 3,
             stride: int = 2, pad: int = 1) -> str:
        self.i += 1
        name = f"pool{self.i}"
        self.nodes.append(Node(name, kind, [tin], [f"{name}.out"],
                               {"kernel": k, "stride": stride, "pad": pad}))
        return f"{name}.out"


def _basic_block(b: _B, tin: str, cin: int, cout: int, stride: int) -> str:
    t = b.conv(tin, cin, cout, 3, stride)
    t = b.conv(t, cout, cout, 3, 1, relu=False)
    if stride != 1 or cin != cout:
        sc = b.conv(tin, cin, cout, 1, stride, pad=0, relu=False)
    else:
        sc = tin
    return b.add(t, sc)


def _bottleneck(b: _B, tin: str, cin: int, cmid: int, stride: int) -> str:
    cout = cmid * 4
    t = b.conv(tin, cin, cmid, 1, 1, pad=0)
    t = b.conv(t, cmid, cmid, 3, stride)
    t = b.conv(t, cmid, cout, 1, 1, pad=0, relu=False)
    if stride != 1 or cin != cout:
        sc = b.conv(tin, cin, cout, 1, stride, pad=0, relu=False)
    else:
        sc = tin
    return b.add(t, sc)


def _resnet(name: str, layers, bottleneck: bool, n_classes: int = 1000,
            in_hw: int = 224) -> Graph:
    b = _B()
    t = b.conv("input", 3, 64, 7, 2, pad=3)
    t = b.pool(t)
    cin = 64
    for stage, (n_blocks, cmid) in enumerate(zip(layers, (64, 128, 256, 512))):
        for blk in range(n_blocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            if bottleneck:
                t = _bottleneck(b, t, cin, cmid, stride)
                cin = cmid * 4
            else:
                t = _basic_block(b, t, cin, cmid, stride)
                cin = cmid
    t_gap = "gap.out"
    b.nodes.append(Node("gap", "GlobalAveragePool", [t], [t_gap]))
    b.nodes.append(Node("flatten", "Flatten", [t_gap], ["flat.out"]))
    b.nodes.append(Node("fc", "Gemm", ["flat.out"], ["fc.out"],
                        {"weight_shape": (cin, n_classes)}))
    return Graph(name, b.nodes, {"input": (3, in_hw, in_hw)}, ["fc.out"])


def resnet18(**kw) -> Graph:
    return _resnet("resnet18", (2, 2, 2, 2), False, **kw)


def resnet34(**kw) -> Graph:
    return _resnet("resnet34", (3, 4, 6, 3), False, **kw)


def resnet50(**kw) -> Graph:
    return _resnet("resnet50", (3, 4, 6, 3), True, **kw)


def resnet101(**kw) -> Graph:
    return _resnet("resnet101", (3, 4, 23, 3), True, **kw)
