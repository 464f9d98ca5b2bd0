"""Tiny graphs for the functional simulator and unit tests."""
from __future__ import annotations

from ..core.graph import Graph, Node


def conv_relu_toy() -> Graph:
    """The §3.4 walk-through workload: Conv(32,3,3,3) s=1 p=1 + ReLU on a
    3x32x32 input."""
    nodes = [
        Node("conv", "Conv", ["input"], ["conv.out"],
             {"weight_shape": (32, 3, 3, 3), "stride": 1, "pad": 1}),
        Node("relu", "Relu", ["conv.out"], ["relu.out"]),
    ]
    return Graph("conv_relu_toy", nodes, {"input": (3, 32, 32)}, ["relu.out"])


def tiny_cnn(in_hw: int = 8, c1: int = 4, c2: int = 8,
             n_classes: int = 10) -> Graph:
    nodes = [
        Node("conv1", "Conv", ["input"], ["conv1.out"],
             {"weight_shape": (c1, 3, 3, 3), "stride": 1, "pad": 1}),
        Node("relu1", "Relu", ["conv1.out"], ["relu1.out"]),
        Node("conv2", "Conv", ["relu1.out"], ["conv2.out"],
             {"weight_shape": (c2, c1, 3, 3), "stride": 1, "pad": 1}),
        Node("relu2", "Relu", ["conv2.out"], ["relu2.out"]),
        Node("pool", "MaxPool", ["relu2.out"], ["pool.out"],
             {"kernel": 2, "stride": 2}),
        Node("flatten", "Flatten", ["pool.out"], ["flat.out"]),
        Node("fc", "Gemm", ["flat.out"], ["fc.out"],
             {"weight_shape": (c2 * (in_hw // 2) ** 2, n_classes)}),
    ]
    return Graph("tiny_cnn", nodes, {"input": (3, in_hw, in_hw)}, ["fc.out"])


def tiny_mlp(d_in: int = 16, d_h: int = 32, d_out: int = 8) -> Graph:
    nodes = [
        Node("fc1", "Gemm", ["input"], ["fc1.out"],
             {"weight_shape": (d_in, d_h)}),
        Node("relu", "Relu", ["fc1.out"], ["relu.out"]),
        Node("fc2", "Gemm", ["relu.out"], ["fc2.out"],
             {"weight_shape": (d_h, d_out)}),
    ]
    return Graph("tiny_mlp", nodes, {"input": (d_in,)}, ["fc2.out"])
