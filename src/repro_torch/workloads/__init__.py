"""CIM benchmark networks (§4.1 "Network Benchmark") as graph builders."""
from .resnet import resnet18, resnet34, resnet50, resnet101
from .tiny import tiny_cnn, tiny_mlp, conv_relu_toy

WORKLOADS = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "tiny_cnn": tiny_cnn,
    "tiny_mlp": tiny_mlp,
    "conv_relu_toy": conv_relu_toy,
}


def get_workload(name: str, **kw):
    if name not in WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; have {sorted(WORKLOADS)}")
    return WORKLOADS[name](**kw)
