"""CIM benchmark networks (§4.1 "Network Benchmark") as graph builders."""
from .vgg import vgg7, vgg16
from .resnet import resnet18, resnet34, resnet50, resnet101
from .vit import vit_base, vit_b16
from .tiny import tiny_cnn, tiny_mlp, conv_relu_toy

WORKLOADS = {
    "vgg7": vgg7,
    "vgg16": vgg16,
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "vit": vit_base,
    "vit_b16": vit_b16,
    "tiny_cnn": tiny_cnn,
    "tiny_mlp": tiny_mlp,
    "conv_relu_toy": conv_relu_toy,
}


def get_workload(name: str, **kw):
    if name.startswith("lmblock:"):
        from .lm_blocks import lm_block
        return lm_block(name.split(":", 1)[1], **kw)
    if name not in WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; have {sorted(WORKLOADS)}")
    return WORKLOADS[name](**kw)
