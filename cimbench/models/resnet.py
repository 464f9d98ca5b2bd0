"""ResNet with basic blocks (He et al., CVPR 2016, arXiv:1512.03385) as a
plain layer list for ``cimbench.reference``.

Layers are named as the served graph names its nodes: one counter over
convolutions, additions and pools, so ``conv1`` is the stem, ``pool2``
its max-pool and ``add5`` the first residual sum.  The weights are keyed
by these names.  Every convolution is followed by a ReLU except the
second of a block and the projection shortcut; the sum is followed by
one.  The stem is a 7x7 stride-2 convolution and a 3x3 stride-2 max-pool;
global average pooling and one fully connected layer end the network.
"""
from __future__ import annotations

from typing import Dict, List


def layers(cfg: Dict) -> List[Dict]:
    out: List[Dict] = []
    i = 0

    def conv(tin: str, cin: int, cout: int, k: int, stride: int, pad: int,
             relu: bool) -> str:
        nonlocal i
        i += 1
        name = f"conv{i}"
        out.append(dict(op="conv", name=name, inputs=[tin],
                        output=f"{name}.out", cin=cin, cout=cout, k=k,
                        stride=stride, pad=pad))
        t = f"{name}.out"
        if relu:
            out.append(dict(op="relu", inputs=[t], output=f"relu{i}.out"))
            t = f"relu{i}.out"
        return t

    t = conv("input", cfg["in_channels"], cfg["widths"][0], 7, 2, 3, True)
    i += 1
    out.append(dict(op="maxpool", name=f"pool{i}", inputs=[t],
                    output=f"pool{i}.out", k=3, stride=2, pad=1))
    t = f"pool{i}.out"
    cin = cfg["widths"][0]
    for stage, (n_blocks, width) in enumerate(zip(cfg["blocks"],
                                                  cfg["widths"])):
        for blk in range(n_blocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            y = conv(t, cin, width, 3, stride, 1, True)
            y = conv(y, width, width, 3, 1, 1, False)
            sc = conv(t, cin, width, 1, stride, 0, False) \
                if (stride != 1 or cin != width) else t
            i += 1
            out.append(dict(op="add", name=f"add{i}", inputs=[y, sc],
                            output=f"add{i}.out"))
            out.append(dict(op="relu", inputs=[f"add{i}.out"],
                            output=f"relu{i}.out"))
            t = f"relu{i}.out"
            cin = width
    out.append(dict(op="gap", inputs=[t], output="gap.out"))
    out.append(dict(op="flatten", inputs=["gap.out"], output="flat.out"))
    out.append(dict(op="fc", name="fc", inputs=["flat.out"],
                    output="fc.out", cin=cin, cout=cfg["n_classes"]))
    return out


def input_shape(cfg: Dict):
    return (cfg["in_channels"], cfg["in_hw"], cfg["in_hw"])


def build_kwargs(cfg: Dict) -> Dict:
    """The served graph builder's keyword arguments."""
    return {"in_hw": cfg["in_hw"], "n_classes": cfg["n_classes"]}
