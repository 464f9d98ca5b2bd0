"""ViT-B/16 (Dosovitskiy et al., ICLR 2021, arXiv:2010.11929, Eq. 1-4 and
Table 1) as a plain layer list for ``cimbench.reference``, with the
operators the reference lacks in ``OPS``.

Layers are named as the served graph names its nodes: ``patch`` embeds
the image by a ``patch`` x ``patch`` stride-``patch`` convolution, the
class token ``cls`` is prepended and the position table ``pos`` added
(``embed``); each block ``l{i}.`` is pre-norm multi-head attention
(``wq``, ``wk``, ``wv``, per-head ``qkt``, ``smax``, ``av``, ``wo``,
``res1``) and a GELU MLP (``fc1``, ``gelu``, ``fc2``, ``res2``); ``ln_f``
and ``head`` classify the class token alone.  The weights are keyed by
these names.  Tensors carry the batch as their first axis; a layer's
``shape``, ``perm`` and ``axis`` are of one image.

Departures from the paper, all of them the flow's own conventions:

* no biases, as in the ResNet configurations;
* LayerNorm without gain or offset, ``(x - mean) / sqrt(var + 1e-6)``,
  and GELU in its tanh form;
* int8 fake quantisation: every crossbar layer, ``add`` and ``matmul``
  requantises its integer accumulator by a calibrated right shift; the
  float ops (Softmax with its ``scale``, LayerNorm, GELU) run in float64
  on the int8-grid values and return ``round(y * 32)`` clamped to
  [-128, 127];
* the class token and the position table are int8 tensors drawn by a
  fixed rule from the layer's name and the configuration's
  ``param_seed``, not from the run's seed: ``torch.randint(-128, 128,
  shape)`` on the CPU from a generator seeded with
  ``zlib.crc32(f"{name}\\x00{param_seed}")``.

Imports torch and the standard library only.
"""
from __future__ import annotations

import zlib
from typing import Dict, List

import torch


def _tokens(cfg: Dict) -> int:
    return (cfg["in_hw"] // cfg["patch"]) ** 2 + 1


def layers(cfg: Dict) -> List[Dict]:
    d, n_heads = cfg["d"], cfg["n_heads"]
    dh = d // n_heads
    grid = cfg["in_hw"] // cfg["patch"]
    t = _tokens(cfg)
    out: List[Dict] = []

    def op(kind, name, inputs, **kw):
        out.append(dict(op=kind, name=name, inputs=inputs,
                        output=f"{name}.out", **kw))
        return f"{name}.out"

    def gemm(name, tin, cin, cout, rows=t):
        return op("fc", name, [tin], cin=cin, cout=cout, rows=rows)

    def heads(name, x):
        x = op("reshape", f"{name}.split", [x], shape=(t, n_heads, dh))
        return op("transpose", f"{name}.heads", [x], perm=(1, 0, 2))

    x = op("conv", "patch", ["input"], cin=cfg["in_channels"], cout=d,
           k=cfg["patch"], stride=cfg["patch"], pad=0)
    x = op("reshape", "patch.flat", [x], shape=(d, grid * grid))
    x = op("transpose", "patch.tokens", [x], perm=(1, 0))
    # a constant reads the input only for its batch and device
    cls = op("const", "cls", ["input"], shape=(1, d), seed=cfg["param_seed"])
    x = op("concat", "tokens", [cls, x], axis=0)
    pos = op("const", "pos", ["input"], shape=(t, d), seed=cfg["param_seed"])
    x = op("add", "embed", [x, pos])
    for i in range(cfg["n_layers"]):
        p = f"l{i}."
        h = op("layernorm", f"{p}ln1", [x])
        q = heads(f"{p}q", gemm(f"{p}wq", h, d, d))
        k = heads(f"{p}k", gemm(f"{p}wk", h, d, d))
        v = heads(f"{p}v", gemm(f"{p}wv", h, d, d))
        a = op("matmul", f"{p}qkt", [q, k], transpose_b=True, requant=True)
        a = op("softmax", f"{p}smax", [a], scale=dh ** -0.5)
        a = op("matmul", f"{p}av", [a, v], requant=True)
        a = op("transpose", f"{p}merge", [a], perm=(1, 0, 2))
        a = op("reshape", f"{p}merge.flat", [a], shape=(t, d))
        x = op("add", f"{p}res1", [x, gemm(f"{p}wo", a, d, d)])
        h = op("layernorm", f"{p}ln2", [x])
        h = op("gelu", f"{p}gelu", [gemm(f"{p}fc1", h, d, cfg["d_ff"])])
        x = op("add", f"{p}res2", [x, gemm(f"{p}fc2", h, cfg["d_ff"], d)])
    x = op("layernorm", "ln_f", [x])
    x = op("split", "cls_token", [x], axis=0, parts=(1, t - 1))
    gemm("head", x, d, cfg["n_classes"], rows=1)
    return out


def input_shape(cfg: Dict):
    return (cfg["in_channels"], cfg["in_hw"], cfg["in_hw"])


def build_kwargs(cfg: Dict) -> Dict:
    """The served graph builder's keyword arguments."""
    return {k: cfg[k] for k in ("in_hw", "patch", "d", "n_layers",
                                "n_heads", "d_ff", "n_classes",
                                "param_seed")}


# -- the operators the reference lacks -------------------------------------------

def const_value(name: str, shape, seed: int) -> torch.Tensor:
    """The fixed rule: int8 values from the layer's name and the seed."""
    gen = torch.Generator().manual_seed(
        zlib.crc32(f"{name}\x00{seed}".encode()))
    return torch.randint(-128, 128, tuple(shape), generator=gen)


def _const(xs, layer):
    x = xs[0]
    v = const_value(layer["name"], layer["shape"], layer["seed"])
    return v.to(x.device).expand(x.shape[0], *v.shape)


def _axis(layer, x) -> int:
    """A per-image axis as an axis of the batched tensor ``x``."""
    return layer["axis"] % (x.dim() - 1) + 1


def _reshape(xs, layer):
    return xs[0].reshape(xs[0].shape[0], *layer["shape"])


def _transpose(xs, layer):
    return xs[0].permute(0, *(p + 1 for p in layer["perm"]))


def _concat(xs, layer):
    return torch.cat(xs, dim=_axis(layer, xs[0]))


def _split(xs, layer):
    """The first part: the class token."""
    return xs[0].narrow(_axis(layer, xs[0]), 0, layer["parts"][0])


def _matmul(xs, layer):
    """Activation x activation product, exact in float64 (int8 operands);
    the reference requantises it by the layer's calibrated shift."""
    b = xs[1].transpose(-1, -2) if layer.get("transpose_b") else xs[1]
    return (xs[0].to(torch.float64) @ b.to(torch.float64)).to(torch.int64)


def _host(fn):
    """A float op as the flow states it: ``fn`` in float64 on the
    int8-grid values, then ``round(y * 32)`` clamped to [-128, 127]."""
    def op(xs, layer):
        y = fn(xs[0].to(torch.float64), layer)
        return torch.clamp(torch.round(y * 32.0), -128, 127).to(torch.int64)
    return op


def _softmax(x, layer):
    x = x * layer.get("scale", 1.0)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _layernorm(x, layer):
    x = x - x.mean(dim=-1, keepdim=True)
    return x / torch.sqrt((x ** 2).mean(dim=-1, keepdim=True) + 1e-6)


def _gelu(x, layer):
    return x * 0.5 * (1.0 + torch.tanh(0.7978845608 * (x + 0.044715 * x ** 3)))


OPS = {
    "const": _const, "reshape": _reshape, "transpose": _transpose,
    "concat": _concat, "split": _split, "matmul": _matmul,
    "softmax": _host(_softmax), "layernorm": _host(_layernorm),
    "gelu": _host(_gelu),
}
