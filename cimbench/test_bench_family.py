"""A configuration family that brings its own operators and builder
arguments, rehearsed on the CPU: a one-layer transformer served on
jia-issc21 through the harness, held against the reference with the
family's plain operators, and the control and the faults the check has
to catch.

The family is defined here, not under ``models/``: the port's ``vit``
builder as it stands (single-headed, no patch embedding) at a small
size, whose graph holds a saturating crossbar Gemm, activation x
activation MatMuls and the host float ops Softmax, LayerNorm and GELU.
"""
import json
import sys
import time
import types

import numpy as np
import pytest
import torch

from cimbench import control, harness, reference
from cimbench.harness import ROOT
from cimbench.test_bench_cell import SEED, _broken

FAMILY = "vit_rehearsal"


def _host(fn):
    """A host float op as the flow states it: ``fn`` in float64 on the
    int8-grid values, then ``round(y * 32)`` clamped to [-128, 127]."""
    def op(xs, layer):
        y = fn(xs[0].to(torch.float64))
        return torch.clamp(torch.round(y * 32.0), -128, 127).to(torch.int64)
    return op


def _layernorm(x):
    x = x - x.mean(dim=-1, keepdim=True)
    return x / torch.sqrt((x ** 2).mean(dim=-1, keepdim=True) + 1e-6)


def _softmax(x):
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _gelu(x):
    return x * 0.5 * (1.0 + torch.tanh(0.7978845608 * (x + 0.044715 * x ** 3)))


def _matmul(xs, layer):
    """Activation x activation product, exact in float64; requantised by
    the layer's calibrated shift."""
    b = xs[1].transpose(-1, -2) if layer.get("transpose_b") else xs[1]
    return (xs[0].to(torch.float64) @ b.to(torch.float64)).to(torch.int64)


def _layers(cfg):
    d, t = cfg["d"], cfg["n_tokens"]
    out = []

    def op(kind, name, inputs, **kw):
        out.append(dict(op=kind, name=name, inputs=inputs,
                        output=f"{name}.out", **kw))
        return f"{name}.out"

    def gemm(name, tin, cin, cout):
        return op("fc", name, [tin], cin=cin, cout=cout, rows=t)

    x = "input"
    for i in range(cfg["n_layers"]):
        p = f"l{i}."
        h = op("layernorm", f"{p}ln1", [x])
        q, k, v = (gemm(f"{p}w{s}", h, d, d) for s in "qkv")
        a = op("matmul", f"{p}qkt", [q, k], transpose_b=True, requant=True)
        a = op("softmax", f"{p}smax", [a])
        a = op("matmul", f"{p}av", [a, v], requant=True)
        x = op("add", f"{p}res1", [x, gemm(f"{p}wo", a, d, d)])
        h = op("layernorm", f"{p}ln2", [x])
        h = op("gelu", f"{p}gelu", [gemm(f"{p}fc1", h, d, cfg["d_ff"])])
        x = op("add", f"{p}res2", [x, gemm(f"{p}fc2", h, cfg["d_ff"], d)])
    h = op("layernorm", "ln_f", [x])
    gemm("head", h, d, cfg["n_classes"])
    return out


def _family():
    mod = types.ModuleType(f"cimbench.models.{FAMILY}")
    mod.layers = _layers
    mod.input_shape = lambda cfg: (cfg["n_tokens"], cfg["d"])
    mod.build_kwargs = lambda cfg: {
        k: cfg[k] for k in ("n_layers", "d", "n_heads", "d_ff", "n_tokens",
                            "n_classes")}
    mod.OPS = {"layernorm": _host(_layernorm), "softmax": _host(_softmax),
               "gelu": _host(_gelu), "matmul": _matmul}
    return mod


#: d_ff = 512 makes fc2's reads saturate jia's 8-bit ADC on these inputs
CONFIG = {
    "name": "vit-rehearsal", "family": FAMILY, "workload": "vit",
    "n_layers": 1, "d": 32, "n_heads": 2, "d_ff": 512, "n_tokens": 9,
    "n_classes": 10, "outputs": ["head.out", "l0.res1.out"],
    "arch": "jia-issc21",
    "crossbar": {"rows": 1152, "cols": 256, "act_bits": 8, "weight_bits": 8,
                 "dac_bits": 1, "cell_bits": 1, "parallel_row": 1152,
                 "adc_bits": 8},
}


@pytest.fixture
def cell(monkeypatch):
    monkeypatch.setitem(sys.modules, f"cimbench.models.{FAMILY}", _family())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return harness.Cell({"name": "vit-rehearsal.b2", "config": CONFIG["name"],
                         "traffic": "b2", "chips": 1},
                        dict(CONFIG), {"batch": 2}, bench)


def rehearse(cell):
    return harness.run_cell(cell, SEED, 0.5, False,
                            t_start=time.perf_counter(), device="cpu")


def test_graph_has_every_kind_of_work(cell):
    """The served graph holds what the family is there for: a crossbar
    layer whose reads saturate, activation x activation MatMuls and each
    host float op."""
    graph, _, _ = harness.program_graph(cell)
    kinds = {n.op_type for n in graph.nodes}
    assert {"Gemm", "MatMul", "Softmax", "LayerNorm", "Gelu"} <= kinds
    rows = {name: r for name, (r, _) in reference.weight_shapes(cell.layers)}
    assert not cell.xb.exact(rows["l0.fc2"]) and cell.xb.exact(rows["l0.wq"])
    assert {layer["op"] for layer in cell.layers} >= {
        "fc", "matmul", "softmax", "layernorm", "gelu", "add"}


def test_rehearsal_is_correct(cell):
    res = rehearse(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "infer_per_s"}


@pytest.mark.parametrize("fault", ["answer", "half_batch", "permuted"])
def test_broken_timed_path_is_caught(monkeypatch, cell, fault):
    _broken(monkeypatch, fault)
    res = rehearse(cell)
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] > 0


def test_control_is_caught(cell):
    checks = control.control(cell, SEED, torch.device("cpu"))
    assert not harness.passed(checks)
    assert checks["wrong_answers"]["value"] > 0


def test_saturation_shows_in_the_answers(cell):
    """fc2's reads saturate: the exact product in place of the ADC's
    clamp changes every logit answer."""
    inp = harness.make_inputs(cell, SEED, torch.device("cpu"))
    ref = harness.reference_outputs(cell, inp, torch.device("cpu"))
    cell.config = dict(cell.config,
                       crossbar=dict(cell.config["crossbar"], adc_bits=32))
    got = harness.reference_outputs(cell, inp, torch.device("cpu"))
    diff = np.abs(got["head.out"] - ref["head.out"])
    assert (diff.reshape(len(diff), -1).max(axis=1) > 0).all()


def _wrong_op(cell, op):
    """The family's reference with ``op`` computed wrongly."""
    if op == "matmul":          # av's accumulator not requantised
        layers = cell.model.layers
        cell.model.layers = lambda cfg: [
            {k: v for k, v in layer.items()
             if not (layer.get("name") == "l0.av" and k == "requant")}
            for layer in layers(cfg)]
        return
    cell.model.OPS[op] = _host({
        "gelu": torch.relu,
        "layernorm": lambda x: x / torch.sqrt(
            (x ** 2).mean(dim=-1, keepdim=True) + 1e-6),
        "softmax": lambda x: _softmax(x.transpose(-1, -2))
        .transpose(-1, -2)}[op])


@pytest.mark.parametrize("op", ["gelu", "layernorm", "softmax", "matmul"])
def test_each_family_op_is_compared(cell, op):
    """Each of the family's operators reaches the answers: the reference
    with one of them wrong fails the program's run."""
    _wrong_op(cell, op)
    res = rehearse(cell)
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] > 0
