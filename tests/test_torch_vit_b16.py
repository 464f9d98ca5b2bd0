"""ViT-B/16 in the port (``workloads.vit_b16``) against the benchmark's
plain reference (``cimbench/reference.py`` with ``cimbench/models/vit.py``),
at a small size on the CPU: 32x32 images in 16x16 patches (5 tokens),
d = 32 over 4 heads of 8, d_ff = 512 so that fc2's reads saturate jia's
8-bit ADC, 2 layers.  Also the ops the model brought into the flow: the
``Constant`` node, ``MatMul`` on per-head operands and the Softmax
``scale``.

The reference side is plain torch and imports nothing of the port.
"""
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cimbench import reference  # noqa: E402
from cimbench.models import vit as plain  # noqa: E402
from repro_torch.cimsim import compile_and_verify  # noqa: E402
from repro_torch.cimsim.functional import (_float_dcom, apply_dcom,  # noqa: E402
                                           calibrate_shifts, constant_value,
                                           reference_forward, reference_mvm)
from repro_torch.core.abstraction import get_arch  # noqa: E402
from repro_torch.core.graph import Graph, Node, weight_matrix_shape  # noqa: E402
from repro_torch.kernels.cim_mvm import cim_mvm_params  # noqa: E402
from repro_torch.serving import CimBatchService, CimRequest  # noqa: E402
from repro_torch.workloads import get_workload  # noqa: E402

SMALL = dict(in_hw=32, patch=16, d=32, n_layers=2, n_heads=4, d_ff=512,
             n_classes=10)
#: the plain model's configuration at the small size
CFG = dict(SMALL, in_channels=3, param_seed=0)
#: served tensors compared: the logits and two inner tensors
OUTPUTS = ["head.out", "embed.out", "l1.res1.out"]
ARCH_CONFIG = {"jia-issc21": "vit-jia.json",
               "isaac-baseline": "resnet18-isaac.json"}


def _graph(**kw):
    return get_workload("vit_b16", **dict(SMALL, **kw))


def _crossbar(arch: str) -> reference.Crossbar:
    cfg = json.loads((ROOT / "cimbench" / "configs"
                      / ARCH_CONFIG[arch]).read_text())
    return reference.Crossbar.from_config(cfg)


# -- the graph ---------------------------------------------------------------------

def test_graph_has_each_published_part():
    g = _graph()
    sh = g.shapes
    patch = g.node("patch")
    assert patch.op_type == "Conv" and patch.inputs == ["image"]
    assert patch.attrs["weight_shape"] == (32, 3, 16, 16)
    assert patch.attrs["stride"] == 16 and sh["patch.out"] == (32, 2, 2)
    for name, shape in (("cls", (1, 32)), ("pos", (5, 32))):
        n = g.node(name)
        assert n.op_type == "Constant" and n.inputs == []
        assert sh[n.outputs[0]] == shape
    cat = g.node("tokens")
    assert cat.op_type == "Concat" and cat.inputs[0] == "cls.out"
    assert sh["tokens.out"] == (5, 32)
    assert g.node("embed").inputs == ["tokens.out", "pos.out"]
    for i in range(2):
        for s in "qkv":
            assert sh[f"l{i}.{s}.heads.out"] == (4, 5, 8)
        assert sh[f"l{i}.qkt.out"] == (4, 5, 5)
        assert g.node(f"l{i}.qkt").attrs["transpose_b"]
        assert g.node(f"l{i}.smax").attrs["scale"] == \
            pytest.approx(1 / math.sqrt(8), rel=1e-15)
        assert sh[f"l{i}.av.out"] == (4, 5, 8)
        assert sh[f"l{i}.merge.flat.out"] == (5, 32)
    head = g.node("head")
    assert head.inputs == ["cls_token.out"] and sh["cls_token.out"] == (1, 32)
    assert g.outputs == ["head.out"] and sh["head.out"] == (1, 10)
    # crossbar layers: the plain model's, in its order
    assert [(n.name, weight_matrix_shape(n)) for n in g.cim_nodes] == \
        reference.weight_shapes(plain.layers(CFG))


def test_published_widths():
    """ViT-B/16 as published: 197 tokens, 12 heads of 64 scaled by 1/8,
    86.3 M crossbar weights."""
    g = get_workload("vit_b16")
    assert g.inputs == {"image": (3, 224, 224)}
    assert g.shapes["embed.out"] == (197, 768)
    assert g.shapes["l11.qkt.out"] == (12, 197, 197)
    assert g.node("l0.smax").attrs["scale"] == 0.125
    assert sum(math.prod(weight_matrix_shape(n)) for n in g.cim_nodes) \
        == 86_292_480
    assert len(g.cim_nodes) == 12 * 6 + 2


# -- the port against the plain reference ------------------------------------------

def _inputs(n_images: int, seed: int = 5):
    gen = torch.Generator().manual_seed(seed)
    weights = {name: torch.randint(-128, 128, rc, generator=gen,
                                   dtype=torch.int32)
               for name, rc in reference.weight_shapes(plain.layers(CFG))}
    imgs = torch.randint(-128, 128, (n_images + 1, 3, 32, 32), generator=gen,
                         dtype=torch.int32)
    return weights, imgs[0], imgs[1:]


@pytest.mark.parametrize("arch", sorted(ARCH_CONFIG))
def test_served_port_equals_plain_reference(arch):
    """``CimBatchService`` on the card's executor path (plain route on
    the CPU) and the interpreter's ``reference_forward`` give the plain
    reference's tensors exactly, image for image."""
    g = dataclasses.replace(_graph(), outputs=OUTPUTS)
    a = get_arch(arch)
    params = cim_mvm_params(a)
    xb = _crossbar(arch)
    assert xb.exact() == params.exact
    weights, calib, pool = _inputs(4)
    want = reference.run(plain.layers(CFG), weights, calib, pool, xb,
                         device=torch.device("cpu"), block=3,
                         outputs=OUTPUTS, ops=plain.OPS)
    shifts = calibrate_shifts(g, weights, {"image": calib.numpy()}, params,
                              device="cpu")
    svc = CimBatchService(g, a, max_batch=4, weights=weights, shifts=shifts,
                          device="cpu")
    reqs = [CimRequest(rid=i, inputs={"image": pool[i].numpy()})
            for i in range(4)]
    svc.dispatch(reqs)
    mvm = reference_mvm(params, "cpu")
    w_np = {k: v.numpy() for k, v in weights.items()}
    for i, r in enumerate(reqs):
        interp, _ = reference_forward(g, w_np, {"image": pool[i].numpy()},
                                      shifts=shifts, mvm=mvm)
        for t in OUTPUTS:
            np.testing.assert_array_equal(r.outputs[t], want[t][i].numpy(),
                                          err_msg=f"served {t}")
            np.testing.assert_array_equal(interp[t], want[t][i].numpy(),
                                          err_msg=f"interpreter {t}")
    # the answers are each image's own
    logits = want["head.out"].reshape(4, -1)
    assert len(torch.unique(logits, dim=0)) == 4


def test_fc2_reads_saturate_on_jia():
    """fc2's 512-row reads of these inputs reach jia's 8-bit ADC limit:
    the unclamped product changes the logits."""
    weights, calib, pool = _inputs(2)
    xb = _crossbar("jia-issc21")
    assert not xb.exact(512)
    run = dict(device=torch.device("cpu"), block=2, outputs=["head.out"],
               ops=plain.OPS)
    got = reference.run(plain.layers(CFG), weights, calib, pool, xb, **run)
    wide = reference.Crossbar(**dict(vars(xb), adc_bits=32))
    exact = reference.run(plain.layers(CFG), weights, calib, pool, wide, **run)
    assert not torch.equal(got["head.out"], exact["head.out"])


@pytest.mark.parametrize("arch", ["toy", "puma", "jia-issc21"])
@pytest.mark.parametrize("executor", [True, False],
                         ids=["executor", "interpreter"])
def test_compiled_flow_verifies(arch, executor):
    """The compiled flow, lowered or interpreted, equals the port's own
    int8 reference on each chip mode."""
    rep = compile_and_verify(_graph(n_layers=1), get_arch(arch), batch=2,
                             device="cpu", use_executor=executor)
    assert rep.error is None and rep.ok, rep.max_abs_err


def test_fault_aware_compile_and_accuracy():
    """The fault passes take a graph whose Constants read no tensor: a
    line-clustered fault map on puma is retired around, and the remapped
    executor keeps every argmax."""
    from repro_torch.cimsim.faults import (FaultModel, accuracy_under_faults,
                                           fault_aware_compile)
    g, arch = _graph(n_layers=1), get_arch("puma")
    model = FaultModel(seed=7, stuck_col_rate=0.01, dead_row_rate=0.005)
    res = fault_aware_compile(g, arch, model)
    assert res.retired_rows + res.retired_cols > 0
    assert accuracy_under_faults(g, arch, model, n_inputs=3, device="cpu",
                                 remap=True) == 1.0


# -- the Constant ----------------------------------------------------------------

def _const(name, shape, seed):
    return Node(name, "Constant", [], [f"{name}.out"],
                {"shape": shape, "seed": seed})


def test_constant_is_one_rule_on_both_sides():
    for name, shape in (("cls", (1, 32)), ("pos", (5, 32))):
        got = constant_value(_const(name, shape, 0))
        want = plain.const_value(name, shape, 0).numpy()
        assert got.dtype == np.int32 and got.shape == shape
        np.testing.assert_array_equal(got, want)
        assert got.min() >= -128 and got.max() <= 127
        assert len(np.unique(got)) > 1
        other = constant_value(_const(name, shape, 1))
        assert not np.array_equal(got, other)
    assert not np.array_equal(constant_value(_const("cls", (1, 32), 0)),
                              constant_value(_const("pos", (5, 32), 0))[:1])


def test_executor_expands_the_constant_over_the_batch():
    """The lowered program holds each Constant once on the device and
    gives every inference of a batch the same class token."""
    from repro_torch.cimsim.executor import lower
    from repro_torch.core import compiler
    g = dataclasses.replace(_graph(n_layers=1), outputs=["tokens.out"])
    res = compiler.compile_graph(g, get_arch("toy"))
    exe = lower(res.plan, res.program, device="cpu", cache=False)
    assert set(exe._consts) == {"cls", "pos"}
    assert exe._consts["pos"].shape == (5, 32)
    x = np.random.default_rng(0).integers(-128, 128, (3, 3, 32, 32))
    from repro_torch.cimsim.functional import make_weights
    out = exe.run_batch({"image": x}, make_weights(g))["tokens.out"]
    cls = constant_value(g.node("cls"))
    for i in range(3):
        np.testing.assert_array_equal(out[i, :1], cls)


# -- MatMul and Softmax ----------------------------------------------------------

def _matmul(transpose_b=True):
    return Node("mm", "MatMul", ["a", "b"], ["mm.out"],
                {"transpose_b": transpose_b} if transpose_b else {})


def test_2d_matmul_equals_the_plain_transpose():
    rng = np.random.default_rng(1)
    a = rng.integers(-128, 128, (5, 8)).astype(np.int32)
    b = rng.integers(-128, 128, (7, 8)).astype(np.int32)
    node = _matmul()
    shifts = {}
    got = apply_dcom(node, [a, b], None, shifts, calibrating=True)
    y = a.astype(np.int64) @ b.T.astype(np.int64)
    sh = shifts["mm"]
    assert sh > 0
    want = np.clip(y >> sh, -128, 127).astype(np.int32)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_per_head_matmul_equals_the_loop_over_heads():
    rng = np.random.default_rng(2)
    q = rng.integers(-128, 128, (4, 5, 8)).astype(np.int32)
    k = rng.integers(-128, 128, (4, 5, 8)).astype(np.int32)
    v = rng.integers(-128, 128, (4, 5, 8)).astype(np.int32)
    shifts = {"mm": 6}
    got = apply_dcom(_matmul(), [q, k], None, shifts, False)
    assert got.shape == (4, 5, 5)
    for h in range(4):
        np.testing.assert_array_equal(
            got[h], apply_dcom(_matmul(),
                               [q[h], k[h]], None, shifts, False))
    got = apply_dcom(_matmul(False), [q, v.swapaxes(1, 2)],
                     None, shifts, False)
    for h in range(4):
        np.testing.assert_array_equal(
            got[h], apply_dcom(_matmul(False),
                               [q[h], v[h].T], None, shifts, False))


def _softmax_node(**attrs):
    return Node("smax", "Softmax", ["x"], ["smax.out"], attrs)


def test_softmax_without_scale_is_unchanged():
    x = np.random.default_rng(3).integers(-128, 128, (4, 5, 5))
    xf = x.astype(np.float64)
    e = np.exp(xf - xf.max(axis=-1, keepdims=True))
    want = e / e.sum(axis=-1, keepdims=True)
    for node in (_softmax_node(), _softmax_node(scale=1.0)):
        got = _float_dcom("Softmax", [x], node)
        assert got.tobytes() == want.tobytes()


def test_softmax_scale_multiplies_before_the_max():
    x = np.random.default_rng(4).integers(-128, 128, (4, 5, 5))
    s = 8 ** -0.5
    got = _float_dcom("Softmax", [x], _softmax_node(scale=s))
    xf = x.astype(np.float64) * s
    e = np.exp(xf - xf.max(axis=-1, keepdims=True))
    assert got.tobytes() == (e / e.sum(axis=-1, keepdims=True)).tobytes()
    plain_y = plain.OPS["softmax"]([torch.as_tensor(x)], {"scale": s})
    np.testing.assert_array_equal(
        plain_y.numpy(), np.clip(np.round(got * 32), -128, 127))


def test_constant_compiles_to_an_op_that_reads_no_tensor():
    """A Constant feeding an Add compiles to a flow with a ``const`` op
    that reads no tensor."""
    from repro_torch.core import compiler
    nodes = [_const("c", (4,), 3),
             Node("fc", "Gemm", ["x"], ["fc.out"], {"weight_shape": (8, 4)}),
             Node("sum", "Add", ["fc.out", "c.out"], ["sum.out"])]
    g = Graph("const_add", nodes, {"x": (8,)}, ["sum.out"])
    res = compiler.compile_graph(g, get_arch("toy"))
    ops = [op for op in res.program.walk(expand_loops=False)
           if op.kind == "const"]
    assert len(ops) == 1 and "src" not in ops[0].attrs
    assert compile_and_verify(g, get_arch("toy"), batch=2, device="cpu").ok


def test_every_node_emits_its_span():
    """With a recorder installed a dispatch gives each node, the
    Constants and the per-head Transpose, Reshape and MatMul included,
    its ``<op_type>`` span named by ``node``.  No float op makes a host
    round trip: every operand is a clamped output, so the span of each
    row-reducing one (the scaled Softmax among them) says it ran as a
    row reduction on the device, and the GELU's that it was gathered
    from its table."""
    from repro_torch.obs import trace as obs_trace
    g = _graph(n_layers=1)
    svc = CimBatchService(g, get_arch("jia-issc21"), seed=3, max_batch=2,
                          device="cpu")
    x = np.random.default_rng(5).integers(-128, 128, (2, 3, 32, 32))
    reqs = lambda: [CimRequest(rid=i, inputs={"image": x[i]})  # noqa: E731
                    for i in range(2)]
    svc.dispatch(reqs())                     # warms the batch shape
    rec = obs_trace.install()
    try:
        svc.dispatch(reqs())
    finally:
        obs_trace.uninstall()
    ev = [e for e in rec.events if e["ph"] == "X"]
    nodes = [(e["name"], e["args"]["node"]) for e in ev if "node" in e["args"]]
    assert nodes == [(n.op_type, n.name) for n in svc.graph.nodes]
    assert ("Constant", "cls") in nodes and ("Softmax", "l0.smax") in nodes
    float_ops = [n for n in g.nodes
                 if n.op_type in ("Softmax", "LayerNorm")]
    assert len(float_ops) == 4
    assert sum(e["name"] == "executor.host_dcom" for e in ev) == 0
    stats = svc.executor_stats
    assert (stats.table_dcom_nodes, stats.row_dcom_nodes,
            stats.host_dcom_nodes) == (1, 4, 0)
    dcom = {e["args"]["node"]: e["args"].get("dcom") for e in ev
            if "node" in e["args"]}
    assert dcom["l0.gelu"] == "table"
    assert all(dcom[n.name] == "row" for n in float_ops)
    assert dcom["l0.fc1"] is None and dcom["l0.smax"] == "row"
