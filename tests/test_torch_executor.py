"""The port's trace-lowered executor against the JAX package's, on the CPU.

Mirrors tests/test_executor.py: every case runs the same seeded weights,
shifts and inputs through ``repro_torch``'s executor (``device="cpu"``,
the plain-version route) and through ``repro``'s executor and op-by-op
interpreter, and requires equal outputs (tolerance 0: the CIM path is
integer and the float DCOM ops run the same NumPy float64 code).
"""
import functools
import types

import jax
import numpy as np
import pytest

from repro.cimsim import executor as jex
from repro.cimsim import functional as jfn
from repro.core import abstraction as ja
from repro.core import compiler as jcompiler
from repro.core import graph as jgraph
from repro.kernels.cim_mvm import cim_mvm_params as jparams
from repro.kernels.cim_mvm import ref as jref
from repro.workloads import get_workload as jwl
from repro_torch.cimsim import executor as tex
from repro_torch.cimsim import functional as tfn
from repro_torch.core import abstraction as ta
from repro_torch.core import compiler as tcompiler
from repro_torch.core import graph as tgraph
from repro_torch.kernels import backend
from repro_torch.kernels.cim_mvm import cim_mvm_params as tparams
from repro_torch.workloads import get_workload as twl

MODES = ["WLM", "XBM", "CM"]


@pytest.fixture(scope="module", autouse=True)
def _jitted_reference_oracle():
    """The reference interpreter calls the JAX oracle once per crossbar
    read, thousands of times per tiny_cnn inference; run that same
    function under ``jax.jit`` so each call is one compiled dispatch."""
    oracle = jax.jit(jref.cim_mvm_ref, static_argnames=(
        "act_bits", "weight_bits", "dac_bits", "cell_bits", "parallel_row",
        "adc_bits"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfn, "kref", types.SimpleNamespace(cim_mvm_ref=oracle))
        yield


def _arch(mod, kind: str, mode: str = "WLM"):
    """The SMALL test arch of tests/test_executor.py in package ``mod``:
    ``exact`` (8-bit ADC), ``saturating`` (4-bit ADC) or ``streamed``
    (the docs/KERNELS.md 2-core, 1-crossbar chip that forces segments)."""
    n_cores, n_xbs = (2, 1) if kind == "streamed" else (4, 2)
    return mod.CIMArch(
        name=f"test-{kind}", mode=mod.ComputingMode[mode],
        chip=mod.ChipTier(core_number=(n_cores, 1), alu_ops_per_cycle=64,
                          l0_bw_bits=1024),
        core=mod.CoreTier(xb_number=(n_xbs, 1), l1_bw_bits=1024),
        xb=mod.CrossbarTier(xb_size=(32, 32), dac_bits=1,
                            adc_bits=4 if kind == "saturating" else 8,
                            cell_type=mod.CellType.SRAM, cell_precision=2,
                            parallel_row=8))


def _attn_graph(mod):
    Node = mod.Node
    nodes = [
        Node("fc1", "Gemm", ["input"], ["fc1.out"],
             {"weight_shape": (16, 16)}),
        Node("sm", "Softmax", ["fc1.out"], ["sm.out"]),
        Node("mm", "MatMul", ["sm.out", "fc1.out"], ["mm.out"],
             {"transpose_b": True}),
        Node("ln", "LayerNorm", ["mm.out"], ["ln.out"]),
        Node("ge", "Gelu", ["ln.out"], ["ge.out"]),
        Node("fc2", "Gemm", ["ge.out"], ["fc2.out"],
             {"weight_shape": (4, 5)}),
    ]
    return mod.Graph("attn_toy", nodes, {"input": (4, 16)}, ["fc2.out"])


def _split_graph(mod):
    Node = mod.Node
    nodes = [
        Node("fc1", "Gemm", ["input"], ["fc1.out"],
             {"weight_shape": (16, 12)}),
        Node("sp", "Split", ["fc1.out"], ["sp.a", "sp.b"],
             {"axis": -1, "parts": [4, 8]}),
        Node("ra", "Relu", ["sp.a"], ["ra.out"]),
        Node("rb", "Relu", ["sp.b"], ["rb.out"]),
        Node("cat", "Concat", ["ra.out", "rb.out"], ["cat.out"],
             {"axis": -1}),
        Node("fc2", "Gemm", ["cat.out"], ["fc2.out"],
             {"weight_shape": (12, 5)}),
    ]
    return mod.Graph("splitnet", nodes, {"input": (16,)}, ["fc2.out"])


GRAPHS = {"tiny_mlp": (lambda: jwl("tiny_mlp"), lambda: twl("tiny_mlp")),
          "tiny_cnn": (lambda: jwl("tiny_cnn"), lambda: twl("tiny_cnn")),
          "split": (lambda: _split_graph(jgraph),
                    lambda: _split_graph(tgraph)),
          "attn": (lambda: _attn_graph(jgraph), lambda: _attn_graph(tgraph))}


#: inputs per cell; a batch-b case serves the first b of them
N_INPUTS = 3


@functools.lru_cache(maxsize=None)
def _reference(wl: str, kind: str, mode: str):
    """(weights, shifts, inputs, repro interpreter outputs per input,
    repro executor outputs for the stacked inputs) for one cell."""
    g = GRAPHS[wl][0]()
    arch = _arch(ja, kind, mode)
    params = jparams(arch)
    weights = jfn.make_weights(g, 0)
    inputs = [jfn.make_input(g, i) for i in range(N_INPUTS)]
    shifts = jfn.calibrate_shifts(g, weights, inputs[0], params)
    res = jcompiler.compile_graph(g, arch, expand=True)
    sim = jfn.FunctionalSimulator(res.plan, res.program, weights, shifts,
                                  params=params)
    interp = [sim.run(x) for x in inputs]
    res = jcompiler.compile_graph(g, arch)
    exe = jex.lower(res.plan, res.program, params=params)
    stacked = {k: np.stack([x[k] for x in inputs]) for k in g.inputs}
    return weights, shifts, inputs, interp, exe.run_batch(
        stacked, weights, shifts)


def _port(wl: str, kind: str, mode: str, batch: int):
    weights, shifts, inputs, interp, jexe = _reference(wl, kind, mode)
    g = GRAPHS[wl][1]()
    arch = _arch(ta, kind, mode)
    params = tparams(arch)
    assert tfn.calibrate_shifts(g, weights, inputs[0], params,
                                device="cpu") == shifts
    res = tcompiler.compile_graph(g, arch)
    exe = tex.lower(res.plan, res.program, params=params, device="cpu")
    stacked = {k: np.stack([x[k] for x in inputs[:batch]])
               for k in g.inputs}
    out = exe.run_batch(stacked, weights, shifts)
    for t in g.outputs:
        np.testing.assert_array_equal(out[t], jexe[t][:batch])
        np.testing.assert_array_equal(
            out[t], np.stack([o[t] for o in interp[:batch]]))
    return g, exe, out


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("kind", ["exact", "saturating"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wl", ["tiny_mlp", "tiny_cnn"])
def test_executor_matches_reference(wl, mode, kind, batch):
    _, exe, _ = _port(wl, kind, mode, batch)
    assert exe.stats.cim_reads > 0
    assert exe.stats.kernel_mode == "torch"
    if exe.stats.streamed:
        assert exe.stats.segments > 1 and exe.stats.swaps > 0
        assert exe.stats.matmul_nodes == 0
    elif kind == "exact":
        assert exe.stats.matmul_nodes == exe.stats.cim_nodes
    else:
        assert exe.stats.matmul_nodes == 0     # tile-batched MVM path


def test_executor_split_graph():
    _port("split", "exact", "WLM", 2)


@pytest.mark.parametrize("kind", ["exact", "saturating"])
def test_executor_float_and_matmul_dcom_ops(kind):
    """MatMul (transpose_b), Softmax, LayerNorm and Gelu: each float op
    reads an int8-range operand, so Softmax and LayerNorm run as row
    reductions on the device and Gelu as a table, all bit-equal to the
    reference's NumPy float64 path."""
    _port("attn", kind, "WLM", 2)


@pytest.mark.parametrize("wl", ["tiny_mlp", "tiny_cnn"])
def test_executor_streamed_weight_updates(wl):
    """The docs/KERNELS.md chip cannot hold the model: the plan has
    segments and the executor swaps weights through the crossbar pool."""
    _, exe, _ = _port(wl, "streamed", "WLM", 3)
    assert exe.stats.streamed and exe.stats.swaps > 0
    assert exe.stats.segments > 1


def test_interpreter_and_entry_points_match_reference():
    """The port's op-by-op interpreter, ``simulate`` and
    ``compile_and_verify`` on the saturating arch."""
    weights, shifts, inputs, interp, _ = _reference("tiny_cnn", "saturating",
                                                    "XBM")
    g, arch = twl("tiny_cnn"), _arch(ta, "saturating", "XBM")
    res = tcompiler.compile_graph(g, arch, expand=True)
    sim = tfn.FunctionalSimulator(res.plan, res.program, weights, shifts,
                                  device="cpu")
    np.testing.assert_array_equal(sim.run(inputs[0])["fc.out"],
                                  interp[0]["fc.out"])
    sim_out, ref_out, _ = tfn.simulate(g, arch, device="cpu")
    exe_out, _, stats = tfn.simulate(g, arch, use_executor=True,
                                     device="cpu")
    jsim_out, jref_out, _ = jfn.simulate(jwl("tiny_cnn"),
                                         _arch(ja, "saturating", "XBM"))
    np.testing.assert_array_equal(sim_out["fc.out"], jsim_out["fc.out"])
    np.testing.assert_array_equal(exe_out["fc.out"], jsim_out["fc.out"])
    np.testing.assert_array_equal(ref_out["fc.out"], jref_out["fc.out"])
    assert stats.cim_reads > 0
    rep = tfn.compile_and_verify(g, arch, batch=2, device="cpu")
    assert rep.ok and rep.lower_s > 0.0


def test_pack_takes_weights_from_reference():
    weights, shifts, inputs, _, jexe = _reference("tiny_mlp", "saturating",
                                                  "WLM")
    g, arch = twl("tiny_mlp"), _arch(ta, "saturating", "WLM")
    params = tparams(arch)
    tw, tsh = tfn.weights_from_reference(weights, shifts, params, "cpu")
    assert all(w.dtype.is_floating_point is False for w in tw.values())
    res = tcompiler.compile_graph(g, arch)
    exe = tex.lower(res.plan, res.program, params=params, device="cpu")
    out = exe.run_batch({"input": np.stack([x["input"] for x in inputs])},
                        packed=exe.pack(tw), shifts=tsh)
    np.testing.assert_array_equal(out["fc2.out"], jexe["fc2.out"])
    bad = dict(weights, fc1=weights["fc1"] * 4)
    with pytest.raises(ValueError, match="signed 8-bit"):
        tfn.weights_from_reference(bad, shifts, params, "cpu")
    with pytest.raises(TypeError):
        tfn.weights_from_reference(
            dict(weights, fc1=weights["fc1"].astype(np.float32)), shifts,
            params, "cpu")


def test_lower_cache_and_route_errors():
    g, arch = twl("tiny_mlp"), _arch(ta, "exact")
    res = tcompiler.compile_graph(g, arch)
    e1 = tex.lower(res.plan, res.program, device="cpu")
    assert tex.lower(res.plan, res.program, device="cpu") is e1
    assert tex.lower(res.plan, res.program, device="cpu",
                     cache=False) is not e1
    assert tex.lower(res.plan, res.program, device="cpu",
                     params=tparams(_arch(ta, "saturating"))) is not e1
    # a route the registry cannot satisfy raises; it is not a LoweringError
    with pytest.raises(backend.KernelUnsupportedError):
        tex.lower(res.plan, res.program, device="cpu", mode="compiled",
                  cache=False)
    assert not issubclass(backend.KernelUnsupportedError, tex.LoweringError)


def test_compile_and_verify_falls_back_on_lowering_error(monkeypatch):
    def refuse(*args, **kwargs):
        raise tex.LoweringError("forced for test")

    monkeypatch.setattr(tex, "lower", refuse)
    rep = tfn.compile_and_verify(twl("tiny_mlp"), _arch(ta, "exact"),
                                 batch=2, device="cpu")
    assert rep.ok and rep.lower_s == 0.0    # interpreter path was used


@pytest.mark.parametrize("kind", ["saturating", "streamed"])
def test_pack_rejects_weights_outside_the_encoded_range(kind):
    """A weight outside the signed ``weight_bits`` range would wrap in
    the kernel's uint8 crossbar operand; packing refuses it instead."""
    g, arch = twl("tiny_mlp"), _arch(ta, kind)
    res = tcompiler.compile_graph(g, arch)
    exe = tex.lower(res.plan, res.program, device="cpu", cache=False)
    weights = tfn.make_weights(g, 0)
    exe.pack(weights)
    weights["fc1"][0, 0] = 128
    with pytest.raises(tex.TileRangeError, match="outside"):
        exe.pack(weights)


def _float_op_graph(op: str, in_shape, direct: bool = False,
                    width: int = 7, **attrs):
    """``op`` (with ``attrs``) after a crossbar Gemm of ``width``
    outputs (``direct``: on the graph input itself, then the Gemm),
    served with the Gemm's output."""
    Node = tgraph.Node
    k = in_shape[-1]
    if direct:
        nodes = [Node("f", op, ["input"], ["f.out"], attrs),
                 Node("fc", "Gemm", ["f.out"], ["fc.out"],
                      {"weight_shape": (k, width)})]
        outputs = ["f.out", "fc.out"]
    else:
        nodes = [Node("fc", "Gemm", ["input"], ["fc.out"],
                      {"weight_shape": (k, width)}),
                 Node("f", op, ["fc.out"], ["f.out"], attrs)]
        outputs = ["fc.out", "f.out"]
    return tgraph.Graph(f"{op.lower()}_toy", nodes, {"input": in_shape},
                        outputs)


def _interpreted(g, arch, weights, shifts, xs):
    """The port's op-by-op interpreter over each row of ``xs``, stacked."""
    res = tcompiler.compile_graph(g, arch, expand=True)
    sim = tfn.FunctionalSimulator(res.plan, res.program, weights, shifts,
                                  device="cpu")
    outs = [sim.run({"input": x}) for x in xs]
    return {t: np.stack([o[t] for o in outs]) for t in g.outputs}


@pytest.mark.parametrize("op", ["Gelu", "Silu", "Sigmoid", "Tanh"])
def test_elementwise_float_op_is_a_table_equal_to_the_host_path(op):
    """After a crossbar node (int8-range) the op is one gather from a
    256-entry table: the table is the NumPy float64 reference's answer
    to every operand, and ``run_batch`` equals the interpreter and the
    host round trip over batches of odd shapes."""
    arch = _arch(ta, "saturating")
    params = tparams(arch)
    for in_shape in [(13,), (3, 13)]:
        g = _float_op_graph(op, in_shape)
        res = tcompiler.compile_graph(g, arch)
        exe = tex.lower(res.plan, res.program, params=params, device="cpu",
                        cache=False)
        assert (exe.stats.table_dcom_nodes, exe.stats.row_dcom_nodes,
                exe.stats.host_dcom_nodes) == (1, 0, 0)
        y = tfn._float_dcom(op, [np.arange(-128, 128)], g.node("f"))
        np.testing.assert_array_equal(
            exe._tables["f"].numpy(),
            np.clip(np.round(y * 32.0), -128, 127).astype(np.int32))
        weights = tfn.make_weights(g, 0)
        shifts = tfn.calibrate_shifts(g, weights, tfn.make_input(g, 0),
                                      params, device="cpu")
        host = tex.lower(res.plan, res.program, params=params, device="cpu",
                         cache=False)
        host._tables.clear()
        for batch in (1, 2, 5):
            xs = np.stack([tfn.make_input(g, batch * 10 + i)["input"]
                           for i in range(batch)])
            out = exe.run_batch({"input": xs}, weights, shifts)
            want = _interpreted(g, arch, weights, shifts, xs)
            got_host = host.run_batch({"input": xs}, weights, shifts)
            for t in g.outputs:
                np.testing.assert_array_equal(out[t], want[t])
                np.testing.assert_array_equal(out[t], got_host[t])


def test_float_op_on_a_graph_input_keeps_the_host_round_trip():
    """Nothing clamps a graph input, so an op reading one is not
    tabulated, and operands far outside [-128, 127] still equal the
    interpreter."""
    arch = _arch(ta, "saturating")
    params = tparams(arch)
    g = _float_op_graph("Gelu", (3, 13), direct=True)
    res = tcompiler.compile_graph(g, arch)
    exe = tex.lower(res.plan, res.program, params=params, device="cpu",
                    cache=False)
    assert (exe.stats.table_dcom_nodes, exe.stats.row_dcom_nodes,
            exe.stats.host_dcom_nodes) == (0, 0, 1)
    assert not exe._tables
    weights = tfn.make_weights(g, 0)
    xs = np.random.default_rng(1).integers(-1000, 1001, (2, 3, 13))
    xs[0, 0, :2] = (-1000, 1000)
    shifts = tfn.calibrate_shifts(g, weights, {"input": xs[0]}, params,
                                  device="cpu")
    out = exe.run_batch({"input": xs}, weights, shifts)
    want = _interpreted(g, arch, weights, shifts, xs)
    for t in g.outputs:
        np.testing.assert_array_equal(out[t], want[t])


def _marked_graph():
    """Each mark the range proof gives: kept through Relu, Transpose and
    Reshape, lost by a Concat with the graph input."""
    Node = tgraph.Node
    nodes = [
        Node("fc", "Gemm", ["input"], ["fc.out"], {"weight_shape": (8, 8)}),
        Node("r", "Relu", ["fc.out"], ["r.out"]),
        Node("tr", "Transpose", ["r.out"], ["tr.out"], {"perm": [1, 0]}),
        Node("rs", "Reshape", ["tr.out"], ["rs.out"], {"shape": [4, 4]}),
        Node("t1", "Tanh", ["rs.out"], ["t1.out"]),
        Node("cat", "Concat", ["input", "fc.out"], ["cat.out"],
             {"axis": 0}),
        Node("t2", "Sigmoid", ["cat.out"], ["t2.out"]),
    ]
    return tgraph.Graph("marks", nodes, {"input": (2, 8)},
                        ["t1.out", "t2.out"])


@pytest.mark.parametrize("case, routes", [
    ("marks", (1, 0, 1)),
    ("vit_b16", (12, 37, 0)),     # 12 Gelu; 12 Softmax and 25 LayerNorm
    ("resnet18", (0, 0, 0)),
])
def test_float_op_routes_at_lowering(case, routes):
    if case == "marks":
        g = _marked_graph()
        assert tex._int8_range(g) == {"fc.out", "r.out", "tr.out",
                                      "rs.out", "t1.out", "t2.out"}
    elif case == "vit_b16":
        g = twl("vit_b16", in_hw=32, patch=16, d=32, n_layers=12,
                n_heads=4, d_ff=512, n_classes=10)
    else:
        g = twl("resnet18", in_hw=32)
    res = tcompiler.compile_graph(g, ta.get_arch("jia-issc21"))
    exe = tex.lower(res.plan, res.program, device="cpu", cache=False)
    assert (exe.stats.table_dcom_nodes, exe.stats.row_dcom_nodes,
            exe.stats.host_dcom_nodes) == routes
    marked = tex._int8_range(g)
    assert sorted(exe._tables) == sorted(
        n.name for n in g.nodes
        if n.op_type in ("Gelu", "Silu", "Sigmoid", "Tanh")
        and n.inputs[0] in marked)
    assert sorted(exe._row_ops) == sorted(
        n.name for n in g.nodes
        if n.op_type in ("Softmax", "LayerNorm", "RMSNorm")
        and n.inputs[0] in marked)


@pytest.mark.parametrize("op, attrs", [
    ("Softmax", {"scale": 0.125}),
    ("Softmax", {}),
    ("LayerNorm", {}),
    ("RMSNorm", {}),
])
def test_row_float_op_runs_on_the_device_equal_to_the_host_path(op, attrs):
    """After a crossbar node (int8-range) the op is a row reduction on
    the executor's device, over rows of 200 (split 96 + 104 in NumPy's
    pairwise order) and of 7, equal to the interpreter and to the host
    round trip over batches of odd sizes."""
    arch = _arch(ta, "saturating")
    params = tparams(arch)
    for width in (200, 7):
        g = _float_op_graph(op, (3, 13), width=width, **attrs)
        res = tcompiler.compile_graph(g, arch)
        exe = tex.lower(res.plan, res.program, params=params, device="cpu",
                        cache=False)
        assert (exe.stats.table_dcom_nodes, exe.stats.row_dcom_nodes,
                exe.stats.host_dcom_nodes) == (0, 1, 0)
        weights = tfn.make_weights(g, 0)
        shifts = tfn.calibrate_shifts(g, weights, tfn.make_input(g, 0),
                                      params, device="cpu")
        host = tex.lower(res.plan, res.program, params=params, device="cpu",
                         cache=False)
        host._row_ops.clear()
        for batch in (1, 2, 5):
            xs = np.stack([tfn.make_input(g, batch * 10 + i)["input"]
                           for i in range(batch)])
            out = exe.run_batch({"input": xs}, weights, shifts)
            want = _interpreted(g, arch, weights, shifts, xs)
            got_host = host.run_batch({"input": xs}, weights, shifts)
            for t in g.outputs:
                np.testing.assert_array_equal(out[t], want[t])
                np.testing.assert_array_equal(out[t], got_host[t])


@pytest.mark.parametrize("op, attrs, direct", [
    ("Softmax", {"scale": 0.0}, False),
    ("Softmax", {"scale": -0.5}, False),
    ("LayerNorm", {}, True),
    ("Softmax", {"scale": 0.125}, True),
])
def test_row_float_op_keeps_the_host_round_trip(op, attrs, direct):
    """A Softmax whose scale is not positive (its row max is not the
    scaled max of the integers) and a row op on a graph input (nothing
    clamps it) keep the host round trip, and still equal the
    interpreter, on a graph input operands far outside [-128, 127]
    included."""
    arch = _arch(ta, "saturating")
    params = tparams(arch)
    g = _float_op_graph(op, (3, 13), direct=direct, width=40, **attrs)
    res = tcompiler.compile_graph(g, arch)
    exe = tex.lower(res.plan, res.program, params=params, device="cpu",
                    cache=False)
    assert (exe.stats.table_dcom_nodes, exe.stats.row_dcom_nodes,
            exe.stats.host_dcom_nodes) == (0, 0, 1)
    assert not exe._row_ops
    weights = tfn.make_weights(g, 0)
    if direct:
        xs = np.random.default_rng(1).integers(-1000, 1001, (2, 3, 13))
        xs[0, 0, :2] = (-1000, 1000)
    else:       # the crossbar's operands stay in its range
        xs = np.stack([tfn.make_input(g, i)["input"] for i in range(2)])
    shifts = tfn.calibrate_shifts(g, weights, {"input": xs[0]}, params,
                                  device="cpu")
    out = exe.run_batch({"input": xs}, weights, shifts)
    want = _interpreted(g, arch, weights, shifts, xs)
    for t in g.outputs:
        np.testing.assert_array_equal(out[t], want[t])
