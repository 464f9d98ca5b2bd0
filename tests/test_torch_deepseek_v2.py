"""DeepSeek-V2-Lite in the port (``workloads.deepseek_v2_lite``) and the
ops it brought into the flow: YaRN ``RoPE``, the causal ``Softmax``,
``TopKRouter`` and the expert combine ``MoE`` with the executor's routed
dispatch.  At a small width on the CPU (d = 64 over 4 heads of 16 + 8
rope / 16 value dims, latent 32, a dense layer of 512 so that its down
projection's reads saturate jia's 8-bit ADC, 16 experts of 32 with 4
held, top-4, 2 layers, 24 tokens), the executor, the interpreter and the
benchmark's plain reference (``cimbench/models/deepseek_v2.py``, plain
torch) agree bit for bit.

The file imports no JAX, so its card cases run on a card host with
``python -m pytest -q --noconftest -m cuda tests/test_torch_deepseek_v2.py``.
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
from cimbench.models import deepseek_v2 as plain  # noqa: E402
from repro_torch.cimsim import compile_and_verify  # noqa: E402
from repro_torch.cimsim import executor as tex  # noqa: E402
from repro_torch.cimsim import functional as tfn  # noqa: E402
from repro_torch.core import compiler  # noqa: E402
from repro_torch.core.abstraction import get_arch  # noqa: E402
from repro_torch.core.graph import Graph, Node, weight_matrix_shape  # noqa: E402
from repro_torch.kernels.cim_mvm import cim_mvm_params  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serving import CimBatchService, CimRequest  # noqa: E402
from repro_torch.workloads import get_workload  # noqa: E402
from repro_torch.workloads.deepseek_v2 import YARN  # noqa: E402

SEED = 2_148_032_011
SMALL = dict(seq=24, d=64, n_layers=2, n_heads=4, qk_nope=16, qk_rope=8,
             v_dim=16, kv_lora=32, d_ff=512, moe_d_ff=32, n_experts=16,
             top_k=4, n_shared=2, experts_held=(0, 1, 2, 3), vocab=40)
#: the plain model's configuration at the small size
CFG = json.loads((ROOT / "cimbench" / "configs"
                  / "deepseek-v2-lite-jia.json").read_text())
CFG.update(prompt_tokens=24, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8,
           v_head_dim=16, kv_lora_rank=32, intermediate_size=512,
           moe_intermediate_size=32, num_experts_per_tok=4,
           n_routed_experts=4, experts_held=[0, 1, 2, 3], vocab_size=40,
           published={"n_routed_experts": 16})
#: served tensors compared: the logits and inner tensors of each new op
OUTPUTS = ["lm_head.out", "l0.q_rope.out", "l0.smax.out", "l1.route.out",
           "l1.moe.out", "l1.res2.out"]
ARCH_CONFIG = {"jia-issc21": "deepseek-v2-lite-jia.json",
               "isaac-baseline": "resnet18-isaac.json"}


def _graph(**kw):
    return get_workload("deepseek_v2_lite", **dict(SMALL, **kw))


def _crossbar(arch: str) -> reference.Crossbar:
    cfg = json.loads((ROOT / "cimbench" / "configs"
                      / ARCH_CONFIG[arch]).read_text())
    return reference.Crossbar.from_config(cfg)


# -- the graph ---------------------------------------------------------------------

def test_published_widths():
    """The cut served on the chip: 5 layers (the dense layer 0, 4 MoE
    layers), 8 of 64 experts held, an eighth of the vocabulary, every
    width as published."""
    g = get_workload("deepseek_v2_lite", n_layers=5,
                     experts_held=range(8), vocab=12800)
    sh = g.shapes
    assert g.inputs == {"embeds": (2048, 2048)}
    clip = g.node("embed")
    assert clip.op_type == "Clip" and clip.inputs == ["embeds"]
    assert (clip.attrs["min"], clip.attrs["max"]) == (-128, 127)
    assert sh["l0.wq.out"] == (2048, 3072)
    assert sh["l0.kva.ckv"] == (2048, 512) and sh["l0.kva.kpe"] == (2048, 64)
    assert sh["l0.wkvb.out"] == (2048, 4096)
    assert sh["l0.q.heads.out"] == sh["l0.k.heads.out"] == (16, 2048, 192)
    assert sh["l0.qkt.out"] == (16, 2048, 2048)
    assert sh["l0.v.heads.out"] == (16, 2048, 128)
    assert sh["l0.w_gate.out"] == (2048, 10944)
    assert sh["l1.router.out"] == sh["l1.route.out"] == (2048, 64)
    assert sh["l1.e7.w_gate.out"] == (2048, 1408)
    assert sh["l1.shared.w_gate.out"] == (2048, 2816)
    assert sh["l4.moe.out"] == (2048, 2048)
    assert sh["lm_head.out"] == (1, 12800)
    smax = g.node("l0.smax").attrs
    assert smax["causal"] and smax["scale"] == pytest.approx(0.114721,
                                                             abs=1e-6)
    route = g.node("l1.route").attrs
    assert (route["n_experts"], route["top_k"]) == (64, 6)
    assert g.node("l1.moe").attrs["experts"] == tuple(range(8))
    assert sum(math.prod(weight_matrix_shape(n)) for n in g.cim_nodes) \
        == 508_821_504


def test_graph_is_the_plain_models():
    g = _graph()
    assert [(n.name, weight_matrix_shape(n)) for n in g.cim_nodes] == \
        reference.weight_shapes(plain.layers(CFG))
    assert plain.build_kwargs(CFG) == dict(SMALL, first_k_dense=1,
                                           yarn=YARN)


# -- the port against the plain reference ------------------------------------------

@pytest.mark.parametrize("arch, d_ff", [("isaac-baseline", 512),
                                         ("jia-issc21", 512),
                                         ("jia-issc21", 10944)])
def test_served_port_equals_plain_reference(arch, d_ff):
    """``CimBatchService`` (the executor, routed dispatch and all) and
    the interpreter's ``reference_forward`` give the plain reference's
    tensors exactly, prompt for prompt; with the published dense width
    too, whose down projection jia cuts into row chunks."""
    g = dataclasses.replace(_graph(d_ff=d_ff), outputs=OUTPUTS)
    cfg = dict(CFG, intermediate_size=d_ff, outputs=OUTPUTS)
    a = get_arch(arch)
    params = cim_mvm_params(a)
    xb = _crossbar(arch)
    assert xb.exact() == params.exact
    gen = torch.Generator().manual_seed(5)
    weights = {name: torch.randint(-128, 128, rc, generator=gen,
                                   dtype=torch.int32)
               for name, rc in reference.weight_shapes(plain.layers(cfg))}
    x = torch.randint(-128, 128, (4, 24, 64), generator=gen,
                      dtype=torch.int32)
    calib, pool = x[0], x[1:]
    want = reference.run(plain.layers(cfg), weights, calib, pool, xb,
                         device=torch.device("cpu"), block=2,
                         outputs=OUTPUTS, ops=plain.OPS)
    shifts = tfn.calibrate_shifts(g, weights, {"embeds": calib.numpy()},
                                  params, device="cpu")
    svc = CimBatchService(g, a, max_batch=3, weights=weights, shifts=shifts,
                          device="cpu")
    reqs = [CimRequest(rid=i, inputs={"embeds": pool[i].numpy()})
            for i in range(3)]
    svc.dispatch(reqs)
    mvm = tfn.reference_mvm(params, "cpu")
    w_np = {k: v.numpy() for k, v in weights.items()}
    for i, r in enumerate(reqs):
        interp, _ = tfn.reference_forward(g, w_np,
                                          {"embeds": pool[i].numpy()},
                                          shifts=shifts, mvm=mvm)
        for t in OUTPUTS:
            np.testing.assert_array_equal(r.outputs[t], want[t][i].numpy(),
                                          err_msg=f"served {t}")
            np.testing.assert_array_equal(interp[t], want[t][i].numpy(),
                                          err_msg=f"interpreter {t}")
    logits = want["lm_head.out"].reshape(3, -1)
    assert len(torch.unique(logits, dim=0)) == 3
    assert (want["l1.moe.out"] != 0).any()


@pytest.mark.parametrize("arch", ["toy", "puma", "jia-issc21"])
@pytest.mark.parametrize("executor", [True, False],
                         ids=["executor", "interpreter"])
def test_compiled_flow_verifies(arch, executor):
    """The compiled flow, lowered or interpreted, equals the port's own
    int8 reference on each chip mode."""
    rep = compile_and_verify(_graph(n_layers=2, d_ff=96), get_arch(arch),
                             batch=2, device="cpu", use_executor=executor)
    assert rep.error is None and rep.ok, rep.max_abs_err


def test_aligned_rows_chunk_on_crossbar_boundaries():
    """A Gemm larger than jia's 16 crossbars is cut into row chunks: the
    dense down projection (10944 x 2048) into an even split by default
    (2189 rows, reads from each chunk's first row), on 1152-row crossbar
    boundaries when the node asks (2304 rows, reads as in the whole
    matrix)."""
    def chunk_rows(aligned):
        g = Graph("big", [Node("fc", "Gemm", ["x"], ["fc.out"],
                               {"weight_shape": (10944, 2048),
                                "aligned_rows": aligned})],
                  {"x": (4, 10944)}, ["fc.out"])
        res = compiler.compile_graph(g, get_arch("jia-issc21"))
        return sorted({(tfn.chunk_offsets(p.node, p)[0], p.mapping.r)
                       for p in res.plan.placements})
    assert chunk_rows(False) == [(2189 * k, 2189) for k in range(5)]
    assert chunk_rows(True) == [(2304 * k, 2304) for k in range(5)]


@pytest.mark.parametrize("lo, hi, route", [(-128, 127, "row"),
                                           (-1000, 1000, "host")])
def test_clip_states_the_int8_range(lo, hi, route):
    """A graph input is of unknown range, so a norm of it leaves the
    card; a ``Clip`` into int8 states the range and keeps it there.
    Either way the executor equals the interpreter."""
    g = Graph("clip", [Node("c", "Clip", ["x"], ["c.out"],
                            {"min": lo, "max": hi}),
                       Node("n", "RMSNorm", ["c.out"], ["n.out"]),
                       Node("fc", "Gemm", ["n.out"], ["fc.out"],
                            {"weight_shape": (8, 4)})],
              {"x": (3, 8)}, ["fc.out"])
    res = compiler.compile_graph(g, get_arch("toy"))
    exe = tex.lower(res.plan, res.program, device="cpu", cache=False)
    assert ("n" in exe._row_ops) == (route == "row")
    assert exe.stats.host_dcom_nodes == (route == "host")
    x = np.random.default_rng(SEED).integers(-300, 300, (2, 3, 8))
    w = tfn.make_weights(g)
    mvm = tfn.reference_mvm(cim_mvm_params(get_arch("toy")), "cpu")
    _, shifts = tfn.reference_forward(g, w, {"x": x[0]}, mvm=mvm)
    got = exe.run_batch({"x": x}, w, shifts)["fc.out"]
    for i in range(2):
        want, _ = tfn.reference_forward(g, w, {"x": x[i]}, shifts=shifts,
                                        mvm=mvm)
        np.testing.assert_array_equal(got[i], want["fc.out"])
    assert len(np.unique(got)) > 4


# -- routed dispatch ---------------------------------------------------------------

def _moe_graph(t=6, d=8, ff=4):
    """Two held experts (1 and 3 of 4), each a SwiGLU on the rows ``x``,
    combined under the gates that the graph takes as its input."""
    nodes = []
    outs = []
    for e in (1, 3):
        p = f"e{e}."
        nodes += [Node(f"{p}w_gate", "Gemm", ["x"], [f"{p}w_gate.out"],
                       {"weight_shape": (d, ff)}),
                  Node(f"{p}act", "Silu", [f"{p}w_gate.out"], [f"{p}act.out"]),
                  Node(f"{p}w_up", "Gemm", ["x"], [f"{p}w_up.out"],
                       {"weight_shape": (d, ff)}),
                  Node(f"{p}gu", "Mul", [f"{p}act.out", f"{p}w_up.out"],
                       [f"{p}gu.out"]),
                  Node(f"{p}w_down", "Gemm", [f"{p}gu.out"],
                       [f"{p}w_down.out"], {"weight_shape": (ff, d)})]
        outs.append(f"{p}w_down.out")
    nodes.append(Node("moe", "MoE", ["gates"] + outs, ["moe.out"],
                      {"experts": (1, 3)}))
    return Graph("moe", nodes, {"x": (t, d), "gates": (t, 4)}, ["moe.out"])


def _gates(rng, t, routed=True):
    g = np.where(rng.random((t, 4)) < 0.5, rng.integers(0, 33, (t, 4)), -1)
    if not routed:
        g[:, [1, 3]] = -1
    return g.astype(np.int32)


@pytest.mark.parametrize("arch", ["toy", "jia-issc21"])
def test_routed_dispatch_equals_dense_experts(arch):
    """Each held expert's chain on its routed rows alone gives the dense
    experts' combine bit for bit, a prompt routed to no held expert (a
    row of zeros) and one whose every row is routed included; so does
    the interpreter."""
    g = _moe_graph()
    a = get_arch(arch)
    rng = np.random.default_rng(SEED)
    w = tfn.make_weights(g, 3)
    x = rng.integers(-128, 128, (3, 6, 8)).astype(np.int32)
    gates = np.stack([_gates(rng, 6), _gates(rng, 6, routed=False),
                      np.full((6, 4), 7, np.int32)])
    mvm = tfn.reference_mvm(cim_mvm_params(a), "cpu")
    _, shifts = tfn.reference_forward(g, w, {"x": x[0], "gates": gates[0]},
                                      mvm=mvm)
    res = compiler.compile_graph(g, a)
    routed = tex.lower(res.plan, res.program, device="cpu", cache=False)
    dense = tex.lower(res.plan, res.program, device="cpu", cache=False)
    assert [c.expert for c in routed._moe["moe"]] == [1, 3]
    assert [n.name for n in routed._moe["moe"][0].nodes] == \
        ["e1.w_gate", "e1.act", "e1.w_up", "e1.gu", "e1.w_down"]
    dense._moe["moe"] = [None, None]
    dense._in_moe = set()
    inputs = {"x": x, "gates": gates}
    got = routed.run_batch(inputs, w, shifts)["moe.out"]
    np.testing.assert_array_equal(
        got, dense.run_batch(inputs, w, shifts)["moe.out"])
    for i in range(3):
        want, _ = tfn.reference_forward(
            g, w, {"x": x[i], "gates": gates[i]}, shifts=shifts, mvm=mvm)
        np.testing.assert_array_equal(got[i], want["moe.out"])
    assert not got[1].any() and got[0].any() and got[2].any()


def test_expert_chain_stops_at_shared_tensors():
    """A node whose output anything besides the chain reads is not the
    chain's: the chain then starts from that tensor, and with two such
    tensors there is none and the expert is combined densely."""
    g = _moe_graph()
    nodes = list(g.nodes) + [Node("tap", "Relu", ["e3.gu.out"],
                                  ["tap.out"])]
    g2 = Graph("moe_tap", nodes, g.inputs, ["moe.out", "tap.out"])
    chains = [tex._expert_chain(g2, g2.node("moe"), e, t)
              for e, t in ((1, "e1.w_down.out"), (3, "e3.w_down.out"))]
    assert chains[0] is not None and len(chains[0].nodes) == 5
    assert chains[0].source == "x"
    assert [n.name for n in chains[1].nodes] == ["e3.w_down"]
    assert chains[1].source == "e3.gu.out"
    nodes[-1] = Node("tap", "Add", ["e3.gu.out", "e3.act.out"], ["tap.out"])
    g3 = Graph("moe_tap2", nodes, g.inputs, ["moe.out", "tap.out"])
    assert tex._expert_chain(g3, g3.node("moe"), 3, "e3.w_down.out") \
        is not None
    nodes[-1] = Node("tap", "Add", ["x", "e3.w_down.out"], ["tap.out"])
    g4 = Graph("moe_tap3", nodes, g.inputs, ["moe.out", "tap.out"])
    assert tex._expert_chain(g4, g4.node("moe"), 3, "e3.w_down.out") is None


# -- the router --------------------------------------------------------------------

def _router(top_k=2):
    return Node("r", "TopKRouter", ["x"], ["r.out"],
                {"n_experts": 6, "top_k": top_k, "scale": 1.0})


#: equal logits at experts 1, 2, 4 and 5: the lower index wins each tie
TIES = np.array([[0, 9, 9, 3, 9, 9],
                 [5, 5, 5, 5, 5, 5],
                 [-128, -128, 7, -128, 7, -128]], np.int32)


@pytest.mark.parametrize("side", ["interpreter", "executor", "plain"])
def test_router_breaks_ties_to_the_lower_expert(side):
    if side == "interpreter":
        got = tfn.apply_dcom(_router(), [TIES], None, {}, False)
    elif side == "executor":
        exe = _lowered_router()
        got = exe._route(_router(), torch.as_tensor(TIES)).numpy()
    else:
        got = plain.OPS["router"]([torch.as_tensor(TIES)],
                                  {"top_k": 2, "scaling": 1.0}).numpy()
    routed = got >= 0
    np.testing.assert_array_equal(np.nonzero(routed)[1],
                                  [1, 2, 0, 1, 2, 4])
    w = tfn._float_dcom("Softmax", [TIES], _router())
    np.testing.assert_array_equal(got[routed],
                                  np.round(w * 32)[routed].astype(int))
    assert got[0, 1] == got[0, 2] == 8 and got[1, 0] == 5


def _lowered_router():
    g = Graph("router", [
        Node("fc", "Gemm", ["x"], ["fc.out"], {"weight_shape": (8, 6)}),
        Node("r", "TopKRouter", ["fc.out"], ["r.out"], _router().attrs)],
        {"x": (3, 8)}, ["r.out"])
    res = compiler.compile_graph(g, get_arch("toy"))
    exe = tex.lower(res.plan, res.program, device="cpu", cache=False)
    assert "r" in exe._routers
    return exe


def test_router_without_top_k_is_not_lowered():
    """The LM-block graphs' routers state no ``top_k``: they lower as
    before, which is not at all."""
    g = Graph("r", [Node("r", "TopKRouter", ["x"], ["r.out"],
                         {"n_experts": 6})], {"x": (3, 6)}, ["r.out"])
    res = compiler.compile_graph(g, get_arch("toy"))
    with pytest.raises(tex.LoweringError, match="TopKRouter"):
        tex.lower(res.plan, res.program, device="cpu", cache=False)


# -- RoPE -------------------------------------------------------------------------

def _rope_node(**kw):
    return Node("rope", "RoPE", ["x"], ["rope.out"],
                dict(dim=64, axis=0, interleaved=True, **dict(YARN, **kw)))


def test_yarn_tables_are_the_published_formula():
    """inv_freq_i = f_i / 40 (1 - M_i) + f_i M_i, f_i = 10000^(-2i/64),
    M_i = 1 - clamp((i - 10) / 13, 0, 1): 10 and 23 are the correction
    range of 32 and 1 rotations over 4096 positions; cos and sin of
    t inv_freq over both halves, mscale / mscale_all_dim = 1.  The plain
    reference builds the same tables in torch."""
    cos, sin = tfn.rope_tables(_rope_node(), 2048)
    i = np.arange(32)
    f = 10000.0 ** (-2 * i / 64)
    m = 1 - np.clip((i - 10) / 13, 0, 1)
    inv = f / 40 * (1 - m) + f * m
    ang = np.arange(2048)[:, None] * np.concatenate([inv, inv])[None]
    np.testing.assert_allclose(cos, np.cos(ang), rtol=0, atol=1e-12)
    np.testing.assert_allclose(sin, np.sin(ang), rtol=0, atol=1e-12)
    assert np.array_equal(cos[0], np.ones(64)) and not sin[0].any()
    layer = dict(dim=64, theta=10000, **CFG["rope_scaling"])
    pc, ps = plain.rope_tables(layer, 2048, torch.device("cpu"))
    np.testing.assert_allclose(pc.numpy(), cos, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ps.numpy(), sin, rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(24, 64), (24, 4, 64)])
def test_rope_rotates_interleaved_pairs(shape):
    """Position t turns pair (x_2j, x_2j+1), taken to (j, j + 32), by
    t inv_freq_j; the port's interpreter, executor and the plain
    reference agree."""
    rng = np.random.default_rng(SEED)
    x = rng.integers(-128, 128, shape).astype(np.int32)
    node = _rope_node()
    got = tfn.apply_dcom(node, [x], None, {}, False)
    cos, sin = tfn.rope_tables(node, shape[0])
    ang = np.arctan2(sin[:, :32], cos[:, :32])
    ang = ang.reshape((shape[0],) + (1,) * (len(shape) - 2) + (32,))
    a, b = x[..., 0::2].astype(float), x[..., 1::2].astype(float)
    want = np.concatenate([a * np.cos(ang) - b * np.sin(ang),
                           b * np.cos(ang) + a * np.sin(ang)], axis=-1)
    assert np.abs(got - np.clip(want, -128, 127)).max() <= 0.5 + 1e-9
    perm, tshape = tfn.rope_layout(node, shape)
    exe_cos = torch.as_tensor(cos.reshape(tshape))
    exe_sin = torch.as_tensor(sin.reshape(tshape))
    xe = torch.as_tensor(x)[None]
    ex = tex.LoweredExecutable.__new__(tex.LoweredExecutable)
    ex._ropes = {"rope": (torch.as_tensor(perm), exe_cos, exe_sin)}
    np.testing.assert_array_equal(ex._dcom(node, [xe], {})[0].numpy(), got)
    layer = dict(dim=64, theta=10000, **CFG["rope_scaling"])
    np.testing.assert_array_equal(
        plain.OPS["rope"]([torch.as_tensor(x)[None]], layer)[0].numpy(), got)


# -- the causal Softmax --------------------------------------------------------------

CAUSAL = [(0.114721, (2, 4, 24, 24)), (1.0, (2, 3, 197, 197)),
          (192 ** -0.5, (1, 2, 129, 129))]


def _causal(scale, shape, device):
    node = Node("s", "Softmax", ["x"], ["s.out"],
                {"scale": scale, "causal": True})
    x = np.random.default_rng(SEED).integers(-128, 128, shape,
                                             dtype=np.int32)
    x[..., 0, :] = 127            # a first row whose masked scores are max
    exp = torch.as_tensor(tex._softmax_exp_table(scale), device=device)
    n = torch.tensor(float(shape[-1]), dtype=torch.float64, device=device)
    keep = torch.as_tensor(tfn.causal_mask(*shape[-2:]), device=device)
    xd = torch.as_tensor(x, device=device)
    y = tfn._float_dcom("Softmax", [x], node)
    np.testing.assert_array_equal(
        tex._row_float("Softmax", xd, exp, n, keep).cpu().numpy(), y)
    got = tex._row_dcom("Softmax", xd, exp, n, keep).cpu().numpy()
    np.testing.assert_array_equal(got, tex._float_host(node, x))
    assert not y[..., 0, 1:].any() and (y[..., 0, 0] == 1).all()
    np.testing.assert_array_equal(
        plain.OPS["softmax"]([torch.as_tensor(x)], node.attrs).numpy(), got)


@pytest.mark.parametrize("scale, shape", CAUSAL)
def test_causal_row_softmax_equals_the_host_path(scale, shape):
    """Masked scores leave the max and add 0 in their places of the
    pairwise sum, as NumPy's ``exp(-inf)``; each query's weights sum to
    1 over its own and earlier keys."""
    _causal(scale, shape, torch.device("cpu"))


# -- lowering statistics, spans and counters ----------------------------------------

def test_executor_stats_at_the_published_widths():
    """The served cut lowers with every float op on the device, the
    first norm too, since the graph clips its input to int8: 37 SiLU
    tables, 21 row ops of which 5 causal Softmax, 10 RoPE, 4 MoE, each
    of its 8 experts routed."""
    g = get_workload("deepseek_v2_lite", n_layers=5,
                     experts_held=range(8), vocab=12800)
    res = compiler.compile_graph(g, get_arch("jia-issc21"))
    exe = tex.LoweredExecutable(res.plan, res.program, device="cpu")
    s = exe.stats
    assert (s.table_dcom_nodes, s.row_dcom_nodes, s.causal_softmax_nodes,
            s.host_dcom_nodes, s.rope_nodes, s.moe_nodes) == \
        (37, 21, 5, 0, 10, 4)
    assert "l0.attn_norm" in exe._row_ops
    assert all(c is not None and len(c.nodes) == 5
               for chains in exe._moe.values() for c in chains)
    assert len(exe._in_moe) == 4 * 8 * 5 and len(exe._routers) == 4


def test_moe_spans_nest_under_their_node_and_rows_are_counted():
    """A traced dispatch: ``moe.route`` (``experts_held``,
    ``routed_rows``) and one ``moe.expert`` (``expert``, ``rows``) per
    held expert inside the MoE node's span, each expert's chain nodes
    inside its ``moe.expert``; the ``executor_expert_rows`` histogram
    takes one observation per held expert per dispatch, summing to the
    routed rows."""
    g = _graph()
    svc = CimBatchService(g, get_arch("jia-issc21"), seed=3, max_batch=2,
                          device="cpu")
    x = np.random.default_rng(5).integers(-128, 128, (2, 24, 64))
    reqs = lambda: [CimRequest(rid=i, inputs={"embeds": x[i]})  # noqa: E731
                    for i in range(2)]
    svc.dispatch(reqs())
    reg = obs_metrics.enable(obs_metrics.MetricsRegistry())
    rec = obs_trace.install()
    try:
        svc.dispatch(reqs())
        svc.dispatch(reqs())
    finally:
        obs_trace.uninstall()
        obs_metrics.disable()
    last = max(e["args"]["dispatch"] for e in rec.events
               if "dispatch" in e.get("args", {}))
    ev = [e for e in rec.events if e["ph"] == "X"
          and e["args"].get("dispatch") == last]
    moe = next(e for e in ev if e["args"].get("node") == "l1.moe")
    assert moe["name"] == "MoE"

    def inside(e, outer):
        return outer["ts"] <= e["ts"] and \
            e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]

    route = [e for e in ev if e["name"] == "moe.route"]
    experts = [e for e in ev if e["name"] == "moe.expert"]
    assert len(route) == 1 and inside(route[0], moe)
    assert route[0]["args"]["experts_held"] == 4
    assert [e["args"]["expert"] for e in experts] == [0, 1, 2, 3]
    assert all(inside(e, moe) for e in experts)
    rows = [e["args"]["rows"] for e in experts]
    assert sum(rows) == route[0]["args"]["routed_rows"] > 0
    for e in experts:
        chain = [c for c in ev if c["args"].get("node", "").startswith(
            f"l1.e{e['args']['expert']}.")]
        assert len(chain) == (5 if e["args"]["rows"] else 0)
        assert all(inside(c, e) for c in chain)
    h = reg.snapshot()["histograms"]["executor_expert_rows"]
    assert h["count"] == 2 * 4 and h["sum"] == 2 * sum(rows)
    stats = svc.executor_stats
    assert (stats.rope_nodes, stats.moe_nodes,
            stats.causal_softmax_nodes) == (4, 1, 2)


# ------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the checks hold the card's "
                    "float64 kernels to the host's NumPy")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scale, shape",
                         CAUSAL + [(0.114721, (2, 16, 2048, 2048))])
def test_causal_row_softmax_on_the_card(card, scale, shape):
    _causal(scale, shape, card)


@pytest.mark.cuda
def test_rope_and_router_on_the_card(card):
    """RoPE's float64 products and sum, and the router's Softmax and
    stable sort, round on the card as on the host."""
    rng = np.random.default_rng(SEED)
    node = _rope_node()
    x = rng.integers(-128, 128, (2, 2048, 16, 64)).astype(np.int32)
    perm, tshape = tfn.rope_layout(node, x.shape[1:])
    cos, sin = tfn.rope_tables(node, 2048)
    ex = tex.LoweredExecutable.__new__(tex.LoweredExecutable)
    ex._ropes = {"rope": (torch.as_tensor(perm, device=card),
                          torch.as_tensor(cos.reshape(tshape), device=card),
                          torch.as_tensor(sin.reshape(tshape), device=card))}
    got = ex._dcom(node, [torch.as_tensor(x, device=card)], {})
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        np.stack([tfn.apply_dcom(node, [xi], None, {}, False) for xi in x]))
    logits = rng.integers(-128, 128, (4096, 64)).astype(np.int32)
    logits[:8] = logits[8]             # rows of equal-weight ties
    logits[:4, 5:40] = 3
    r = Node("r", "TopKRouter", ["x"], ["r.out"],
             {"n_experts": 64, "top_k": 6, "scale": 1.0})
    ex._routers = {"r": (
        torch.as_tensor(tex._softmax_exp_table(1.0), device=card),
        torch.tensor(64.0, dtype=torch.float64, device=card), None)}
    got = ex._route(r, torch.as_tensor(logits, device=card))
    np.testing.assert_array_equal(
        got.cpu().numpy(), tfn.apply_dcom(r, [logits], None, {}, False))
