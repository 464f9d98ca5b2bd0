"""The port's dispatch spans (``CimBatchService.dispatch`` down to each
kernel launch) and their clock, on the CPU through the plain route.

The served graph is ResNet-18 on jia-issc21 at 32x32 in batches of two,
serving the logits and the stage-1 map; a toy graph with a float op
covers the host round trip.
"""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.cimsim import executor as tex
from repro_torch.cimsim import functional as tfn
from repro_torch.core import abstraction as ta
from repro_torch.core import compiler as tcompiler
from repro_torch.core import graph as tgraph
from repro_torch.kernels.cim_mvm import cim_mvm_params
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import CimBatchService, CimRequest
from repro_torch.workloads import get_workload

SEED = 2_148_000_321
BATCH = 2
POOL = 8
#: nesting slack: each span's ts and dur are rounded to 1 ns
EPS_US = 0.01


@pytest.fixture(scope="module")
def served():
    """(service, requests(indices), the pool's size) of jia at 32x32."""
    graph = get_workload("resnet18", in_hw=32, n_classes=1000)
    graph = dataclasses.replace(graph, outputs=["fc.out", "conv3.out"])
    name = next(iter(graph.inputs))
    pool = [tfn.make_input(graph, SEED + 1 + i)[name] for i in range(POOL)]
    svc = CimBatchService(graph, ta.get_arch("jia-issc21"), seed=SEED,
                          max_batch=BATCH, device="cpu")

    def reqs(idx):
        return [CimRequest(rid=int(j), inputs={name: pool[j]}) for j in idx]

    svc.dispatch(reqs(range(BATCH)))         # warms the batch shape
    return svc, reqs, POOL


@pytest.fixture
def recorder():
    rec = obs_trace.install()
    try:
        yield rec
    finally:
        obs_trace.uninstall()


def _spans(rec):
    return [e for e in rec.events if e["ph"] == "X"]


def _tree(events):
    """{index: parent index or None} of nested spans on one row."""
    order = sorted(range(len(events)),
                   key=lambda i: (events[i]["ts"], -events[i]["dur"]))
    end = lambda i: events[i]["ts"] + events[i]["dur"]  # noqa: E731
    parent, stack = {}, []
    for i in order:
        while stack and end(stack[-1]) + EPS_US < end(i):
            stack.pop()
        parent[i] = stack[-1] if stack else None
        stack.append(i)
    return parent


def test_span_tree_nests_on_one_row(served, recorder):
    svc, reqs, _ = served
    svc.dispatch(reqs([1, 2]))
    ev = _spans(recorder)
    assert len({(e["pid"], e["tid"]) for e in ev}) == 1
    parent = _tree(ev)
    name = {i: e["name"] for i, e in enumerate(ev)}
    up = {i: (name[p] if p is not None else None) for i, p in parent.items()}
    root = [i for i, p in up.items() if p is None]
    assert [name[i] for i in root] == ["service.dispatch"]
    kids = lambda n: [name[i] for i, p in up.items() if p == n]  # noqa: E731
    assert kids("service.dispatch") == [
        "service.stack", f"dispatch:{svc.graph.name}", "service.answers"]
    assert kids(f"dispatch:{svc.graph.name}") == [
        "executor.inputs", "executor.forward", "executor.outputs"]
    nodes = [e for i, e in enumerate(ev) if up[i] == "executor.forward"]
    assert [e["name"] for e in nodes] == \
        [n.op_type for n in svc.graph.nodes]
    assert [e["args"]["node"] for e in nodes] == \
        [n.name for n in svc.graph.nodes]
    assert all(e["args"]["cim"] == (e["name"] in ("Conv", "Gemm"))
               for e in nodes)
    # every launch sits inside a crossbar node
    mvm = [i for i, e in enumerate(ev) if e["name"] == "cim_mvm"]
    assert mvm and all(up[i] in ("Conv", "Gemm") for i in mvm)
    disp = next(e for e in ev if e["name"] == "service.dispatch")
    assert disp["args"]["batch"] == 2 and disp["args"]["padded_to"] == 2
    assert "warm" not in disp["args"]
    inputs = next(e for e in ev if e["name"] == "executor.inputs")
    outputs = next(e for e in ev if e["name"] == "executor.outputs")
    assert inputs["args"]["bytes"] == 2 * 3 * 32 * 32 * 4
    assert outputs["args"]["bytes"] == sum(
        2 * int(np.prod(svc.graph.shapes[t])) * 4 for t in svc.graph.outputs)


def test_one_dispatch_id_per_pass(served, recorder):
    svc, reqs, _ = served
    svc.dispatch(reqs([0, 1]))
    svc.dispatch(reqs([2, 3]))
    svc.dispatch(reqs([3]), pad_to=4)        # a new shape: warm pass first
    ev = _spans(recorder)
    assert all("dispatch" in e["args"] for e in ev)
    tops = [e for e in ev if e["name"] == "service.dispatch"]
    ids = [e["args"]["dispatch"] for e in tops]
    assert len(ids) == 4 and len(set(ids)) == 4 and ids == sorted(ids)
    assert [bool(e["args"].get("warm")) for e in tops] == \
        [False, False, True, False]
    assert tops[3]["args"] == dict(tops[3]["args"], batch=1, padded_to=4)
    for top in tops:
        lo, hi = top["ts"], top["ts"] + top["dur"]
        inside = [e for e in ev if lo - EPS_US <= e["ts"]
                  and e["ts"] + e["dur"] <= hi + EPS_US]
        assert {e["args"]["dispatch"] for e in inside} == \
            {top["args"]["dispatch"]}
        assert len(inside) == sum(e["args"]["dispatch"] ==
                                  top["args"]["dispatch"] for e in ev)


def test_launch_args_match_dispatch_shapes(served, recorder):
    svc, reqs, _ = served
    svc.dispatch(reqs([4, 5]))
    got = [(e["args"]["t"], e["args"]["m"], e["args"]["r"], e["args"]["c"])
           for e in _spans(recorder) if e["name"] == "cim_mvm"]
    assert got == svc._exe.dispatch_shapes(BATCH)
    assert {e["args"]["route"] for e in _spans(recorder)
            if e["name"] == "cim_mvm"} == {svc._exe.route.mode}


def test_outputs_bit_identical_with_recorder(served):
    svc, reqs, _ = served
    plain = reqs([6, 7])
    svc.dispatch(plain)
    obs_trace.install()
    try:
        traced = reqs([6, 7])
        svc.dispatch(traced)
    finally:
        obs_trace.uninstall()
    for a, b in zip(plain, traced):
        assert a.outputs.keys() == b.outputs.keys()
        for k in a.outputs:
            assert a.outputs[k].dtype == b.outputs[k].dtype
            np.testing.assert_array_equal(a.outputs[k], b.outputs[k])


def test_no_span_and_no_series_with_recorder_off(served, monkeypatch):
    svc, reqs, _ = served
    rec = obs_trace.install()
    obs_trace.uninstall()

    def refuse(*a, **kw):
        raise AssertionError("a span was built with no recorder installed")

    monkeypatch.setattr(obs_trace, "Spans", refuse)
    monkeypatch.setattr(obs_trace.TraceRecorder, "complete", refuse)
    monkeypatch.setattr(obs_trace.TraceRecorder, "_complete", refuse)
    assert obs_metrics.active() is None
    svc.dispatch(reqs([0, 3]))
    assert rec.events == [] and obs_metrics.active() is None
    # with a registry on, a dispatch feeds exactly its three series, and
    # a recorder beside it adds none
    series = []
    for traced in (False, True):
        monkeypatch.undo()
        reg = obs_metrics.enable(obs_metrics.MetricsRegistry())
        if traced:
            obs_trace.install()
        try:
            svc.dispatch(reqs([1, 3]))
        finally:
            obs_trace.uninstall()
            obs_metrics.disable()
        snap = reg.snapshot()
        series.append(sorted(k for kind in ("counters", "gauges",
                                            "histograms")
                             for k in snap.get(kind, {})))
    assert series[0] == series[1]
    assert [s.split("{")[0] for s in series[0]] == [
        "cim_service_staging_total", "executor_dispatch_s",
        "executor_dispatches_total"]


def test_padded_shape_warms_under_the_same_spans(served, recorder):
    """A new padded shape: a warm pass, then the timed one, each with the
    whole tree, counting the padded rows' bytes; only real rows are
    answered."""
    svc, reqs, _ = served
    batch = reqs([5, 6])
    svc.dispatch(batch, pad_to=3)
    ev = _spans(recorder)
    tops = [e for e in ev if e["name"] == "service.dispatch"]
    assert [e["args"].get("warm", False) for e in tops] == [True, False]
    for top in tops:
        assert (top["args"]["batch"], top["args"]["padded_to"]) == (2, 3)
        mine = [e for e in ev
                if e["args"]["dispatch"] == top["args"]["dispatch"]]
        names = [e["name"] for e in mine]
        for name in ("service.stack", f"dispatch:{svc.graph.name}",
                     "executor.inputs", "executor.forward",
                     "executor.outputs", "service.answers"):
            assert names.count(name) == 1, name
        inputs = next(e for e in mine if e["name"] == "executor.inputs")
        assert inputs["args"]["bytes"] == 3 * 3 * 32 * 32 * 4
    assert all(r.outputs["fc.out"].shape == (1000,) for r in batch)


def test_staging_args_on_the_spans(served, recorder):
    """``service.stack`` says whether the pass allocated its shape's
    buffers or reused them, ``executor.inputs`` whether its inputs were
    pinned (never on the CPU); names and nesting are as before."""
    svc, reqs, _ = served
    svc.dispatch(reqs([1, 2]), pad_to=5)     # a new shape: warm pass first
    svc.dispatch(reqs([3, 4]))
    ev = _spans(recorder)
    stack = [e["args"]["staged"] for e in ev if e["name"] == "service.stack"]
    assert stack == ["allocated", "reused", "reused"]
    assert [e["args"]["pinned"] for e in ev
            if e["name"] == "executor.inputs"] == [False] * 3
    for top in (e for e in ev if e["name"] == "service.dispatch"):
        mine = [e for e in ev
                if e["args"]["dispatch"] == top["args"]["dispatch"]]
        parent = _tree(mine)
        up = {mine[i]["name"]: (mine[p]["name"] if p is not None else None)
              for i, p in parent.items()}
        assert up["service.stack"] == up["service.answers"] == \
            "service.dispatch"
        assert up["executor.inputs"] == f"dispatch:{svc.graph.name}"


def test_run_batch_alone_spans_the_graphs_row(served, recorder):
    """Called without the service's spans, ``run_batch`` makes its own on
    the graph's row of the executor track, with no dispatch id; the
    service's passes use that same row."""
    svc, reqs, _ = served
    name = next(iter(svc.graph.inputs))
    x = np.stack([r.inputs[name] for r in reqs([2, 7])])
    out = svc._exe.run_batch({name: x}, packed=svc._packed,
                             shifts=svc.shifts)
    ev = _spans(recorder)
    parent = _tree(ev)
    assert [ev[i]["name"] for i, p in parent.items() if p is None] == \
        [f"dispatch:{svc.graph.name}"]
    assert all("dispatch" not in e["args"] for e in ev)
    assert sum(e["name"] == "cim_mvm" for e in ev) == \
        len(svc._exe.dispatch_shapes(BATCH))
    served_reqs = reqs([2, 7])
    svc.dispatch(served_reqs)
    assert len({(e["pid"], e["tid"]) for e in _spans(recorder)}) == 1
    assert sum(e["ph"] == "M" and e["name"] == "thread_name"
               for e in recorder.events) == 1
    for i, r in enumerate(served_reqs):
        np.testing.assert_array_equal(r.outputs["conv3.out"],
                                      out["conv3.out"][i])


def test_install_reads_both_clocks_together():
    """The anchor is the Unix time at the process clock's zero: read
    within ``install`` and consistent with ``now_s`` afterwards."""
    lo = time.time_ns()
    rec = obs_trace.install()
    try:
        hi = time.time_ns()
        t = obs_trace.now_s()
        unix = time.time_ns()
    finally:
        obs_trace.uninstall()
    assert set(rec.anchor) == {"ts0_unix_ns"}
    assert lo <= rec.anchor["ts0_unix_ns"] <= hi
    assert abs(rec.anchor["ts0_unix_ns"] + t * 1e9 - unix) < 1e6
    obs_trace.validate_chrome_trace(rec.to_dict())
    # a recorder never installed has no clock to save
    assert "otherData" not in obs_trace.TraceRecorder().to_dict()


def _float_graph():
    """A Softmax on the graph input, which nothing clamps: it keeps the
    host round trip."""
    Node = tgraph.Node
    nodes = [
        Node("sm", "Softmax", ["input"], ["sm.out"]),
        Node("fc1", "Gemm", ["sm.out"], ["fc1.out"],
             {"weight_shape": (16, 16)}),
        Node("fc2", "Gemm", ["fc1.out"], ["fc2.out"],
             {"weight_shape": (16, 5)}),
    ]
    return tgraph.Graph("float_toy", nodes, {"input": (16,)}, ["fc2.out"])


def test_host_round_trip_is_its_own_span(recorder):
    g = _float_graph()
    arch = ta.CIMArch(
        name="test-saturating", mode=ta.ComputingMode.WLM,
        chip=ta.ChipTier(core_number=(4, 1), alu_ops_per_cycle=64,
                         l0_bw_bits=1024),
        core=ta.CoreTier(xb_number=(2, 1), l1_bw_bits=1024),
        xb=ta.CrossbarTier(xb_size=(32, 32), dac_bits=1, adc_bits=4,
                           cell_type=ta.CellType.SRAM, cell_precision=2,
                           parallel_row=8))
    params = cim_mvm_params(arch)
    weights = tfn.make_weights(g, 0)
    res = tcompiler.compile_graph(g, arch)
    exe = tex.lower(res.plan, res.program, params=params, device="cpu",
                    cache=False)
    x = np.stack([tfn.make_input(g, i)["input"] for i in range(3)])
    sp = obs_trace.Spans(recorder, obs_trace.EXECUTOR_TRACK, g.name,
                         dispatch=5)
    out = exe.run_batch({"input": x}, weights, {}, spans=sp)
    ev = [e for e in _spans(recorder) if e["args"].get("dispatch") == 5]
    parent = _tree(ev)
    dcom = [i for i, e in enumerate(ev) if e["name"] == "executor.host_dcom"]
    assert len(dcom) == 1
    assert ev[parent[dcom[0]]]["name"] == "Softmax"
    assert ev[dcom[0]]["args"]["bytes"] == 3 * 16 * 4
    obs_trace.uninstall()
    np.testing.assert_array_equal(
        exe.run_batch({"input": x}, weights, {})["fc2.out"], out["fc2.out"])


def test_saved_trace_carries_the_clock(tmp_path, recorder):
    from repro_torch import serving
    assert serving.TraceRecorder is obs_trace.TraceRecorder
    t0 = obs_trace.now_s()
    obs_trace.Spans(recorder, obs_trace.EXECUTOR_TRACK, "g",
                    dispatch=1).span("probe", t0)
    saved = obs_trace.load_trace(recorder.save(tmp_path / "t.json"))
    clock = saved["otherData"]["clock"]
    assert clock == recorder.anchor
    assert isinstance(clock["ts0_unix_ns"], int)
    (ev,) = _spans(recorder)
    assert ev["args"] == {"dispatch": 1} and ev["cat"] == "executor"


def test_program_span_lands_on_the_profiler_timeline(recorder, tmp_path):
    """A ``record_function`` inside a program span lies inside that span
    once the span is moved onto the profiler's timeline."""
    from torch.profiler import ProfilerActivity, profile, record_function
    sp = obs_trace.Spans(recorder, obs_trace.EXECUTOR_TRACK, "g")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            t0 = obs_trace.now_s()
            with record_function(f"probe{i}"):
                torch.ones(64).sum()
            sp.span(f"span{i}", t0)
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    # a span's place on the profiler's timeline, in microseconds
    shift = (recorder.anchor["ts0_unix_ns"]
             - data["baseTimeNanoseconds"]) / 1e3
    moved = {e["name"]: dict(e, ts=e["ts"] + shift)
             for e in _spans(recorder)}
    probes = {e["name"]: e for e in data["traceEvents"]
              if e.get("ph") == "X" and e["name"].startswith("probe")}
    assert len(probes) == 3
    for i in range(3):
        p, s = probes[f"probe{i}"], moved[f"span{i}"]
        assert s["ts"] - 50 <= float(p["ts"])
        assert float(p["ts"]) + float(p["dur"]) <= s["ts"] + s["dur"] + 50


# ------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pinned staging and the "
                    "crossbar-MVM kernel have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_stages_pinned_and_matches_the_plain_route(card, served,
                                                        recorder):
    """On the card the staging buffer is pinned and ``executor.inputs``
    says so; two back-to-back dispatches of different batches, the second
    overwriting the buffer the first was copied from, answer as the CPU
    service does (the plain route, bit-exact)."""
    ref, reqs, _ = served
    svc = CimBatchService(ref.graph, ref.arch, max_batch=BATCH,
                          weights=ref.weights, shifts=ref.shifts, device=card)
    batches = [reqs([0, 5]), reqs([6, 3])]
    svc.dispatch(batches[0])
    svc.dispatch(batches[1])
    name = next(iter(ref.graph.inputs))
    assert svc._staging[BATCH].tensors[name].is_pinned()
    assert [e["args"]["pinned"] for e in _spans(recorder)
            if e["name"] == "executor.inputs"] == [True] * 3
    obs_trace.uninstall()
    for got, idx in zip(batches, ([0, 5], [6, 3])):
        want = reqs(idx)
        ref.dispatch(want)
        for a, b in zip(got, want):
            for t in ref.graph.outputs:
                np.testing.assert_array_equal(a.outputs[t], b.outputs[t])
