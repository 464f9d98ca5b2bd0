"""The span phase's reductions (``cimbench/spans.py``) on synthetic
traces, and the phase on the CPU at 32x32."""
import pytest
import torch

from cimbench import harness, spans
from repro_torch.cimsim import functional as tfn
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import CimBatchService, CimRequest

SEED = 2_148_000_321
BATCH = 2


@pytest.fixture(scope="module")
def served():
    """(service, requests(indices), the pool's size) of jia at 32x32."""
    cell = harness.load_cell("resnet18-jia.b16")
    cell.config = dict(cell.config, in_hw=32)
    cell.traffic = dict(cell.traffic, batch=BATCH)
    dev = torch.device("cpu")
    graph, arch, params = harness.program_graph(cell)
    inp = harness.make_inputs(cell, SEED, dev)
    name = next(iter(graph.inputs))
    shifts = tfn.calibrate_shifts(graph, inp.weights, {name: inp.calib},
                                  params, device=dev)
    svc = CimBatchService(graph, arch, max_batch=BATCH, weights=inp.weights,
                          shifts=shifts, device=dev)

    def reqs(idx):
        return [CimRequest(rid=int(j), inputs={name: inp.pool[j]})
                for j in idx]

    svc.dispatch(reqs(range(BATCH)))         # warms the batch shape
    return svc, reqs, len(inp.pool)


def test_program_spans_move_by_the_anchor():
    """A span's ``ts`` moves by the anchor less the profiler's base; a
    trace without the anchor cannot be moved; no base leaves it as
    recorded."""
    rec = {"traceEvents": [{"name": "s", "ph": "X", "ts": 10.0, "dur": 2.0},
                           {"name": "m", "ph": "M", "ts": 0}],
           "otherData": {"clock": {"ts0_unix_ns": 1_700_000_000_123_456_789}}}
    (moved,) = spans.program_spans(rec, 1_700_000_000_000_000_000)
    assert moved["ts"] == pytest.approx(10.0 + 123_456.789)
    assert moved["dur"] == 2.0
    assert spans.program_spans({"traceEvents": rec["traceEvents"]},
                               1_700_000_000_000_000_000) == []
    assert spans.program_spans(rec, None)[0]["ts"] == 10.0


def _x(name, ts, dur, **args):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur, "args": args}


def test_idle_by_span_splits_gaps_by_time():
    """A parent [0, 100] holding a child [20, 60]; device busy [0, 10]
    and [70, 80]; window [0, 120].  The gap [10, 70] crosses both: 10
    to the parent, 40 to the child, 10 to the parent; [80, 120] gives 20
    to the parent and 20 to no span."""
    progs = [_x("parent", 0.0, 100.0), _x("child", 20.0, 40.0)]
    ops = [{"cat": "kernel", "name": "k", "ph": "X", "ts": 0.0, "dur": 10.0},
           {"cat": "gpu_memcpy", "name": "c", "ph": "X", "ts": 70.0,
            "dur": 10.0}]
    got = spans.idle_by_span(progs, ops, (0.0, 120.0))
    assert got == pytest.approx({"parent": 40e-6, "child": 40e-6,
                                 spans.OUTSIDE: 20e-6})
    assert sum(got.values()) == pytest.approx(100e-6)
    # the start of a gap does not decide: one gap opening in the child
    # and running past the parent's end is split three ways
    got = spans.idle_by_span(progs, [ops[0]], (0.0, 120.0))
    assert got == pytest.approx({"parent": 50e-6, "child": 40e-6,
                                 spans.OUTSIDE: 20e-6})


def test_span_readings_share_out_the_idle_time():
    """The phase's readings on a synthetic trace of two dispatches: the
    three idle shares sum to the phase's idle share."""
    progs = []
    for d, t in ((1, 0.0), (2, 200.0)):
        progs += [
            _x("service.dispatch", t, 150.0, dispatch=d, batch=2,
               padded_to=2),
            _x("service.stack", t, 20.0, dispatch=d),
            _x("dispatch:g", t + 20.0, 120.0, dispatch=d),
            _x("executor.inputs", t + 20.0, 10.0, dispatch=d, bytes=64),
            _x("executor.forward", t + 30.0, 60.0, dispatch=d),
            _x("Conv", t + 30.0, 60.0, dispatch=d, node="c", cim=True),
            _x("cim_mvm", t + 40.0, 10.0, dispatch=d, t=1, m=2, r=3, c=4,
               route="compiled"),
            _x("executor.outputs", t + 90.0, 50.0, dispatch=d, bytes=32),
            _x("service.answers", t + 140.0, 10.0, dispatch=d)]
    events = [{"cat": "kernel", "name": "k", "ph": "X", "ts": t + 60.0,
               "dur": 70.0} for t in (0.0, 200.0)]
    events += [{"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ph": "X", "ts": t + 45.0, "dur": 1.0} for t in (0.0, 200.0)]
    got = spans.readings(spans.SpanPhase(progs, events, []))
    # window [0, 350], busy 140: idle 210 = forward 2 x 30 (issuing),
    # inputs 2 x 10 + outputs 2 x 10 (copying), stack and answers
    # 2 x 30, the executor pass's own time 0, and 50 between dispatches
    assert got["idle_pct"] == pytest.approx(100 * 210 / 350)
    assert got["idle_issuing_pct"] == pytest.approx(100 * 60 / 350)
    assert got["idle_copying_pct"] == pytest.approx(100 * 40 / 350)
    assert got["idle_service_pct"] == pytest.approx(100 * 110 / 350)
    assert got["idle_issuing_pct"] + got["idle_copying_pct"] + \
        got["idle_service_pct"] == pytest.approx(got["idle_pct"])
    assert got["service_self_ms"] == pytest.approx(30e-3)
    assert got["executor_input_ms"] == pytest.approx(10e-3)
    assert got["executor_issue_ms"] == pytest.approx(60e-3)
    assert got["executor_output_wait_ms"] == pytest.approx(50e-3)
    assert got["runtime_in_dispatch_pct"] == 100.0
    assert (got["launches"], got["input_bytes"], got["output_bytes"]) == \
        (1.0, 64.0, 32.0)
    # spans of a program that emits none of these: nothing to read
    assert set(spans.readings(spans.SpanPhase(
        [_x("dispatch:g", 0.0, 5.0)], events, [])).values()) == {None}


def test_span_phase_on_the_cpu(served):
    """The phase runs without a card: the span readings come from the
    recorder, the device's idle shares read nothing."""
    svc, reqs, n = served
    draw = iter([[0, 1], [2, 3], [4, 5]])
    phase = spans.span_trace(svc, reqs, draw, 3, cuda=False)
    assert obs_trace.get_trace() is None
    assert len(phase.done) == 3 and phase.events == []
    got = spans.readings(phase)
    for key in ("service_self_ms", "executor_input_ms", "executor_issue_ms",
                "executor_output_wait_ms"):
        assert got[key] is not None and got[key] >= 0.0, key
    assert got["launches"] == len(svc._exe.dispatch_shapes(BATCH))
    for key in ("idle_issuing_pct", "idle_copying_pct", "idle_service_pct",
                "idle_pct", "runtime_in_dispatch_pct"):
        assert got[key] is None, key
