"""The port's CimBatchService against the JAX package's, on the CPU.

Both services get the same weights and calibrated shifts (the port's
through ``weights_from_reference``) and serve the same seeded requests;
outputs must be equal (tolerance 0, the CIM path is integer).  A route
the registry cannot satisfy must raise, not fall back.
"""
import numpy as np
import pytest

from repro.cimsim import functional as jfn
from repro.core import abstraction as ja
from repro.serving.cim_service import CimBatchService as JaxService
from repro.serving.common import CimRequest as JaxRequest
from repro.workloads import get_workload as jwl
from repro_torch.cimsim import executor as tex
from repro_torch.cimsim import functional as tfn
from repro_torch.core import abstraction as ta
from repro_torch.kernels import backend
from repro_torch.kernels.cim_mvm import cim_mvm_params
from repro_torch.serving import CimBatchService, CimRequest
from repro_torch.workloads import get_workload as twl


def _arch(mod, kind: str):
    """``saturating``: 4-bit ADC on the 4-core test chip; ``streamed``:
    the 2-core, 1-crossbar chip the model does not fit (segments)."""
    n_cores, n_xbs = (2, 1) if kind == "streamed" else (4, 2)
    return mod.CIMArch(
        name=f"serve-{kind}", mode=mod.ComputingMode.WLM,
        chip=mod.ChipTier(core_number=(n_cores, 1), alu_ops_per_cycle=64,
                          l0_bw_bits=1024),
        core=mod.CoreTier(xb_number=(n_xbs, 1), l1_bw_bits=1024),
        xb=mod.CrossbarTier(xb_size=(32, 32), dac_bits=1,
                            adc_bits=4 if kind == "saturating" else 8,
                            cell_type=mod.CellType.SRAM, cell_precision=2,
                            parallel_row=8))


@pytest.mark.parametrize("kind", ["saturating", "streamed"])
def test_service_matches_reference(kind):
    jg, tg = jwl("tiny_cnn"), twl("tiny_cnn")
    jsvc = JaxService(jg, _arch(ja, kind), max_batch=4)
    weights, shifts = tfn.weights_from_reference(
        jsvc.weights, jsvc.shifts, cim_mvm_params(_arch(ta, kind)), "cpu")
    svc = CimBatchService(tg, _arch(ta, kind), max_batch=4, weights=weights,
                          shifts=shifts, device="cpu")
    assert svc.use_executor and svc.executor_stats.kernel_mode == "torch"
    if kind == "streamed":
        assert svc.executor_stats.streamed and svc.executor_stats.swaps > 0
    jreqs = [JaxRequest(rid=i, inputs=jfn.make_input(jg, i))
             for i in range(6)]
    treqs = [CimRequest(rid=i, inputs=tfn.make_input(tg, i))
             for i in range(6)]
    jsvc.serve(jreqs)
    svc.serve(treqs)
    for a, b in zip(jreqs, treqs):
        np.testing.assert_array_equal(b.outputs["fc.out"], a.outputs["fc.out"])
    assert svc.stats.requests == 6 and svc.stats.batches == 2


def test_service_calibrates_like_reference():
    """Without weights/shifts the port calibrates itself; the shifts and
    outputs still equal the reference's."""
    jg, tg = jwl("tiny_mlp"), twl("tiny_mlp")
    jsvc = JaxService(jg, _arch(ja, "saturating"), max_batch=4)
    svc = CimBatchService(tg, _arch(ta, "saturating"), max_batch=4,
                          device="cpu")
    assert svc.shifts == jsvc.shifts
    reqs = [CimRequest(rid=i, inputs=tfn.make_input(tg, i)) for i in range(3)]
    jreqs = [JaxRequest(rid=i, inputs=jfn.make_input(jg, i))
             for i in range(3)]
    svc.serve(reqs)
    jsvc.serve(jreqs)
    for a, b in zip(jreqs, reqs):
        np.testing.assert_array_equal(b.outputs["fc2.out"],
                                      a.outputs["fc2.out"])


def test_forced_route_error_raises_not_falls_back(monkeypatch):
    g = twl("tiny_mlp")
    with pytest.raises(backend.KernelUnsupportedError):
        CimBatchService(g, _arch(ta, "saturating"), device="cpu",
                        mode="compiled")
    monkeypatch.setenv("REPRO_TORCH_KERNEL_MODE", "compiled")
    with pytest.raises(backend.KernelUnsupportedError):
        CimBatchService(g, _arch(ta, "saturating"), device="cpu")


def test_lowering_error_falls_back_to_interpreter(monkeypatch):
    def refuse(*args, **kwargs):
        raise tex.LoweringError("forced for test")

    g = twl("tiny_mlp")
    ref = CimBatchService(g, _arch(ta, "saturating"), max_batch=4,
                          device="cpu")
    assert ref.use_executor
    monkeypatch.setattr(tex, "lower", refuse)
    svc = CimBatchService(g, _arch(ta, "saturating"), max_batch=4,
                          device="cpu")
    assert not svc.use_executor and svc.executor_stats is None
    reqs = [CimRequest(rid=i, inputs=tfn.make_input(g, i)) for i in range(2)]
    reqs2 = [CimRequest(rid=i, inputs=tfn.make_input(g, i)) for i in range(2)]
    svc.serve(reqs)
    ref.serve(reqs2)
    for a, b in zip(reqs, reqs2):
        np.testing.assert_array_equal(a.outputs["fc2.out"],
                                      b.outputs["fc2.out"])


# -- input staging ------------------------------------------------------------

def _staged_service():
    """tiny_cnn on the saturating chip, the port alone: staged dispatches
    are held against the executor fed a fresh ``np.stack``, the path the
    service took before it staged its inputs."""
    g = twl("tiny_cnn")
    return g, CimBatchService(g, _arch(ta, "saturating"), max_batch=4,
                              device="cpu")


def _fresh_stack(svc, batch, pad_to=None):
    """The batch's outputs through ``run_batch`` on a fresh ``np.stack``
    of its rows (padded by repeating the last), as numpy inputs."""
    n = max(pad_to or 0, len(batch))
    stacked = {}
    for name in svc.graph.inputs:
        rows = [np.asarray(r.inputs[name]) for r in batch]
        stacked[name] = np.stack(rows + [rows[-1]] * (n - len(rows)))
    out = svc._exe.run_batch(stacked, packed=svc._packed, shifts=svc.shifts)
    return [{t: out[t][i] for t in svc.graph.outputs}
            for i in range(len(batch))]


def test_staged_dispatches_match_fresh_stacking():
    """Five dispatches in a row with different images, padded and not,
    one of a new shape: each answer equals the fresh-stack path's, and
    no earlier answer changes when later batches overwrite the buffers."""
    g, svc = _staged_service()
    plan = [(range(0, 4), None), (range(4, 7), 4), (range(7, 9), 4),
            (range(9, 11), None), (range(11, 14), 4)]
    kept = []
    for rids, pad_to in plan:
        batch = [CimRequest(rid=i, inputs=tfn.make_input(g, 100 + i))
                 for i in rids]
        want = _fresh_stack(svc, batch, pad_to)
        svc.dispatch(batch, pad_to=pad_to)
        for r, w in zip(batch, want):
            assert r.outputs.keys() == w.keys()
            for t in w:
                assert r.outputs[t].dtype == w[t].dtype
                np.testing.assert_array_equal(r.outputs[t], w[t])
        kept.append((batch, [{t: v.copy() for t, v in r.outputs.items()}
                             for r in batch]))
    assert sorted(svc._staging) == [2, 4]
    for batch, snap in kept:
        for r, s in zip(batch, snap):
            for t in s:
                np.testing.assert_array_equal(r.outputs[t], s[t])


def _alias_graph():
    """A graph serving a view of its input beside a crossbar layer: on
    the CPU ``id.out`` is the staged input's memory unless copied."""
    from repro_torch.core.graph import Graph, Node
    return Graph("alias_toy", [
        Node("fc", "Gemm", ["input"], ["fc.out"], {"weight_shape": (16, 5)}),
        Node("id", "Flatten", ["input"], ["id.out"]),
    ], {"input": (16,)}, ["fc.out", "id.out"])


def test_answers_never_alias_the_staging_buffer():
    g = _alias_graph()
    svc = CimBatchService(g, _arch(ta, "saturating"), max_batch=2,
                          device="cpu")
    first = [CimRequest(rid=i, inputs=tfn.make_input(g, i)) for i in range(2)]
    svc.dispatch(first)
    snap = [r.outputs["id.out"].copy() for r in first]
    for r, s in zip(first, snap):
        np.testing.assert_array_equal(s, r.inputs["input"])
    svc.dispatch([CimRequest(rid=i, inputs=tfn.make_input(g, 10 + i))
                  for i in range(2)])
    for r, s in zip(first, snap):
        np.testing.assert_array_equal(r.outputs["id.out"], s)
        assert not np.shares_memory(r.outputs["id.out"],
                                    svc._staging[2].tensors["input"].numpy())


@pytest.mark.parametrize("kind", ["float64", "float32", "int8", "mixed",
                                  "read_only", "reversed"])
def test_staging_casts_rows_like_numpy(kind):
    """A float or int8 request becomes the operand that
    ``np.asarray(v, np.int32)`` makes of it (floats truncate); a
    read-only or negatively strided int32 row is taken as it is."""
    g, svc = _staged_service()
    rng = np.random.default_rng(7)

    def row(i):
        x = tfn.make_input(g, 200 + i)["input"]
        k = kind if kind != "mixed" else ("float64", "int8", "float32")[i % 3]
        if k == "int8":
            return x.astype(np.int8)
        if k == "read_only":
            x.setflags(write=False)
            return x
        if k == "reversed":
            return np.ascontiguousarray(x[..., ::-1])[..., ::-1]
        return (x + rng.uniform(-0.99, 0.99, x.shape)).astype(k)

    batch = [CimRequest(rid=i, inputs={"input": row(i)}) for i in range(3)]
    ints = [CimRequest(rid=r.rid,
                       inputs={"input": np.asarray(r.inputs["input"],
                                                   np.int32)})
            for r in batch]
    want = _fresh_stack(svc, ints, 4)
    svc.dispatch(batch, pad_to=4)
    staged = svc._staging[4].tensors["input"].numpy()
    np.testing.assert_array_equal(staged[:3],
                                  np.stack([r.inputs["input"] for r in ints]))
    for r, w in zip(batch, want):
        for t in w:
            np.testing.assert_array_equal(r.outputs[t], w[t])


def test_staging_counter_allocates_once_per_shape():
    from repro_torch.obs import metrics as obs_metrics
    g, svc = _staged_service()
    reqs = [CimRequest(rid=i, inputs=tfn.make_input(g, i)) for i in range(4)]
    reg = obs_metrics.enable(obs_metrics.MetricsRegistry())
    try:
        svc.dispatch(reqs)                 # warm (allocated), timed
        svc.dispatch(reqs[::-1])           # timed
        svc.dispatch(reqs[:2])             # a new shape: warm, timed
        svc.dispatch(reqs[:3], pad_to=4)   # the first shape again
    finally:
        obs_metrics.disable()
    counts = {k: v for k, v in reg.flat().items()
              if k.startswith("cim_service_staging_total")}
    assert counts == {'cim_service_staging_total{outcome="allocated"}': 2,
                      'cim_service_staging_total{outcome="reused"}': 4}
    assert set(svc._staging) == svc._warmed == {2, 4}
