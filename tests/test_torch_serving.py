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
