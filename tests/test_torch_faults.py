"""The port's fault tier against the JAX package's, on the CPU.

Every case builds the same seeded fault model in both packages and
requires equal results, tolerance 0 (the CIM path is integer): fault
materialisation per tile span, the interpreter and the executor under
every fault class on the bucket, streamed and exact paths,
``fault_aware_compile`` and ``accuracy_under_faults``.  The port runs
with ``device="cpu"`` (the plain-version route); ``repro`` runs on the
CPU route its own tests use.
"""
import numpy as np
import pytest

from repro.cimsim import executor as jex
from repro.cimsim import faults as jfaults
from repro.cimsim import functional as jfn
from repro.core import abstraction as ja
from repro.core import compiler as jcompiler
from repro.core import graph as jgraph
from repro.core.mapping import FaultBudgetError as JaxBudgetError
from repro.kernels.cim_mvm import cim_mvm_params as jparams
from repro.workloads import get_workload as jwl
from repro_torch.cimsim import executor as tex
from repro_torch.cimsim import faults as tfaults
from repro_torch.cimsim import functional as tfn
from repro_torch.core import abstraction as ta
from repro_torch.core import compiler as tcompiler
from repro_torch.core import graph as tgraph
from repro_torch.core.mapping import FaultBudgetError
from repro_torch.kernels.cim_mvm import cim_mvm_params as tparams
from repro_torch.workloads import get_workload as twl

#: every fault class at once (stuck cells and columns, dead word and bit
#: lines, drift, ADC offsets), as tests/test_kernel_conformance.py uses
EVERY = dict(stuck_cell_rate=0.01, stuck_col_rate=0.01, dead_row_rate=0.01,
             dead_col_rate=0.01, drift_sigma=0.3, adc_offset_sigma=0.5)
#: the line-clustered map that retirement can clear (tests/test_faults.py)
LINES = dict(seed=7, stuck_col_rate=0.01, dead_row_rate=0.005)


def _arch(mod, kind: str):
    """The small test chip in package ``mod``: ``saturating`` (4-bit ADC,
    the bucket path) or ``streamed`` (8-bit ADC and one crossbar per
    core, so the model needs segments and streams its weights)."""
    n_xbs = 1 if kind == "streamed" else 2
    return mod.CIMArch(
        name=f"faults-{kind}", mode=mod.ComputingMode.WLM,
        chip=mod.ChipTier(core_number=(4, 1), alu_ops_per_cycle=64,
                          l0_bw_bits=1024),
        core=mod.CoreTier(xb_number=(n_xbs, 1), l1_bw_bits=1024),
        xb=mod.CrossbarTier(xb_size=(32, 32), dac_bits=1,
                            adc_bits=4 if kind == "saturating" else 8,
                            cell_type=mod.CellType.SRAM, cell_precision=2,
                            parallel_row=8))


def _resnet18_prefix(gmod, wl, in_hw=8, n_classes=16):
    """resnet18 cut after its first residual add (tests/test_faults.py)."""
    full = wl("resnet18", in_hw=in_hw, n_classes=n_classes)
    cut = next(i for i, n in enumerate(full.nodes)
               if n.op_type == "Add") + 1
    nodes = full.nodes[:cut]
    return gmod.Graph("resnet18-prefix", nodes, full.inputs,
                      [nodes[-1].outputs[0]])


CASES = {
    "tiny_mlp": (lambda: jwl("tiny_mlp"), lambda: twl("tiny_mlp"),
                 "saturating"),
    "tiny_cnn": (lambda: jwl("tiny_cnn"), lambda: twl("tiny_cnn"),
                 "streamed"),
    "resnet18_prefix": (lambda: _resnet18_prefix(jgraph, jwl),
                        lambda: _resnet18_prefix(tgraph, twl), "isaac"),
}


def _archs(kind: str):
    if kind == "isaac":
        return ja.get_arch("isaac-baseline"), ta.get_arch("isaac-baseline")
    return _arch(ja, kind), _arch(ta, kind)


def _both(case: str):
    """(reference graph, port graph, reference arch, port arch)."""
    jg_fn, tg_fn, kind = CASES[case]
    return (jg_fn(), tg_fn()) + _archs(kind)


# ------------------------------------------------------ materialisation

@pytest.mark.parametrize("remap", [False, True], ids=["direct", "remap"])
@pytest.mark.parametrize("case", ["tiny_mlp", "resnet18_prefix"])
def test_fault_map_matches_reference(case, remap):
    """``apply_tile``, ``tile_offset`` and ``span_deficit`` equal the
    reference's on every span of the compiled plan; the spans are the
    reference's too."""
    jg, tg, jarch, tarch = _both(case)
    jres = jcompiler.compile_graph(jg, jarch)
    tres = tcompiler.compile_graph(tg, tarch)
    spans = tfaults.plan_spans(tres.plan, tres.program)
    assert spans == jfaults.plan_spans(jres.plan, jres.program)
    jmap = jfaults.FaultMap(jfaults.FaultModel(seed=5, **EVERY), jarch,
                            remap=remap)
    tmap = tfaults.FaultMap(tfaults.FaultModel(seed=5, **EVERY), tarch,
                            remap=remap)
    assert tmap.token == jmap.token
    rng = np.random.default_rng(1)
    changed = 0
    for name, node_spans in spans.items():
        for span in node_spans:
            w = rng.integers(-128, 128, (span[1] - span[0],
                                         span[3] - span[2])).astype(np.int32)
            got = tmap.apply_tile(name, span, w)
            np.testing.assert_array_equal(got, jmap.apply_tile(name, span, w))
            changed += int(not np.array_equal(got, w))
            want = jmap.tile_offset(name, span)
            off = tmap.tile_offset(name, span)
            assert (off is None) == (want is None)
            if off is not None:
                np.testing.assert_array_equal(off, want)
            assert tmap.span_deficit(name, span) == \
                jmap.span_deficit(name, span)
    assert changed, "the map left every tile untouched"


def test_fault_map_rejects_spans_wider_than_a_crossbar():
    """A core-mode chip reads whole chunks that cover several crossbars
    (jia-issc21: 576 x 64 logical cells at 8 one-bit slices need 512
    bitlines of a 256-bitline crossbar); both packages refuse to fold a
    per-crossbar fault map into such a span."""
    jg = jwl("resnet18", in_hw=32, n_classes=16)
    tg = twl("resnet18", in_hw=32, n_classes=16)
    jarch, tarch = ja.get_arch("jia-issc21"), ta.get_arch("jia-issc21")
    jres = jcompiler.compile_graph(jg, jarch)
    tres = tcompiler.compile_graph(tg, tarch)
    model = dict(seed=0, stuck_col_rate=0.01)
    with pytest.raises(ValueError, match="exceeds the physical"):
        jex.lower(jres.plan, jres.program, cache=False,
                  faults=jfaults.FaultMap(jfaults.FaultModel(**model), jarch))
    with pytest.raises(ValueError, match="exceeds the physical"):
        tex.lower(tres.plan, tres.program, device="cpu", cache=False,
                  faults=tfaults.FaultMap(tfaults.FaultModel(**model), tarch))


# ------------------------------------------- interpreter and executor

def _reference_run(case: str, model: dict):
    """(weights, shifts, input, reference executor outputs under the map,
    reference clean executor outputs)."""
    jg, _, jarch, _ = _both(case)
    params = jparams(jarch)
    weights, inputs = jfn.make_weights(jg, 0), jfn.make_input(jg, 0)
    shifts = jfn.calibrate_shifts(jg, weights, inputs, params)
    res = jcompiler.compile_graph(jg, jarch)
    fm = jfaults.FaultMap(jfaults.FaultModel(**model), jarch)
    faulted = jex.lower(res.plan, res.program, params=params, faults=fm,
                        cache=False).run(inputs, weights, shifts)
    clean = jex.lower(res.plan, res.program, params=params,
                      cache=False).run(inputs, weights, shifts)
    return weights, shifts, inputs, faulted, clean


def _port_run(case: str, model: dict, weights, shifts, inputs, *,
              interpreter: bool):
    """(port executor outputs under the map, its ExecutorStats, port
    interpreter outputs under the map or None)."""
    _, tg, _, tarch = _both(case)
    params = tparams(tarch)
    res = tcompiler.compile_graph(tg, tarch)
    exe = tex.lower(res.plan, res.program, params=params, device="cpu",
                    faults=tfaults.FaultMap(tfaults.FaultModel(**model),
                                            tarch), cache=False)
    out = exe.run(inputs, weights, shifts)
    interp = None
    if interpreter:
        res = tcompiler.compile_graph(tg, tarch, expand=True)
        interp = tfn.FunctionalSimulator(
            res.plan, res.program, weights, shifts, params=params,
            device="cpu",
            faults=tfaults.FaultMap(tfaults.FaultModel(**model), tarch)
        ).run(inputs)
    return out, exe.stats, interp


@pytest.mark.parametrize("seed", [0, 17, 40])
def test_interpreter_equals_executor_every_fault_class(seed):
    """tiny_mlp on the saturating chip with every fault class on: the
    port's interpreter, the port's executor and the reference's executor
    agree bit for bit, and the map changes the output."""
    model = dict(seed=seed, **EVERY)
    weights, shifts, inputs, jout, jclean = _reference_run("tiny_mlp", model)
    out, stats, interp = _port_run("tiny_mlp", model, weights, shifts,
                                   inputs, interpreter=True)
    assert stats.matmul_nodes == 0 and not stats.streamed   # bucket path
    for t in jout:
        np.testing.assert_array_equal(interp[t], out[t])
        np.testing.assert_array_equal(out[t], jout[t])
        assert not np.array_equal(out[t], jclean[t])


@pytest.mark.parametrize("case", ["resnet18_prefix", "tiny_cnn"],
                         ids=["exact", "streamed"])
def test_exact_and_streamed_paths_match_reference(case):
    """The exact-ADC matmul path (resnet18 prefix on isaac-baseline) and
    the streamed multi-segment path (tiny_cnn on one-crossbar cores)
    fold the map as the reference does; on the streamed path the
    interpreter agrees too."""
    model = dict(seed=11, **EVERY)
    weights, shifts, inputs, jout, jclean = _reference_run(case, model)
    out, stats, interp = _port_run(case, model, weights, shifts, inputs,
                                   interpreter=case == "tiny_cnn")
    if case == "tiny_cnn":
        assert stats.streamed and stats.swaps > 0
    else:
        assert stats.matmul_nodes == stats.cim_nodes
    changed = False
    for t in jout:
        np.testing.assert_array_equal(out[t], jout[t])
        if interp is not None:
            np.testing.assert_array_equal(interp[t], out[t])
        changed = changed or not np.array_equal(out[t], jclean[t])
    assert changed, "the map left every output untouched"


def test_verify_and_simulate_with_faults_match_reference():
    """``compile_and_verify(faults=)`` and ``simulate(faults=)`` measure
    the same fault-induced deviation from the clean reference as the
    JAX package's, through the executor and through the interpreter."""
    jarch, tarch = _arch(ja, "saturating"), _arch(ta, "saturating")
    jg, tg = jwl("tiny_mlp"), twl("tiny_mlp")
    model = dict(seed=3, **EVERY)
    jfm = jfaults.FaultMap(jfaults.FaultModel(**model), jarch)
    tfm = tfaults.FaultMap(tfaults.FaultModel(**model), tarch)
    want = jfn.compile_and_verify(jg, jarch, batch=2, faults=jfm)
    assert not want.ok
    for use_executor in (True, False):
        got = tfn.compile_and_verify(tg, tarch, batch=2, faults=tfm,
                                     use_executor=use_executor,
                                     device="cpu")
        assert got.max_abs_err == want.max_abs_err
    jsim, jref, _ = jfn.simulate(jg, jarch, faults=jfm, use_executor=True)
    for use_executor in (True, False):
        sim, ref, _ = tfn.simulate(tg, tarch, faults=tfm, device="cpu",
                                   use_executor=use_executor)
        for t in jsim:
            np.testing.assert_array_equal(sim[t], jsim[t])
            np.testing.assert_array_equal(ref[t], jref[t])


def test_lower_cache_keys_on_the_fault_map():
    """A clean caller never gets a faulted executable, nor the reverse;
    equal maps share one."""
    tg, tarch = twl("tiny_mlp"), _arch(ta, "saturating")
    res = tcompiler.compile_graph(tg, tarch)
    tex.clear_lower_cache()
    model = tfaults.FaultModel(**LINES)
    clean = tex.lower(res.plan, res.program, device="cpu")
    a = tex.lower(res.plan, res.program, device="cpu",
                  faults=tfaults.FaultMap(model, tarch))
    a2 = tex.lower(res.plan, res.program, device="cpu",
                   faults=tfaults.FaultMap(model, tarch))
    b = tex.lower(res.plan, res.program, device="cpu",
                  faults=tfaults.FaultMap(model, tarch, remap=True))
    assert clean.faults is None and a.faults is not None
    assert len({id(clean), id(a), id(b)}) == 3
    assert a2 is a
    assert tex.lower(res.plan, res.program, device="cpu") is clean
    weights, inputs = tfn.make_weights(tg, 0), tfn.make_input(tg, 0)
    shifts = tfn.calibrate_shifts(tg, weights, inputs, tparams(tarch),
                                  device="cpu")
    out = tg.outputs[0]
    assert not np.array_equal(a.run(inputs, weights, shifts)[out],
                              clean.run(inputs, weights, shifts)[out])


# ------------------------------------------------------- compiler tier

def test_fault_aware_compile_matches_reference():
    """Same retired rows, columns, attempts and compile key as the
    reference, on a map that needs retirement; an exhausted budget
    raises the port's typed error where the reference raises its own."""
    jg, tg = jwl("tiny_mlp"), twl("tiny_mlp")
    jarch, tarch = ja.get_arch("isaac-baseline"), ta.get_arch("isaac-baseline")
    model = dict(seed=3, stuck_col_rate=0.02, dead_row_rate=0.2)
    want = jfaults.fault_aware_compile(jg, jarch,
                                       jfaults.FaultModel(**model))
    got = tfaults.fault_aware_compile(tg, tarch, tfaults.FaultModel(**model))
    assert got.retired_cols > 0 and got.attempts > 2
    assert (got.retired_rows, got.retired_cols, got.attempts) == \
        (want.retired_rows, want.retired_cols, want.attempts)
    assert got.result.key == want.result.key
    assert got.result.plan.notes["fault_retired"] == \
        want.result.plan.notes["fault_retired"]
    assert got.faults.token == want.faults.token
    hopeless = dict(seed=2, stuck_col_rate=0.5)
    with pytest.raises(JaxBudgetError):
        jfaults.fault_aware_compile(jwl("tiny_mlp"), jarch,
                                    jfaults.FaultModel(**hopeless),
                                    max_rounds=3)
    with pytest.raises(FaultBudgetError):
        tfaults.fault_aware_compile(twl("tiny_mlp"), tarch,
                                    tfaults.FaultModel(**hopeless),
                                    max_rounds=3)


ACCURACY = dict(seed=7, stuck_col_rate=0.01)


def test_accuracy_under_faults_matches_reference():
    """resnet18@32 (16 classes) on exact-ADC isaac-baseline with 1 %
    stuck bitlines: the unmitigated top-1 agreement equals the
    reference's and the map costs accuracy."""
    jg = jwl("resnet18", in_hw=32, n_classes=16)
    tg = twl("resnet18", in_hw=32, n_classes=16)
    want = jfaults.accuracy_under_faults(
        jg, ja.get_arch("isaac-baseline"), jfaults.FaultModel(**ACCURACY),
        n_inputs=4)
    got = tfaults.accuracy_under_faults(
        tg, ta.get_arch("isaac-baseline"), tfaults.FaultModel(**ACCURACY),
        n_inputs=4, device="cpu")
    assert got == want and got < 1.0


def test_accuracy_under_faults_remapped_is_exact():
    """With fault-aware remapping the same map leaves top-1 untouched
    (the reference's own test holds it to 1.0 as well)."""
    tg = twl("resnet18", in_hw=32, n_classes=16)
    assert tfaults.accuracy_under_faults(
        tg, ta.get_arch("isaac-baseline"), tfaults.FaultModel(**ACCURACY),
        n_inputs=4, remap=True, device="cpu") == 1.0
