"""The port's design-space exploration tier against the JAX package's, on
the CPU.

Every case runs the same graphs, archs, design spaces and seeds through
``repro.dse`` and ``repro_torch.dse`` in one process and requires equal
results, tolerance 0: the workload graphs (the LM decoder blocks too,
with the reduced qwen1.5-4b block verified bit for bit), the §4.2
baseline plans, the
design points, the Pareto frontier, the batched proxy, the sweep, the
successive-halving and adaptive searches, campaigns with the winning
point verified, the fault metric and the scorecards.  The port runs
everything that executes with ``device="cpu"`` (the plain-version
route).  The last cases hold the port's narrowed fail-soft catches: a
``RuntimeError`` of the kernel path propagates, an infeasible point is
still reported with the reference's own error string.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro import dse as jdse
from repro.cimsim import faults as jfaults
from repro.cimsim import perf as jperf
from repro.core import abstraction as ja
from repro.core import baselines as jbase
from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import compiler as jcompiler
from repro.workloads import get_workload as jwl
from repro.workloads import lm_blocks as jlm_blocks
from repro_torch import dse as tdse
from repro_torch.cimsim import executor as tex
from repro_torch.cimsim import faults as tfaults
from repro_torch.cimsim import perf as tperf
from repro_torch.core import abstraction as ta
from repro_torch.core import baselines as tbase
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.core import compiler as tcompiler
from repro_torch.workloads import get_workload as twl
from repro_torch.workloads import lm_blocks as tlm_blocks


def _arch(mod, kind: str):
    """The small test chip of tests/test_torch_executor.py in package
    ``mod``: ``saturating`` (4-bit ADC, so every crossbar MVM takes the
    kernel's route) or ``exact`` (8-bit ADC)."""
    return mod.CIMArch(
        name=f"test-{kind}", mode=mod.ComputingMode.WLM,
        chip=mod.ChipTier(core_number=(4, 1), alu_ops_per_cycle=64,
                          l0_bw_bits=1024),
        core=mod.CoreTier(xb_number=(2, 1), l1_bw_bits=1024),
        xb=mod.CrossbarTier(xb_size=(32, 32), dac_bits=1,
                            adc_bits=4 if kind == "saturating" else 8,
                            cell_type=mod.CellType.SRAM, cell_precision=2,
                            parallel_row=8))


def _toy_space(pkg_dse, pkg_arch):
    """tests/test_search.py's space: toy with two crossbar widths."""
    return pkg_dse.DesignSpace(pkg_arch.get_arch("toy"), arch_axes={
        "xb.xb_size": [(32, 128), (64, 128)]})


def _flat_results(results):
    """SweepResults as plain tuples, comparable across the packages."""
    return [(r.index, dataclasses.astuple(r.point), r.metrics, r.cached,
             r.error, r.tag) for r in results]


def _flat_search(sr):
    return {
        "results": _flat_results(sr.results),
        "rungs": [dataclasses.astuple(r) for r in sr.rungs],
        "full_evals": sr.full_evals,
        "best": None if sr.best is None else
        (dataclasses.astuple(sr.best.point), sr.best.metrics),
    }


def _flat_campaign(camp):
    return {
        name: (_flat_results(w.results), _flat_results(w.frontier),
               w.full_evals, [dataclasses.astuple(r) for r in w.rungs],
               dataclasses.astuple(w.best.point) if w.best else None)
        for name, w in camp.workloads.items()
    } | {"robust": [(dataclasses.astuple(rp.point), rp.max_regret,
                     rp.regret) for rp in camp.robust],
         "full_evals": camp.full_evals}


# ------------------------------------------------------------ workloads

@pytest.mark.parametrize("name", ["vgg7", "vgg16", "vit"])
def test_workload_graphs_match_reference(name):
    want, got = jwl(name), twl(name)
    assert got.to_dict() == want.to_dict()
    assert got.shapes == want.shapes


@pytest.mark.parametrize("name", sorted(JARCHS) + ["nope"])
def test_lm_block_graphs_match_reference(name):
    """Each architecture's decoder block is the reference's graph; an
    unknown workload or architecture raises ``KeyError`` in both."""
    if name == "nope":
        for bad in ("nope", "lmblock:nope"):
            with pytest.raises(KeyError):
                jwl(bad)
            with pytest.raises(KeyError):
                twl(bad)
        return
    want, got = jwl(f"lmblock:{name}"), twl(f"lmblock:{name}")
    assert got.to_dict() == want.to_dict()
    assert got.shapes == want.shapes


def test_lm_block_compile_key_matches_reference():
    name = "lmblock:qwen1.5-4b"
    assert tcompiler.compile_key(twl(name), ta.get_arch("jia-issc21")) == \
        jcompiler.compile_key(jwl(name), ja.get_arch("jia-issc21"))


def _patch_lm_blocks(monkeypatch, jcut, tcut):
    """Build the LM blocks from ``jcut(config)`` in the reference and
    ``tcut(config)`` in the port."""
    monkeypatch.setattr(jlm_blocks, "get_config",
                        lambda n: jcut(jget_config(n)))
    monkeypatch.setattr(tlm_blocks, "get_config",
                        lambda n: tcut(tget_config(n)))


@pytest.fixture
def reduced_lm_blocks(monkeypatch):
    """Both packages' LM blocks built from ``reduced()`` configs."""
    _patch_lm_blocks(monkeypatch, jreduced, treduced)


def _verify_lm_block_both(name: str, **kw):
    """``compile_and_verify`` of one LM block on jia-issc21 at batch 2 in
    both packages, and both executors' outputs on the same weights,
    shifts and inputs: (reference report, port report, reference
    outputs, port outputs)."""
    from repro.cimsim import executor as jex
    from repro.cimsim import functional as jfn
    from repro.kernels.cim_mvm import cim_mvm_params as jparams
    from repro_torch.cimsim import functional as tfn
    from repro_torch.kernels.cim_mvm import cim_mvm_params as tparams
    jg, tg = jwl(name, **kw), twl(name, **kw)
    jarch, tarch = ja.get_arch("jia-issc21"), ta.get_arch("jia-issc21")
    jrep = jfn.compile_and_verify(jg, jarch, batch=2)
    trep = tfn.compile_and_verify(tg, tarch, batch=2, device="cpu")

    weights = jfn.make_weights(jg, 0)
    inputs = [jfn.make_input(jg, i) for i in range(2)]
    batched = {k: np.stack([x[k] for x in inputs]) for k in jg.inputs}
    shifts = jfn.calibrate_shifts(jg, weights, inputs[0], jparams(jarch))
    assert tfn.calibrate_shifts(tg, weights, inputs[0], tparams(tarch),
                                device="cpu") == shifts
    jres = jcompiler.compile_graph(jg, jarch)
    tres = tcompiler.compile_graph(tg, tarch)
    want = jex.lower(jres.plan, jres.program, params=jparams(jarch)) \
        .run_batch(batched, weights, shifts)
    exe = tex.lower(tres.plan, tres.program, params=tparams(tarch),
                    device="cpu")
    assert exe.stats.matmul_nodes == 0         # saturating: the MVM route
    return jrep, trep, want, exe.run_batch(batched, weights, shifts)


def test_reduced_lm_block_verifies_bit_equal_to_reference(reduced_lm_blocks):
    """The reduced qwen1.5-4b block on jia-issc21 verifies with
    ``max_abs_err`` 0 in both packages, and the two executors' outputs
    are bit-equal."""
    jrep, trep, want, got = _verify_lm_block_both("lmblock:qwen1.5-4b")
    assert jrep.max_abs_err == trep.max_abs_err == {"res2.out": 0}
    np.testing.assert_array_equal(got["res2.out"], want["res2.out"])


def test_wide_lm_block_verify_error_matches_reference(monkeypatch):
    """A reference property, not a port fault: at qwen1.5-4b's d = 2560
    the reference forward groups each weight matrix's rows by
    ``parallel_row`` (1152) over the whole matrix while the compiled
    flow reads 852-854-row chunks, and jia's 8-bit ADC saturates
    differently on the two, so the reference's own ``compile_and_verify``
    reports a nonzero error.  The port reports the same error and its
    executor's outputs are the reference's, bit for bit (the block is
    cut to 2 heads of 64 and d_ff 256 at seq 16; d stays 2560)."""
    def cut(cfg):
        return dataclasses.replace(cfg, n_heads=2, n_kv_heads=2,
                                   head_dim=64, d_ff=256)
    _patch_lm_blocks(monkeypatch, cut, cut)
    jrep, trep, want, got = _verify_lm_block_both("lmblock:qwen1.5-4b",
                                                  seq=16)
    assert trep.max_abs_err == jrep.max_abs_err == {"res2.out": 131}
    np.testing.assert_array_equal(got["res2.out"], want["res2.out"])
    # the cause: with an ADC that never saturates (11 bits over 1152
    # rows), or at d = 2304 (two whole 1152-row chunks), the error is 0
    from repro_torch.cimsim import functional as tfn
    jia = ta.get_arch("jia-issc21")
    exact = dataclasses.replace(jia, xb=dataclasses.replace(jia.xb,
                                                            adc_bits=11))
    for arch, d in ((exact, 2560), (jia, 2304)):
        monkeypatch.setattr(tlm_blocks, "get_config", lambda n, d=d: cut(
            dataclasses.replace(tget_config(n), d_model=d)))
        rep = tfn.compile_and_verify(twl("lmblock:qwen1.5-4b", seq=16),
                                     arch, batch=2, device="cpu")
        assert rep.max_abs_err == {"res2.out": 0}, (arch.xb, d)


@pytest.mark.parametrize("name,match", [
    ("gemma2-2b", "mismatch in its core dimension"),
    ("mamba2-780m", "no float DCOM for SSMScan")])
def test_lm_block_reference_limits_carry_over(name, match,
                                              reduced_lm_blocks):
    """Reference limits, not port faults: the GQA block's ``qkt`` puts
    ``h*hd``-wide queries against ``k*hd``-wide keys, and the SSM block's
    ``SSMScan`` has no float DCOM; both packages raise the same
    ``ValueError``."""
    from repro.cimsim import functional as jfn
    from repro_torch.cimsim import functional as tfn
    errors = []
    for fn, wl, arch, kw in (
            (jfn, jwl, ja, {}), (tfn, twl, ta, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match) as err:
            fn.compile_and_verify(wl(f"lmblock:{name}"),
                                  arch.get_arch("jia-issc21"), batch=2, **kw)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# ------------------------------------------------------------ baselines

@pytest.mark.parametrize("policy", ["no_opt", "native", "poly_schedule"])
@pytest.mark.parametrize("workload,arch", [
    ("tiny_cnn", "toy"), ("resnet18", "isaac-baseline")])
def test_baseline_plans_match_reference(policy, workload, arch):
    kw = {"in_hw": 32} if workload == "resnet18" else {}
    want = getattr(jbase, policy)(jwl(workload, **kw), ja.get_arch(arch))
    got = getattr(tbase, policy)(twl(workload, **kw), ta.get_arch(arch))
    assert tcompiler.compile_key_for_plan(got) == \
        jcompiler.compile_key_for_plan(want)
    assert got.notes["policy"] == want.notes["policy"]
    assert [(p.node.name, p.chunk, p.dup, p.cores, p.mapping.n_xbs)
            for p in got.placements] == \
        [(p.node.name, p.chunk, p.dup, p.cores, p.mapping.n_xbs)
         for p in want.placements]
    assert tperf.estimate(got).metrics() == jperf.estimate(want).metrics()


# ---------------------------------------------------------- design space

@pytest.mark.parametrize("arch,axes", [
    ("toy", {"xb.xb_size": [(32, 128), (64, 128)]}),
    ("jia-issc21", {"xb.cell_precision": [1, 2],
                    "chip.core_number": [8, 16]}),
    ("puma", {"xb.xb_size": [(64, 64), (128, 128)], "xb.parallel_row": [8],
              "act_bits": [4, 8]}),
])
def test_design_points_and_overrides_match_reference(arch, axes):
    want = jdse.DesignSpace(ja.get_arch(arch), arch_axes=axes)
    got = tdse.DesignSpace(ta.get_arch(arch), arch_axes=axes)
    wp, gp = want.points(), got.points()
    assert [dataclasses.astuple(p) for p in gp] == \
        [dataclasses.astuple(p) for p in wp]
    assert [p.label() for p in gp] == [p.label() for p in wp]
    for (wo, wa), (go, ga) in zip(want.arch_variants(), got.arch_variants()):
        assert go == wo and ga.to_dict() == wa.to_dict()
    ov = {"xb.xb_size": (16, 16), "chip.core_number": (2, 2)}
    assert tdse.apply_arch_overrides(ta.get_arch(arch), ov).to_dict() == \
        jdse.apply_arch_overrides(ja.get_arch(arch), ov).to_dict()


def test_pareto_frontier_matches_reference():
    rng = np.random.default_rng(0)
    rows = [{"latency_cycles": float(a), "peak_power": float(b),
             "crossbars_used": int(c)}
            for a, b, c in rng.integers(1, 6, (40, 3))]
    want = jdse.pareto_frontier(rows)
    got = tdse.pareto_frontier(rows)
    assert got == want and 0 < len(got) < len(rows)
    g, space = twl("tiny_cnn"), _toy_space(tdse, ta)
    res = tdse.sweep(g, space)
    want_f = jdse.pareto_frontier(
        [r for r in jdse.sweep(jwl("tiny_cnn"), _toy_space(jdse, ja))
         if r.ok])
    assert _flat_results(tdse.pareto_frontier([r for r in res if r.ok])) \
        == _flat_results(want_f)


# ---------------------------------------------------------------- proxy

@pytest.mark.parametrize("workload,arch,axes", [
    ("tiny_cnn", "toy", {"xb.xb_size": [(32, 128), (64, 128)]}),
    ("resnet18", "isaac-baseline", {"xb.cell_precision": [1, 2, 4]}),
])
def test_proxy_batch_matches_scalar_and_reference(workload, arch, axes):
    kw = {"in_hw": 32} if workload == "resnet18" else {}
    tg, tarch = twl(workload, **kw), ta.get_arch(arch)
    points = tdse.DesignSpace(tarch, arch_axes=axes).points()
    got = tdse.proxy_metrics_batch(tg, points, tarch)
    want = jdse.proxy_metrics_batch(
        jwl(workload, **kw), jdse.DesignSpace(ja.get_arch(arch),
                                              arch_axes=axes).points(),
        ja.get_arch(arch))
    assert got.errors == want.errors
    for i, p in enumerate(points):
        assert got.metrics(i) == want.metrics(i)
        if got.errors[i] is not None:
            continue
        kwargs = p.compile_kwargs()
        kwargs.pop("expand", None)
        assert got.metrics(i) == tcompiler.proxy_metrics(
            tg, p.arch_for(tarch), **kwargs)


# ------------------------------------------------------ sweep and search

@pytest.mark.parametrize("workers", [1, 2])
def test_sweep_matches_reference(workers, tmp_path):
    got = tdse.sweep(twl("tiny_mlp"), _toy_space(tdse, ta),
                     cache=tdse.CompileCache(tmp_path / "t"),
                     workers=workers)
    want = jdse.sweep(jwl("tiny_mlp"), _toy_space(jdse, ja),
                      cache=jdse.CompileCache(tmp_path / "j"))
    assert _flat_results(got) == _flat_results(want)
    assert all(r.ok for r in got)


def test_successive_halving_matches_reference(tmp_path):
    got = tdse.successive_halving(twl("tiny_cnn"), _toy_space(tdse, ta),
                                  cache=tdse.CompileCache(tmp_path / "t"))
    want = jdse.successive_halving(jwl("tiny_cnn"), _toy_space(jdse, ja),
                                   cache=jdse.CompileCache(tmp_path / "j"))
    assert _flat_search(got) == _flat_search(want)
    assert got.full_evals < len(_toy_space(tdse, ta).points())


def test_adaptive_search_matches_reference(tmp_path):
    kw = dict(seed=7, batch=12, prefix_keep=6, full_keep=3)
    got = tdse.adaptive_search(twl("tiny_cnn"), _toy_space(tdse, ta),
                               cache=tdse.CompileCache(tmp_path / "t"), **kw)
    want = jdse.adaptive_search(jwl("tiny_cnn"), _toy_space(jdse, ja),
                                cache=jdse.CompileCache(tmp_path / "j"),
                                **kw)
    assert _flat_search(got) == _flat_search(want)
    assert got.ask_log == want.ask_log
    assert (got.proxy_evals, got.prefix_evals, got.ask_rounds) == \
        (want.proxy_evals, want.prefix_evals, want.ask_rounds)


@pytest.mark.parametrize("mode", ["halving", "adaptive", "exhaustive"])
def test_campaign_matches_reference(mode, tmp_path):
    kw = dict(mode=mode, seed=5, robust_tol=0.25,
              adaptive=dict(batch=16, prefix_keep=8, full_keep=4))
    got = tdse.run_campaign(
        {"tiny_mlp": twl("tiny_mlp"), "tiny_cnn": twl("tiny_cnn")},
        _toy_space(tdse, ta), cache=tdse.CompileCache(tmp_path / "t"), **kw)
    want = jdse.run_campaign(
        {"tiny_mlp": jwl("tiny_mlp"), "tiny_cnn": jwl("tiny_cnn")},
        _toy_space(jdse, ja), cache=jdse.CompileCache(tmp_path / "j"), **kw)
    assert _flat_campaign(got) == _flat_campaign(want)
    assert got.cache_stats == want.cache_stats


def test_campaign_verify_best_matches_reference():
    """The winning point of each workload is verified on the saturating
    chip: the same winners, and the same (zero) max |err| per output."""
    def space(pkg_dse, pkg_arch):
        return pkg_dse.DesignSpace(
            _arch(pkg_arch, "saturating"), levels=("CM", "WLM"),
            bindings=("B->XBC",), pipeline=(True,), duplication=(True,),
            arch_axes={"xb.parallel_row": [8, 16]})
    graphs = ("tiny_mlp", "tiny_cnn")
    got = tdse.run_campaign({n: twl(n) for n in graphs}, space(tdse, ta),
                            mode="exhaustive", verify_best=True,
                            device="cpu")
    want = jdse.run_campaign({n: jwl(n) for n in graphs}, space(jdse, ja),
                             mode="exhaustive", verify_best=True)
    assert _flat_campaign(got) == _flat_campaign(want)
    for name in graphs:
        g, w = got.workloads[name].verify, want.workloads[name].verify
        assert g.error is None and w.error is None
        assert g.max_abs_err == w.max_abs_err
        assert (g.graph, g.arch, g.batch, g.ok) == \
            (w.graph, w.arch, w.batch, w.ok)


def test_evaluate_point_fault_top1_matches_reference(tmp_path):
    model = dict(seed=4, stuck_col_rate=0.05, adc_offset_sigma=1.0)
    point = dict(level="WLM", binding="B->XBC", use_pipeline=True,
                 use_duplication=True)
    got, got_cached = tdse.evaluate_point(
        twl("tiny_mlp"), _arch(ta, "saturating"), tdse.DesignPoint(**point),
        cache=tdse.CompileCache(tmp_path / "t"),
        fault_model=tfaults.FaultModel(**model), device="cpu")
    want, want_cached = jdse.evaluate_point(
        jwl("tiny_mlp"), _arch(ja, "saturating"), jdse.DesignPoint(**point),
        cache=jdse.CompileCache(tmp_path / "j"),
        fault_model=jfaults.FaultModel(**model))
    assert got == want and got_cached == want_cached
    assert 0.0 <= got["fault_top1"] <= 1.0


def test_scorecards_match_reference(tmp_path):
    def run(pkg_dse, pkg_arch, wl, root):
        cache = pkg_dse.CompileCache(root)
        sr = pkg_dse.successive_halving(wl("tiny_mlp"),
                                        _toy_space(pkg_dse, pkg_arch),
                                        cache=cache)
        camp = pkg_dse.run_campaign({"tiny_mlp": wl("tiny_mlp")},
                                    _toy_space(pkg_dse, pkg_arch),
                                    cache=cache)
        return (pkg_dse.search_scorecard(sr, "tiny_mlp"),
                pkg_dse.campaign_scorecard(camp))
    got = run(tdse, ta, twl, tmp_path / "t")
    want = run(jdse, ja, jwl, tmp_path / "j")
    for g, w in zip(got, want):
        assert g.to_markdown() == w.to_markdown()
        assert json.loads(g.to_json()) == json.loads(w.to_json())


# ------------------------------------------------------ fail-soft catches

def _failing_launch(*args, **kwargs):
    raise RuntimeError("cim_mvm_tiles: kernel launch failed with "
                       "cudaError 700")


def test_kernel_fault_propagates_from_verify_best(monkeypatch):
    """A RuntimeError of the executor is not reported as a point that
    failed verification: it leaves ``run_campaign``."""
    monkeypatch.setattr(tex.LoweredExecutable, "run_batch", _failing_launch)
    space = tdse.DesignSpace(_arch(ta, "saturating"), levels=("WLM",),
                             bindings=("B->XBC",), pipeline=(True,),
                             duplication=(True,))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        tdse.run_campaign({"tiny_mlp": twl("tiny_mlp")}, space,
                          mode="exhaustive", verify_best=True, device="cpu")


def test_kernel_fault_propagates_from_fault_evaluate_point(monkeypatch):
    monkeypatch.setattr(tex.LoweredExecutable, "run_batch", _failing_launch)
    point = tdse.DesignPoint(level="WLM", binding="B->XBC",
                             use_pipeline=True, use_duplication=True)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        tdse.evaluate_point(twl("tiny_mlp"), _arch(ta, "saturating"), point,
                            fault_model=tfaults.FaultModel(seed=1),
                            device="cpu")


def test_runtime_error_propagates_out_of_the_job_queue(monkeypatch):
    """The sweep's per-job catch reports a ValueError as an infeasible
    point but lets a RuntimeError leave ``run_jobs``."""
    def failing_compile(*args, **kwargs):
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(tcompiler, "compile_graph", failing_compile)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tdse.sweep(twl("tiny_mlp"), _toy_space(tdse, ta))


def test_infeasible_points_keep_the_reference_error_strings(tmp_path):
    """A binding wider than a one-core crossbar-mode chip, and a level
    the chip does not expose: the same points come back infeasible with
    the same strings, through the unscreened sweep and through the
    screened campaign rungs."""
    def points(pkg_dse, pkg_arch):
        toy = pkg_arch.get_arch("toy")
        arch = toy.replace(mode=pkg_arch.ComputingMode.XBM,
                           chip=dataclasses.replace(toy.chip,
                                                    core_number=(1, 1)))
        pts = pkg_dse.DesignSpace(arch, arch_axes={
            "xb.xb_size": [(4, 8), (32, 128)]}).points()
        return pts + [pkg_dse.DesignPoint(
            level="WLM", binding="B->XBC", use_pipeline=True,
            use_duplication=True)], arch
    tp, tarch = points(tdse, ta)
    jp, jarch = points(jdse, ja)
    got = tdse.sweep(twl("tiny_cnn"), tp, tarch,
                     cache=tdse.CompileCache(tmp_path / "t"))
    want = jdse.sweep(jwl("tiny_cnn"), jp, jarch,
                      cache=jdse.CompileCache(tmp_path / "j"))
    assert _flat_results(got) == _flat_results(want)
    errors = {r.error for r in got if r.error}
    assert len(errors) >= 2 and all(e.startswith("ValueError: ")
                                    for e in errors)
    camp_t = tdse.run_campaign({"tiny_cnn": twl("tiny_cnn")}, tp, tarch)
    camp_j = jdse.run_campaign({"tiny_cnn": jwl("tiny_cnn")}, jp, jarch)
    assert _flat_campaign(camp_t) == _flat_campaign(camp_j)


def test_forced_kernel_route_reaches_verify_and_the_fault_metric():
    """``kernel_mode``/``mode`` reach the simulator: forcing the kernel
    on CPU tensors raises the route error out of both DSE entry points
    instead of an infeasible-point report."""
    from repro_torch.kernels.backend import KernelUnsupportedError
    space = tdse.DesignSpace(_arch(ta, "saturating"), levels=("WLM",),
                             bindings=("B->XBC",), pipeline=(True,),
                             duplication=(True,))
    with pytest.raises(KernelUnsupportedError):
        tdse.run_campaign({"tiny_mlp": twl("tiny_mlp")}, space,
                          mode="exhaustive", verify_best=True, device="cpu",
                          kernel_mode="compiled")
    with pytest.raises(KernelUnsupportedError):
        tdse.evaluate_point(twl("tiny_mlp"), _arch(ta, "saturating"),
                            space.points()[0],
                            fault_model=tfaults.FaultModel(seed=1),
                            device="cpu", mode="compiled")
    camp = tdse.run_campaign({"tiny_mlp": twl("tiny_mlp")}, space,
                             mode="exhaustive", verify_best=True,
                             device="cpu", kernel_mode="torch")
    assert camp.workloads["tiny_mlp"].verify.ok
