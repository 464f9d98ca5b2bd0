"""The port's design-space exploration tier against the JAX package's, on
the CPU.

Every case runs the same graphs, archs, design spaces and seeds through
``repro.dse`` and ``repro_torch.dse`` in one process and requires equal
results, tolerance 0: the workload graphs, the §4.2 baseline plans, the
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
from repro.core import compiler as jcompiler
from repro.workloads import get_workload as jwl
from repro_torch import dse as tdse
from repro_torch.cimsim import executor as tex
from repro_torch.cimsim import faults as tfaults
from repro_torch.cimsim import perf as tperf
from repro_torch.core import abstraction as ta
from repro_torch.core import baselines as tbase
from repro_torch.core import compiler as tcompiler
from repro_torch.workloads import get_workload as twl


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


def test_lm_block_workloads_say_they_are_not_ported():
    with pytest.raises(NotImplementedError, match="LM configs"):
        twl("lmblock:gemma2-2b")
    with pytest.raises(KeyError):
        twl("nope")


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
