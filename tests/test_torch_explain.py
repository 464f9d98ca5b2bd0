"""The port's compile provenance (``obs.explain``) against the JAX
package's, on the CPU.

``ExplainReport.to_json()`` of the same compile must be equal in both
packages, tolerance 0, with and without a fault model; only the compile
wall seconds, which no two runs share, are left out of the comparison.
"""
import json

import pytest

from repro.cimsim import faults as jfaults
from repro.core import abstraction as ja
from repro.dse import CompileCache as JCache
from repro.obs.explain import explain_compile as jexplain
from repro.workloads import get_workload as jwl
from repro_torch import obs as tobs
from repro_torch.cimsim import faults as tfaults
from repro_torch.core import abstraction as ta
from repro_torch.dse import CompileCache as TCache
from repro_torch.obs.explain import ExplainReport, explain_compile
from repro_torch.workloads import get_workload as twl

CASES = {
    "tiny_mlp-toy": ("tiny_mlp", {}, "toy"),
    "tiny_cnn-puma": ("tiny_cnn", {}, "puma"),
    "resnet18@32-isaac": ("resnet18", {"in_hw": 32}, "isaac-baseline"),
    "resnet18@32-jia": ("resnet18", {"in_hw": 32}, "jia-issc21"),
}
#: per case, a map that fault-aware compile retires lines for: the
#: stuck cells of tests/test_obs.py, the line-clustered faults of
#: tests/test_torch_faults.py
FAULTS = {"tiny_mlp-toy": dict(seed=0, stuck_cell_rate=0.02),
          "tiny_cnn-puma": dict(seed=7, stuck_col_rate=0.01,
                                dead_row_rate=0.005)}


def _json(report) -> dict:
    data = json.loads(report.to_json())
    data["meta"].pop("compile_wall_s", None)
    return data


@pytest.mark.parametrize("case", sorted(CASES))
def test_explain_json_matches_reference(case):
    name, kw, arch = CASES[case]
    got = explain_compile(twl(name, **kw), ta.get_arch(arch))
    want = jexplain(jwl(name, **kw), ja.get_arch(arch))
    assert _json(got) == _json(want)
    assert got.to_markdown().splitlines()[0] == \
        want.to_markdown().splitlines()[0]
    assert got.coverage == want.coverage == 1.0


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_explain_with_fault_model_matches_reference(case):
    name, kw, arch = CASES[case]
    got = explain_compile(twl(name, **kw), ta.get_arch(arch),
                          fault_model=tfaults.FaultModel(**FAULTS[case]))
    want = jexplain(jwl(name, **kw), ja.get_arch(arch),
                    fault_model=jfaults.FaultModel(**FAULTS[case]))
    assert _json(got) == _json(want)
    assert got.meta["fault_retire_attempts"] >= 1


def test_explain_cache_provenance_matches_reference(tmp_path):
    reports = {}
    for tag, explain, wl, arch, cache in (
            ("t", explain_compile, twl, ta, TCache(tmp_path / "t")),
            ("j", jexplain, jwl, ja, JCache(tmp_path / "j"))):
        first = explain(wl("tiny_mlp"), arch.get_arch("toy"), cache=cache)
        again = explain(wl("tiny_mlp"), arch.get_arch("toy"), cache=cache)
        reports[tag] = (_json(first), _json(again))
    assert reports["t"] == reports["j"]
    assert reports["t"][0]["meta"]["cache_hit"] is False
    assert reports["t"][1]["meta"]["cache_hit"] is True


def test_obs_exports_explain_lazily():
    assert tobs.ExplainReport is ExplainReport
    assert tobs.explain_compile is explain_compile
    assert tobs.explain.ExplainReport is ExplainReport
    with pytest.raises(AttributeError):
        tobs.nope
