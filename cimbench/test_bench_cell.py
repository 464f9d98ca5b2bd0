"""A whole cell rehearsed on the CPU at a small size through the plain
route, its check held against the reference, the control and the faults
the check has to catch, and the isolation of what the benchmark loads."""
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cimbench import control, harness, reference
from cimbench.harness import ROOT

SEED = 2_148_000_123          # above 2**31, as the check's seeds are


CELLS = ["resnet18-jia.b16", "resnet18-isaac.b64"]


def small(name: str, hw: int = 32, batch: int = 2):
    """Cell ``name`` of BENCHMARK.json at ``hw`` x ``hw`` input, in batches
    of ``batch``."""
    cell = harness.load_cell(name)
    cell.config = dict(cell.config, in_hw=hw)
    cell.traffic = dict(cell.traffic, batch=batch)
    return cell


def rehearse(cell, traced=False, seconds=0.5):
    return harness.run_cell(cell, SEED, seconds, traced,
                            t_start=time.perf_counter(), device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_is_correct(name):
    res = rehearse(small(name))
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "infer_per_s"}
    # a CPU run names its platform and reads no device
    assert res["device"]["platform"] == "cpu"
    assert list(res["checks"]) == ["unanswered", "wrong_answers",
                                   "max_abs_diff"]


def test_traced_rehearsal_reads_no_device_metric():
    res = rehearse(small("resnet18-isaac.b64"), traced=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"batch_p95_ms.host", "service_host_ms",
                                   "setup_calibrate_s"}
    assert "busy_s" not in res["device"] and "breakdown" not in res


@pytest.mark.parametrize("name", CELLS)
def test_control_is_caught(name):
    checks = control.control(small(name), SEED, torch.device("cpu"))
    assert not harness.passed(checks)
    assert checks["wrong_answers"]["value"] > 0


def _broken(monkeypatch, fault):
    from repro_torch.cimsim import executor
    orig = executor.LoweredExecutable._run_batch_impl

    def run(self, inputs, *a, **kw):
        if fault == "answer":
            out = orig(self, inputs, *a, **kw)
            for v in out.values():
                v.reshape(-1)[0] += 1
            return out
        if fault == "permuted":
            # each answer handed to the next request of the batch
            out = orig(self, inputs, *a, **kw)
            return {k: np.roll(v, 1, axis=0) for k, v in out.items()}
        # half of the batch left out: the rest's mean in its place
        n = next(iter(inputs.values())).shape[0]
        keep = max(1, n // 2)
        out = orig(self, {k: v[:keep] for k, v in inputs.items()}, *a, **kw)
        return {k: np.concatenate(
            [v, np.repeat(np.floor(v.mean(axis=0, keepdims=True))
                          .astype(v.dtype), n - keep, axis=0)])
            for k, v in out.items()}

    monkeypatch.setattr(executor.LoweredExecutable, "_run_batch_impl", run)


@pytest.mark.parametrize("fault", ["answer", "half_batch", "permuted"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_caught(monkeypatch, name, fault):
    _broken(monkeypatch, fault)
    res = rehearse(small(name))
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] > 0


def test_unclamped_adc_is_caught():
    """jia's answers hold the ADC's saturation: the exact product in its
    place changes every one of them."""
    cell = small("resnet18-jia.b16")
    inp = harness.make_inputs(cell, SEED, torch.device("cpu"))
    ref = harness.reference_outputs(cell, inp, torch.device("cpu"))
    cell.config = dict(cell.config,
                       crossbar=dict(cell.config["crossbar"], adc_bits=32))
    got = harness.reference_outputs(cell, inp, torch.device("cpu"))
    for name in cell.outputs:
        assert (np.abs(got[name] - ref[name]).max(axis=1) > 0).all(), name


@pytest.mark.parametrize("name", CELLS)
def test_answers_differ_between_images(name):
    """Each image's answer is its own, so an answer handed to another
    request, or a mean in its place, cannot pass."""
    cell = small(name)
    inp = harness.make_inputs(cell, SEED, torch.device("cpu"))
    ref = harness.reference_outputs(cell, inp, torch.device("cpu"))
    rows = np.concatenate([v.reshape(len(inp.pool), -1)
                           for v in ref.values()], axis=1)
    assert len(np.unique(rows, axis=0)) == len(rows)


def test_mvm_matches_its_definition():
    """The plane-by-plane product against the sum written out, on a
    matrix whose rows split into a short last group."""
    xb = reference.Crossbar(act_bits=8, weight_bits=8, dac_bits=2,
                            cell_bits=2, parallel_row=5, adc_bits=5)
    g = torch.Generator().manual_seed(7)
    x = torch.randint(-128, 128, (3, 12), generator=g)
    w = torch.randint(-128, 128, (12, 4), generator=g)
    got = reference.Mvm(w, xb, 8)(x)
    xu, wu = (x + 128).tolist(), (w + 128).tolist()
    want = []
    for m in range(3):
        row = []
        for c in range(4):
            y = 0
            for g0 in range(0, 12, 5):
                for p in range(4):
                    for s in range(4):
                        a = sum(((xu[m][r] >> 2 * p) & 3)
                                * ((wu[r][c] >> 2 * s) & 3)
                                for r in range(g0, min(g0 + 5, 12)))
                        y += min(a, 31) << (2 * p + 2 * s)
            y -= 128 * sum(xu[m]) + 128 * sum(wu[r][c] for r in range(12))
            row.append(y + 12 * 128 * 128)
        want.append(row)
    assert got.tolist() == want
    exact = dataclasses.replace(xb, adc_bits=16)
    assert torch.equal(reference.Mvm(w, exact, 8)(x), x @ w)


@pytest.mark.parametrize("adc_bits", [5, 16])
def test_mvm_rows_with_leading_dimensions(adc_bits):
    """Every leading dimension is a row: (2, 3, R) rows give the (6, R)
    call's products, where the reads saturate and where they are
    exact."""
    xb = reference.Crossbar(act_bits=8, weight_bits=8, dac_bits=2,
                            cell_bits=2, parallel_row=5, adc_bits=adc_bits)
    g = torch.Generator().manual_seed(11)
    x = torch.randint(-128, 128, (2, 3, 12), generator=g)
    w = torch.randint(-128, 128, (12, 4), generator=g)
    mvm = reference.Mvm(w, xb, 8)
    assert mvm.exact == (adc_bits == 16)
    assert torch.equal(mvm(x), mvm(x.reshape(6, 12)).reshape(2, 3, 4))


def test_config_files_agree_with_the_program():
    for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]:
        harness.program_graph(harness.load_cell(w["name"]))


@pytest.mark.parametrize("name", CELLS)
def test_program_graph_is_the_resnet18_builders(name):
    """The family's builder arguments give the graph the builder gives
    at 224 and 1000 classes: the same nodes and weight shapes."""
    from repro_torch.core.graph import weight_matrix_shape
    from repro_torch.workloads import get_workload
    cell = harness.load_cell(name)
    graph, _, _ = harness.program_graph(cell)
    want = get_workload("resnet18", in_hw=224, n_classes=1000)
    assert graph.nodes == want.nodes and graph.inputs == want.inputs
    assert [weight_matrix_shape(n) for n in graph.cim_nodes] \
        == [weight_matrix_shape(n) for n in want.cim_nodes]
    assert graph.outputs == cell.outputs


def test_reference_loads_nothing_of_the_program():
    models = sorted(p.stem for p in (ROOT / "cimbench" / "models")
                    .glob("*.py") if p.stem != "__init__")
    assert "resnet" in models
    code = ("import sys; sys.path.insert(0, '.');"
            "import cimbench.reference, cimbench.counts, cimbench.trace,"
            " cimbench.control;"
            + "".join(f"import cimbench.models.{m};" for m in models)
            + "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core", "torch", "jaxtyping"]) == []
    assert harness.forbidden_modules(
        ["repro", "repro.core", "jax.numpy", "flax"]) \
        == ["flax", "jax.numpy", "repro", "repro.core"]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "cimbench/run.py", "--workload",
                        "resnet18-jia.b16", "--seed", str(SEED),
                        "--seconds", "1"], cwd=ROOT, capture_output=True,
                       text=True)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
def test_cell_on_the_card(cuda_device):
    res = harness.run_cell(small("resnet18-jia.b16", hw=224, batch=16), SEED,
                           2.0, False, t_start=time.perf_counter(),
                           device=cuda_device)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
