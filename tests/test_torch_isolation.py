"""The port stands alone: no JAX, no ``repro``, no silent CPU.

An AST scan finds no import of ``jax`` or ``repro`` in the port's
package or in ``chip_smoke.py``; the package imports in a process where
both are blocked; and entry points asked for the default device raise
when there is no CUDA card.
"""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(PORT_FILES) > 20


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "from repro_torch.serving import CimBatchService, CimCluster\n"
        "from repro_torch.serving import (batcher, engine, fleet,\n"
        "                                 placement, traffic)\n"
        "from repro_torch.cimsim import executor, faults, functional\n"
        "from repro_torch.kernels.cim_mvm import kernel, ops\n"
        "from repro_torch.workloads import get_workload\n"
        "from repro_torch.core import compiler\n"
        "from repro_torch.core.abstraction import get_arch\n"
        "res = compiler.compile_graph(get_workload('tiny_mlp'),\n"
        "                             get_arch('toy'))\n"
        "fm = faults.FaultMap(faults.FaultModel(seed=1, stuck_col_rate=0.1),\n"
        "                     get_arch('toy'))\n"
        "exe = executor.lower(res.plan, res.program, device='cpu',\n"
        "                     faults=fm)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'repro')\n"
        "             and sys.modules[m] is not None))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]"


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.cimsim import executor, faults, functional
    from repro_torch.core import compiler
    from repro_torch.core.abstraction import get_arch
    from repro_torch.kernels.backend import resolve, resolve_device
    from repro_torch.serving import CimBatchService, CimCluster, TenantSpec
    from repro_torch.workloads import get_workload
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, arch = get_workload("tiny_mlp"), get_arch("toy")
    res = compiler.compile_graph(g, arch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CimBatchService(g, arch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CimCluster([TenantSpec("mlp", g)], {"c0": arch})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve("cim_mvm_tiles")                  # no device: the card
    with pytest.raises(ValueError):
        resolve("cim_mvm", mode="interpret")      # a bad mode still says so
    with pytest.raises(RuntimeError, match="no CUDA device"):
        faults.accuracy_under_faults(g, arch, faults.FaultModel(seed=0),
                                     n_inputs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        executor.lower(res.plan, res.program, cache=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        functional.compile_and_verify(g, arch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        functional.weights_from_reference(functional.make_weights(g), {},
                                          executor.cim_mvm_params(arch))
    assert resolve_device("cpu") == torch.device("cpu")
