"""The port stands alone: no JAX, no ``repro``, no silent CPU.

An AST scan finds no import of ``jax`` or ``repro`` in the port's
package or in ``chip_smoke.py``; the package imports in a process where
both are blocked; entry points asked for the default device (the LM
model's, server's, trainer's and training CLI's too) raise when there
is no CUDA card (the host mesh's too); and the
port's compile store is its own and refuses the JAX package's entries.
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


def test_package_imports_with_jax_and_repro_blocked(tmp_path):
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
        "from repro_torch import dse\n"
        "from repro_torch.dse import (adaptive, cache, campaign, pareto,\n"
        "                             proxy_vec, report, runner, search,\n"
        "                             space)\n"
        "from repro_torch.obs import explain\n"
        "from repro_torch.core import baselines\n"
        "import torch, repro_torch.configs, repro_torch.models.lm\n"
        "from repro_torch.serving import server\n"
        "from repro_torch.configs import get_config, reduced\n"
        "cfg = reduced(get_config('hymba-1.5b'))\n"
        "p = repro_torch.models.lm.init_params(cfg, torch.Generator(),\n"
        "                                    device='cpu')\n"
        "assert cfg.param_count() > 0\n"
        "req = server.Request(0, prompt=[1, 2, 3], max_new_tokens=2)\n"
        "server.BatchServer(cfg, p, device='cpu').serve([req])\n"
        "assert len(req.output) == 2\n"
        "res = compiler.compile_graph(get_workload('tiny_mlp'),\n"
        "                             get_arch('toy'))\n"
        "camp = dse.run_campaign({'cnn': get_workload('tiny_cnn')},\n"
        "                        dse.DesignSpace(get_arch('toy')),\n"
        "                        verify_best=True, device='cpu')\n"
        "assert camp.workloads['cnn'].verify.ok\n"
        "explain.explain_compile(get_workload('tiny_cnn'), get_arch('toy'))\n"
        "fm = faults.FaultMap(faults.FaultModel(seed=1, stuck_col_rate=0.1),\n"
        "                     get_arch('toy'))\n"
        "exe = executor.lower(res.plan, res.program, device='cpu',\n"
        "                     faults=fm)\n"
        "import repro_torch.train, repro_torch.launch.train\n"
        "from repro_torch import checkpoint, data, launch, optim, train\n"
        "from repro_torch.launch import steps\n"
        "cli = repro_torch.launch.train\n"
        f"trainer, _ = cli.build(cli.parse_args(['--arch', 'gemma2-2b',\n"
        f"    '--reduced', '--device', 'cpu', '--steps', '2', '--batch', '2',\n"
        f"    '--seq-len', '8', '--save-every', '1',\n"
        f"    '--workdir', {str(tmp_path)!r}]))\n"
        "assert trainer.train()['steps'] == 2\n"
        "from repro_torch.analysis import roofline\n"
        "from repro_torch.launch import dryrun, mesh, sharding\n"
        "from repro_torch.models.perfopts import OPTIMIZED, use_perf_opts\n"
        "from repro_torch.configs.base import ShapeSpec\n"
        "cell = steps.build_cell(cfg, ShapeSpec('d', 'decode', 8, 1),\n"
        "                        perf=OPTIMIZED)\n"
        "assert roofline.count(cell.fn, *cell.materialize('meta'))[0] > 0\n"
        "rec = dryrun.run_cell(cfg, ShapeSpec('p', 'prefill', 8, 1),\n"
        "                      mesh.make_production_mesh())\n"
        "assert rec['status'] == 'ok', rec\n"
        "with use_perf_opts(OPTIMIZED):\n"
        "    server.BatchServer(cfg, p, device='cpu').serve([\n"
        "        server.Request(1, prompt=[1, 2], max_new_tokens=2)])\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'repro')\n"
        "             and sys.modules[m] is not None))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]"


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
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
    from repro_torch import dse
    space = dse.DesignSpace(arch, levels=("WLM",), bindings=("B->XBC",),
                            pipeline=(True,), duplication=(True,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dse.run_campaign([g], space, mode="exhaustive", verify_best=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dse.evaluate_point(g, arch, space.points()[0],
                           fault_model=faults.FaultModel(seed=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        functional.weights_from_reference(functional.make_weights(g), {},
                                          executor.cim_mvm_params(arch))
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm
    from repro_torch.serving import BatchServer
    cfg = reduced(get_config("qwen1.5-4b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.params_from_reference({}, cfg)
    params = lm.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchServer(cfg, params)
    assert BatchServer(cfg, params, device="cpu").device.type == "cpu"
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import train as train_cli
    from repro_torch.train import Trainer, TrainerConfig
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, ShapeSpec("t", "train", 8, 2),
                TrainerConfig(workdir=str(tmp_path)), iter(()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "gemma2-2b", "--reduced", "--workdir",
                        str(tmp_path)])
    from repro_torch.launch import mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_host_mesh()
    assert mesh.make_host_mesh(device="cpu").devices == ("cpu",)
    assert resolve_device("cpu") == torch.device("cpu")


def test_compile_store_is_the_ports_own(tmp_path, monkeypatch):
    """The port's default store differs from the JAX package's, the JAX
    package's variable does not move it, and an entry the JAX package
    wrote under the same key raises instead of being unpickled (which
    would import ``repro``) or recompiled in silence."""
    from repro import dse as jdse
    from repro.core import abstraction as ja
    from repro.core import compiler as jcompiler
    from repro.workloads import get_workload as jwl
    from repro_torch import dse as tdse
    from repro_torch.core import abstraction as ta
    from repro_torch.core import compiler as tcompiler
    from repro_torch.workloads import get_workload as twl

    monkeypatch.delenv("REPRO_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.delenv(tdse.cache.CACHE_DIR_ENV, raising=False)
    ours = tdse.default_cache_dir()
    assert ours != jdse.default_cache_dir()
    assert ours.name == "compile" and ours.parent.name == \
        "repro-cim-mlc-torch"
    monkeypatch.setenv("REPRO_COMPILE_CACHE_DIR", str(tmp_path / "jax"))
    assert tdse.default_cache_dir() == ours
    assert jdse.default_cache_dir() == tmp_path / "jax"
    monkeypatch.setenv("REPRO_TORCH_COMPILE_CACHE_DIR", str(tmp_path / "t"))
    assert tdse.default_cache_dir() == tmp_path / "t"

    root = tmp_path / "shared"
    jres = jcompiler.compile_graph(jwl("tiny_mlp"), ja.get_arch("toy"),
                                   cache=jdse.CompileCache(root))
    key = tcompiler.compile_key(twl("tiny_mlp"), ta.get_arch("toy"))
    assert key == jres.key
    theirs = tdse.CompileCache(root)
    with pytest.raises(tdse.ForeignEntryError, match="repro"):
        theirs.get(key)
    with pytest.raises(tdse.ForeignEntryError):
        tcompiler.compile_graph(twl("tiny_mlp"), ta.get_arch("toy"),
                                cache=theirs)
    assert theirs.misses == 0 and theirs.hits == 0
    # the port's own entries round-trip, and truncated ones still
    # degrade to a recompute
    own = tdse.CompileCache(tmp_path / "own")
    first = tcompiler.compile_graph(twl("tiny_mlp"), ta.get_arch("toy"),
                                    cache=own)
    assert tdse.CompileCache(tmp_path / "own").get(key).key == first.key
    own._pkl(key).write_bytes(b"\x80\x05truncated")
    assert tdse.CompileCache(tmp_path / "own").get(key) is None
