"""Compile a transformer (ViT) onto every published CIM chip abstraction
and compare schedules — the paper's §4.4 scenario, runnable end to end,
on ``repro_torch``.  Compiling and the performance simulator run on the
host; no device is touched.

Shows the arch-applicability split: Q/K/V/O + MLP Gemms map to
crossbars, QK^T / AV MatMuls stay on the ALU (weight-stationary
constraint — DESIGN.md §4).

  PYTHONPATH=src python examples/compile_vit_cim_torch.py

``examples/compile_vit_cim.py`` is the same run on the JAX package.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.cimsim import perf
from repro_torch.core import baselines, compiler
from repro_torch.core.abstraction import get_arch
from repro_torch.workloads import get_workload


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]) \
        .parse_args(argv)
    vit = get_workload("vit", n_layers=4)   # 4-layer ViT for a quick run
    n_cim = len(vit.cim_nodes)
    n_alu = len(vit.nodes) - n_cim
    print(f"ViT graph: {n_cim} crossbar-mappable Gemms, "
          f"{n_alu} ALU ops (incl. QK^T/AV MatMuls)\n")

    for preset in ("isaac-baseline", "puma", "jia-issc21"):
        arch = get_arch(preset)
        res = compiler.compile_graph(vit, arch)
        ours = perf.estimate(res.plan)
        noopt = perf.estimate(baselines.no_opt(vit, arch))
        counts = res.program.op_counts()
        cim_ops = sum(v for k, v in counts.items() if k.startswith("cim."))
        print(f"{preset:15s} mode={arch.mode.value:3s} "
              f"segments={ours.n_segments:3d} cim_ops={cim_ops:8d} "
              f"latency={ours.latency_cycles:10.0f}cy "
              f"speedup={noopt.latency_cycles/ours.latency_cycles:6.1f}x "
              f"peak_xbs={ours.peak_active_xbs:.0f}")


if __name__ == "__main__":
    main()
