"""Quickstart on ``repro_torch``: compile a small CNN through the full
CIM-MLC stack and execute the generated meta-operator flow in the
functional simulator, every crossbar read through the crossbar-MVM
kernel on ``--device`` (the CUDA kernel on a card, the plain PyTorch
version on ``--device cpu``).

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

``examples/quickstart.py`` is the same walk-through on the JAX package;
the two print the same lines.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np

from repro_torch.cimsim import perf
from repro_torch.cimsim.functional import simulate
from repro_torch.core import baselines, compiler
from repro_torch.core.abstraction import get_arch
from repro_torch.kernels.backend import resolve_device
from repro_torch.workloads import get_workload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the simulation (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)   # no card: refuse now

    # 1. a workload graph (ONNX-isomorphic IR) and a CIM chip abstraction
    graph = get_workload("tiny_cnn")
    arch = get_arch("isaac-baseline")
    print(f"workload: {graph.name} ({len(graph.nodes)} nodes)")
    print(f"chip: {arch.name}, mode={arch.mode.value}, "
          f"{arch.chip.n_cores} cores x {arch.core.n_xbs} crossbars "
          f"of {arch.xb.xb_size}")

    # 2. multi-level compilation (CG -> MVM -> VVM for a WLM chip)
    result = compiler.compile_graph(graph, arch)
    print("\n--- meta-operator flow (head) ---")
    print(result.program.to_text(max_lines=24))
    print("\nop counts:", dict(result.program.op_counts()))

    # 3. schedule quality vs baselines (same performance simulator)
    ours = perf.estimate(result.plan)
    noopt = perf.estimate(baselines.no_opt(graph, arch))
    poly = perf.estimate(baselines.poly_schedule(graph, arch))
    print(f"\nlatency: ours={ours.latency_cycles:.0f} cycles, "
          f"no-opt={noopt.latency_cycles:.0f} "
          f"({noopt.latency_cycles/ours.latency_cycles:.1f}x), "
          f"poly={poly.latency_cycles:.0f} "
          f"({poly.latency_cycles/ours.latency_cycles:.1f}x)")
    print(f"peak active crossbars: {ours.peak_active_xbs:.0f} "
          f"(staggered) vs {noopt.peak_active_xbs:.0f}")

    # 4. the flow computes the right numbers: interpret it on the device
    # and compare with the int8 reference forward pass
    sim_out, ref_out, stats = simulate(graph, arch, device=device)
    ok = all(np.array_equal(sim_out[t], ref_out[t]) for t in graph.outputs)
    print(f"\nfunctional simulation: {stats.cim_reads} CIM reads, "
          f"{stats.dcom_ops} DCOM ops -> matches reference: {ok}")
    assert ok


if __name__ == "__main__":
    main()
