#!/usr/bin/env python3
"""Time the crossbar-MVM kernel at the main path's four shape sets.

Usage:  python3 tools/cim_mvm_timing.py [--root DIR] [--reps N]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so a
second checkout unpacked under a directory that git ignores can be timed
beside this one in the same process-free way: run the tool once per
checkout, in turns, on one card.  Each checkout builds and binds its own
``csrc/cim_mvm.cu``.  The shape sets are the ones that checkout's
compiler and executor produce:

  * ``resnet18_jia``  one batch-4 forward of ResNet-18@224 on jia-issc21
    (its ``cim_mvm_tiles`` dispatches);
  * ``calibration``   that network's calibration MVMs (one per CIM node
    at batch 1, as (1, M, R, C));
  * ``lmblock_jia``   the qwen1.5-4b decoder block at seq 512 on
    jia-issc21, batch 2;
  * ``resnet18_puma`` one batch-4 forward of ResNet-18@224 on puma.

Operands are uint8, drawn from a seed; each set runs once to warm up,
then ``--reps`` times between CUDA events.  Prints one JSON line: the
mean milliseconds of each set, its launch count, the card's name and
the root timed.  Needs ``nvcc`` and a Hopper card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys


def shape_sets():
    """{set name: (params, [(T, M, R, C), ...])} from the imported
    package."""
    from repro_torch.cimsim.executor import lower
    from repro_torch.core import compiler
    from repro_torch.core.abstraction import get_arch
    from repro_torch.core.graph import weight_matrix_shape
    from repro_torch.kernels.cim_mvm import cim_mvm_params
    from repro_torch.workloads import get_workload, resnet18

    def dispatches(graph, arch, batch):
        params = cim_mvm_params(arch)
        res = compiler.compile_graph(graph, arch)
        return params, lower(res.plan, res.program, params=params,
                             device="cpu", cache=False).dispatch_shapes(batch)

    jia, puma = get_arch("jia-issc21"), get_arch("puma")
    graph = resnet18(in_hw=224)
    calibration = []
    for node in graph.cim_nodes:
        r, c = weight_matrix_shape(node)
        shape = graph.shapes[node.outputs[0]]
        m = shape[1] * shape[2] if node.op_type == "Conv" else \
            (1 if len(shape) == 1 else shape[0])
        calibration.append((1, m, r, c))
    return {"resnet18_jia": dispatches(graph, jia, 4),
            "calibration": (cim_mvm_params(jia), calibration),
            "lmblock_jia": dispatches(get_workload("lmblock:qwen1.5-4b"),
                                      jia, 2),
            "resnet18_puma": dispatches(graph, puma, 4)}


def time_sets(kernel, sets, reps: int) -> dict:
    """{set name: {"ms", "launches"}}: each set's ``cim_mvm_tiles``
    launches on seeded uint8 operands, once to warm up, then ``reps``
    times between CUDA events."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    out = {}
    for name, (params, shapes) in sets.items():
        ops = [tuple(torch.from_numpy(rng.integers(0, 256, s)
                                      .astype(np.uint8)).cuda()
                     for s in ((t, m, r), (t, r, c)))
               for t, m, r, c in shapes]

        def run():
            for x, w in ops:
                kernel.cim_mvm_tiles_cuda(x, w, params)

        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        end.record()
        torch.cuda.synchronize()
        out[name] = {"ms": start.elapsed_time(end) / reps,
                     "launches": len(shapes)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[1])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("cim_mvm_timing: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.cim_mvm import kernel
    kernel.build()
    out = {"root": str(root), "card": torch.cuda.get_device_name(0)}
    out.update(time_sets(kernel, shape_sets(), args.reps))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
