#!/usr/bin/env python
"""Compile-provenance CLI on ``repro_torch`` — "why does my network run
the way it runs".

Compiles a workload for an architecture preset and prints the per-node
provenance table (``repro_torch.obs.explain.ExplainReport``): the
scheduling tier each operator compiled under, its crossbar binding and
grid, the duplication the search paid for, which schedule segment it
landed in, plus the plan-level decisions (pipeline, ping-pong, cache
provenance, compile wall seconds) as metadata.  Compiling runs on the
host; no device is touched.

    python tools/explain_torch.py --workload resnet18 --arch isaac-baseline
    python tools/explain_torch.py --workload vgg7 --arch puma --level MVM \
        --format json

Pass ``--fault-prob`` to route through the fault-aware compiler and see
the retired-line provenance on top.  ``tools/explain.py`` is the same
tool on the JAX package.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core.abstraction import PRESETS, get_arch    # noqa: E402
from repro_torch.core.mapping import BitBinding               # noqa: E402
from repro_torch.obs.explain import explain_compile           # noqa: E402
from repro_torch.workloads import WORKLOADS, get_workload     # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Per-node compile provenance for one workload/arch")
    ap.add_argument("--workload", default="resnet18",
                    choices=sorted(WORKLOADS))
    ap.add_argument("--arch", default="isaac-baseline",
                    choices=sorted(PRESETS))
    ap.add_argument("--level", default=None,
                    help="clamp the scheduling tier (CM/MVM/VVM aliases "
                         "accepted by the compiler; default: chip mode)")
    ap.add_argument("--binding", default="B->XBC",
                    choices=[b.value for b in BitBinding])
    ap.add_argument("--no-pipeline", action="store_true",
                    help="disable inter-operator pipelining")
    ap.add_argument("--no-duplication", action="store_true",
                    help="disable the duplication search")
    ap.add_argument("--fault-prob", type=float, default=None,
                    help="stuck-cell probability: route through the "
                         "fault-aware compiler")
    ap.add_argument("--seed", type=int, default=0,
                    help="fault-model seed (with --fault-prob)")
    ap.add_argument("--format", default="markdown",
                    choices=["markdown", "json"])
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    fault_model = None
    if args.fault_prob is not None:
        from repro_torch.cimsim.faults import FaultModel
        fault_model = FaultModel(seed=args.seed,
                                 stuck_cell_rate=args.fault_prob)
    report = explain_compile(
        get_workload(args.workload), get_arch(args.arch),
        level=args.level,
        binding=BitBinding(args.binding),
        use_pipeline=not args.no_pipeline,
        use_duplication=not args.no_duplication,
        fault_model=fault_model)
    if args.format == "json":
        print(report.to_json(indent=2))
    else:
        print(report.to_markdown())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
