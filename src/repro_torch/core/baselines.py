"""Baseline scheduling policies the paper compares against (§4.2).

Every baseline is expressed as a restriction of the same ``SchedulePlan``
machinery, so latency / power numbers are produced by the *same*
performance simulator as CIM-MLC's own schedules — only the policy
differs (matching the paper's "same CIM architecture abstracted in
Table 3" methodology).

  * ``no_opt``        — serial layer-by-layer execution, one copy per op.
  * ``native``        — the chip's own scheduling: dup=1, no intra-image
                        pipeline, traditional full-VXB activation.
  * ``poly_schedule`` — Poly-Schedule [22]-style: greedy operator
                        duplication + inter-layer (batch) pipeline; no
                        MVM-grained stagger, no VVM remap, and no
                        intra-image pipeline (its pipeline overlaps
                        *different* inputs, which does not cut
                        single-image latency).
"""
from __future__ import annotations

from . import cg_opt
from .abstraction import CIMArch, ComputingMode
from .cg_opt import SchedulePlan
from .graph import Graph
from .mapping import BitBinding


def no_opt(graph: Graph, arch: CIMArch,
           binding: BitBinding = BitBinding.B_TO_XBC) -> SchedulePlan:
    plan = cg_opt.run(graph, arch, use_pipeline=False, use_duplication=False,
                      binding=binding, naive_chunking=True)
    plan.notes["policy"] = "no-opt"
    plan.notes["level"] = ComputingMode.CM
    return plan


def native(graph: Graph, arch: CIMArch,
           binding: BitBinding = BitBinding.B_TO_XBC) -> SchedulePlan:
    """The accelerator's as-published schedule: weights mapped once,
    operators execute in order, all crossbars of an operator fire
    together (traditional Fig.12(c) activation)."""
    plan = no_opt(graph, arch, binding)
    plan.notes["policy"] = "native"
    plan.notes["level"] = arch.mode  # uses the chip's full interface width
    return plan


def poly_schedule(graph: Graph, arch: CIMArch,
                  binding: BitBinding = BitBinding.B_TO_XBC) -> SchedulePlan:
    plan = cg_opt.run(graph, arch, use_pipeline=False, use_duplication=True,
                      binding=binding, naive_chunking=True)
    # greedy (min-sum) duplication instead of the balanced pipelined DP
    for seg in plan.segments:
        for p in seg.placements:
            p.dup = 1
        cg_opt.greedy_duplication(seg.placements, arch.chip.n_cores)
    plan.notes["policy"] = "poly-schedule"
    plan.notes["level"] = (ComputingMode.XBM
                           if arch.mode.allows(ComputingMode.XBM)
                           else ComputingMode.CM)
    return plan
