"""MVM-grained optimization (§3.3.3, Figure 12).

Inherits the CG-grained results and, under the core-tier abstraction:

  * **VXB-granularity duplication** — Eq. (1):

        D'_Oi = floor( num_core_Oi * D_Oi * Core_VXB / num_VXB_Oi )

    The CG pass allocated whole cores; at crossbar granularity those
    cores contain ``Core_VXB`` VXB slots each, so the copy count is
    re-derived from the *slot* pool rather than the core pool.

  * **Staggered MVM pipeline** — instead of waiting until *all* crossbars
    of a VXB set receive their inputs (traditional scheduling, Fig.12(c)),
    a crossbar is activated as soon as its input arrives (Fig.12(d)).
    Effects (realized in cimsim.perf):
      - peak concurrently-active crossbars drop from the full VXB set to
        one row-stripe of it (peak-power reduction, e.g. PUMA -75%);
      - inter-stage transfers shrink to half-tile granularity, halving
        per-stage communication and the pipeline fill latency.
"""
from __future__ import annotations

import math

from .abstraction import ComputingMode
from .cg_opt import SchedulePlan, balance_duplication
from .mapping import vxbs_per_core


def run(plan: SchedulePlan) -> SchedulePlan:
    arch = plan.arch
    if not arch.mode.allows(ComputingMode.XBM):
        raise ValueError(f"{arch.name} exposes no crossbar-level interface "
                         f"(mode={arch.mode.value})")

    for seg in plan.segments:
        # The CG pass allocated whole cores; XBM exposes the crossbars
        # inside them, so the slot pool of this segment is every crossbar
        # of every allocated core.  (CM cannot see a core's idle
        # crossbars — e.g. an operator whose matrix needs 4 of the 8
        # arrays wastes half the core; XBM packs a second copy there,
        # which is exactly the §3.4 walk-through's dup 2 -> 4 update.)
        slot_pool = sum(p.dup * p.cores for p in seg.placements) \
            * arch.core.n_xbs
        for p in seg.placements:
            core_vxb = vxbs_per_core(arch, p.mapping)
            num_vxb = p.mapping.n_vxb
            # Eq. (1) per-operator floor (recorded for reference):
            slots = p.cores * p.dup * core_vxb * p.mapping.xbs_per_vxb
            d_eq1 = max(1, (p.cores * p.dup * core_vxb) // max(num_vxb, 1))
            p.vxb_slots = slots
            p.node.sched.update({"dup_mvm_eq1": d_eq1, "vxb_slots": slots,
                                 "core_vxb": core_vxb, "num_vxb": num_vxb})
            p.dup = min(d_eq1, p.n_mvm) if not plan.use_duplication else p.dup

        if plan.use_duplication:
            # joint re-balance over the segment's crossbar-slot pool
            # (subsumes Eq.(1): every op gets at least its Eq.(1) floor
            # when slots allow, and freed fractional-core waste is
            # redistributed to the bottleneck stages).
            if plan.use_pipeline:
                balance_duplication(seg.placements, slot_pool, unit="xbs")
            else:
                from .cg_opt import greedy_duplication
                greedy_duplication(seg.placements, slot_pool, unit="xbs")
        for p in seg.placements:
            p.node.sched["dup_mvm"] = p.dup

    plan.mvm_pipeline = True
    plan.notes["mvm_stagger"] = True
    return plan


def peak_active_xbs(p, staggered: bool) -> int:
    """Crossbars of one placement active in the same cycle.

    Traditional scheduling fires every crossbar of every copy at once;
    the staggered pipeline keeps only one row-stripe (``grid_c`` crossbars
    x bit-slice group) of each copy active per cycle (Figure 12(d): 4 of
    6 VXBs -> here modeled as ceil(n_xbs / grid_r))."""
    per_copy = p.mapping.n_xbs
    if staggered and p.mapping.grid_r > 1:
        per_copy = math.ceil(p.mapping.n_xbs / p.mapping.grid_r)
    return p.dup * per_copy
