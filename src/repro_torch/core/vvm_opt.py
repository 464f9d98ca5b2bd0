"""VVM-grained optimization (§3.3.4, Figure 14).

Wordline-mode chips can only activate ``parallel_row`` wordlines per
cycle, so reading one crossbar whose mapped rows exceed that limit takes
``g = ceil(rows_used / parallel_row)`` serial sub-cycles, and a consumer
operator cannot start until the serial accumulation finishes.

The *data remapping* strategy spreads the row groups that contribute to
the same accumulation across ``k`` different crossbars: all groups then
activate in the same cycle (their partial sums are combined by the ALU
shift-accumulate), so the activation takes ``ceil(g/k)`` sub-cycles and
the consumer starts earlier — converting serial accumulation into
parallel computation (Figure 14(c)/(d)).

The remap consumes spare crossbars left over after MVM-grained
duplication; the pass chooses, per operator, between spending leftovers
on further duplication or on row-spreading, keeping whichever minimizes
the stage bottleneck (the paper applies remapping where MVM-grained
duplication is ineffective, e.g. Jain et al.'s small-core macro).
"""
from __future__ import annotations

import math

from .abstraction import ComputingMode
from .cg_opt import SchedulePlan


def run(plan: SchedulePlan) -> SchedulePlan:
    arch = plan.arch
    if not arch.mode.allows(ComputingMode.WLM):
        raise ValueError(f"{arch.name} exposes no wordline-level interface "
                         f"(mode={arch.mode.value})")

    total_xbs = arch.chip.n_cores * arch.core.n_xbs
    for seg in plan.segments:
        used = sum(p.dup * p.mapping.n_xbs for p in seg.placements)
        spare = max(0, total_xbs - used)
        # 1. spend spare crossbars on the ops with the worst bottleneck first
        for p in sorted(seg.placements, key=lambda q: -q.stage_cycles):
            g = p.row_groups
            if g <= 1:
                p.node.sched["row_spread"] = 1
                continue
            # spreading one copy's row groups k-ways costs (k-1) extra
            # crossbar sets of the same column footprint
            per_spread = max(1, p.dup * p.mapping.n_xbs)
            k_max = 1 + (spare // per_spread)
            k = min(g, k_max)
            if k > 1:
                spare -= (k - 1) * per_spread
                p.row_spread = k

        # 2. duplication <-> spreading conversion: turning two copies into
        # one double-spread copy keeps the crossbar cost and the stage
        # throughput but halves t_window — a strictly finer pipeline
        # granularity (Fig. 14(d)'s earlier consumer start).
        if plan.use_pipeline:
            for p in seg.placements:
                while (p.dup >= 2 and p.row_spread * 2 <=
                       max(1, math.ceil(p.row_groups / 1))):
                    if p.row_spread >= p.row_groups:
                        break
                    old_stage = p.stage_cycles
                    old_dup, old_spread = p.dup, p.row_spread
                    p.dup = old_dup // 2
                    p.row_spread = min(p.row_groups, old_spread * 2)
                    if p.stage_cycles > old_stage + 1e-9:
                        p.dup, p.row_spread = old_dup, old_spread
                        break
        for p in seg.placements:
            p.node.sched["row_spread"] = p.row_spread

    plan.vvm_remap = True
    plan.notes["vvm_remap"] = True
    return plan
