"""CG-grained optimization (§3.3.2, Figure 9).

Operates on the computation graph under the chip-tier abstraction:

  * **operator duplication** — a dynamic-programming / dual search for the
    per-operator duplication count under the ``core_number`` budget
    (Figure 9(b): "use dynamic programming to search for all operators'
    duplication numbers under the core_number constraint");
  * **inter-operator pipeline** — adjacent operators stream tiles;
  * **dynamic balancing** — duplication numbers adjusted so adjacent
    stages' compute/data rates match (avoiding pipeline stalls), under
    ``core_noc_cost`` / ``L0 BW`` / ``ALU`` constraints;
  * **resource-adaptive graph segmentation** — when CIM capacity cannot
    hold the whole DNN, maximal subgraphs are constructed iteratively and
    boundaries refined by popping trailing nodes while latency improves.

The pass attaches its results to ``node.sched`` (the paper annotates the
ONNX nodes) and returns a ``SchedulePlan`` consumed by the finer-grained
passes and by the performance simulator.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from ..obs import hooks as obs_hooks
from .abstraction import CIMArch, ComputingMode
from .graph import Graph, Node, n_mvm, out_elems, weight_matrix_shape
from .mapping import (BitBinding, VXBMapping, bind, cores_per_copy,
                      logical_cols_per_xb, vxb_span_error)


# ---------------------------------------------------------------------------
# Placement records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OpPlacement:
    """One CIM operator's (possibly column-tiled chunk's) placement."""

    node: Node
    chunk: int                   # chunk id when an op is split across segments
    n_chunks: int
    mapping: VXBMapping
    n_mvm: int                   # MVMs (windows) this chunk must execute
    cores: int                   # cores per copy
    dup: int = 1                 # duplication count (copies)
    phases: int = 1              # DAC input-bit phases per activation
    row_groups: int = 1          # serial parallel-row groups per activation
    t_load: float = 0.0          # cycles to stream one MVM input
    alu_epilogue: float = 0.0    # ALU cycles per window (fused successors)
    # filled by finer passes:
    vxb_slots: int = 0           # MVM-grained: VXB slots backing this op
    row_spread: int = 1          # VVM-grained: parallel-row remap factor

    @property
    def t_mvm(self) -> float:
        """Cycles per crossbar-set activation after VVM row-spreading."""
        return self.phases * math.ceil(self.row_groups / self.row_spread)

    @property
    def t_window(self) -> float:
        """Steady-state cycles between consecutive windows of one copy."""
        return max(self.t_mvm, self.t_load, self.alu_epilogue)

    @property
    def stage_cycles(self) -> float:
        """Total cycles for this op chunk at its current duplication."""
        return math.ceil(self.n_mvm / self.dup) * self.t_window

    @property
    def n_xbs_total(self) -> int:
        return self.dup * self.mapping.n_xbs


@dataclasses.dataclass
class Segment:
    placements: List[OpPlacement]
    rewrite_cycles: float = 0.0  # weight (re)programming before this segment

    @property
    def cores_used(self) -> int:
        return sum(p.dup * p.cores for p in self.placements)


@dataclasses.dataclass
class SchedulePlan:
    graph: Graph
    arch: CIMArch
    segments: List[Segment]
    use_pipeline: bool = True
    use_duplication: bool = True
    mvm_pipeline: bool = False   # set by mvm_opt (staggered activation)
    vvm_remap: bool = False      # set by vvm_opt (row remapping)
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def placements(self) -> List[OpPlacement]:
        return [p for s in self.segments for p in s.placements]


# ---------------------------------------------------------------------------
# Cost model shared by the passes
# ---------------------------------------------------------------------------

class CostModel:
    """Analytic per-operator costs under a CIMArch (cycles)."""

    def __init__(self, arch: CIMArch, binding: BitBinding = BitBinding.B_TO_XBC):
        self.arch = arch
        self.binding = binding

    def placement(self, node: Node, graph: Graph, chunk: int = 0,
                  n_chunks: int = 1,
                  sub_rc: Optional[Tuple[int, int]] = None) -> OpPlacement:
        r, c = weight_matrix_shape(node)
        if sub_rc is not None:
            r, c = sub_rc
        mapping = bind((r, c), self.arch, self.binding)
        windows = n_mvm(node, graph.shapes)
        xb = self.arch.xb
        phases = xb.input_phases(self.arch.act_bits)
        if self.arch.mode == ComputingMode.WLM:
            groups = xb.row_groups(min(r, xb.rows))
        else:
            groups = xb.row_groups(xb.rows)
        in_bits = r * self.arch.act_bits
        l1 = self.arch.core.l1_bw_bits
        t_load = in_bits / l1 if math.isfinite(l1) else 0.0
        p = OpPlacement(
            node=node, chunk=chunk, n_chunks=n_chunks, mapping=mapping,
            n_mvm=windows, cores=cores_per_copy(self.arch, mapping),
            phases=phases, row_groups=groups, t_load=t_load,
            alu_epilogue=self._epilogue(node, graph, windows),
        )
        # provenance event, gated at the call site: this method runs once
        # per node per design point inside DSE sweeps, so even the
        # payload-dict construction must be skipped when nobody listens
        if obs_hooks.subscribed():
            obs_hooks.emit("mapping.place", node=node.name, chunk=chunk,
                           n_chunks=n_chunks,
                           grid=f"{mapping.grid_r}x{mapping.grid_c}",
                           xbs=mapping.n_xbs, cores=p.cores,
                           windows=windows)
        return p

    def _epilogue(self, node: Node, graph: Graph, windows: int) -> float:
        """ALU cycles per window for directly-fused successor DCOM ops.

        §3.3.2: "Once the CIM-unsupported node, like Relu, follows the
        operator, we will also update the duplication number under the
        constraint of ALU" — we charge the ALU work to the producing CIM
        stage so duplication past the ALU rate is not rewarded.
        """
        alu = self.arch.chip.alu_ops_per_cycle
        if not math.isfinite(alu):
            return 0.0
        cyc = 0.0
        for elems in fused_epilogue_elems(node, graph):
            cyc += elems / alu
        return cyc / max(windows, 1)

    def alu_cycles(self, node: Node, graph: Graph) -> float:
        """Standalone cost of a CIM-unsupported operator on the chip ALU."""
        from .graph import macs
        alu = self.arch.chip.alu_ops_per_cycle
        if not math.isfinite(alu):
            return 0.0
        return macs(node, graph.shapes) / alu

    def weight_xbs(self, node: Node) -> int:
        return bind(node, self.arch, self.binding).n_xbs


def fused_epilogue_elems(node: Node, graph: Graph) -> List[int]:
    """Output element counts of the DCOM successors fused into ``node``'s
    CIM stage, in graph order.

    This is the single source of the §3.3.2 fusion rule (which successor
    ops ride the producing stage's ALU budget): ``CostModel._epilogue``
    sums ``elems / alu`` over it, and the batched proxy (dse.proxy_vec)
    bakes the same ordered counts into its per-graph node tensor so the
    two paths can never disagree on what is fused.
    """
    return [out_elems(succ, graph.shapes) for succ in graph.successors(node)
            if not succ.is_cim and succ.op_type not in ("Flatten", "Reshape",
                                                        "Identity")]


# ---------------------------------------------------------------------------
# Duplication search
# ---------------------------------------------------------------------------

def _copy_cost(p: OpPlacement, unit: str) -> int:
    """Resource cost of one copy: whole cores (CM granularity) or
    crossbar slots (XBM granularity — Eq. (1) packing)."""
    return p.cores if unit == "cores" else p.mapping.n_xbs


def _feasible_bottleneck(placements: List[OpPlacement], budget: int,
                         target: float, unit: str) -> Optional[List[int]]:
    """Duplications achieving stage_cycles <= target within the budget."""
    dups = []
    total = 0
    for p in placements:
        work = p.n_mvm * p.t_window
        d = max(1, math.ceil(work / max(target, 1e-9)))
        d = min(d, p.n_mvm)  # no point duplicating past one window per copy
        if math.ceil(p.n_mvm / d) * p.t_window > target:
            return None
        dups.append(d)
        total += d * _copy_cost(p, unit)
        if total > budget:
            return None
    return dups


def balance_duplication(placements: List[OpPlacement], budget: int,
                        unit: str = "cores") -> None:
    """Min-bottleneck duplication under the resource budget (pipelined
    objective).

    Lagrangian-dual binary search over the bottleneck latency T: each op
    needs ceil(work/T) copies; feasibility is monotone in T, so the search
    is exact for the bottleneck objective (equivalent to the paper's DP on
    this objective, but O(n log W)).  Leftover resources then go greedily
    to the slowest stages (the paper's "intra-segment dynamic balancing").
    """
    base = sum(_copy_cost(p, unit) for p in placements)
    if base > budget:
        for p in placements:
            p.dup = 1
        return
    lo, hi = 0.0, max(p.n_mvm * p.t_window for p in placements)
    best = [1] * len(placements)
    for _ in range(60):
        mid = (lo + hi) / 2
        cand = _feasible_bottleneck(placements, budget, mid, unit)
        if cand is not None:
            best, hi = cand, mid
        else:
            lo = mid
    for p, d in zip(placements, best):
        p.dup = d
    _spend_leftover(placements, budget, unit)


def greedy_duplication(placements: List[OpPlacement], budget: int,
                       unit: str = "cores") -> None:
    """Min-sum duplication (non-pipelined objective): greedy marginal gain.

    Optimal for the convex per-op cost work/d; this is the 'CG-Duplication'
    ablation arm and also the Poly-Schedule-style baseline policy.
    """
    import heapq
    for p in placements:
        p.dup = 1
    used = sum(_copy_cost(p, unit) for p in placements)
    if used > budget:
        return

    def gain(p: OpPlacement) -> float:
        cur = math.ceil(p.n_mvm / p.dup) * p.t_window
        nxt = math.ceil(p.n_mvm / (p.dup + 1)) * p.t_window
        return (cur - nxt) / _copy_cost(p, unit)

    heap = [(-gain(p), i) for i, p in enumerate(placements)]
    heapq.heapify(heap)
    while heap:
        g, i = heapq.heappop(heap)
        p = placements[i]
        if -g <= 0 or used + _copy_cost(p, unit) > budget or p.dup >= p.n_mvm:
            continue
        p.dup += 1
        used += _copy_cost(p, unit)
        heapq.heappush(heap, (-gain(p), i))


def _spend_leftover(placements: List[OpPlacement], budget: int,
                    unit: str) -> None:
    import heapq
    used = sum(p.dup * _copy_cost(p, unit) for p in placements)
    heap = [(-p.stage_cycles, i) for i, p in enumerate(placements)]
    heapq.heapify(heap)
    guard = 0
    while heap and guard < 100000:
        guard += 1
        neg, i = heapq.heappop(heap)
        p = placements[i]
        if p.dup >= p.n_mvm or used + _copy_cost(p, unit) > budget:
            continue
        p.dup += 1
        used += _copy_cost(p, unit)
        heapq.heappush(heap, (-p.stage_cycles, i))
        if all(used + _copy_cost(q, unit) > budget or q.dup >= q.n_mvm
               for q in placements):
            break


# ---------------------------------------------------------------------------
# Segment latency estimate (used during segmentation search)
# ---------------------------------------------------------------------------

def estimate_segment_cycles(placements: List[OpPlacement],
                            use_pipeline: bool) -> float:
    if not placements:
        return 0.0
    if use_pipeline:
        fill = sum(p.t_window for p in placements)
        return fill + max(p.stage_cycles for p in placements)
    return sum(p.stage_cycles for p in placements)


# ---------------------------------------------------------------------------
# Array-shaped twins of the duplication searches.
#
# The batched proxy cost model (dse.proxy_vec) evaluates the analytic
# rung for a whole array of design points at once: every search below
# operates on (n_points, n_nodes) tensors and is bit-exact against its
# scalar namesake above — same bisection trajectory, same heap pop order
# (ties resolve to the lowest node index, exactly like heapq on a
# ``(-key, index)`` tuple), same floating-point operation order.  The
# scalar implementations stay the oracle; tests/test_proxy_vec.py anchors
# the equivalence point by point.
# ---------------------------------------------------------------------------

def seq_sum(a):
    """Left-to-right float sum along the node axis — the same operation
    order as Python's ``sum()`` over a placement list, so pipelined fill
    and stage totals match the scalar estimate bit for bit."""
    import numpy as np
    out = np.zeros(a.shape[0], dtype=np.float64)
    for j in range(a.shape[1]):
        out = out + a[:, j]
    return out


def _unique_search_rows(arrays):
    """(unique_index, inverse) over the rows of the stacked ``arrays``.

    The duplication searches are pure functions of their per-point rows,
    and large cross-product spaces repeat rows heavily (e.g. XBM and WLM
    points of one arch variant pose the *same* search problem), so each
    distinct row is searched once and the result broadcast back.
    Bitwise row identity (a void view over the packed bytes) is used, so
    merged rows are exactly-equal inputs — a pure deduplication, never
    an approximation."""
    import numpy as np
    key = np.ascontiguousarray(np.concatenate(
        [np.asarray(a, dtype=np.float64).reshape(a.shape[0], -1)
         for a in arrays], axis=1))
    view = key.view([("", np.void, key.shape[1] * 8)]).ravel()
    _, first, inverse = np.unique(view, return_index=True,
                                  return_inverse=True)
    return first, inverse


def _spend_leftover_arr(dup, n_mvm, t_window, cost, budget):
    """Vectorized ``_spend_leftover``: per point, repeatedly give one more
    copy to the placement with the largest current ``stage_cycles``.
    Dense form — every row of the ``(rows, nodes)`` arrays is active.

    Mirrors the heap semantics exactly: a popped placement that cannot
    take another copy is discarded for good (both ineligibility
    conditions are monotone — ``used`` never decreases, ``dup`` never
    decreases — so the discard loses nothing), and ties select the
    lowest node index.  Two pure-performance accelerations keep the
    sequential character out of the hot path without changing a single
    pop outcome:

      * **run-length batching** — while the selected placement's heap
        key ``(-stage, index)`` stays the smallest, the scalar heap
        would keep popping it; the whole run is applied in one step.
        Against the runner-up key ``(-s2, j2)`` that means popping while
        ``stage > s2``, or while ``stage >= s2`` when ``index < j2``
        (ties go to the lower index).  The run length comes from
        inverting the stage step function and is then *verified* against
        the exact float comparison the scalar code performs
        (monotonicity of ``ceil(n/d) * t`` in ``d`` makes one check at
        the run's last step sufficient); on any doubt the run degrades
        to a single pop, which is always exact.
      * **row compaction** — points whose heap has drained are dropped
        from the working set, so late iterations only touch the few
        long-running points.

    Mutates and returns ``dup``.
    """
    import numpy as np
    n_points, n_nodes = dup.shape
    if n_nodes == 0 or n_points == 0:
        return dup
    out = dup
    sub = np.arange(n_points)
    d = out
    nm, tw, cs, bud = n_mvm, t_window, cost, budget
    used = (d * cs).sum(axis=1)
    # masked stage: -inf marks discarded placements (popped ineligible)
    ms = np.ceil(nm / d) * tw
    neg_inf = np.full(sub.size, -np.inf)
    pt = np.arange(sub.size)
    # per-point pop budget: the scalar guard truncates after 100000 heap
    # pops, and a batched run of m increments is m pops — count them the
    # same way so even guard-truncated spends stay bit-exact
    pops = np.zeros(sub.size, dtype=np.int64)
    with np.errstate(invalid="ignore", divide="ignore"):
        while sub.size:
            sel = ms.argmax(axis=1)             # ties: lowest index, like
            flat = pt * n_nodes + sel           # heapq on (-stage, i)
            msel = ms.ravel()[flat]             # == per-row max
            live = (msel > -np.inf) & (pops < 100000)
            if not live.all():
                keep = np.flatnonzero(live)
                out[sub] = d                    # write back finished rows
                sub, d, nm, tw, cs, bud, used, ms, pops = (
                    sub[keep], d[keep], nm[keep], tw[keep], cs[keep],
                    bud[keep], used[keep], ms[keep], pops[keep])
                neg_inf = neg_inf[:sub.size]
                pt = pt[:sub.size]
                continue
            d_s = d.ravel()[flat]
            nm_s = nm.ravel()[flat]
            tw_s = tw.ravel()[flat]
            cs_s = cs.ravel()[flat]
            # runner-up heap key (-s2, j2) among the other live placements
            if n_nodes > 1:
                ms.ravel()[flat] = -np.inf
                j2 = ms.argmax(axis=1)
                s2 = ms.ravel()[pt * n_nodes + j2]
                ms.ravel()[flat] = msel
            else:
                j2, s2 = sel, neg_inf
            m_cap = np.minimum(nm_s - d_s, (bud - used) // cs_s)
            m_cap = np.minimum(m_cap, 100000 - pops)
            # run length: sel keeps popping while stage > s2 — or while
            # stage >= s2 when it wins ties (sel < j2).  Invert the stage
            # step function:
            # stage(d') > s2  <=> ceil(nm/d') > floor(s2/t) = q
            #                 <=> d' <= ceil(nm/q) - 1        (q >= 1)
            # stage(d') >= s2 <=> ceil(nm/d') >= ceil(s2/t) = q2
            #                 <=> d' <= ceil(nm/(q2 - 1)) - 1 (q2 >= 2)
            # then verify the last step with the exact float comparison
            # the scalar code performs (stage is non-increasing in d, so
            # one check suffices); degrade to a single pop on any doubt.
            wins_tie = sel < j2
            qq = np.where(wins_tie, np.ceil(s2 / tw_s) - 1.0,
                          np.floor(s2 / tw_s))
            tgt = np.ceil(nm_s / np.maximum(qq, 1.0)) - d_s
            m = np.where(qq >= 1, np.clip(tgt, 1, m_cap), m_cap)
            m = np.where(m_cap >= 1, m, 0).astype(np.int64)
            last_stage = np.ceil(nm_s / np.maximum(d_s + m - 1, 1)) * tw_s
            exact = (m <= 1) | (last_stage > s2) | \
                (wins_tie & (last_stage == s2))
            m = np.where(exact, m, np.minimum(m, 1))
            d.ravel()[flat] = d_s + m
            used += m * cs_s
            pops += np.maximum(m, 1)            # a failed pop still counts
            new_stage = np.ceil(nm_s / np.maximum(d_s + m, 1)) * tw_s
            ms.ravel()[flat] = np.where(m_cap >= 1, new_stage, -np.inf)
    if sub.size:
        out[sub] = d
    return out


def balance_duplication_arr(n_mvm, t_window, cost, budget, active=None):
    """(points x nodes) twin of ``balance_duplication``.

    ``n_mvm``/``t_window``/``cost`` are ``(P, N)`` arrays (``cost`` is the
    per-copy resource cost in the caller's unit), ``budget`` is ``(P,)``;
    ``active`` masks the points to search (inactive points keep dup=1).
    Returns the ``(P, N)`` int64 duplication array: 60-step bisection over
    the bottleneck target, then the leftover-spending greedy — both run
    once per *distinct* search row (``_unique_search_rows``) and the
    results broadcast back.
    """
    import numpy as np
    n_points, n_nodes = t_window.shape
    dup = np.ones((n_points, n_nodes), dtype=np.int64)
    if n_nodes == 0 or n_points == 0:
        return dup
    if active is None:
        active = np.ones(n_points, dtype=bool)
    nm_full = np.broadcast_to(n_mvm, t_window.shape)
    rows = active & (cost.sum(axis=1) <= budget)   # over budget: dup = 1
    if not rows.any():
        return dup
    sub = np.flatnonzero(rows)               # bisect the active subset only
    uniq, inv = _unique_search_rows([nm_full[sub], t_window[sub],
                                     cost[sub], budget[sub]])
    ui = sub[uniq]
    nm = np.ascontiguousarray(nm_full[ui])
    tw = np.ascontiguousarray(t_window[ui])
    cs = np.ascontiguousarray(cost[ui])
    bud = budget[ui]
    work = nm * tw
    lo = np.zeros(ui.size)
    hi = work.max(axis=1)
    best = np.ones((ui.size, n_nodes), dtype=np.int64)
    for _ in range(60):
        mid = (lo + hi) / 2
        tgt = np.maximum(mid, 1e-9)[:, None]
        d = np.minimum(np.maximum(1.0, np.ceil(work / tgt)), nm)
        ok = (np.ceil(nm / d) * tw <= mid[:, None]).all(axis=1)
        d = d.astype(np.int64)
        feas = ok & ((d * cs).sum(axis=1) <= bud)
        best = np.where(feas[:, None], d, best)
        hi = np.where(feas, mid, hi)
        lo = np.where(feas, lo, mid)
    best = _spend_leftover_arr(best, nm, tw, cs, bud)
    dup[sub] = best[inv]
    return dup


def greedy_duplication_arr(n_mvm, t_window, cost, budget, active=None):
    """(points x nodes) twin of ``greedy_duplication`` (min-sum objective,
    marginal-gain heap).  Same shapes/semantics as the balanced twin;
    replays the exact pop sequence, including the scalar quirk that a
    zero-gain pop discards the placement even if a later increment would
    have turned its gain positive again (ceil steps are not convex).
    Like the balanced twin, each distinct search row is solved once."""
    import numpy as np
    n_points, n_nodes = t_window.shape
    dup = np.ones((n_points, n_nodes), dtype=np.int64)
    if n_nodes == 0 or n_points == 0:
        return dup
    if active is None:
        active = np.ones(n_points, dtype=bool)
    nm_full = np.broadcast_to(n_mvm, t_window.shape)
    rows = active & (cost.sum(axis=1) <= budget)   # over budget: dup = 1
    if not rows.any():
        return dup

    def _gain_at(d, nm, tw, cs):
        cur = np.ceil(nm / d) * tw
        nxt = np.ceil(nm / (d + 1)) * tw
        return (cur - nxt) / cs

    osub = np.flatnonzero(rows)
    uniq, inv = _unique_search_rows([nm_full[osub], t_window[osub],
                                     cost[osub], budget[osub]])
    ui = osub[uniq]
    nm = np.ascontiguousarray(nm_full[ui])
    tw = np.ascontiguousarray(t_window[ui])
    cs = np.ascontiguousarray(cost[ui])
    bud = budget[ui]
    out = np.ones((ui.size, n_nodes), dtype=np.int64)
    sub = np.arange(ui.size)
    d = out
    used = cs.sum(axis=1)
    # masked gain: -inf marks discarded placements (popped with gain <= 0
    # or over budget — discarded for good, like the scalar heap)
    mg = _gain_at(d, nm, tw, cs)
    while sub.size:
        live = mg.max(axis=1) > -np.inf
        if not live.all():
            keep = np.flatnonzero(live)
            out[sub] = d                   # write back finished rows
            sub, d, nm, tw, cs, bud, used, mg = (
                sub[keep], d[keep], nm[keep], tw[keep], cs[keep],
                bud[keep], used[keep], mg[keep])
            if not sub.size:
                break
        pt = np.arange(sub.size)
        sel = mg.argmax(axis=1)
        flat = pt * n_nodes + sel
        g_s = mg.ravel()[flat]
        cs_s = cs.ravel()[flat]
        d_s = d.ravel()[flat]
        nm_s = nm.ravel()[flat]
        elig = (g_s > 0) & (used + cs_s <= bud) & (d_s < nm_s)
        d.ravel()[flat] = d_s + elig
        used += np.where(elig, cs_s, 0)
        new_gain = _gain_at(d_s + 1, nm_s, tw.ravel()[flat], cs_s)
        mg.ravel()[flat] = np.where(elig, new_gain, -np.inf)
    if sub.size:
        out[sub] = d
    dup[osub] = out[inv]
    return dup


def estimate_segment_cycles_arr(n_mvm, dup, t_window, use_pipeline):
    """(points,) twin of ``estimate_segment_cycles`` over (P, N) arrays;
    ``use_pipeline`` is a per-point boolean column."""
    import numpy as np
    if t_window.shape[1] == 0:
        return np.zeros(t_window.shape[0])
    stage = np.ceil(n_mvm / dup) * t_window
    pipelined = seq_sum(t_window) + stage.max(axis=1)
    return np.where(use_pipeline, pipelined, seq_sum(stage))


# ---------------------------------------------------------------------------
# The CG pass
# ---------------------------------------------------------------------------

def run(graph: Graph, arch: CIMArch, *, use_pipeline: bool = True,
        use_duplication: bool = True,
        binding: BitBinding = BitBinding.B_TO_XBC,
        ping_pong: bool = False,
        naive_chunking: bool = False) -> SchedulePlan:
    """CG-grained pass.

    ``ping_pong=True`` schedules segments onto half the core pool so the
    other half can be (re)programmed concurrently — weight-rewrite
    latency hides behind compute (double buffering).  The compiler tries
    both variants for multi-segment schedules and keeps the faster
    (compiler.compile_graph); on weight-frozen single-segment ReRAM
    deployments it is never chosen.
    """
    if not arch.mode.allows(ComputingMode.CM):
        raise ValueError("architecture exposes no core-level interface")
    cm = CostModel(arch, binding)
    budget = arch.chip.n_cores
    if ping_pong:
        budget = max(1, budget // 2)

    # 1. placements for every CIM node; ops whose single copy exceeds the
    # whole chip are tiled into (row x col) chunks that each fit.  Row
    # chunks produce partial sums accumulated by the chip ALU; column
    # chunks produce disjoint output slices.
    pls: List[OpPlacement] = []
    for node in graph.cim_nodes:
        p0 = cm.placement(node, graph)
        if p0.cores <= budget:
            pls.append(p0)
            continue
        r, c = weight_matrix_shape(node)
        slot_cap = budget * arch.core.n_xbs      # crossbars on the chip
        full = bind((r, c), arch, binding)
        grid_r_full = full.grid_r
        # Column capacity is counted in VXB column *units* so a chunk
        # boundary never splits the bit slices of one logical column
        # (B->XB: one unit = col_slices crossbars; B->XBC: one crossbar).
        xbs_per_unit = full.xbs_per_vxb
        cols_per_unit = logical_cols_per_xb(full, arch)
        units_c_full = math.ceil(c / cols_per_unit)
        if slot_cap < xbs_per_unit:
            raise ValueError(vxb_span_error(node.name, xbs_per_unit,
                                            slot_cap))
        # search the (row-chunks x col-chunks) grid minimizing the total
        # chunk count (serial reload generations), subject to one chunk
        # fitting the chip; ties prefer bigger chunks (better packing)
        best = None
        rc_lo = max(1, math.ceil(grid_r_full / (slot_cap // xbs_per_unit)))
        rc_hi = rc_lo if naive_chunking else grid_r_full
        for rc in range(rc_lo, rc_hi + 1):
            grid_r_chunk = math.ceil(grid_r_full / rc)
            col_cap = slot_cap // (grid_r_chunk * xbs_per_unit)
            if col_cap < 1:
                continue
            units_c_chunk = min(col_cap, units_c_full)
            cc = math.ceil(units_c_full / units_c_chunk)
            chunk_xbs = grid_r_chunk * units_c_chunk * xbs_per_unit
            cores = math.ceil(chunk_xbs / arch.core.n_xbs)
            if cores > budget:
                continue
            key = (rc * cc, -chunk_xbs)
            if best is None or key < best[0]:
                best = (key, rc, cc, units_c_chunk)
            if grid_r_chunk == 1:
                break   # further row splits cannot reduce the chunk count
        assert best is not None, f"no feasible chunking for {node.name}"
        _, rc, cc, units_c_chunk = best
        sub_r = math.ceil(r / rc)
        sub_c = min(c, units_c_chunk * cols_per_unit)
        n_chunks = rc * cc
        for ch in range(n_chunks):
            pls.append(cm.placement(node, graph, chunk=ch, n_chunks=n_chunks,
                                    sub_rc=(sub_r, sub_c)))
        # safety: the construction above guarantees fit, but guard anyway
        assert pls[-1].cores <= budget, (
            f"chunking failed for {node.name}: {pls[-1].cores} > {budget}")

    # 2. resource-adaptive segmentation + per-segment duplication
    segments = segment_graph(pls, arch, budget, use_pipeline, use_duplication)

    # 3. annotate nodes (paper: attributes on the ONNX graph)
    for si, seg in enumerate(segments):
        for p in seg.placements:
            p.node.sched.update({
                "segment": si, "dup": p.dup, "cores_per_copy": p.cores,
                "n_vxb": p.mapping.n_xbs,
            })

    plan = SchedulePlan(graph=graph, arch=arch, segments=segments,
                        use_pipeline=use_pipeline,
                        use_duplication=use_duplication)
    plan.notes["cg_budget"] = budget
    plan.notes["ping_pong"] = ping_pong
    if obs_hooks.subscribed():
        obs_hooks.emit("cg.plan", graph=graph.name, arch=arch.name,
                       segments=len(segments), budget=budget,
                       ping_pong=ping_pong,
                       placements=len(plan.placements))
    return plan


def _rewrite_cycles(seg_pls: List[OpPlacement], arch: CIMArch) -> float:
    """Per-inference cycles to (re)program a segment's crossbars.

    Cores program their crossbars in parallel; rows within a crossbar are
    written serially at the memory cell's write cost (§2.1's device
    diversity — ReRAM/FLASH writes are ~100-1000x an SRAM write)."""
    n_xbs = sum(p.dup * p.mapping.n_xbs for p in seg_pls)
    return n_xbs * arch.t_write_xb() / max(arch.chip.n_cores, 1)


def _duplicate_segment(seg_pls: List[OpPlacement], arch: CIMArch,
                       budget: int, use_pipeline: bool, use_duplication: bool,
                       charge_rewrite: bool) -> float:
    """Assign duplications for one segment; returns estimated cycles.

    When the segment must be reprogrammed per inference (multi-segment
    schedules), duplication inflates the rewrite cost, so the budget
    actually spent on duplication is searched (the paper's
    resource-*adaptive* allocation): fractions of the core budget are
    tried and the best rewrite+compute total wins.  On SRAM chips writes
    are cheap and the full budget survives the search.
    """
    def apply(frac: float) -> float:
        for p in seg_pls:
            p.dup = 1
        if use_duplication and frac > 0:
            b = max(sum(p.cores for p in seg_pls), int(budget * frac))
            if use_pipeline:
                balance_duplication(seg_pls, b)
            else:
                greedy_duplication(seg_pls, b)
        cost = estimate_segment_cycles(seg_pls, use_pipeline)
        if charge_rewrite:
            cost += _rewrite_cycles(seg_pls, arch)
        return cost

    if not use_duplication:
        return apply(0.0)
    if not charge_rewrite:
        return apply(1.0)
    best_cost, best_frac = None, 1.0
    for frac in (1.0, 0.5, 0.25, 0.125, 0.0625, 0.0):
        cost = apply(frac)
        if best_cost is None or cost < best_cost - 1e-9:
            best_cost, best_frac = cost, frac
    return apply(best_frac)


def segment_graph(pls: List[OpPlacement], arch: CIMArch, budget: int,
                  use_pipeline: bool, use_duplication: bool,
                  pop_window: int = 4) -> List[Segment]:
    """Figure 9(b)'s resource-adaptive segmentation.

    Grow a maximal prefix that fits (one copy per op), then refine the
    boundary: pop trailing nodes while the estimated latency of the
    segment (after duplication DP) improves.  Weight-rewrite cost between
    segments is charged per the memory-cell write cost — this is where
    ReRAM's expensive writes penalize segmentation (§1, §2.1).
    """
    # Does the whole model fit at one copy per op?  If so, weights are
    # programmed once and amortized over the inference stream (ReRAM
    # weight-frozen operation); otherwise EVERY segment is reprogrammed
    # on every inference (segment N+1 overwrites segment N's crossbars).
    multi_segment = sum(p.cores for p in pls) > budget
    segments: List[Segment] = []
    i = 0
    while i < len(pls):
        j = i
        used = 0
        while j < len(pls) and used + pls[j].cores <= budget:
            used += pls[j].cores
            j += 1
        j = max(j, i + 1)  # always make progress

        # boundary refinement: try popping up to pop_window trailing nodes
        best_j, best_cost = j, None
        if j < len(pls):  # popping only matters when a tail remains
            for jj in range(j, max(i + 1, j - pop_window) - 1, -1):
                seg_pls = pls[i:jj]
                cost = _duplicate_segment(seg_pls, arch, budget, use_pipeline,
                                          use_duplication, multi_segment)
                # remaining nodes at 1 copy + their rewrite as tail estimate
                tail = sum(p.n_mvm * p.t_window for p in pls[jj:])
                if multi_segment:
                    tail += _rewrite_cycles(pls[jj:], arch)
                cost += tail
                if best_cost is None or cost < best_cost - 1e-9:
                    best_cost, best_j = cost, jj
        j = best_j

        seg_pls = pls[i:j]
        _duplicate_segment(seg_pls, arch, budget, use_pipeline,
                           use_duplication, multi_segment)
        rewrite = _rewrite_cycles(seg_pls, arch) if multi_segment else 0.0
        segments.append(Segment(placements=seg_pls, rewrite_cycles=rewrite))
        i = j
    return segments
