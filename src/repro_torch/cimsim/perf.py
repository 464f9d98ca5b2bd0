"""Performance simulator (§4.1): latency (cycles) + peak power.

Extends the PUMA-sim / NeuroSim-style modeling the paper builds on: an
event-driven simulation over the scheduled operator stages.

Latency.  Each CIM operator chunk is a *stage* whose steady-state cycle
count comes from its placement (``stage_cycles`` = windows/dup x
t_window); CIM-unsupported operators either fuse into their producer's
epilogue (streaming ops like ReLU — their ALU cost is charged to the
producer's per-window time) or form standalone ALU stages (MatMul etc.).
With the intra-image pipeline enabled, a consumer starts once each
producer has emitted the fraction of its output the consumer's first
unit of work needs (*per-edge warmup*); the MVM-grained staggered
pipeline halves the transfer granularity and thus the warmup
(Fig. 12(d)); the VVM remap shortens the per-window time itself
(Fig. 14(d)).  Without the pipeline, consumers wait for full outputs.

Peak power.  Analog activation dominates (the paper's measured split:
crossbar activation 83%, ADC/DAC 10%, data movement 7%).  We track the
number of concurrently-activated crossbars over time; traditional
scheduling fires all crossbars of a VXB set at once, the staggered
pipeline only one row-stripe per copy (Fig. 12(c) vs (d)).  Reported
``peak_power`` is in units of one crossbar activation (incl. its
ADC/DAC + movement share).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

from ..core.abstraction import CIMArch
from ..core.cg_opt import OpPlacement, SchedulePlan
from ..core.graph import Graph, Node
from ..core.mvm_opt import peak_active_xbs

XB_POWER_SHARE = 0.83
ADC_POWER_SHARE = 0.10
MOV_POWER_SHARE = 0.07


@dataclasses.dataclass
class PerfReport:
    latency_cycles: float
    compute_cycles: float          # sum of stage cycles (no overlap)
    rewrite_cycles: float
    peak_active_xbs: float
    peak_power: float              # normalized crossbar-activation units
    avg_active_xbs: float
    energy_units: float            # xb-activation-cycles
    n_segments: int
    n_stages: int
    pipeline: bool
    stagger: bool
    remap: bool
    crossbars_used: int = 0        # peak physical crossbars mapped (any segment)

    def metrics(self) -> Dict[str, float]:
        """JSON-safe flat metric bundle (DSE objectives + diagnostics).

        Every value is a plain int/float/bool so the bundle can be stored
        next to a compile-cache entry and re-read without unpickling the
        full ``CompileResult``.
        """
        d = dataclasses.asdict(self)
        return {k: (v if isinstance(v, (bool, int)) else float(v))
                for k, v in d.items()}


@dataclasses.dataclass
class _Info:
    start: float
    finish: float

    @property
    def duration(self) -> float:
        return max(self.finish - self.start, 0.0)


def _edge_frac(prod: Node, cons: Node, graph: Graph) -> float:
    """Fraction of a producer's output the consumer needs before starting
    its own first unit of work (pipeline warmup granularity)."""
    shapes = graph.shapes
    out = shapes.get(prod.outputs[0], (1,))
    t = cons.op_type
    if t == "Conv":
        k = cons.attrs["weight_shape"][2]
        h = out[1] if len(out) >= 3 else 1
        return min(1.0, k / max(h, 1))
    if t in ("MaxPool", "AveragePool"):
        k = cons.attrs.get("kernel", 2)
        h = out[1] if len(out) >= 3 else 1
        return min(1.0, k / max(h, 1))
    if t in ("Gemm", "Linear", "LayerNorm", "RMSNorm", "Softmax",
             "TopKRouter"):
        # token-wise streaming: these operate row-by-row over the leading
        # (token) dims, so they start after the first token vector arrives
        if len(out) >= 2:
            return 1.0 / max(math.prod(out[:-1]), 1)
        return 1.0              # flattened vector: needs everything
    if t in ("GlobalAveragePool", "Flatten", "MatMul"):
        return 1.0
    # elementwise & misc: stream through at element granularity
    n = max(math.prod(out), 1)
    return 1.0 / n


def _alu_stage_cycles(node: Node, graph: Graph, arch: CIMArch) -> float:
    from ..core.graph import macs
    alu = arch.chip.alu_ops_per_cycle
    if not math.isfinite(alu):
        return 0.0
    return macs(node, graph.shapes) / alu


def _is_standalone_alu(node: Node, graph: Graph) -> bool:
    """ALU nodes not fused into a CIM producer's epilogue."""
    if node.is_cim:
        return False
    if node.op_type == "MatMul":
        return True
    return not any(p.is_cim for p in graph.predecessors(node))


def estimate(plan: SchedulePlan) -> PerfReport:
    arch, graph = plan.arch, plan.graph
    stagger = plan.mvm_pipeline
    pipeline = plan.use_pipeline

    info: Dict[str, _Info] = {}
    intervals: List[Tuple[float, float, float]] = []   # start, end, active xbs
    compute = 0.0
    rewrites = 0.0
    n_stages = 0

    placements_of: Dict[str, List[OpPlacement]] = {}
    segment_of: Dict[str, int] = {}
    for si, seg in enumerate(plan.segments):
        for p in seg.placements:
            placements_of.setdefault(p.node.name, []).append(p)
            segment_of[p.node.name] = si

    def warm_edge(pred: Node, node: Node) -> float:
        pi = info[pred.name]
        if not pipeline:
            return pi.finish
        frac = _edge_frac(pred, node, graph)
        if stagger and pred.is_cim:
            frac *= 0.5          # half-tile forwarding (Fig. 12(d))
        return pi.start + pi.duration * min(1.0, frac)

    def ready_time(node: Node, floor: float) -> float:
        t = floor
        for pred in graph.predecessors(node):
            if pred.name in info:
                t = max(t, warm_edge(pred, node))
        return t

    offset = 0.0
    processed: set = set()
    ping_pong = bool(plan.notes.get("ping_pong"))
    prev_duration = 0.0
    # chunked ops may span segments: accumulate chunk intervals per node
    chunk_acc: Dict[str, List[Tuple[float, float]]] = {}
    for si, seg in enumerate(plan.segments):
        if ping_pong and si > 0:
            # double buffering: this segment's weights were programmed
            # into the idle half of the pool while the previous segment
            # computed — only the un-hidden remainder stalls the chip.
            stall = max(0.0, seg.rewrite_cycles - prev_duration)
            offset += stall
            rewrites += stall
        else:
            offset += seg.rewrite_cycles
            rewrites += seg.rewrite_cycles
        seg_start = offset
        seg_nodes = {p.node.name for p in seg.placements}
        seg_end = offset

        for node in graph.nodes:
            if node.name in processed:
                continue
            if node.is_cim:
                if node.name not in seg_nodes:
                    continue   # mapped in a later segment
            else:
                # ALU node: defer until all predecessors are scheduled
                # (a missing pred can only be a later-segment CIM node,
                # since graph.nodes and the segment list share topo order)
                if any(pr.name not in info for pr in graph.predecessors(node)):
                    continue

            if node.is_cim:
                # schedule only the chunks mapped in THIS segment
                start = ready_time(node, offset)
                acc = chunk_acc.setdefault(node.name, [])
                for p in seg.placements:
                    if p.node.name != node.name:
                        continue
                    cyc = p.stage_cycles
                    compute += cyc
                    n_stages += 1
                    acc.append((start, start + cyc))
                    ax = peak_active_xbs(p, stagger)
                    if ax > 0 and cyc > 0:
                        intervals.append((start, start + cyc, ax))
                    seg_end = max(seg_end, start + cyc)
                if len(acc) < len(placements_of[node.name]):
                    continue   # remaining chunks live in later segments
                processed.add(node.name)
                info[node.name] = _Info(start=min(s for s, _ in acc),
                                        finish=max(e for _, e in acc))
                seg_end = max(seg_end, info[node.name].finish)
                continue

            processed.add(node.name)
            start = ready_time(node, offset)
            if _is_standalone_alu(node, graph):
                cyc = _alu_stage_cycles(node, graph, arch)
                compute += cyc
                n_stages += 1
                finish = start + cyc
            else:
                # fused streaming op: completes with its slowest producer
                preds = [info[p.name].finish
                         for p in graph.predecessors(node) if p.name in info]
                finish = max(preds + [start])
            info[node.name] = _Info(start=start, finish=finish)
            seg_end = max(seg_end, finish)
        prev_duration = seg_end - seg_start
        offset = seg_end

    # trailing ALU nodes whose producers were deferred (rare)
    for node in graph.nodes:
        if node.name in processed or node.is_cim:
            continue
        if all(pr.name in info for pr in graph.predecessors(node)):
            start = ready_time(node, offset)
            if _is_standalone_alu(node, graph):
                cyc = _alu_stage_cycles(node, graph, arch)
                compute += cyc
                n_stages += 1
                finish = start + cyc
            else:
                preds = [info[p.name].finish
                         for p in graph.predecessors(node) if p.name in info]
                finish = max(preds + [start])
            info[node.name] = _Info(start=start, finish=finish)
            offset = max(offset, finish)

    latency = max(offset, *(i.finish for i in info.values()), 1e-9) \
        if info else 1e-9

    # peak power sweep
    events: List[Tuple[float, float]] = []
    energy = 0.0
    for s, e, ax in intervals:
        events.append((s, ax))
        events.append((e, -ax))
        energy += ax * (e - s)
    events.sort()
    peak = cur = 0.0
    for _, delta in events:
        cur += delta
        peak = max(peak, cur)

    # crossbars physically occupied: segments execute serially and reuse
    # (overwrite) the pool, so the footprint is the busiest segment's.
    xbs_used = max((sum(p.dup * p.mapping.n_xbs for p in seg.placements)
                    for seg in plan.segments), default=0)

    return PerfReport(
        latency_cycles=latency,
        compute_cycles=compute,
        rewrite_cycles=rewrites,
        peak_active_xbs=peak,
        peak_power=peak,
        avg_active_xbs=energy / latency,
        energy_units=energy,
        n_segments=len(plan.segments),
        n_stages=n_stages,
        pipeline=pipeline,
        stagger=stagger,
        remap=plan.vvm_remap,
        crossbars_used=xbs_used,
    )
