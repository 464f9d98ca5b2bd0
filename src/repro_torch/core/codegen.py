"""Meta-operator flow generation (§3.3.2-3.3.4 "Meta-operator Flow
Generation" paragraphs; worked example §3.4 / Figure 16).

Translates a ``SchedulePlan`` into the meta-operator ``Program``:

  * CM  — ``parallel { cim.read_core(...) }`` per duplicated copy, DCOM
    ops for CIM-unsupported operators, ``mov`` for explicit transfers.
  * XBM — ``cim.write_xb`` weight programming, then per window:
    ``mov(L0->L1)``; ``parallel { cim.read_xb ... }``; shift-accumulate;
    ``mov(L1->L0)``.
  * WLM — ``cim.write_row`` programming honoring the VVM remap, then
    ``parallel { cim.read_row(row_addr, len=parallel_row) ... }``.

Large flows are Loop-compressed (the paper's "256 similar code segments");
``expand=True`` materializes every window with concrete indices so the
functional simulator can interpret the flow.
"""
from __future__ import annotations

import math
from typing import Dict, List

from .abstraction import CIMArch, ComputingMode
from .cg_opt import OpPlacement, SchedulePlan
from .graph import Graph, Node, out_elems
from . import mop
from .mop import Loop, MetaOp, Parallel, Program, Stmt

# DCOM kind for each CIM-unsupported graph op
_DCOM_OF = {
    "Relu": "relu", "Gelu": "gelu", "Silu": "silu", "Sigmoid": "sigmoid",
    "Tanh": "tanh", "Add": "add", "Mul": "mul", "MaxPool": "maxpool",
    "AveragePool": "avgpool", "GlobalAveragePool": "avgpool",
    "Softmax": "softmax", "LayerNorm": "layernorm", "RMSNorm": "rmsnorm",
    "MatMul": "matmul", "Embedding": "embedding", "SSMScan": "ssm_scan",
    "RoPE": "rope", "TopKRouter": "topk_router", "Softcap": "softcap",
    "Flatten": "flatten", "Reshape": "reshape", "Concat": "concat",
    "Split": "split", "Identity": "identity", "Transpose": "transpose",
    "Constant": "const",
}

MAX_EXPANDED_OPS = 500_000


class _BufferAllocator:
    """Bump allocator assigning L0 byte offsets to graph tensors."""

    def __init__(self, graph: Graph, act_bits: int):
        self.graph = graph
        self.act_bits = act_bits
        self.offsets: Dict[str, int] = {}
        self.top = 0

    def addr(self, tensor: str) -> int:
        if tensor not in self.offsets:
            self.offsets[tensor] = self.top
            nbytes = out_bytes(self.graph, tensor, self.act_bits)
            self.top += nbytes
        return self.offsets[tensor]


def out_bytes(graph: Graph, tensor: str, act_bits: int) -> int:
    shape = graph.shapes.get(tensor, (1,))
    return max(1, math.prod(shape) * act_bits // 8)


def emit(plan: SchedulePlan, expand: bool = False) -> Program:
    arch, graph = plan.arch, plan.graph
    alloc = _BufferAllocator(graph, arch.act_bits)
    stmts: List[Stmt] = []
    level = plan.notes.get("level", arch.mode)

    # map node name -> its placements (chunks) for quick lookup
    by_node: Dict[str, List[OpPlacement]] = {}
    seg_of: Dict[str, int] = {}
    for si, seg in enumerate(plan.segments):
        for p in seg.placements:
            by_node.setdefault(p.node.name, []).append(p)
            seg_of[p.node.name] = si

    core_cursor = 0

    def assign_cores(p: OpPlacement) -> int:
        nonlocal core_cursor
        base = core_cursor
        core_cursor += p.dup * p.cores
        if core_cursor > arch.chip.n_cores:  # wrap (segments reuse cores)
            core_cursor = p.dup * p.cores
            base = 0
        return base

    emitted_nodes = set()
    for si, seg in enumerate(plan.segments):
        core_cursor = 0
        seg_nodes = {p.node.name for p in seg.placements}
        # 1. weight programming for XBM/WLM-visible levels
        if level.allows(ComputingMode.XBM):
            init: List[Stmt] = []
            for p in seg.placements:
                base = assign_cores(p)
                p.node.sched["core_base"] = base
                init.extend(_emit_writes(p, arch, level, base))
            if init:
                stmts.append(Loop(init, 1, note=f"segment {si}: program weights"))
        else:
            for p in seg.placements:
                p.node.sched["core_base"] = assign_cores(p)

        # 2. compute flow in topological order
        for node in graph.nodes:
            if node.name in emitted_nodes:
                continue
            if node.is_cim:
                if node.name not in seg_nodes:
                    continue
                emitted_nodes.add(node.name)
                for p in by_node[node.name]:
                    stmts.extend(_emit_cim_compute(p, plan, alloc, level, expand))
            else:
                # emit an ALU node once ALL its producers are emitted
                # (a missing one lives in a later segment — retry there)
                preds = plan.graph.predecessors(node)
                if any(pr.name not in emitted_nodes for pr in preds):
                    continue
                emitted_nodes.add(node.name)
                stmts.append(_emit_dcom(node, graph, alloc))

    # trailing ALU nodes whose producers landed in the final segment
    for node in graph.nodes:
        if node.name in emitted_nodes or node.is_cim:
            continue
        if all(pr.name in emitted_nodes for pr in graph.predecessors(node)):
            emitted_nodes.add(node.name)
            stmts.append(_emit_dcom(node, graph, alloc))

    prog = Program(name=f"{graph.name}@{arch.name}:{level.value}", stmts=stmts,
                   meta={"arch": arch.name, "graph": graph.name,
                         "level": level.value,
                         "segments": len(plan.segments)})
    if expand:
        prog = prog.expand()
        n = sum(prog.op_counts().values())
        if n > MAX_EXPANDED_OPS:
            raise ValueError(f"expanded flow too large ({n} ops); "
                             "use expand=False for this graph")
    return prog


def _emit_writes(p: OpPlacement, arch: CIMArch, level: ComputingMode,
                 core_base: int) -> List[Stmt]:
    """cim.write_xb / cim.write_row programming ops for one placement."""
    out: List[Stmt] = []
    m = p.mapping
    wlm = level.allows(ComputingMode.WLM)
    for copy in range(p.dup):
        xb_idx = 0
        for rt in range(m.grid_r):
            for ct in range(m.grid_c):
                core = core_base + (copy * p.cores +
                                    xb_idx // arch.core.n_xbs)
                xb = xb_idx % arch.core.n_xbs
                if wlm and p.row_spread > 1:
                    rows = arch.xb.rows if rt < m.grid_r - 1 else m.rows_used_last
                    grp = arch.xb.parallel_row
                    n_grp = max(1, math.ceil(rows / grp))
                    for part in range(min(p.row_spread, n_grp)):
                        out.append(mop.write_row(
                            row_addr=(core, xb, part, 0),
                            value=f"{p.node.name}.w[r{rt},c{ct},s{part}]",
                            op=p.node.name, copy=copy, row_tile=rt,
                            col_tile=ct, spread=part, chunk=p.chunk))
                else:
                    out.append(mop.write_xb(
                        xb_addr=(core, xb), mat=f"{p.node.name}.w[r{rt},c{ct}]",
                        op=p.node.name, copy=copy, row_tile=rt, col_tile=ct,
                        chunk=p.chunk))
                xb_idx += 1
    return out


def _emit_cim_compute(p: OpPlacement, plan: SchedulePlan,
                      alloc: _BufferAllocator, level: ComputingMode,
                      expand: bool) -> List[Stmt]:
    arch = plan.arch
    node = p.node
    src = alloc.addr(node.inputs[0])
    dst = alloc.addr(node.outputs[0])
    core_base = node.sched.get("core_base", 0)

    if level == ComputingMode.CM:
        block = Parallel([
            mop.read_core(op=node.op_type.lower(), core_addr=core_base + c,
                          src=src, dst=dst, node=node.name, copy=c,
                          chunk=p.chunk)
            for c in range(p.dup)
        ]) if p.dup > 1 else mop.read_core(
            op=node.op_type.lower(), core_addr=core_base, src=src, dst=dst,
            node=node.name, copy=0, chunk=p.chunk)
        return [block]

    m = p.mapping
    windows_per_copy = math.ceil(p.n_mvm / p.dup)
    wlm = level.allows(ComputingMode.WLM)

    def window_block(w) -> List[Stmt]:
        reads: List[Stmt] = []
        for copy in range(p.dup):
            xb_idx = 0
            for rt in range(m.grid_r):
                for ct in range(m.grid_c):
                    core = core_base + (copy * p.cores +
                                        xb_idx // arch.core.n_xbs)
                    xb = xb_idx % arch.core.n_xbs
                    common = dict(op=node.name, copy=copy, window=w,
                                  row_tile=rt, col_tile=ct, chunk=p.chunk)
                    if wlm:
                        rows = arch.xb.rows if rt < m.grid_r - 1 else m.rows_used_last
                        k = p.row_spread
                        n_grp = max(1, math.ceil(rows / arch.xb.parallel_row))
                        for part in range(min(k, n_grp)):
                            reads.append(mop.read_row(
                                row_addr=(core, xb, part, 0),
                                length=arch.xb.parallel_row,
                                spread=part, **common))
                    else:
                        reads.append(mop.read_xb(xb_addr=(core, xb),
                                                 length=1, **common))
                    xb_idx += 1
        body: List[Stmt] = [mop.mov(src=f"L0+{src}", dst="L1", length=m.r,
                                    op=node.name, window=w)]
        body.append(Parallel(reads) if len(reads) > 1 else reads[0])
        if m.grid_r > 1:
            body.append(mop.dcom("shift_acc", op=node.name, window=w,
                                 parts=m.grid_r))
        body.append(mop.mov(src="L1", dst=f"L0+{dst}", length=m.c,
                            op=node.name, window=w))
        return body

    if expand:
        out: List[Stmt] = []
        for w in range(windows_per_copy):
            out.extend(window_block(w))
        return out
    return [Loop(window_block("w"), windows_per_copy,
                 note=f"{node.name}: {windows_per_copy} windows x "
                      f"{p.dup} copies")]


def _emit_dcom(node: Node, graph: Graph, alloc: _BufferAllocator) -> MetaOp:
    kind = _DCOM_OF.get(node.op_type)
    if kind is None:
        raise ValueError(f"no DCOM lowering for {node.op_type}")
    attrs = dict(node=node.name)
    srcs = [alloc.addr(t) for t in node.inputs]
    if kind == "add" and len(srcs) >= 2:
        attrs.update(src1=srcs[0], src2=srcs[1])
    elif srcs:                          # a Constant reads no tensor
        attrs.update(src=srcs[0])
    attrs["dst"] = alloc.addr(node.outputs[0])
    attrs["len"] = out_elems(node, graph.shapes)
    return mop.dcom(kind, **attrs)
