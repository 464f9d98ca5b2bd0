"""Trace-lowered batched executor for compiled meta-operator flows.

The op-by-op interpreter (cimsim.functional.FunctionalSimulator) walks
the expanded Program in Python, dispatching one MVM per crossbar tile
with a host<->device round-trip each time.  This module lowers a
compiled ``(SchedulePlan, Program)`` **once** into a flat batched
program over device tensors with the same bit-exact semantics:

  * ``cim.write_xb`` / ``cim.write_row`` become ahead-of-time weight
    packing: every node's crossbar tiles are sliced out of the weight
    matrix, offset-encoded, and stacked into device-resident tensors
    (``pack``);
  * all ``cim.read_xb`` / ``cim.read_row`` / ``cim.read_core`` ops of a
    node collapse into batched MVM invocations — tiles ride the leading
    tile axis of ``kernels.cim_mvm.cim_mvm_tiles`` (saturating-ADC
    configs; on the card one CUDA kernel launch per dispatch), or the
    whole node folds into a single matrix product (the provably-exact
    ADC case);
  * ``shift_acc``, requantization and the DCOM operators run as tensor
    ops on the same device.  The float-reference ops stay bit-identical
    to the NumPy float64 reference.  On an operand that lowering proves
    int8-range (``_int8_range``) an elementwise one becomes a gather
    from a 256-entry table that the reference itself filled at
    lowering, and a row reduction (Softmax, LayerNorm, RMSNorm) runs on
    the device in the reference's float64 operations and summation
    order (``_row_dcom``); an operand of unknown range, or a Softmax
    whose scale is not positive, makes a host round-trip into it;
  * an ``MoE`` node sums each held expert's gated output rows: an
    expert whose input a chain of row-wise nodes computes from one row
    tensor alone (``_expert_chain``) runs that chain on the rows its
    router sent it, gathered, and scatters them back, so the crossbar
    kernel's row count follows the routing;
  * every tensor carries a leading batch axis, so N inferences execute
    in one pass (``run_batch``);
  * **multi-segment schedules stream weight updates**: when the compile
    reprograms crossbars between segments, the lowering models the
    physical crossbar pool as one device tensor per tile shape whose
    slots are rewritten at every segment boundary — each node reads its
    tiles from the pool as *its* segment left it, and the pool, not the
    sum of all segments' weights, is the crossbar working set.  It is
    on exactly when ``len(plan.segments) > 1``;
  * **device faults fold in at lowering** (``faults=``, a
    ``cimsim.faults.FaultMap``): each tile span's weight transform is
    applied while packing, and the per-span post-MVM ADC offsets become
    int32 device tensors, one per dispatch, added to its partial sums —
    the same per-span functions the interpreter applies per read.

The program runs eagerly in PyTorch; the per-dispatch index tensors
(im2col and pooling gathers, tile row and column maps) are built on the
device once, at lowering.

How the MVM executes — the CUDA kernel or the plain PyTorch version — is
a ``kernels.backend`` registry decision made at lowering for the
executor's device (``ExecutorStats.kernel_mode``).  A route the registry
cannot satisfy raises ``KernelUnsupportedError``; it is never turned
into ``LoweringError``, so no caller silently trades the kernel for the
interpreter.

Lowering is cached process-wide, keyed by the *content* of the compile
(``compiler.compile_key_for_plan``) x the crossbar compute params x the
route x the device x the fault map's identity (``FaultMap.token``).
Weights and requantization shifts are runtime inputs: the same
executable serves any weight set (re-``pack``) and any shift table.

The interpreter remains the bit-exact oracle; tests sweep the executor
against it across chip modes, saturating-ADC configs and batch sizes.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..core.abstraction import CIMArch
from ..core.cg_opt import OpPlacement, SchedulePlan
from ..core.graph import Graph, Node, weight_matrix_shape
from ..core.mop import Program
from ..kernels import backend
from ..kernels.cim_mvm import CimMvmParams, cim_mvm_params, cim_mvm_tiles
from ..kernels.cim_mvm.kernel import operand_dtype
from .functional import (_float_dcom, apply_dcom, causal_mask,
                         chunk_offsets, constant_value, rope_layout,
                         rope_tables, spread_slice, tile_ranges,
                         weights_numpy)

_INT32_MAX = 2 ** 31 - 1

#: largest weight-matrix R for which the exact-ADC path may use the
#: split-plane f32 GEMM: per-plane |partial| <= R * 128 * 15 must stay
#: under 2^24 (the f32 exact-integer range), so R <= 8192 is safe.
_F32_SPLIT_MAX_R = 8192

#: DCOM graph ops the lowering can run (parity with apply_dcom).
_SUPPORTED_DCOM = {
    "Relu", "Add", "Mul", "MaxPool", "AveragePool", "GlobalAveragePool",
    "Flatten", "Reshape", "Identity", "Transpose", "Concat", "Split",
    "MatMul", "Gelu", "Silu", "Sigmoid", "Tanh", "Softmax", "LayerNorm",
    "RMSNorm", "Constant", "RoPE", "TopKRouter", "MoE", "Clip",
}

#: ops whose lowering consumes a calibrated requantization shift
_SHIFTED_DCOM = {"Add", "Mul", "MatMul", "MoE"}

#: float-reference ops elementwise over one operand: on an int8-range
#: operand each answer is one of 256, gathered from a table on the device
_TABLE_DCOM = {"Gelu", "Silu", "Sigmoid", "Tanh"}

#: float-reference ops reducing over the last axis: on an int8-range
#: operand they run on the device in the reference's order
_ROW_DCOM = {"Softmax", "LayerNorm", "RMSNorm"}

#: every float-reference op
_FLOAT_DCOM = _TABLE_DCOM | _ROW_DCOM

#: ops whose output is clamped or clipped to [-128, 127] (crossbar nodes
#: too); ``Constant`` draws from that range
_INT8_OUT = _FLOAT_DCOM | {"Add", "Mul", "MatMul", "Constant", "RoPE",
                           "TopKRouter", "MoE"}

#: ops that map each row of their operands to the same row of their
#: output: a held expert's chain of them runs on its routed rows alone
_ROW_WISE = _TABLE_DCOM | {"Gemm", "Linear", "Relu", "Add", "Mul",
                           "Identity"}

#: buckets of the ``executor_expert_rows`` histogram
_ROW_BUCKETS = (0, 16, 64, 256, 1024, 4096, 16384)

#: ops whose output stays in the range of their inputs
_INT8_KEEP = {"Relu", "MaxPool", "AveragePool", "GlobalAveragePool",
              "Flatten", "Reshape", "Identity", "Transpose", "Split",
              "Concat"}


class LoweringError(ValueError):
    """The program cannot be lowered bit-exactly (unsupported op or
    int32 overflow risk); callers should fall back to the interpreter."""


class TileRangeError(RuntimeError):
    """An offset-encoded crossbar tile left the kernel's operand range.
    Not a ``ValueError``: callers that treat a ``ValueError`` as an
    infeasible plan or a ``LoweringError`` as a cue to fall back must not
    mistake a packing fault for either."""


@dataclasses.dataclass
class ExecutorStats:
    """Lowering statistics (shape of the flattened program)."""

    cim_nodes: int = 0
    dcom_nodes: int = 0
    table_dcom_nodes: int = 0  # float ops gathered from a device table
    row_dcom_nodes: int = 0    # float ops run as row reductions on the device
    host_dcom_nodes: int = 0   # float ops run by a host round trip
    causal_softmax_nodes: int = 0  # causal Softmax nodes among the row ops
    rope_nodes: int = 0        # rotary embeddings, float64 on the device
    moe_nodes: int = 0         # expert combines, each held expert routed
    units: int = 0          # crossbar read units folded into dispatches
    dispatches: int = 0     # batched MVM invocations per forward
    matmul_nodes: int = 0   # exact-ADC nodes lowered to one matrix product
    segments: int = 1       # schedule segments of the compiled plan
    streamed: bool = False  # weight-update streaming active (multi-segment)
    swaps: int = 0          # segment-boundary weight-pool updates
    kernel_mode: str = ""   # resolved cim_mvm_tiles route (backend registry)

    @property
    def cim_reads(self) -> int:   # SimStats-compatible accessor
        return self.units


@dataclasses.dataclass(frozen=True)
class _Expert:
    """One held expert of an ``MoE`` node: the nodes that compute its
    input ``out`` from the row tensor ``source`` alone, each row from
    the same row, so they run on the rows routed to the expert."""

    expert: int                      # the expert's index in the router
    source: str
    nodes: Tuple[Node, ...]          # in graph order
    out: str


@dataclasses.dataclass(frozen=True)
class _Bucket:
    """Same-shaped crossbar tiles of one node, batched into one call."""

    spans: Tuple[Tuple[int, int, int, int], ...]   # (r0, r1, c0, c1) per tile
    r_len: int
    c_len: int

    @property
    def key(self) -> str:
        return f"{self.r_len}x{self.c_len}"


@dataclasses.dataclass(frozen=True)
class _StreamGroup:
    """Same-shaped tiles of one node living in one schedule segment.

    The streamed twin of ``_Bucket``: tiles are not packed per node but
    occupy slots ``[lo, hi)`` of the shared per-shape crossbar pool for
    the duration of segment ``seg`` — the node's dispatch slices them
    out of the pool while it holds that segment's tiles.
    """

    seg: int
    spans: Tuple[Tuple[int, int, int, int], ...]
    r_len: int
    c_len: int
    lo: int                          # first pool slot
    hi: int                          # one past the last pool slot

    @property
    def key(self) -> str:
        return f"{self.r_len}x{self.c_len}"


@dataclasses.dataclass
class _CimPlan:
    """Static lowering of one CIM node."""

    node: Node
    r: int
    c: int
    exact: bool                      # single-matmul path (ADC never clips)
    buckets: List[_Bucket]
    vector_in: bool                  # unbatched input was 1-D
    conv_out: Optional[Tuple[int, int, int]] = None   # (cout, oh, ow)
    im2col_idx: Optional[torch.Tensor] = None         # (M, C*k*k) gather
    pad: int = 0
    stream_groups: Tuple[_StreamGroup, ...] = ()      # streamed mode only
    #: per dispatch (bucket or stream group, in order): the (T, r_len)
    #: weight-row index of each tile and the concatenated column index
    dispatch_idx: List[Tuple[torch.Tensor, torch.Tensor]] = \
        dataclasses.field(default_factory=list)
    #: per dispatch: the constant term of the offset-encoding correction
    #: (``r_len * 2^(ab-1) * 2^(wb-1)``, an int), or with a fault map
    #: whose offsets are not all zero that term plus its (T, 1, c_len)
    #: post-MVM offsets — one add either way
    dispatch_bias: List[Union[int, torch.Tensor]] = \
        dataclasses.field(default_factory=list)
    #: exact path: the fault map's (C,) post-MVM offsets, or None
    exact_off: Optional[torch.Tensor] = None


def _im2col_indices(cin: int, h: int, w: int, k: int, stride: int,
                    pad: int) -> np.ndarray:
    """Gather indices turning a flattened padded (C,Hp,Wp) image into the
    (H_out*W_out, C*k*k) patch matrix of functional.im2col."""
    hp, wp = h + 2 * pad, w + 2 * pad
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    ci, di, dj = np.meshgrid(np.arange(cin), np.arange(k), np.arange(k),
                             indexing="ij")
    patch = (ci * hp * wp + di * wp + dj).reshape(-1)        # (C*k*k,)
    ii, jj = np.meshgrid(np.arange(oh) * stride, np.arange(ow) * stride,
                         indexing="ij")
    base = (ii * wp + jj).reshape(-1)                        # (OH*OW,)
    return base[:, None] + patch[None, :]


def _pool_indices(h: int, w: int, k: int, stride: int, pad: int
                  ) -> np.ndarray:
    """(OH*OW, k*k) gather indices into a flattened padded (Hp,Wp) map."""
    wp = w + 2 * pad
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    di, dj = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    win = (di * wp + dj).reshape(-1)
    ii, jj = np.meshgrid(np.arange(oh) * stride, np.arange(ow) * stride,
                         indexing="ij")
    base = (ii * wp + jj).reshape(-1)
    return base[:, None] + win[None, :]


def _collect_units(program: Program, placements: Dict[Tuple[str, int],
                                                      OpPlacement],
                   graph: Graph, arch: CIMArch,
                   seg_of: Dict[Tuple[str, int], int]
                   ) -> Dict[str, List[Tuple[Tuple[int, int, int, int], int]]]:
    """Walk the (possibly Loop-compressed) program once and resolve every
    distinct crossbar read into a weight-matrix span (r0, r1, c0, c1)
    tagged with the schedule segment its chunk is placed in.

    Copies and windows are emission-side parallelism: every copy reads
    the same tiles and each window row is handled by exactly one copy,
    so the executor applies each distinct unit to *all* window rows.
    """
    seen: Dict[Tuple, None] = {}
    for op in program.walk(expand_loops=False):
        k = op.kind
        if k == "cim.read_core":
            seen.setdefault(("core", op.attrs["node"],
                             op.attrs.get("chunk", 0)))
        elif k in ("cim.read_xb", "cim.read_row"):
            a = op.attrs
            seen.setdefault((k, a["op"], a.get("chunk", 0),
                             a.get("row_tile", 0), a.get("col_tile", 0),
                             a.get("spread", 0)))
    units: Dict[str, List[Tuple[Tuple[int, int, int, int], int]]] = {}
    for key in seen:
        if key[0] == "core":
            _, name, chunk = key
            node = graph.node(name)
            p = placements[(name, chunk)]
            total_r, total_c = weight_matrix_shape(node)
            ro, co = chunk_offsets(node, p)
            span = (ro, min(ro + p.mapping.r, total_r),
                    co, min(co + p.mapping.c, total_c))
        else:
            kind, name, chunk, rt, ct, spread = key
            node = graph.node(name)
            p = placements[(name, chunk)]
            total_r, total_c = weight_matrix_shape(node)
            r0, r1, c0, c1 = tile_ranges(p, arch, rt, ct)
            ro, co = chunk_offsets(node, p)
            r_lo, r_hi = ro + r0, min(ro + r1, total_r)
            c_lo, c_hi = co + c0, min(co + c1, total_c)
            if r_hi <= r_lo or c_hi <= c_lo:
                continue
            if kind == "cim.read_row" and p.row_spread > 1:
                ss = spread_slice(r_hi - r_lo, arch.xb.parallel_row,
                                  p.row_spread, spread)
                if ss is None:
                    continue
                r_lo, r_hi = r_lo + ss[0], r_lo + ss[1]
            span = (r_lo, r_hi, c_lo, c_hi)
        if span[1] > span[0] and span[3] > span[2]:
            units.setdefault(name, []).append(
                (span, seg_of.get((name, key[2]), 0)))
    return units


class LoweredExecutable:
    """One compiled program, lowered to a batched tensor program on
    ``device``.

    Construction is pure analysis plus the device-resident index tensors.
    Weights enter through ``pack`` (ahead-of-time tile packing) and
    shifts are per-call inputs.
    """

    def __init__(self, plan: SchedulePlan, program: Program,
                 params: Optional[CimMvmParams] = None, *,
                 mode: Optional[str] = None,
                 route: Optional[backend.KernelRoute] = None,
                 device="cuda", faults=None):
        self.device = backend.resolve_device(device)
        #: optional cimsim.faults.FaultMap — tile weight transforms fold
        #: into ``pack`` and the per-tile post-MVM ADC offsets become
        #: device tensors built at lowering, one per dispatch
        self.faults = faults
        # the exact-ADC path's split-plane float32 GEMM is exact only in
        # full float32; TF32 keeps 10 mantissa bits
        torch.backends.cuda.matmul.allow_tf32 = False
        assert not torch.backends.cuda.matmul.allow_tf32
        self.plan = plan
        self.graph: Graph = plan.graph
        self.arch: CIMArch = plan.arch
        self.params = params or cim_mvm_params(plan.arch)
        self.route = route or backend.resolve("cim_mvm_tiles", mode,
                                              device=self.device)
        self._n_segments = max(1, len(plan.segments))
        # a multi-segment schedule reprograms crossbars: stream weights
        self._stream = self._n_segments > 1
        self.stats = ExecutorStats(segments=self._n_segments,
                                   streamed=self._stream,
                                   kernel_mode=self.route.mode)
        #: compile-key prefix linking this executable back to the span
        #: the compiler drew (set by ``lower`` when tracing is on); the
        #: first dispatch closes the compile→dispatch flow arrow
        self._flow_key: Optional[str] = None
        self._flow_done = False
        #: bound metric instruments for the dispatch hot path, cached
        #: per registry identity so a dispatch pays attribute access +
        #: a float add instead of two label-key constructions
        self._prof: Optional[tuple] = None
        self._disp_span = f"dispatch:{self.graph.name}"
        self._ox = 1 << (self.params.act_bits - 1)
        self._ow = 1 << (self.params.weight_bits - 1)
        #: the kernel's operand type: crossbar tiles are stored in it, so
        #: a dispatch converts nothing
        self._op_dtype = operand_dtype(self.params)

        unsupported = sorted({n.op_type for n in self.graph.nodes
                              if not n.is_cim and (
                                  n.op_type not in _SUPPORTED_DCOM
                                  or n.op_type == "TopKRouter"
                                  and "top_k" not in n.attrs)})
        if unsupported:
            raise LoweringError(f"no bit-exact lowering for {unsupported}")

        seg_of = {(p.node.name, p.chunk): si
                  for si, seg in enumerate(plan.segments)
                  for p in seg.placements}
        placements = {(p.node.name, p.chunk): p for p in plan.placements}
        units = _collect_units(program, placements, self.graph, self.arch,
                               seg_of)
        #: streamed-mode crossbar-pool layout: per (segment, shape key)
        #: the tiles resident there, in slot order (drives ``pack``)
        self._seg_layout: Dict[Tuple[int, str],
                               List[Tuple[str, Tuple[int, int, int, int]]]] \
            = {}
        self._seg_cursor: Dict[Tuple[int, str], int] = {}
        self._plans: Dict[str, _CimPlan] = {}
        for node in self.graph.cim_nodes:
            self._plans[node.name] = self._lower_cim_node(node,
                                                          units.get(node.name))
        #: per-shape pool depth = the largest simultaneous (per-segment)
        #: tile count — the device working set a real crossbar pool holds
        self._pool_shapes: Dict[str, Tuple[int, int, int]] = {}
        for (seg, key), n in self._seg_cursor.items():
            rl, cl = (int(v) for v in key.split("x"))
            depth = max(n, self._pool_shapes.get(key, (0,))[0])
            self._pool_shapes[key] = (depth, rl, cl)
        self.stats.swaps = len(self._seg_layout)
        self._pools: Optional[Dict[str, torch.Tensor]] = None
        self._pool_idx: Dict[str, torch.Tensor] = {}
        #: each Constant node's value, on the device once; a forward
        #: expands it over the batch without a copy
        self._consts: Dict[str, torch.Tensor] = {}
        for node in self.graph.nodes:
            if node.op_type == "Constant":
                self._consts[node.name] = self._dev(constant_value(node))
            if node.op_type in ("MaxPool", "AveragePool"):
                _, h, w = self.graph.shapes[node.inputs[0]]
                k = node.attrs.get("kernel", 2)
                self._pool_idx[node.name] = self._index(_pool_indices(
                    h, w, k, node.attrs.get("stride", k),
                    node.attrs.get("pad", 0)))
            if not node.is_cim:
                self.stats.dcom_nodes += 1
        #: each tabulated float op's answers to the operands -128..127,
        #: on the device; each row-reducing float op's Softmax exp table
        #: (``None`` for the norms), row length, a float64 device tensor,
        #: and a causal Softmax's (queries, keys) mask (else ``None``).
        #: The other float ops take the host round trip.  A router's
        #: Softmax takes the row route on the same terms
        self._tables: Dict[str, torch.Tensor] = {}
        self._row_ops: Dict[str, Tuple[Optional[torch.Tensor],
                                       torch.Tensor,
                                       Optional[torch.Tensor]]] = {}
        self._routers: Dict[str, Tuple[Optional[torch.Tensor],
                                       torch.Tensor,
                                       Optional[torch.Tensor]]] = {}
        exp_tables: Dict[float, torch.Tensor] = {}
        int8 = _int8_range(self.graph)
        for node in self.graph.nodes:
            routes = node.op_type == "TopKRouter"
            if not (node.op_type in _FLOAT_DCOM or routes) \
                    or node.inputs[0] not in int8:
                continue
            if node.op_type in _TABLE_DCOM:
                self._tables[node.name] = self._dev(
                    _float_host(node, np.arange(-128, 128)))
                continue
            exp = keep = None
            shape = self.graph.shapes[node.inputs[0]]
            if node.op_type in ("Softmax", "TopKRouter"):
                scale = node.attrs.get("scale", 1.0)
                if not scale > 0:
                    continue            # the host round trip
                if scale not in exp_tables:
                    exp_tables[scale] = self._dev(
                        _softmax_exp_table(scale), torch.float64)
                exp = exp_tables[scale]
                if node.attrs.get("causal"):
                    keep = torch.as_tensor(causal_mask(*shape[-2:]),
                                           device=self.device)
            row = (exp, self._dev(np.float64(shape[-1]), torch.float64), keep)
            (self._routers if routes else self._row_ops)[node.name] = row
        self.stats.table_dcom_nodes = len(self._tables)
        self.stats.row_dcom_nodes = len(self._row_ops)
        self.stats.causal_softmax_nodes = sum(
            self.graph.node(name).attrs.get("causal", False)
            for name in self._row_ops)
        self.stats.host_dcom_nodes = sum(
            n.op_type in _FLOAT_DCOM for n in self.graph.nodes) \
            - len(self._tables) - len(self._row_ops)
        #: each RoPE node's operand order (interleaved pairs to halves)
        #: and its cos and sin tables, float64 on the device, shaped to
        #: broadcast over a batch of its operands
        self._ropes: Dict[str, Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]] = {}
        for node in self.graph.nodes:
            if node.op_type == "RoPE":
                perm, tshape = rope_layout(
                    node, self.graph.shapes[node.inputs[0]])
                cos, sin = rope_tables(node, tshape[0])
                self._ropes[node.name] = (
                    self._index(perm),
                    self._dev(cos.reshape(tshape), torch.float64),
                    self._dev(sin.reshape(tshape), torch.float64))
        self.stats.rope_nodes = len(self._ropes)
        #: each MoE node's held experts, in its input order, with the
        #: chain run on the expert's routed rows (``None``: the expert's
        #: input is computed for every row, as any tensor is); the chains'
        #: nodes run inside their MoE node, not in graph order.  With
        #: them, the held experts' columns of the router's output
        self._moe: Dict[str, List[Optional[_Expert]]] = {}
        self._held: Dict[str, torch.Tensor] = {}
        for node in self.graph.nodes:
            if node.op_type == "MoE":
                self._moe[node.name] = [
                    _expert_chain(self.graph, node, e, t)
                    for e, t in zip(node.attrs["experts"], node.inputs[1:])]
                self._held[node.name] = self._index(node.attrs["experts"])
        self._in_moe = {n.name for chains in self._moe.values()
                        for c in chains if c is not None for n in c.nodes}
        self.stats.moe_nodes = len(self._moe)
        self._shift_names = sorted(
            [n.name for n in self.graph.nodes
             if n.is_cim or n.op_type in _SHIFTED_DCOM])

    def _index(self, idx: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx, np.int64), device=self.device)

    def dispatch_shapes(self, batch: int) -> List[Tuple[int, int, int, int]]:
        """(T, M, R, C) of every tile-batched MVM that one forward of
        ``batch`` inferences dispatches, in order (exact-ADC nodes fold
        into matrix products and dispatch none)."""
        out = []
        for node in self.graph.cim_nodes:
            cp = self._plans[node.name]
            if cp.exact:
                continue
            if cp.conv_out is not None:
                windows = cp.conv_out[1] * cp.conv_out[2]
            else:
                windows = 1 if cp.vector_in else \
                    self.graph.shapes[node.inputs[0]][0]
            for g in (cp.stream_groups if self._stream else cp.buckets):
                out.append((len(g.spans), batch * windows, g.r_len,
                            g.c_len))
        return out

    # -- lowering ---------------------------------------------------------
    def _lower_cim_node(self, node: Node,
                        tagged: Optional[Sequence[Tuple[
                            Tuple[int, int, int, int], int]]]
                        ) -> _CimPlan:
        total_r, total_c = weight_matrix_shape(node)
        if not tagged:
            raise LoweringError(f"{node.name}: no crossbar reads emitted")
        spans = [span for span, _ in tagged]
        covered = sum((r1 - r0) * (c1 - c0) for r0, r1, c0, c1 in spans)
        if covered != total_r * total_c:
            raise LoweringError(
                f"{node.name}: crossbar reads cover {covered} weight cells, "
                f"expected {total_r * total_c}")
        # int32 headroom: the signed accumulator is bounded by R*2^(ab+wb-2)
        # and each unit's unsigned partial by r_u*(2^ab-1)*(2^wb-1)
        ab, wb = self.params.act_bits, self.params.weight_bits
        max_r_u = max(r1 - r0 for r0, r1, _, _ in spans)
        if (total_r << (ab + wb - 2)) > _INT32_MAX or \
                max_r_u * ((1 << ab) - 1) * ((1 << wb) - 1) > _INT32_MAX:
            raise LoweringError(f"{node.name}: accumulation exceeds int32")

        by_shape: Dict[Tuple[int, int], List[Tuple[int, int, int, int]]] = {}
        for span in sorted(spans):
            r0, r1, c0, c1 = span
            by_shape.setdefault((r1 - r0, c1 - c0), []).append(span)
        buckets = [_Bucket(spans=tuple(group), r_len=rl, c_len=cl)
                   for (rl, cl), group in sorted(by_shape.items())]

        stream_groups: Tuple[_StreamGroup, ...] = ()
        if self._stream:
            # streamed mode: tiles live in the shared per-shape crossbar
            # pool only for their segment — group per (segment, shape)
            # and claim contiguous slots from that segment's cursor
            by_ss: Dict[Tuple[int, int, int],
                        List[Tuple[int, int, int, int]]] = {}
            for span, seg in sorted(tagged, key=lambda t: (t[1], t[0])):
                r0, r1, c0, c1 = span
                by_ss.setdefault((seg, r1 - r0, c1 - c0), []).append(span)
            groups = []
            for (seg, rl, cl), group in sorted(by_ss.items()):
                key = f"{rl}x{cl}"
                lo = self._seg_cursor.get((seg, key), 0)
                hi = lo + len(group)
                self._seg_cursor[(seg, key)] = hi
                self._seg_layout.setdefault((seg, key), []).extend(
                    (node.name, s) for s in group)
                groups.append(_StreamGroup(seg=seg, spans=tuple(group),
                                           r_len=rl, c_len=cl, lo=lo,
                                           hi=hi))
            stream_groups = tuple(groups)

        # streamed mode always rides the tile path: the pool models
        # physical crossbar residency, which the whole-matrix matmul
        # shortcut would bypass
        exact = self.params.exact and not self._stream
        self.stats.cim_nodes += 1
        self.stats.units += len(spans)
        self.stats.dispatches += len(stream_groups) if self._stream \
            else (1 if exact else len(buckets))
        self.stats.matmul_nodes += int(exact)

        cp = _CimPlan(node=node, r=total_r, c=total_c, exact=exact,
                      buckets=buckets,
                      vector_in=len(self.graph.shapes[node.inputs[0]]) == 1,
                      stream_groups=stream_groups)
        if not exact:
            for g in (stream_groups if self._stream else buckets):
                rows_idx = np.stack([np.arange(r0, r1)
                                     for r0, r1, _, _ in g.spans])
                col_idx = np.concatenate([np.arange(c0, c1)
                                          for _, _, c0, c1 in g.spans])
                cp.dispatch_idx.append((self._index(rows_idx),
                                        self._index(col_idx)))
                bias = g.r_len * self._ox * self._ow
                off = self._fault_offsets(node.name, g.spans)
                cp.dispatch_bias.append(bias if off is None else off + bias)
        elif self.faults is not None:
            cp.exact_off = self._fault_offsets(node.name, spans,
                                               total_c=total_c)
        if node.op_type == "Conv":
            cin, h, w = self.graph.shapes[node.inputs[0]]
            k = node.attrs["weight_shape"][2]
            cp.pad = node.attrs.get("pad", 0)
            cp.im2col_idx = self._index(_im2col_indices(
                cin, h, w, k, node.attrs.get("stride", 1), cp.pad))
            cout = node.attrs["weight_shape"][0]
            oh, ow = self.graph.shapes[node.outputs[0]][1:]
            cp.conv_out = (cout, oh, ow)
        return cp

    # -- fault folding ----------------------------------------------------
    def _fault_offsets(self, name: str, spans,
                       total_c: Optional[int] = None
                       ) -> Optional[torch.Tensor]:
        """The fault map's post-MVM ADC offsets of tile ``spans`` as an
        int32 device tensor, built once at lowering: a (T, 1, c_len)
        stack matching the tile axis of one batched MVM, or with
        ``total_c`` the exact path's (C,) aggregate (the spans partition
        the matrix and each span's offset lands once per window row, so
        columns sum over their row tiles).  ``None`` when every offset
        is zero or no fault map is active.  The interpreter adds
        ``tile_offset(name, span)`` to every span's partial sum; these
        are the same vectors folded per dispatch."""
        if self.faults is None:
            return None
        offs = [self.faults.tile_offset(name, s) for s in spans]
        if all(o is None for o in offs):
            return None
        if total_c is not None:
            off = np.zeros(total_c, np.int64)
            for s, o in zip(spans, offs):
                if o is not None:
                    off[s[2]:s[3]] += o
            return self._dev(off)
        c_len = spans[0][3] - spans[0][2]
        return self._dev(np.stack(
            [np.zeros(c_len, np.int64) if o is None else o
             for o in offs])[:, None, :])

    def _tile(self, name: str, span: Tuple[int, int, int, int],
              w: np.ndarray) -> np.ndarray:
        """Tile ``span`` of node ``name``'s signed matrix ``w``, under the
        fault map's weight transform when one is active."""
        r0, r1, c0, c1 = span
        if self.faults is None:
            return w[r0:r1, c0:c1]
        return self.faults.apply_tile(name, span, w[r0:r1, c0:c1])

    def _encode(self, tiles: np.ndarray) -> np.ndarray:
        """Offset-encode signed tiles for the crossbar (``w + 2^(wb-1)``).
        Fault transforms keep weights in the signed ``weight_bits``
        range, so the stored values still fit the kernel's operand type;
        a value outside it raises instead of wrapping."""
        w_u = tiles + self._ow
        if w_u.size and (int(w_u.min()) < 0
                         or int(w_u.max()) >= 2 * self._ow):
            raise TileRangeError(
                f"encoded crossbar tiles span [{int(w_u.min())}, "
                f"{int(w_u.max())}], outside [0, {2 * self._ow - 1}]")
        return w_u

    # -- weight packing ---------------------------------------------------
    def pack(self, weights: Dict[str, Any]) -> Dict[str, Any]:
        """Ahead-of-time weight programming: the ``cim.write_*`` ops.

        ``weights`` maps each CIM node to its signed (R, C) matrix, as
        numpy arrays or tensors (``functional.weights_from_reference``).
        Exact-ADC nodes keep their signed matrix; saturating configs get
        offset-encoded tile stacks plus the rank-1 column sums of the
        digital offset correction.

        Streamed (multi-segment) mode instead packs one offset-encoded
        tile stack **per (segment, tile shape)** in crossbar-pool slot
        order — the payloads written into the pool at each segment
        boundary.
        """
        reg = obs_metrics.active()
        tr = obs_trace.get_trace()
        if reg is None and tr is None:
            return self._pack_impl(weights)
        t0 = time.perf_counter()
        packed = self._pack_impl(weights)
        dt = time.perf_counter() - t0
        if reg is not None:
            reg.histogram("executor_pack_s").observe(dt)
        if tr is not None:
            name = self.graph.name
            tr.complete(obs_trace.EXECUTOR_TRACK, name, f"pack:{name}",
                        "executor", obs_trace.now_s() - dt, dt,
                        bytes=_packed_nbytes(packed),
                        segments=self._n_segments, streamed=self._stream)
        return packed

    def _dev(self, a: np.ndarray, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device).to(dtype)

    def _pack_impl(self, weights: Dict[str, Any]) -> Dict[str, Any]:
        mats = weights_numpy({name: weights[name] for name in self._plans})
        for name, cp in self._plans.items():
            if mats[name].shape != (cp.r, cp.c):
                raise ValueError(f"{name}: weights {mats[name].shape} != "
                                 f"{(cp.r, cp.c)}")
        if self._stream:
            segs: List[Dict[str, Any]] = []
            for si in range(self._n_segments):
                entry = {}
                for (seg, key), layout in self._seg_layout.items():
                    if seg != si:
                        continue
                    tiles = np.stack([self._tile(name, span, mats[name])
                                      for name, span in layout])
                    entry[key] = self._dev(self._encode(tiles),
                                           self._op_dtype)
                segs.append(entry)
            return {"segs": segs}
        packed: Dict[str, Any] = {}
        for name, cp in self._plans.items():
            w = mats[name]
            if cp.exact:
                if self.faults is not None:
                    # tile spans partition the matrix (coverage is
                    # checked at lowering), so per-span surgery yields
                    # the full effective matrix; values stay in the
                    # signed weight range, keeping the split-plane GEMM
                    # exact
                    w = w.copy()
                    for b in cp.buckets:
                        for s in b.spans:
                            w[s[0]:s[1], s[2]:s[3]] = self._tile(name, s, w)
                if cp.r <= _F32_SPLIT_MAX_R and self.params.act_bits <= 8 \
                        and self.params.weight_bits <= 8:
                    # split-plane GEMM: w = 16*w_hi + w_lo with w_hi in
                    # [-8,7], w_lo in [0,15]; each f32 partial product sum
                    # stays under 2^24 so the fast float GEMM is exact
                    packed[name] = {"hi": self._dev(w >> 4, torch.float32),
                                    "lo": self._dev(w & 15, torch.float32)}
                else:
                    packed[name] = {"w": self._dev(w, torch.float64)}
                continue
            entry: Dict[str, Any] = {}
            for b in cp.buckets:
                w_u = self._encode(np.stack([self._tile(name, s, w)
                                             for s in b.spans]))
                entry[b.key] = {
                    "w": self._dev(w_u, self._op_dtype),
                    "sw": self._dev(w_u.sum(axis=1, keepdims=True,
                                            dtype=np.int32)),
                }
            packed[name] = entry
        return packed

    # -- execution --------------------------------------------------------
    def run(self, inputs: Dict[str, np.ndarray],
            weights: Optional[Dict[str, np.ndarray]] = None,
            shifts: Optional[Dict[str, int]] = None, *,
            packed: Optional[Dict[str, Any]] = None
            ) -> Dict[str, np.ndarray]:
        """One inference on unbatched inputs (batch axis added/stripped)."""
        batched = {k: np.asarray(v)[None] for k, v in inputs.items()}
        out = self.run_batch(batched, weights, shifts, packed=packed)
        return {k: v[0] for k, v in out.items()}

    def run_batch(self, inputs: Dict[str, Any],
                  weights: Optional[Dict[str, np.ndarray]] = None,
                  shifts: Optional[Dict[str, int]] = None, *,
                  packed: Optional[Dict[str, Any]] = None,
                  spans: Optional[obs_trace.Spans] = None,
                  inputs_copied: Optional["torch.cuda.Event"] = None
                  ) -> Dict[str, np.ndarray]:
        """N inferences in one pass: every input carries a leading batch
        axis.  Pass ``packed=self.pack(weights)`` to amortize weight
        packing across calls.

        An input is a numpy array (cast as ``np.asarray(v, np.int32)``)
        or an int32 host tensor, which a caller may reuse from pass to
        pass: a pinned one is copied to the device without blocking, and
        ``inputs_copied``, if given, is recorded on the current stream
        once every input is on the device, so the caller can wait on it
        before writing the tensor again.  No output shares memory with a
        tensor input.

        Profiling happens here, at the dispatch boundary: the whole pass,
        which copying the outputs back to numpy synchronizes, is the
        timing unit.  Disabled telemetry costs two ``is None`` checks.
        With a recorder installed the pass is also split into spans:
        ``executor.inputs``, ``executor.forward`` with one span per
        graph node (and per kernel launch and host round trip inside
        it), ``executor.outputs``, all inside the pass's own
        ``dispatch:<graph>`` span.  They go to the caller's ``spans``
        (its row and ids, e.g. the service's ``dispatch``), else to the
        graph's row of the executor track.
        """
        reg = obs_metrics.active()
        tr = obs_trace.get_trace()
        if reg is None and tr is None:
            return self._run_batch_impl(inputs, weights, shifts,
                                        packed=packed,
                                        inputs_copied=inputs_copied)
        name = self.graph.name
        sp = None
        if tr is not None:
            sp = spans if spans is not None else obs_trace.Spans(
                tr, obs_trace.EXECUTOR_TRACK, name)
            ts0 = obs_trace.now_s()
        t0 = time.perf_counter()
        out = self._run_batch_impl(inputs, weights, shifts, packed=packed,
                                   spans=sp, inputs_copied=inputs_copied)
        dt = time.perf_counter() - t0
        if reg is not None:
            prof = self._prof
            if prof is None or prof[0] is not reg:
                prof = self._prof = (
                    reg,
                    reg.counter("executor_dispatches_total",
                                route=self.route.mode),
                    reg.histogram("executor_dispatch_s",
                                  route=self.route.mode))
            prof[1].inc()
            prof[2].observe(dt)
        if sp is not None:
            n = int(next(iter(out.values())).shape[0]) if out else 0
            now = sp.span(self._disp_span, ts0, batch=n,
                          route=self.route.mode, segments=self._n_segments,
                          swaps=self.stats.swaps)
            if self._flow_key is not None and not self._flow_done:
                # close the compile→dispatch arrow inside this span
                self._flow_done = True
                tr.flow_end(obs_trace.EXECUTOR_TRACK, name, "artifact",
                            "flow", (ts0 + now) / 2,
                            flow_id=int(self._flow_key[:12], 16),
                            key=self._flow_key[:12])
        return out

    def _run_batch_impl(self, inputs, weights=None, shifts=None, *,
                        packed=None, spans=None,
                        inputs_copied=None) -> Dict[str, np.ndarray]:
        if packed is None:
            if weights is None:
                raise ValueError("need weights=... or packed=...")
            packed = self.pack(weights)
        shifts = shifts or {}
        sh = {name: int(shifts.get(name, 0)) for name in self._shift_names}
        if spans is not None:
            t = obs_trace.now_s()
        xs, held, pinned = {}, [], False
        for name, v in inputs.items():
            if isinstance(v, torch.Tensor) and v.dtype == torch.int32:
                pin = v.is_pinned()
                pinned |= pin
                xs[name] = v.to(self.device, non_blocking=pin)
                held.append(v)
            else:
                xs[name] = torch.as_tensor(np.asarray(v, np.int32),
                                           device=self.device)
        if inputs_copied is not None:
            inputs_copied.record()
        if spans is not None:
            t = spans.span("executor.inputs", t, pinned=pinned,
                           bytes=sum(_packed_nbytes(x) for x in xs.values()))
        with torch.no_grad():
            out = self._forward(packed, sh, xs, spans)
        if spans is not None:
            t = spans.span("executor.forward", t)
        res = {name: _host_copy(v, held) for name, v in out.items()}
        if spans is not None:
            spans.span("executor.outputs", t,
                       bytes=sum(int(v.nbytes) for v in res.values()))
        return res

    # -- the batched program ----------------------------------------------
    def _pool_slice(self, segs, g: _StreamGroup,
                    loaded: Dict[str, int]) -> torch.Tensor:
        """Slots ``[g.lo, g.hi)`` of the ``g.key`` crossbar pool as
        segment ``g.seg`` programmed them.

        One pool tensor per tile shape, rewritten in place: when a
        dispatch needs a segment other than the one the pool holds, that
        segment's payload is copied into the pool's leading slots — the
        segment-boundary weight swap, applied in segment order as the
        nodes run.  A segment reads only slots its own payload wrote, so
        the pool needs no clearing between segments or forwards.
        """
        if self._pools is None:
            self._pools = {key: torch.zeros(shape, dtype=self._op_dtype,
                                            device=self.device)
                           for key, shape in self._pool_shapes.items()}
        pool = self._pools[g.key]
        if loaded.get(g.key) != g.seg:
            w = segs[g.seg][g.key]
            pool[:w.shape[0]].copy_(w)
            loaded[g.key] = g.seg
        return pool[g.lo:g.hi]

    def _forward(self, packed, shifts, inputs, spans=None):
        loaded: Dict[str, int] = {}          # pool key -> resident segment
        tensors: Dict[str, Any] = dict(inputs)
        for node in self.graph.nodes:
            if node.name not in self._in_moe:
                self._node(node, tensors, packed, shifts, loaded, spans)
        return {t: tensors[t] for t in self.graph.outputs}

    def _node(self, node: Node, tensors: Dict[str, Any], packed, shifts,
              loaded: Dict[str, int], spans=None) -> None:
        """Run ``node`` on ``tensors``, adding its outputs."""
        if spans is not None:
            t0 = obs_trace.now_s()
        if node.op_type == "MoE":
            tensors[node.outputs[0]] = self._moe_dispatch(
                node, tensors, packed, shifts, loaded, spans)
        elif node.op_type == "Constant":
            c = self._consts[node.name]
            n = next(iter(tensors.values())).shape[0]
            tensors[node.outputs[0]] = c.expand(n, *c.shape)
        elif node.is_cim:
            tensors[node.outputs[0]] = self._cim(
                node, tensors[node.inputs[0]], packed, shifts[node.name],
                loaded, spans)
        elif node.op_type == "Split":
            for name, part in zip(node.outputs,
                                  self._split(node, tensors[node.inputs[0]])):
                tensors[name] = part
        else:
            tensors[node.outputs[0]] = self._dcom(
                node, [tensors[t] for t in node.inputs], shifts, spans)
        if spans is not None:
            route = {} if node.op_type not in _FLOAT_DCOM else {
                "dcom": "table" if node.name in self._tables
                else "row" if node.name in self._row_ops
                else "host"}
            spans.span(node.op_type, t0, node=node.name,
                       cim=node.is_cim, **route)

    def _moe_dispatch(self, node: Node, tensors: Dict[str, Any], packed,
                      shifts, loaded: Dict[str, int], spans=None):
        """An MoE node: each held expert's gated output rows summed into
        one int64 accumulator and requantized by the node's shift.  An
        expert with a chain runs it on the rows routed to it alone
        (gathered, then scattered back with their gates): the host waits
        on the device here, to learn how many rows each expert takes.  A
        row routed to no held expert sums to 0."""
        chains = self._moe[node.name]
        gates = tensors[node.inputs[0]]
        lead = gates.shape[:-1]
        gates = gates.reshape(-1, gates.shape[-1])[:, self._held[node.name]]
        d = self.graph.shapes[node.outputs[0]][-1]
        acc = torch.zeros((gates.shape[0], d), dtype=torch.int64,
                          device=self.device)
        if spans is not None:
            t = obs_trace.now_s()
        # (held expert, row) of every routed pair, expert by expert
        picks = torch.nonzero((gates >= 0).t())
        counts = torch.bincount(picks[:, 0], minlength=len(chains)).tolist()
        if spans is not None:
            spans.span("moe.route", t, experts_held=len(chains),
                       routed_rows=int(sum(counts)))
        reg = obs_metrics.active()
        start = 0
        for j, chain in enumerate(chains):
            g = gates[:, j]
            if chain is None:
                y = tensors[node.inputs[1 + j]].reshape(-1, d)
                acc += torch.clamp(g, min=0)[:, None].to(torch.int64) \
                    * y.to(torch.int64)
                continue
            k = counts[j]
            rows = picks[start:start + k, 1]
            start += k
            if reg is not None:
                reg.histogram("executor_expert_rows", _ROW_BUCKETS).observe(k)
            if spans is not None:
                t = obs_trace.now_s()
            if k:
                src = tensors[chain.source]
                local = {chain.source:
                         src.reshape(-1, src.shape[-1])[rows][None]}
                for cn in chain.nodes:
                    self._node(cn, local, packed, shifts, loaded, spans)
                y = local[chain.out][0].to(torch.int64)
                acc.index_add_(0, rows, g[rows, None].to(torch.int64) * y)
            if spans is not None:
                spans.span("moe.expert", t, expert=chain.expert, rows=k)
        y = torch.clamp(acc >> shifts[node.name], -128, 127)
        return y.to(torch.int32).reshape(*lead, d)

    def _rows(self, node: Node, x):
        """(N, windows, R) MVM input rows (im2col for Conv)."""
        cp = self._plans[node.name]
        if node.op_type == "Conv":
            n = x.shape[0]
            p = cp.pad
            if p:
                x = F.pad(x, (p, p, p, p))
            return x.reshape(n, -1)[:, cp.im2col_idx]
        return x[:, None, :] if cp.vector_in else x

    def _cim(self, node: Node, x, packed, sh: int, loaded: Dict[str, int],
             spans=None):
        cp = self._plans[node.name]
        rows = self._rows(node, x)                     # (N, M, R)
        n, m, _ = rows.shape
        if cp.exact:
            pw = packed[node.name]
            if "hi" in pw:
                xf = rows.to(torch.float32)
                acc = ((xf @ pw["hi"]).to(torch.int32) << 4) \
                    + (xf @ pw["lo"]).to(torch.int32)
            else:
                # no int32 matrix product on CUDA; float64 is exact here,
                # since lowering bounded every sum inside int32
                acc = (rows.to(torch.float64) @ pw["w"]).to(torch.int32)
            if cp.exact_off is not None:
                acc = acc + cp.exact_off
        else:
            flat = (rows + self._ox).to(self._op_dtype).reshape(n * m, cp.r)
            acc = torch.zeros((n * m, cp.c), dtype=torch.int32,
                              device=self.device)
            groups = cp.stream_groups if self._stream else cp.buckets
            for g, (rows_idx, col_idx), bias in zip(
                    groups, cp.dispatch_idx, cp.dispatch_bias):
                xt = flat[:, rows_idx].transpose(0, 1)   # (T, NM, r_len)
                if self._stream:
                    # tiles come out of the pool as *this segment* left
                    # it; the offset correction's column sums follow it
                    w_u = self._pool_slice(packed["segs"], g, loaded)
                    sw = w_u.sum(dim=1, keepdim=True, dtype=torch.int32)
                else:
                    w_u = packed[node.name][g.key]["w"]
                    sw = packed[node.name][g.key]["sw"]
                if spans is not None:
                    t0 = obs_trace.now_s()
                y_u = cim_mvm_tiles(xt, w_u, self.params,
                                    mode=self.route.mode)
                if spans is not None:
                    spans.span("cim_mvm", t0, t=int(xt.shape[0]),
                               m=int(xt.shape[1]), r=int(xt.shape[2]),
                               c=int(w_u.shape[2]), route=self.route.mode)
                sx = xt.sum(dim=-1, keepdim=True, dtype=torch.int32)
                y = y_u - self._ow * sx - self._ox * sw + bias
                acc.index_add_(1, col_idx,
                               y.transpose(0, 1).reshape(n * m, -1))
            acc = acc.reshape(n, m, cp.c)
        y = torch.clamp(acc >> sh, -128, 127)
        if cp.conv_out is not None:
            cout, oh, ow = cp.conv_out
            return y.transpose(1, 2).reshape(n, cout, oh, ow)
        if cp.vector_in:
            return y[:, 0]
        return y

    def _split(self, node: Node, x):
        axis = node.attrs.get("axis", -1) % (x.dim() - 1) + 1
        return torch.split(x, list(node.attrs["parts"]), dim=axis)

    def _pool(self, node: Node, x, reduce_max: bool):
        k = node.attrs.get("kernel", 2)
        pad = node.attrs.get("pad", 0)
        n, c = x.shape[0], x.shape[1]
        if pad:
            fill = -(2 ** 31) if reduce_max else 0
            x = F.pad(x, (pad, pad, pad, pad), value=fill)
        win = x.reshape(n, c, -1)[:, :, self._pool_idx[node.name]]
        if reduce_max:
            red = win.amax(dim=-1)
        else:
            red = torch.div(win.sum(dim=-1, dtype=torch.int32), k * k,
                            rounding_mode="floor")
        oh, ow = self.graph.shapes[node.outputs[0]][1:]
        return red.reshape(n, c, oh, ow)

    def _dcom(self, node: Node, xs: List, shifts, spans=None):
        t = node.op_type
        if t == "Relu":
            return torch.clamp(xs[0], min=0)
        if t in ("Add", "Mul"):
            y = xs[0] + xs[1] if t == "Add" else xs[0] * xs[1]
            return torch.clamp(y >> shifts[node.name], -128, 127)
        if t == "MaxPool":
            return self._pool(node, xs[0], reduce_max=True)
        if t == "AveragePool":
            return self._pool(node, xs[0], reduce_max=False)
        if t == "GlobalAveragePool":
            hw = xs[0].shape[2] * xs[0].shape[3]
            return torch.div(
                xs[0].sum(dim=(2, 3), keepdim=True, dtype=torch.int32), hw,
                rounding_mode="floor")
        if t == "Flatten":
            return xs[0].reshape(xs[0].shape[0], -1)
        if t == "Reshape":
            return xs[0].reshape((xs[0].shape[0],)
                                 + tuple(node.attrs["shape"]))
        if t == "Identity":
            return xs[0]
        if t == "Transpose":
            perm = (0,) + tuple(q + 1 for q in node.attrs["perm"])
            return xs[0].permute(perm)
        if t == "Concat":
            axis = node.attrs.get("axis", -1)
            return torch.cat(xs, dim=axis if axis < 0 else axis + 1)
        if t == "Clip":
            return torch.clamp(xs[0], node.attrs["min"], node.attrs["max"])
        if t == "RoPE":
            perm, cos, sin = self._ropes[node.name]
            x = xs[0][..., perm].to(torch.float64)
            half = x.shape[-1] // 2
            rot = torch.cat((-x[..., half:], x[..., :half]), dim=-1)
            # two products and a sum, each rounded, as the reference
            y = x * cos + rot * sin
            return torch.clamp(torch.round(y), -128, 127).to(torch.int32)
        if t == "TopKRouter":
            return self._route(node, xs[0], spans)
        if t == "MatMul":
            b = xs[1]
            if node.attrs.get("transpose_b"):
                b = b.transpose(-1, -2)
            # no int32 matrix product on CUDA; the operands are int8-range
            # requantized activations, so float64 sums are exact
            y = (xs[0].to(torch.float64) @ b.to(torch.float64)) \
                .to(torch.int32)
            return torch.clamp(y >> shifts[node.name], -128, 127)
        # float-reference ops: the NumPy float64 path is the contract
        table = self._tables.get(node.name)
        if table is not None:
            # an int8-range operand: its answer is the table's entry
            idx = (xs[0] + 128).reshape(-1)
            return torch.index_select(table, 0, idx).view(xs[0].shape)
        row = self._row_ops.get(node.name)
        if row is not None:
            return _row_dcom(node.op_type, xs[0], *row)
        return self._host_dcom(node, xs[0], spans)

    def _host_dcom(self, node: Node, x, spans=None):
        """A float op's host round trip through the NumPy path
        (elementwise or over the last axis only, hence batch-transparent)."""
        if spans is not None:
            t0 = obs_trace.now_s()
        xh = x.cpu().numpy()
        if node.op_type == "TopKRouter":
            y = apply_dcom(node, [xh], self.graph, {}, False)
        else:
            y = _float_host(node, xh)
        out = torch.as_tensor(y, device=self.device)
        if spans is not None:
            spans.span("executor.host_dcom", t0, bytes=int(y.nbytes))
        return out

    def _route(self, node: Node, x, spans=None):
        """A TopKRouter on the device: its Softmax on the row route, each
        token's ``top_k`` largest weights kept as gates ``clamp(round(32 *
        w))`` and the other experts -1.  A stable sort gives equal
        weights to the lower expert index, as the NumPy path does."""
        row = self._routers.get(node.name)
        if row is None:
            return self._host_dcom(node, x, spans)
        w = _row_float("Softmax", x, *row)
        top = torch.argsort(-w, dim=-1, stable=True)[..., :node.attrs["top_k"]]
        routed = torch.zeros_like(w, dtype=torch.bool).scatter_(-1, top, True)
        q = torch.clamp(torch.round(w * 32.0), -128, 127).to(torch.int32)
        return torch.where(routed, q, -1)


def _float_host(node: Node, x: np.ndarray) -> np.ndarray:
    """The float-reference op ``node`` on the host: NumPy float64, then
    requantized to int8 as the interpreter does."""
    y = _float_dcom(node.op_type, [x], node)
    return np.clip(np.round(y * 32.0), -128, 127).astype(np.int32)


def _softmax_exp_table(scale: float) -> np.ndarray:
    """``np.exp(x*s - m*s)`` for every operand x and row max m in
    [-128, 127], at entry ``(x + 128) * 256 + m + 128``: the reference's
    exponentials of an int8-range Softmax, computed as it computes them.
    For s > 0 the row max of ``x*s`` is ``m*s``, since rounding is
    monotone."""
    x, m = np.meshgrid(np.arange(-128, 128, dtype=np.float64),
                       np.arange(-128, 128, dtype=np.float64),
                       indexing="ij")
    return np.exp(x * scale - m * scale).reshape(-1)


def _pairwise_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, kept, in NumPy's order for a contiguous
    row (``pairwise_sum`` of its ``loops_utils.h``): blocks of at most
    128 summed in 8 running lanes, longer rows split in two at
    ``n//2 - (n//2) % 8``.  So float64 sums equal ``np.add.reduce(v,
    axis=-1)`` bit for bit: only elementwise adds, each over all blocks
    of one length at once."""
    return _pairwise_blocks(v.unsqueeze(-2))


def _pairwise_blocks(v: torch.Tensor) -> torch.Tensor:
    """(..., k, n) -> (..., k): each of k rows of n summed as
    ``_pairwise_sum`` does."""
    n = v.shape[-1]
    if n < 8:
        s = torch.zeros_like(v[..., 0])
        for i in range(n):
            s = s + v[..., i]
        return s
    if n <= 128:
        end = n - n % 8
        r = v[..., :8]
        for i in range(8, end, 8):
            r = r + v[..., i:i + 8]
        r = r[..., 0::2] + r[..., 1::2]     # (r0+r1), (r2+r3), ...
        r = r[..., 0::2] + r[..., 1::2]     # ((r0+r1)+(r2+r3)), ...
        s = r[..., 0] + r[..., 1]
        for i in range(end, n):
            s = s + v[..., i]
        return s
    h = n // 2
    h -= h % 8
    if 2 * h == n:
        # equal halves: all 2k of them as rows of one call
        s = _pairwise_blocks(v.reshape(*v.shape[:-2], 2 * v.shape[-2], h))
        s = s.reshape(*v.shape[:-1], 2)
        return s[..., 0] + s[..., 1]
    return _pairwise_blocks(v[..., :h]) + _pairwise_blocks(v[..., h:])


def _row_dcom(op_type: str, x: torch.Tensor, exp: Optional[torch.Tensor],
              n: torch.Tensor, keep: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Softmax, LayerNorm or RMSNorm over the last axis of an int8-range
    ``x``, on its device, bit-equal to ``_float_host``."""
    y = _row_float(op_type, x, exp, n, keep)
    return torch.clamp(torch.round(y * 32.0), -128, 127).to(torch.int32)


def _row_float(op_type: str, x: torch.Tensor, exp: Optional[torch.Tensor],
               n: torch.Tensor, keep: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """``_row_dcom`` before requantization, bit-equal to ``_float_dcom``:
    the reference's float64 operations in its order.  ``exp`` is
    Softmax's ``_softmax_exp_table``; ``n`` the row length as a float64
    tensor on the device, since CUDA divides by a host scalar as a
    product with its reciprocal; ``keep`` a causal Softmax's mask over
    the last two axes: a masked score is left out of the row's max and
    its exponential is 0, in its place in the sum, as the reference's
    ``exp(-inf)``.  No fused op: a contracted multiply-add rounds once
    where the reference rounds twice."""
    if op_type == "Softmax":
        # -128 lifts no row's max: each row keeps at least one score
        m = x if keep is None else torch.where(keep, x, -128)
        m = m.amax(dim=-1, keepdim=True)
        idx = ((x + 128) * 256 + (m + 128)).reshape(-1)
        e = torch.index_select(exp, 0, idx).view(x.shape)
        if keep is not None:
            e = torch.where(keep, e, 0.0)
        y = e / _pairwise_sum(e)
    else:
        y = x.to(torch.float64)
        if op_type == "LayerNorm":
            # a sum of integers, exact in float64 in any order
            y = y - y.sum(dim=-1, keepdim=True) / n
        y = y / _sqrt(_pairwise_sum(y * y) / n + 1e-6)
    return y


def _sqrt(v: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as NumPy's: the card's
    ``torch.sqrt`` is, the CPU's (MKL's vector math) not always, so on
    the CPU, where the tensor is host memory, it is NumPy's."""
    if v.device.type == "cpu":
        return torch.from_numpy(np.sqrt(v.numpy()))
    return torch.sqrt(v)


def _expert_chain(graph: Graph, moe: Node, expert: int,
                  out: str) -> Optional[_Expert]:
    """The nodes that compute ``out``, one of ``moe``'s expert inputs,
    from one row tensor alone: walking back from ``out``, every
    ``_ROW_WISE`` node whose outputs only the chain and ``moe`` read
    (and no graph output is), with Gemms over (rows, features).  ``None``
    where they read more than one tensor from outside, or none."""
    chain: List[Node] = []
    names = {moe.name}
    need = {out}
    for node in reversed(graph.nodes):
        if not need.intersection(node.outputs):
            continue
        own = node.op_type in _ROW_WISE and (
            not node.is_cim or len(graph.shapes[node.inputs[0]]) == 2) and \
            not any(o in graph.outputs for o in node.outputs) and \
            all(c.name in names for o in node.outputs
                for c in graph.consumers(o))
        if own:
            chain.append(node)
            names.add(node.name)
            need.update(node.inputs)
    made = {o for n in chain for o in n.outputs}
    sources = {t for n in chain for t in n.inputs if t not in made}
    if not chain or len(sources) != 1:
        return None
    source = sources.pop()
    if len(graph.shapes[source]) != 2 or \
            graph.shapes[source][0] != graph.shapes[out][0]:
        return None
    return _Expert(expert=int(expert), source=source,
                   nodes=tuple(reversed(chain)), out=out)


def _int8_range(graph: Graph) -> set:
    """Names of the tensors that every forward keeps in [-128, 127]:
    the outputs of crossbar nodes and of ``_INT8_OUT`` ops, of a
    ``Clip`` into that range, and of ``_INT8_KEEP`` ops over such
    tensors alone.  Graph inputs are not among them: nothing clamps
    what a caller feeds."""
    marked = set()
    for node in graph.nodes:
        clip = node.op_type == "Clip" and node.attrs["min"] >= -128 \
            and node.attrs["max"] <= 127
        if node.is_cim or node.op_type in _INT8_OUT or clip or (
                node.op_type in _INT8_KEEP
                and all(t in marked for t in node.inputs)):
            marked.update(node.outputs)
    return marked


# ---------------------------------------------------------------------------
# Process-wide lowering cache
# ---------------------------------------------------------------------------

_LOWER_CACHE: "OrderedDict[Tuple, LoweredExecutable]" = OrderedDict()
_LOWER_CACHE_MAX = 32


def clear_lower_cache() -> None:
    _LOWER_CACHE.clear()


def _host_copy(v: torch.Tensor, held: List[torch.Tensor]) -> np.ndarray:
    """``v`` as a host numpy array that shares no memory with ``held``
    (the caller's input tensors, which it may overwrite): a device
    tensor's ``.cpu()`` is a fresh copy, a host tensor is copied only
    where it is a view of one of them."""
    a = v.cpu().numpy()
    if v.device.type == "cpu" and held:
        ptr = v.untyped_storage().data_ptr()
        if any(h.untyped_storage().data_ptr() == ptr for h in held):
            a = a.copy()
    return a


def _packed_nbytes(obj: Any) -> int:
    """Device bytes in a ``pack`` payload (recursive over the dict/list
    nesting; tensor leaves expose ``nbytes``)."""
    if hasattr(obj, "nbytes"):
        return int(obj.nbytes)
    if isinstance(obj, dict):
        return sum(_packed_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_packed_nbytes(v) for v in obj)
    return 0


def lower(plan: SchedulePlan, program: Program,
          params: Optional[CimMvmParams] = None, *,
          mode: Optional[str] = None,
          device="cuda", faults=None,
          cache: bool = True) -> LoweredExecutable:
    """Lower a compiled ``(plan, program)`` to a batched executable on
    ``device``.

    The MVM execution route is a backend-registry decision for that
    device (force with ``mode=``); multi-segment schedules stream
    weight updates.  ``faults`` (a ``cimsim.faults.FaultMap``) folds
    device faults into weight packing plus per-dispatch post-MVM
    offsets.

    Cached process-wide by ``compile_key_for_plan(plan) x params x
    resolved route x device x fault-map identity``, so repeated
    lowerings of the same compile config reuse the executable and its
    index tensors, and a clean caller never gets a faulted executable
    (or the reverse).
    """
    from ..core import compiler
    dev = backend.resolve_device(device)
    params = params or cim_mvm_params(plan.arch)
    route = backend.resolve("cim_mvm_tiles", mode, device=dev)
    streamed = len(plan.segments) > 1
    key = None
    if cache:
        key = (compiler.compile_key_for_plan(plan), params, route.mode,
               str(dev), None if faults is None else faults.token)
        hit = _LOWER_CACHE.get(key)
        if hit is not None:
            _LOWER_CACHE.move_to_end(key)
            return hit
    t0 = time.perf_counter()
    exe = LoweredExecutable(plan, program, params, route=route, device=dev,
                            faults=faults)
    dt = time.perf_counter() - t0
    obs_metrics.count("executor_lowerings_total")
    obs_metrics.observe("executor_lower_s", dt)
    tr = obs_trace.get_trace()
    if tr is not None:
        tr.complete(obs_trace.EXECUTOR_TRACK, plan.graph.name,
                    f"lower:{plan.graph.name}", "executor",
                    obs_trace.now_s() - dt, dt, route=route.mode,
                    segments=len(plan.segments), streamed=streamed)
        # remember the compile key so the first dispatch can close the
        # compile→dispatch flow arrow (ids match compile_graph's start)
        exe._flow_key = (key[0] if key is not None
                         else compiler.compile_key_for_plan(plan))
    if key is not None:
        _LOWER_CACHE[key] = exe
        while len(_LOWER_CACHE) > _LOWER_CACHE_MAX:
            _LOWER_CACHE.popitem(last=False)
    return exe
