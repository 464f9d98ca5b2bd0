"""Functional simulator (§4.1): interprets the meta-operator flow.

The paper verifies its compiler by executing the generated meta-operator
flows in a functional simulator and comparing against a reference
framework (a pure-NumPy int8 fake-quant reference here,
``reference_forward``).

The simulator walks the *expanded* Program op by op:

  * ``cim.write_xb`` / ``cim.write_row`` load quantized weight tiles into
    a crossbar store;
  * ``cim.read_xb`` / ``cim.read_row`` perform one analog activation —
    the bit-sliced, parallel-row-grouped, ADC-saturating MVM of
    kernels/cim_mvm, on the simulator's device (the CUDA kernel on the
    card, the plain version on the CPU) — and accumulate partial sums;
  * ``cim.read_core`` executes a whole operator on a core (CM chips);
  * DCOM ops apply the digital operators; ``mov`` is bookkeeping.

Equality with the reference is bit-exact whenever the ADC does not
saturate (``CimMvmParams.exact``); with a narrow ADC the simulator
reports the (hardware-true) saturated results.

Everything here but the crossbar MVM is NumPy.  Entry points that run
an MVM take ``device=`` (default ``"cuda"``; see
``kernels.backend.resolve_device``).
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.abstraction import CIMArch
from ..core.cg_opt import OpPlacement, SchedulePlan
from ..core.graph import Graph, Node, weight_matrix_shape
from ..core.mapping import logical_cols_per_xb
from ..core.mop import MetaOp, Program
from ..kernels.backend import resolve_device
from ..kernels.cim_mvm import cim_mvm, cim_mvm_params, CimMvmParams


# ---------------------------------------------------------------------------
# Quantization helpers (shared verbatim by simulator and reference)
# ---------------------------------------------------------------------------

def requant(y32: np.ndarray, shift: int) -> np.ndarray:
    """int32 accumulator -> int8 tensor via arithmetic right-shift."""
    return np.clip(y32 >> shift, -128, 127).astype(np.int32)


def pick_shift(y32: np.ndarray) -> int:
    m = int(np.abs(y32).max()) if y32.size else 0
    if m <= 127:
        return 0
    return max(0, int(math.ceil(math.log2((m + 1) / 127.0))))


def make_weights(graph: Graph, seed: int = 0,
                 bits: int = 8) -> Dict[str, np.ndarray]:
    """Deterministic signed int weights (R, C) per CIM node.

    Seeded with a stable digest of ``(node name, seed)`` — ``hash()`` of
    a str is salted per process, which would silently break cross-process
    reproducibility and any cache keyed on weight content.
    """
    out = {}
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1))
    for node in graph.cim_nodes:
        r, c = weight_matrix_shape(node)
        rng = np.random.default_rng(
            zlib.crc32(f"{node.name}\x00{seed}".encode()))
        out[node.name] = rng.integers(lo, hi, (r, c)).astype(np.int32)
    return out


def constant_value(node: Node) -> np.ndarray:
    """The int8 value of a ``Constant`` node (a learned tensor held
    outside the crossbars, such as ViT's class token and position
    table), drawn by one fixed rule from its name and ``seed`` attribute:
    ``torch.randint(-128, 128, shape)`` on the CPU from a generator
    seeded with ``zlib.crc32(f"{name}\\x00{seed}")``.  Returned as int32."""
    gen = torch.Generator().manual_seed(
        zlib.crc32(f"{node.name}\x00{node.attrs['seed']}".encode()))
    return torch.randint(-128, 128, tuple(node.attrs["shape"]),
                         generator=gen).numpy().astype(np.int32)


def make_input(graph: Graph, seed: int = 0, bits: int = 8) -> Dict[str, np.ndarray]:
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1))
    rng = np.random.default_rng(seed)
    return {name: rng.integers(lo, hi, shape).astype(np.int32)
            for name, shape in graph.inputs.items()}


def weights_from_reference(weights: Dict[str, np.ndarray],
                           shifts: Dict[str, int], params: CimMvmParams,
                           device="cuda"
                           ) -> Tuple[Dict[str, torch.Tensor],
                                      Dict[str, int]]:
    """Carry weights and calibrated shifts over from the JAX package.

    ``weights`` are its ``functional.make_weights`` output (signed integer
    (R, C) numpy arrays per CIM node) and ``shifts`` its calibrated
    requantization shifts.  Checks that every matrix is an integer array
    inside the signed ``weight_bits`` range, and returns the port's form:
    int32 tensors on ``device`` plus the shifts as plain ints — what
    ``CimBatchService(weights=, shifts=)`` and ``LoweredExecutable.pack``
    take.
    """
    dev = resolve_device(device)
    lo, hi = -(1 << (params.weight_bits - 1)), 1 << (params.weight_bits - 1)
    out = {}
    for name, w in weights.items():
        w = np.asarray(w)
        if not np.issubdtype(w.dtype, np.integer):
            raise TypeError(f"{name}: weights are {w.dtype}, expected ints")
        if w.ndim != 2:
            raise ValueError(f"{name}: weights have shape {w.shape}, "
                             "expected an (R, C) matrix")
        if w.size and (int(w.min()) < lo or int(w.max()) >= hi):
            raise ValueError(
                f"{name}: weights span [{int(w.min())}, {int(w.max())}], "
                f"outside the signed {params.weight_bits}-bit range "
                f"[{lo}, {hi - 1}]")
        out[name] = torch.as_tensor(w.astype(np.int32), device=dev)
    return out, {name: int(s) for name, s in shifts.items()}


def weights_numpy(weights) -> Dict[str, np.ndarray]:
    """Signed int32 numpy matrices from numpy arrays or tensors."""
    return {name: (w.cpu().numpy() if isinstance(w, torch.Tensor)
                   else np.asarray(w)).astype(np.int32, copy=False)
            for name, w in weights.items()}


def im2col(x: np.ndarray, k: int, stride: int, pad: int) -> np.ndarray:
    """(C,H,W) -> (H_out*W_out, C*k*k) patch matrix (weight-matrix order)."""
    c, h, w = x.shape
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad)))
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    rows = np.empty((oh * ow, c * k * k), dtype=x.dtype)
    idx = 0
    for i in range(oh):
        for j in range(ow):
            patch = xp[:, i * stride:i * stride + k, j * stride:j * stride + k]
            rows[idx] = patch.reshape(-1)
            idx += 1
    return rows


# ---------------------------------------------------------------------------
# Reference executor (int8 fake-quant, exact integer matmuls)
# ---------------------------------------------------------------------------

def _float_dcom(op_type: str, xs: List[np.ndarray],
                node: Node) -> np.ndarray:
    x = xs[0].astype(np.float64)
    if op_type == "Gelu":
        return x * 0.5 * (1.0 + np.tanh(0.7978845608 * (x + 0.044715 * x ** 3)))
    if op_type == "Silu":
        return x / (1.0 + np.exp(-x))
    if op_type == "Sigmoid":
        return 1.0 / (1.0 + np.exp(-x))
    if op_type == "Tanh":
        return np.tanh(x)
    if op_type == "Softmax":
        x = x * node.attrs.get("scale", 1.0)
        e = np.exp(x - x.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)
    if op_type in ("LayerNorm", "RMSNorm"):
        if op_type == "LayerNorm":
            x = x - x.mean(axis=-1, keepdims=True)
        return x / np.sqrt((x ** 2).mean(axis=-1, keepdims=True) + 1e-6)
    raise ValueError(f"no float DCOM for {op_type}")


def apply_dcom(node: Node, xs: List[np.ndarray], graph: Graph,
               shifts: Dict[str, int],
               calibrating: bool) -> np.ndarray:
    """Digital operator semantics shared by simulator and reference."""
    t = node.op_type
    if t == "Relu":
        return np.maximum(xs[0], 0)
    if t == "Constant":
        return constant_value(node)
    if t == "Add":
        y = xs[0].astype(np.int64) + xs[1].astype(np.int64)
        sh = _shift_for(node, y, shifts, calibrating)
        return requant(y.astype(np.int64) >> 0, 0) if sh == 0 \
            else np.clip(y >> sh, -128, 127).astype(np.int32)
    if t == "Mul":
        y = xs[0].astype(np.int64) * xs[1].astype(np.int64)
        sh = _shift_for(node, y, shifts, calibrating)
        return np.clip(y >> sh, -128, 127).astype(np.int32)
    if t == "MaxPool":
        return _pool(xs[0], node, np.max)
    if t in ("AveragePool", "GlobalAveragePool"):
        if t == "GlobalAveragePool":
            return (xs[0].sum(axis=(1, 2), keepdims=True)
                    // (xs[0].shape[1] * xs[0].shape[2])).astype(np.int32)
        return _pool(xs[0], node, lambda a, axis: a.sum(axis=axis)
                     // (node.attrs.get("kernel", 2) ** 2))
    if t == "Flatten":
        return xs[0].reshape(-1)
    if t == "Reshape":
        return xs[0].reshape(node.attrs["shape"])
    if t == "Identity":
        return xs[0]
    if t == "Transpose":
        return xs[0].transpose(node.attrs["perm"])
    if t == "Concat":
        return np.concatenate(xs, axis=node.attrs.get("axis", -1))
    if t == "Split":
        axis = node.attrs.get("axis", -1) % xs[0].ndim
        parts = node.attrs["parts"]
        return np.split(xs[0], np.cumsum(parts[:-1]), axis=axis)
    if t == "MatMul":
        b = np.swapaxes(xs[1], -1, -2) if node.attrs.get("transpose_b") \
            else xs[1]
        y = xs[0].astype(np.int64) @ b.astype(np.int64)
        sh = _shift_for(node, y, shifts, calibrating)
        return np.clip(y >> sh, -128, 127).astype(np.int32)
    # float fallback ops re-quantized to int8 grid
    y = _float_dcom(t, xs, node)
    return np.clip(np.round(y * 32.0), -128, 127).astype(np.int32)


def _shift_for(node: Node, y, shifts: Dict[str, int],
               calibrating: bool) -> int:
    if calibrating:
        shifts[node.name] = pick_shift(np.asarray(y))
    return shifts.get(node.name, 0)


def _pool(x: np.ndarray, node: Node, reducer) -> np.ndarray:
    k = node.attrs.get("kernel", 2)
    stride = node.attrs.get("stride", k)
    pad = node.attrs.get("pad", 0)
    c, h, w = x.shape
    if pad:
        fill = -(2 ** 31) if reducer is np.max else 0
        x = np.pad(x, ((0, 0), (pad, pad), (pad, pad)),
                   constant_values=fill)
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    out = np.empty((c, oh, ow), dtype=np.int32)
    for i in range(oh):
        for j in range(ow):
            win = x[:, i * stride:i * stride + k, j * stride:j * stride + k]
            out[:, i, j] = reducer(win.reshape(c, -1), axis=-1)
    return out


def reference_forward(graph: Graph, weights: Dict[str, np.ndarray],
                      inputs: Dict[str, np.ndarray],
                      shifts: Optional[Dict[str, int]] = None,
                      mvm=None) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """Pure int8 fake-quant forward pass.

    ``mvm(x_rows, w) -> int32`` defaults to the exact integer matmul;
    passing kernels/cim_mvm's signed op makes the reference share the
    crossbar compute semantics (for saturating-ADC comparisons).
    Returns (tensors, calibrated shifts).
    """
    calibrating = shifts is None
    shifts = {} if shifts is None else dict(shifts)
    if mvm is None:
        def mvm(x_rows, w):
            return x_rows.astype(np.int64) @ w.astype(np.int64)
    tensors: Dict[str, np.ndarray] = dict(inputs)
    for node in graph.nodes:
        xs = [tensors[t] for t in node.inputs]
        if node.is_cim:
            w = weights[node.name]
            if node.op_type == "Conv":
                k = node.attrs["weight_shape"][2]
                rows = im2col(xs[0], k, node.attrs.get("stride", 1),
                              node.attrs.get("pad", 0))
                y = np.asarray(mvm(rows, w))
                sh = _shift_for(node, y, shifts, calibrating)
                y = np.clip(y >> sh, -128, 127).astype(np.int32)
                cout = node.attrs["weight_shape"][0]
                oh, ow = graph.shapes[node.outputs[0]][1:]
                y = y.T.reshape(cout, oh, ow)
            else:
                rows = xs[0][None] if xs[0].ndim == 1 else xs[0]
                y = np.asarray(mvm(rows, w))
                sh = _shift_for(node, y, shifts, calibrating)
                y = np.clip(y >> sh, -128, 127).astype(np.int32)
                y = y[0] if xs[0].ndim == 1 else y
            tensors[node.outputs[0]] = y
        else:
            _store_outputs(tensors, node,
                           apply_dcom(node, xs, graph, shifts, calibrating))
    return tensors, shifts


def _store_outputs(tensors: Dict[str, np.ndarray], node: Node, y) -> None:
    """Assign a DCOM result to the node's output tensors (Split is the
    one multi-output operator: apply_dcom returns one array per part)."""
    if node.op_type == "Split":
        for name, part in zip(node.outputs, y):
            tensors[name] = part
    else:
        tensors[node.outputs[0]] = y


# ---------------------------------------------------------------------------
# Crossbar tile geometry + signed MVM semantics, shared by the op-by-op
# interpreter (below) and the trace-lowered batched executor
# (cimsim.executor) — both must address the same weight sub-matrices.
# ---------------------------------------------------------------------------

def tile_ranges(p: OpPlacement, arch: CIMArch, rt: int, ct: int
                ) -> Tuple[int, int, int, int]:
    """Row/col index ranges of tile (rt, ct) of a chunk's sub-matrix."""
    m = p.mapping
    r0 = rt * arch.xb.rows
    r1 = min(r0 + arch.xb.rows, m.r)
    cpx = logical_cols_per_xb(m, arch)
    c0 = ct * cpx
    c1 = min(c0 + cpx, m.c)
    return r0, r1, c0, c1


def chunk_offsets(node: Node, p: OpPlacement) -> Tuple[int, int]:
    """Global (row, col) offset of a chunk inside the full matrix."""
    r, c = weight_matrix_shape(node)
    sub_r, sub_c = p.mapping.r, p.mapping.c
    cc = math.ceil(c / sub_c)
    ci, ri = p.chunk % cc, p.chunk // cc
    return ri * sub_r, ci * sub_c


def spread_slice(rows_in_tile: int, parallel_row: int, row_spread: int,
                 part: int) -> Optional[Tuple[int, int]]:
    """Row sub-span [s0, s1) of spread ``part`` under the VVM remap, or
    ``None`` when the part falls past the tile's rows."""
    n_grp = max(1, math.ceil(rows_in_tile / parallel_row))
    per = math.ceil(n_grp / row_spread) * parallel_row
    s0 = part * per
    if s0 >= rows_in_tile:
        return None
    return s0, min(s0 + per, rows_in_tile)


def signed_oracle_mvm(x_rows: np.ndarray, w: np.ndarray,
                      p: CimMvmParams, device="cuda",
                      mode: Optional[str] = None) -> np.ndarray:
    """Signed MVM through the crossbar MVM via offset encoding.

    The standard CIM trick shared by the interpreter, the executor and
    the saturating-ADC reference: store ``x + 2^(ab-1)`` / ``w + 2^(wb-1)``
    unsigned, run the bit-sliced ADC-saturating ``cim_mvm`` on
    ``device`` (on the card: the CUDA kernel; ``mode`` forces the
    route), subtract the rank-1 correction digitally.
    """
    dev = resolve_device(device)
    ox = 1 << (p.act_bits - 1)
    ow = 1 << (p.weight_bits - 1)
    x_u = x_rows.astype(np.int64) + ox
    w_u = w.astype(np.int64) + ow
    y_u = cim_mvm(torch.as_tensor(x_u.astype(np.int32), device=dev),
                  torch.as_tensor(w_u.astype(np.int32), device=dev),
                  p, mode=mode).cpu().numpy().astype(np.int64)
    r = x_rows.shape[-1]
    sx = x_u.sum(axis=-1, keepdims=True)
    sw = w_u.sum(axis=0, keepdims=True)
    return y_u - ow * sx - ox * sw + r * ox * ow


def reference_mvm(params: CimMvmParams, device="cuda",
                  mode: Optional[str] = None):
    """The MVM the int8 reference must use for these crossbar params:
    ``None`` (exact integer matmul) when the ADC provably never
    saturates, else the offset-encoded crossbar MVM on ``device`` (its
    route forced by ``mode``) — so calibration, simulation and
    verification all share one dispatch rule."""
    if params.exact:
        return None
    return lambda x_rows, w: signed_oracle_mvm(x_rows, w, params, device,
                                               mode)


# ---------------------------------------------------------------------------
# The meta-operator flow interpreter
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimStats:
    cim_reads: int = 0
    cim_writes: int = 0
    dcom_ops: int = 0
    mov_bytes: int = 0


class FunctionalSimulator:
    """Executes an expanded meta-operator flow for one inference; every
    crossbar read runs ``cim_mvm`` on ``device`` (its route forced by
    ``mode``)."""

    def __init__(self, plan: SchedulePlan, program: Program,
                 weights: Dict[str, np.ndarray],
                 shifts: Dict[str, int],
                 params: Optional[CimMvmParams] = None,
                 device="cuda", faults=None, mode: Optional[str] = None):
        self.plan = plan
        self.graph: Graph = plan.graph
        self.arch: CIMArch = plan.arch
        self.program = program
        self.weights = weights_numpy(weights)
        self.shifts = shifts
        self.params = params or cim_mvm_params(plan.arch)
        self.device = resolve_device(device)
        self.mode = mode
        #: optional cimsim.faults.FaultMap — every crossbar read applies
        #: its tile's weight transform + post-MVM offset (the executor
        #: applies the identical per-span functions; see faults.py)
        self.faults = faults
        self.stats = SimStats()
        self._placement: Dict[Tuple[str, int], OpPlacement] = {}
        for p in plan.placements:
            self._placement[(p.node.name, p.chunk)] = p
        self._rows_cache: Dict[str, np.ndarray] = {}
        self._acc: Dict[str, np.ndarray] = {}       # int64 accumulators
        self._acc_pending: Dict[str, bool] = {}

    # -- crossbar-level MVM with the CIM compute semantics ---------------
    def _cim_mvm(self, x_rows: np.ndarray, w: np.ndarray,
                 parallel_row: Optional[int] = None) -> np.ndarray:
        p = self.params
        if parallel_row is not None:
            p = dataclasses.replace(p, parallel_row=parallel_row)
        return signed_oracle_mvm(x_rows, w, p, self.device, self.mode)

    def _faulted(self, name: str, span: Tuple[int, int, int, int],
                 wsub: np.ndarray):
        """(effective weights, post-MVM offset or None) of one tile span
        under the active fault map — identity without one."""
        if self.faults is None:
            return wsub, None
        return (self.faults.apply_tile(name, span, wsub),
                self.faults.tile_offset(name, span))

    # -- tensor store -----------------------------------------------------
    def _tensor(self, name: str) -> np.ndarray:
        prod = self.graph.producer(name)
        if prod is not None and self._acc_pending.get(prod.name):
            self._finalize(prod)
        return self._tensors[name]

    def _finalize(self, node: Node) -> None:
        y = self._acc[node.name]
        sh = self.shifts.get(node.name, 0)
        y = np.clip(y >> sh, -128, 127).astype(np.int32)
        if node.op_type == "Conv":
            cout = node.attrs["weight_shape"][0]
            oh, ow = self.graph.shapes[node.outputs[0]][1:]
            y = y.T.reshape(cout, oh, ow)
        else:
            x_shape = self.graph.shapes[node.inputs[0]]
            if len(x_shape) == 1:
                y = y[0]
        self._tensors[node.outputs[0]] = y
        self._acc_pending[node.name] = False

    def _input_rows(self, node: Node) -> np.ndarray:
        if node.name in self._rows_cache:
            return self._rows_cache[node.name]
        x = self._tensor(node.inputs[0])
        if node.op_type == "Conv":
            k = node.attrs["weight_shape"][2]
            rows = im2col(x, k, node.attrs.get("stride", 1),
                          node.attrs.get("pad", 0))
        else:
            rows = x[None] if x.ndim == 1 else x
        self._rows_cache[node.name] = rows
        return rows

    def _tile_ranges(self, p: OpPlacement, rt: int, ct: int):
        return tile_ranges(p, self.arch, rt, ct)

    def _chunk_offsets(self, node: Node, p: OpPlacement):
        return chunk_offsets(node, p)

    # -- execution ---------------------------------------------------------
    def run(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        self._tensors: Dict[str, np.ndarray] = dict(inputs)
        self._rows_cache.clear()
        self._acc.clear()
        for op in self.program.walk(expand_loops=True):
            self._exec(op)
        # finalize any pending accumulators and run to the graph outputs
        for node in self.graph.nodes:
            if self._acc_pending.get(node.name):
                self._finalize(node)
        return {t: self._tensor(t) for t in self.graph.outputs}

    def _exec(self, op: MetaOp) -> None:
        k = op.kind
        a = op.attrs
        if k in ("cim.write_xb", "cim.write_row"):
            self.stats.cim_writes += 1
            return                      # weights are addressed by attrs
        if k == "mov":
            self.stats.mov_bytes += int(a.get("len", 0))
            return
        if k == "cim.read_core":
            self._read_core(a)
            return
        if k in ("cim.read_xb", "cim.read_row"):
            self._read_tile(a, wlm=(k == "cim.read_row"))
            return
        # DCOM
        self.stats.dcom_ops += 1
        if k == "shift_acc":
            return                      # folded into the accumulation
        node = self.graph.node(a["node"]) if "node" in a else None
        if node is None:
            return
        xs = [self._tensor(t) for t in node.inputs]
        y = apply_dcom(node, xs, self.graph, self.shifts, calibrating=False)
        _store_outputs(self._tensors, node, y)

    def _acc_for(self, node: Node) -> np.ndarray:
        if node.name not in self._acc:
            rows = self._input_rows(node)
            r, c = weight_matrix_shape(node)
            n = rows.shape[0]
            self._acc[node.name] = np.zeros((n, c), np.int64)
        self._acc_pending[node.name] = True
        return self._acc[node.name]

    def _read_core(self, a: Dict) -> None:
        self.stats.cim_reads += 1
        node = self.graph.node(a["node"])
        p = self._placement[(node.name, a.get("chunk", 0))]
        rows = self._input_rows(node)
        acc = self._acc_for(node)
        copy, dup = a.get("copy", 0), p.dup
        idx = np.arange(copy, rows.shape[0], dup)
        if idx.size == 0:
            return
        w = self.weights[node.name]
        ro, co = self._chunk_offsets(node, p)
        wsub = w[ro:ro + p.mapping.r, co:co + p.mapping.c]
        span = (ro, ro + wsub.shape[0], co, co + wsub.shape[1])
        wsub, off = self._faulted(node.name, span, wsub)
        y = self._cim_mvm(rows[idx][:, ro:ro + p.mapping.r], wsub)
        if off is not None:
            y = y + off[None, :]
        acc[np.ix_(idx, np.arange(co, co + wsub.shape[1]))] += y

    def _read_tile(self, a: Dict, wlm: bool) -> None:
        self.stats.cim_reads += 1
        node = self.graph.node(a["op"])
        p = self._placement[(node.name, a.get("chunk", 0))]
        rows = self._input_rows(node)
        acc = self._acc_for(node)
        copy, dup = a.get("copy", 0), p.dup
        w_idx = a["window"]
        windows = np.arange(copy, rows.shape[0], dup)
        if isinstance(w_idx, int):
            if w_idx >= windows.size:
                return
            windows = windows[w_idx:w_idx + 1]
        rt, ct = a.get("row_tile", 0), a.get("col_tile", 0)
        r0, r1, c0, c1 = self._tile_ranges(p, rt, ct)
        ro, co = self._chunk_offsets(node, p)
        w = self.weights[node.name]
        wsub = w[ro + r0:ro + min(r1, p.mapping.r),
                 co + c0:co + min(c1, p.mapping.c)]
        if wsub.size == 0:
            return
        xr0, xr1 = ro + r0, ro + r0 + wsub.shape[0]
        if wlm and p.row_spread > 1:
            span = spread_slice(wsub.shape[0], self.arch.xb.parallel_row,
                                p.row_spread, a.get("spread", 0))
            if span is None:
                return
            s0, s1 = span
            wsub = wsub[s0:s1]
            xr0, xr1 = xr0 + s0, xr0 + (s1 - s0) + s0
        fspan = (xr0, xr1, co + c0, co + c0 + wsub.shape[1])
        wsub, off = self._faulted(node.name, fspan, wsub)
        y = self._cim_mvm(rows[windows][:, xr0:xr1], wsub)
        if off is not None:
            y = y + off[None, :]
        cols = np.arange(co + c0, co + c0 + wsub.shape[1])
        acc[np.ix_(windows, cols)] += y


def calibrate_shifts(graph: Graph, weights: Dict[str, np.ndarray],
                     inputs: Dict[str, np.ndarray],
                     params: CimMvmParams, device="cuda") -> Dict[str, int]:
    """Requantization shifts from one reference calibration pass (the
    reference shares the crossbar compute semantics when the ADC can
    saturate, so calibration sees the hardware-true dynamic range; on
    the card those MVMs run the CUDA kernel)."""
    _, shifts = reference_forward(graph, weights_numpy(weights), inputs,
                                  mvm=reference_mvm(params, device))
    return shifts


def simulate(graph: Graph, arch: CIMArch, *, level=None, seed: int = 0,
             params: Optional[CimMvmParams] = None,
             use_executor: bool = False, device="cuda", faults=None):
    """Compile ``graph`` for ``arch``, run the reference, execute the
    meta-op flow, and return (sim_outputs, ref_outputs, stats).

    ``use_executor=True`` runs the trace-lowered batched executor
    (cimsim.executor) instead of the op-by-op interpreter — same
    semantics, one batched program (stats are then lowering stats).
    ``faults`` (a ``cimsim.faults.FaultMap``) injects device faults into
    the simulated crossbars; the reference outputs stay fault-free, so
    the pair measures fault-induced degradation.
    """
    from ..core import compiler
    dev = resolve_device(device)
    weights = make_weights(graph, seed)
    inputs = make_input(graph, seed)
    p = params or cim_mvm_params(arch)

    ref_mvm = reference_mvm(p, dev)
    _, shifts = reference_forward(graph, weights, inputs, mvm=ref_mvm)
    ref_out, _ = reference_forward(graph, weights, inputs, shifts=shifts,
                                   mvm=ref_mvm)
    if use_executor:
        from .executor import lower
        res = compiler.compile_graph(graph, arch, level=level)
        exe = lower(res.plan, res.program, params=p, device=dev,
                    faults=faults)
        sim_out = exe.run(inputs, weights, shifts)
        stats = exe.stats
    else:
        res = compiler.compile_graph(graph, arch, level=level, expand=True)
        sim = FunctionalSimulator(res.plan, res.program, weights, shifts,
                                  params=p, device=dev, faults=faults)
        sim_out = sim.run(inputs)
        stats = sim.stats
    return sim_out, {t: ref_out[t] for t in graph.outputs}, stats


@dataclasses.dataclass
class VerifyReport:
    """Outcome of one functional verification (§4.1) of a compile."""

    graph: str
    arch: str
    batch: int
    max_abs_err: Dict[str, int]          # per graph output
    lower_s: float = 0.0
    run_s: float = 0.0
    compile_s: float = 0.0               # compile_graph, cache hit or not
    #: set when verification could not run at all (compile/lowering
    #: failure) — ``max_abs_err`` is then empty and ``ok`` is False
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None and \
            all(e == 0 for e in self.max_abs_err.values())


def compile_and_verify(graph: Graph, arch: CIMArch, *, level=None,
                       seed: int = 0, batch: int = 1,
                       params: Optional[CimMvmParams] = None,
                       use_executor: bool = True, device="cuda",
                       faults=None, mode: Optional[str] = None,
                       **compile_kwargs) -> VerifyReport:
    """Compile ``graph`` for ``arch`` and verify the emitted flow against
    the int8 fake-quant reference on ``batch`` random inputs.

    The fast path (default) lowers the compiled program once with the
    batched executor and verifies all inputs in a single dispatch; a
    flow the executor cannot lower bit-exactly (``LoweringError``)
    falls back to op-by-op interpretation, as does
    ``use_executor=False``.  Extra keyword arguments (``use_pipeline``,
    ``binding``, ``cache``, ...) reach ``compile_graph``, so any DSE
    design point can be verified.  With ``faults`` set the simulated
    crossbars carry the fault map while the reference stays clean, so
    ``max_abs_err`` measures fault-induced deviation (``ok`` then means
    the faults were numerically invisible).  Everything runs on
    ``device``; ``mode`` forces the crossbar-MVM route of the reference,
    the executor and the interpreter alike.
    """
    import time
    from ..core import compiler
    dev = resolve_device(device)
    weights = make_weights(graph, seed)
    p = params or cim_mvm_params(arch)
    inputs = [make_input(graph, seed + i) for i in range(batch)]
    ref_mvm = reference_mvm(p, dev, mode)
    _, shifts = reference_forward(graph, weights, inputs[0], mvm=ref_mvm)
    refs = [reference_forward(graph, weights, x, shifts=shifts,
                              mvm=ref_mvm)[0] for x in inputs]

    err = {t: 0 for t in graph.outputs}
    if use_executor:
        from .executor import LoweringError, lower
        t0 = time.time()
        res = compiler.compile_graph(graph, arch, level=level,
                                     **compile_kwargs)
        compile_s = time.time() - t0
        try:
            t0 = time.time()
            exe = lower(res.plan, res.program, params=p, mode=mode,
                        device=dev, faults=faults)
            packed = exe.pack(weights)
            t1 = time.time()
            batched = {name: np.stack([x[name] for x in inputs])
                       for name in graph.inputs}
            outs = exe.run_batch(batched, packed=packed, shifts=shifts)
            t2 = time.time()
            for i in range(batch):
                for t in graph.outputs:
                    d = np.abs(np.asarray(outs[t][i], np.int64)
                               - refs[i][t].astype(np.int64))
                    err[t] = max(err[t], int(d.max()) if d.size else 0)
            return VerifyReport(graph=graph.name, arch=arch.name,
                                batch=batch, max_abs_err=err,
                                lower_s=t1 - t0, run_s=t2 - t1,
                                compile_s=compile_s)
        except LoweringError:
            pass       # fast path unavailable: verify op by op below

    t0 = time.time()
    res = compiler.compile_graph(graph, arch, level=level, expand=True,
                                 **compile_kwargs)
    compile_s = time.time() - t0
    sim = FunctionalSimulator(res.plan, res.program, weights, shifts,
                              params=p, device=dev, faults=faults, mode=mode)
    t0 = time.time()
    for i, x in enumerate(inputs):
        out = sim.run(x)
        for t in graph.outputs:
            d = np.abs(out[t].astype(np.int64) - refs[i][t].astype(np.int64))
            err[t] = max(err[t], int(d.max()) if d.size else 0)
    return VerifyReport(graph=graph.name, arch=arch.name, batch=batch,
                        max_abs_err=err, run_s=time.time() - t0,
                        compile_s=compile_s)
