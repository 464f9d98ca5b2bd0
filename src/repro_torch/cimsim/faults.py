"""Deterministic device-fault injection for CIM crossbars.

Real RRAM/SRAM crossbars ship with stuck-at cells, broken word/bit
lines, conductance drift and per-ADC offsets; this module makes those
breakable on purpose, identically in the op-by-op interpreter
(``functional.FunctionalSimulator``) and the trace-lowered executor
(``executor.LoweredExecutable``).

Fault semantics — the conformance contract
------------------------------------------

Both simulators address weights through the same *tile spans*: global
``(r0, r1, c0, c1)`` sub-rectangles of each node's weight matrix (the
interpreter per crossbar read, the executor via ``_collect_units``).  A
``FaultMap`` defines every fault as a function of ``(node name, span)``:

  * a **weight transform** ``apply_tile(name, span, w) -> w_eff`` — slice
    surgery on the offset-encoded unsigned cell values (stuck cells and
    dead lines force slices to G0/G1, drift perturbs them within the
    cell's LSB range), then decoded back to a signed matrix; and
  * a **post-MVM perturbation** ``tile_offset(name, span)`` — the folded
    integer image of the per-bitline ADC offsets, added to the tile's
    digital partial sum.

Because ``signed_oracle_mvm`` recomputes its rank-1 offset-encoding
correction from whatever weights it is given, substituting ``w_eff``
keeps the interpreter, the executor's saturating tile path *and* the
executor's exact-ADC matmul shortcut mutually bit-exact under faults —
faults fold into the packed tiles plus per-dispatch offset tensors
built once at lowering, so a faulted dispatch is the clean one plus one
device add per MVM dispatch.  Every saturating MVM still runs
``cim_mvm_tiles`` (on the card: the CUDA kernel) on the faulted tiles.

Physical model (per tile): fields are drawn over the **full physical
crossbar grid** (``xb.rows x xb.cols`` cells) with a stable per-(node,
span) seed.  Logical row ``i`` lives on physical row ``i`` and logical
column ``j``'s bit slice ``k`` on physical column ``j*S + k`` (the
``B->XBC`` layout) — unless remapping is on, in which case clean-line
selection steers rows/column-groups away from faulty lines first.
Dead lines are modeled as line-correlated stuck-at-G0 (the whole
word/bit line reads zero conductance), so every fault class is one
uniform unsigned-domain override.

Fault-aware remapping (compiler tier)
-------------------------------------

``fault_aware_compile`` retires wordlines/bitlines from the bindable
geometry (``core.mapping.retired_geometry``), recompiles — the existing
``balance_duplication`` machinery re-spreads copies over the shrunk
tiles — and verifies that every tile span can be steered onto clean
lines, iterating the retirement budget until the map is clean or
``FaultBudgetError`` says it cannot be.  Remapping assumes a *known*
fault map (post-fabrication test), so the per-column ADC offsets are
calibrated out digitally; residual faults still apply wherever clean
lines ran out.

``accuracy_under_faults`` is the executor-backed robustness metric:
top-1 agreement with the fault-free executor over a seeded input batch,
on ``device`` (default ``"cuda"``).

``FaultModel``, ``FaultMap`` and ``FaultCompileResult`` are numpy and
materialise the same faults for the same ``(model, arch, name, span)``
as the JAX package's, bit for bit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.abstraction import CIMArch
from ..core.mapping import FaultBudgetError, retired_geometry
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

Span = Tuple[int, int, int, int]


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Seeded statistical description of one chip's device faults.

    Rates are per-draw probabilities; sigmas are Gaussian widths.  All
    draws are deterministic in ``seed`` (and the tile identity), so two
    ``FaultMap`` instances built from equal models materialize identical
    faults — the property every conformance test leans on.
    """

    seed: int = 0
    #: iid per-cell stuck-at probability (degradation curves; not
    #: line-retirable at realistic rates)
    stuck_cell_rate: float = 0.0
    #: per-bitline whole-column stuck-at probability (line-clustered —
    #: the retirement-friendly fault class)
    stuck_col_rate: float = 0.0
    #: fraction of stuck cells/columns stuck at G1 (max conductance);
    #: the rest stick at G0
    stuck_hi_frac: float = 0.5
    #: per-wordline open probability (line reads as all-G0)
    dead_row_rate: float = 0.0
    #: per-bitline open probability (line reads as all-G0)
    dead_col_rate: float = 0.0
    #: Gaussian conductance drift, in cell LSBs (rounded, clipped to the
    #: cell's level range)
    drift_sigma: float = 0.0
    #: Gaussian per-bitline ADC offset, in ADC counts (rounded)
    adc_offset_sigma: float = 0.0

    @property
    def any_faults(self) -> bool:
        return any((self.stuck_cell_rate, self.stuck_col_rate,
                    self.dead_row_rate, self.dead_col_rate,
                    self.drift_sigma, self.adc_offset_sigma))

    @property
    def token(self) -> str:
        """Stable content hash (executor lowering-cache key component)."""
        payload = ",".join(f"{f.name}={getattr(self, f.name)!r}"
                           for f in dataclasses.fields(self))
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclasses.dataclass
class _SpanFaults:
    """Materialized faults of one (node, span) tile, in logical layout:
    per-slice override mask/values plus drift and the folded per-column
    post-MVM offset.  ``identity`` short-circuits untouched tiles."""

    identity: bool
    mask: Optional[np.ndarray] = None     # (S, r_len, c_len) bool
    val: Optional[np.ndarray] = None      # (S, r_len, c_len) forced level
    drift: Optional[np.ndarray] = None    # (S, r_len, c_len) int
    offset: Optional[np.ndarray] = None   # (c_len,) int64 post-MVM term
    deficit_rows: int = 0                 # remap: rows left on faulty lines
    deficit_cols: int = 0                 # remap: col groups left unclean


class FaultMap:
    """Per-crossbar-tile fault materialization for one chip.

    ``arch`` supplies the *physical* grid (always the original chip —
    pass the unretired arch even when the plan was compiled against
    ``retired_geometry``).  ``remap=True`` enables clean-line selection:
    each tile's rows and column groups are steered onto fault-free
    physical lines first (and known ADC offsets are calibrated out);
    lines beyond the clean supply keep their residual faults.
    """

    def __init__(self, model: FaultModel, arch: CIMArch, *,
                 remap: bool = False):
        self.model = model
        self.remap = bool(remap)
        self.rows_phys = arch.xb.rows
        self.cols_phys = arch.xb.cols
        self.cell_bits = arch.xb.cell_precision
        self.weight_bits = arch.weight_bits
        self.slices = math.ceil(self.weight_bits / self.cell_bits)
        self._ow = 1 << (self.weight_bits - 1)
        #: per-slice bit widths / shifts (top slice may be narrower)
        self.slice_bits = tuple(
            min(self.cell_bits, self.weight_bits - k * self.cell_bits)
            for k in range(self.slices))
        self.slice_shift = tuple(k * self.cell_bits
                                 for k in range(self.slices))
        self._cache: Dict[Tuple[str, Span], _SpanFaults] = {}

    @property
    def token(self) -> str:
        """Content identity for executor lowering-cache keys."""
        return (f"{self.model.token}:{self.rows_phys}x{self.cols_phys}"
                f":{self.cell_bits}b{self.weight_bits}w"
                f":{'remap' if self.remap else 'direct'}")

    # -- per-tile field ---------------------------------------------------
    def _rng(self, name: str, span: Span) -> np.random.Generator:
        tok = f"{name}\x00{span[0]},{span[1]},{span[2]},{span[3]}" \
              f"\x00{self.model.seed}"
        return np.random.default_rng(zlib.crc32(tok.encode()))

    def _field(self, name: str, span: Span) -> Dict[str, np.ndarray]:
        """Draw the tile's physical fault field (full crossbar grid).
        Every array is drawn unconditionally in a fixed order, so the
        stream — hence every fault — is stable across rate settings of
        *other* fault classes only through the model's own values."""
        m = self.model
        rng = self._rng(name, span)
        R, C = self.rows_phys, self.cols_phys
        f = {
            "dead_row": rng.random(R) < m.dead_row_rate,
            "dead_col": rng.random(C) < m.dead_col_rate,
            "stuck_col": rng.random(C) < m.stuck_col_rate,
            "stuck_col_hi": rng.random(C) < m.stuck_hi_frac,
            "stuck_cell": rng.random((R, C)) < m.stuck_cell_rate,
            "stuck_cell_hi": rng.random((R, C)) < m.stuck_hi_frac,
        }
        f["drift"] = np.rint(rng.normal(0.0, 1.0, (R, C))
                             * m.drift_sigma).astype(np.int64)
        f["adc_off"] = np.rint(rng.normal(0.0, 1.0, C)
                               * m.adc_offset_sigma).astype(np.int64)
        return f

    # -- clean-line selection ---------------------------------------------
    def _select_lines(self, f: Dict[str, np.ndarray], r_len: int,
                      c_len: int) -> Tuple[np.ndarray, np.ndarray, int, int]:
        """(row_sel, group_sel, deficit_rows, deficit_cols): the physical
        rows and column groups holding the tile's logical lines.  Without
        remap this is the identity placement; with remap, clean lines
        come first and deficits fall back to faulty ones (in index
        order, so selection is deterministic)."""
        S = self.slices
        n_groups = self.cols_phys // S
        if not self.remap:
            return (np.arange(r_len), np.arange(c_len),
                    int(f["dead_row"][:r_len].sum()), 0)
        clean_r = ~f["dead_row"]
        order_r = np.concatenate([np.flatnonzero(clean_r),
                                  np.flatnonzero(~clean_r)])
        row_sel = order_r[:r_len]
        deficit_rows = int((~clean_r[row_sel]).sum())
        # a column group (one logical column's S slices) is clean when
        # none of its bitlines is dead/stuck and no selected row has a
        # stuck cell in it
        gcols = np.arange(n_groups * S).reshape(n_groups, S)
        line_bad = (f["dead_col"][gcols] | f["stuck_col"][gcols]).any(axis=1)
        cell_bad = f["stuck_cell"][np.ix_(row_sel, np.arange(n_groups * S))]
        cell_bad = cell_bad.reshape(r_len, n_groups, S).any(axis=(0, 2))
        clean_g = ~(line_bad | cell_bad)
        order_g = np.concatenate([np.flatnonzero(clean_g),
                                  np.flatnonzero(~clean_g)])
        group_sel = order_g[:c_len]
        deficit_cols = int((~clean_g[group_sel]).sum())
        return row_sel, group_sel, deficit_rows, deficit_cols

    # -- materialization --------------------------------------------------
    def _span(self, name: str, span: Span) -> _SpanFaults:
        key = (name, span)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        if not self.model.any_faults:
            sf = _SpanFaults(identity=True)
            self._cache[key] = sf
            return sf
        r0, r1, c0, c1 = span
        r_len, c_len = r1 - r0, c1 - c0
        S = self.slices
        if r_len > self.rows_phys or c_len * S > self.cols_phys:
            raise ValueError(
                f"{name}: tile span {span} ({r_len}x{c_len} logical) "
                f"exceeds the physical {self.rows_phys}x{self.cols_phys} "
                "crossbar — was the FaultMap built from the original "
                "(unretired) arch?")
        f = self._field(name, span)
        row_sel, group_sel, dr, dc = self._select_lines(f, r_len, c_len)
        # physical column of logical (j, slice k) after selection
        pc = (group_sel[:, None] * S
              + np.arange(S)[None, :])                     # (c_len, S)
        mask = np.zeros((S, r_len, c_len), dtype=bool)
        val = np.zeros((S, r_len, c_len), dtype=np.int64)
        drift = np.zeros((S, r_len, c_len), dtype=np.int64)
        for k in range(S):
            cols_k = pc[:, k]                              # (c_len,)
            cell = np.ix_(row_sel, cols_k)
            max_k = (1 << self.slice_bits[k]) - 1
            stuck = f["stuck_cell"][cell]
            hi = f["stuck_cell_hi"][cell]
            mask[k] = stuck
            val[k] = np.where(hi, max_k, 0) * stuck
            scol = f["stuck_col"][cols_k]
            val[k] = np.where(scol[None, :] & ~stuck,
                              np.where(f["stuck_col_hi"][cols_k][None, :],
                                       max_k, 0), val[k])
            mask[k] |= scol[None, :]
            # dead lines: line-correlated stuck-at-G0 (overrides all)
            dead = f["dead_col"][cols_k][None, :] \
                | f["dead_row"][row_sel][:, None]
            mask[k] |= dead
            val[k] = np.where(dead, 0, val[k])
            drift[k] = f["drift"][cell]
        if self.model.drift_sigma <= 0:
            drift = None
        if self.remap:
            offset = None          # known map: ADC offsets calibrated out
        else:
            off = np.zeros(c_len, dtype=np.int64)
            for k in range(S):
                off += f["adc_off"][pc[:, k]] << self.slice_shift[k]
            offset = off if off.any() else None
        identity = (not mask.any()) and drift is None and offset is None
        sf = _SpanFaults(identity=identity,
                         mask=None if identity else mask,
                         val=None if identity else val,
                         drift=drift, offset=offset,
                         deficit_rows=dr, deficit_cols=dc)
        self._cache[key] = sf
        return sf

    # -- the two runtime hooks -------------------------------------------
    def apply_tile(self, name: str, span: Span,
                   w: np.ndarray) -> np.ndarray:
        """Effective signed weights of tile ``span`` under the map.

        ``w`` is the signed (r_len, c_len) sub-matrix; the result stays
        in the signed ``weight_bits`` range, so every downstream path
        (offset-encoded oracle, exact matmul, f32 split planes) remains
        valid.  Pure and memoized per span — both simulators call this
        with identical spans, which is the bit-exactness contract.
        """
        sf = self._span(name, span)
        if sf.identity:
            return w
        r_len, c_len = span[1] - span[0], span[3] - span[2]
        if w.shape != (r_len, c_len):
            raise ValueError(f"{name}: weights {w.shape} != span "
                             f"{(r_len, c_len)}")
        w_u = w.astype(np.int64) + self._ow
        out = np.zeros_like(w_u)
        for k in range(len(self.slice_bits)):
            max_k = (1 << self.slice_bits[k]) - 1
            v = (w_u >> self.slice_shift[k]) & max_k
            if sf.drift is not None:
                v = np.clip(v + sf.drift[k], 0, max_k)
            if sf.mask is not None:
                v = np.where(sf.mask[k], sf.val[k], v)
            out += v << self.slice_shift[k]
        return (out - self._ow).astype(w.dtype)

    def tile_offset(self, name: str, span: Span) -> Optional[np.ndarray]:
        """Folded post-MVM ADC-offset term for tile ``span``: an int64
        ``(c_len,)`` vector added to the tile's digital partial sum, or
        ``None`` when the tile's offsets are all zero (or calibrated out
        by remapping)."""
        return self._span(name, span).offset

    def span_deficit(self, name: str, span: Span) -> Tuple[int, int]:
        """(rows, column groups) of the tile that could not be placed on
        clean lines — the fault-aware compile loop's retirement signal
        (always 0 when every line found a clean home)."""
        sf = self._span(name, span)
        return sf.deficit_rows, sf.deficit_cols


# ---------------------------------------------------------------------------
# Fault-aware compilation (compiler tier)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FaultCompileResult:
    """Outcome of ``fault_aware_compile``: the (retired-geometry)
    compile, the remapping fault map to run it under, and how much
    geometry the retirement loop gave up."""

    result: object                  # core.compiler.CompileResult
    faults: FaultMap
    retired_rows: int
    retired_cols: int               # physical bitlines retired
    attempts: int


def plan_spans(plan, program) -> Dict[str, list]:
    """Every node's crossbar-tile spans of a compiled (plan, program) —
    the same span resolution the executor lowers from, so remap
    verification and runtime fault application can never disagree."""
    from .executor import _collect_units
    seg_of = {(p.node.name, p.chunk): si
              for si, seg in enumerate(plan.segments)
              for p in seg.placements}
    placements = {(p.node.name, p.chunk): p for p in plan.placements}
    units = _collect_units(program, placements, plan.graph, plan.arch,
                           seg_of)
    return {name: [span for span, _ in tagged]
            for name, tagged in units.items()}


def fault_aware_compile(graph, arch: CIMArch, model: FaultModel, *,
                        level=None, max_rounds: int = 6,
                        **compile_kwargs) -> FaultCompileResult:
    """Compile ``graph`` so every weight line lands on fault-free
    hardware of ``arch`` under ``model``.

    Iteratively retires wordlines/bitlines from the bindable geometry
    (``retired_geometry``) — the recompile re-spreads duplication over
    the shrunk tiles via the standard ``balance_duplication`` pass —
    until the remapping ``FaultMap`` finds clean lines for every tile
    span, or raises ``FaultBudgetError`` when retirement exhausts the
    crossbar (or ``max_rounds`` budget-growth rounds were not enough).
    """
    from ..core import compiler
    retire_r, retire_c = 0, 0
    fm = FaultMap(model, arch, remap=True)
    S = fm.slices
    for attempt in range(1, max_rounds + 1):
        arch_r = retired_geometry(arch, retire_r, retire_c)
        res = compiler.compile_graph(graph, arch_r, level=level,
                                     **compile_kwargs)
        fm = FaultMap(model, arch, remap=True)
        need_r = need_c = 0
        for name, spans in plan_spans(res.plan, res.program).items():
            for span in spans:
                dr, dc = fm.span_deficit(name, span)
                need_r, need_c = max(need_r, dr), max(need_c, dc)
        if need_r == 0 and need_c == 0:
            res.plan.notes["fault_retired"] = {
                "rows": retire_r, "cols": retire_c, "attempts": attempt}
            obs_metrics.count("fault_compile_attempts_total", n=attempt,
                              workload=graph.name)
            if retire_r or retire_c:
                obs_metrics.count("fault_retired_lines_total",
                                  n=retire_r + retire_c,
                                  workload=graph.name)
            tr = obs_trace.get_trace()
            if tr is not None:
                tr.instant(obs_trace.COMPILER_TRACK, "fault_remap",
                           "faults", obs_trace.now_s(), tenant=graph.name,
                           rows=retire_r, cols=retire_c, attempts=attempt)
            return FaultCompileResult(result=res, faults=fm,
                                      retired_rows=retire_r,
                                      retired_cols=retire_c,
                                      attempts=attempt)
        obs_metrics.count("fault_retry_rounds_total", workload=graph.name)
        retire_r += need_r
        retire_c += need_c * S
    raise FaultBudgetError(
        f"no clean mapping within {max_rounds} retirement rounds "
        f"(reached {retire_r} rows / {retire_c} cols retired on "
        f"{arch.name})", retire_rows=retire_r, retire_cols=retire_c)


# ---------------------------------------------------------------------------
# Executor-backed robustness metric (DSE tier)
# ---------------------------------------------------------------------------

def accuracy_under_faults(graph, arch: CIMArch, model: FaultModel, *,
                          n_inputs: int = 8, seed: int = 0, level=None,
                          remap: bool = False, params=None,
                          mode: Optional[str] = None, device="cuda",
                          **compile_kwargs) -> float:
    """Top-1 agreement with the fault-free executor under ``model``.

    Runs the trace-lowered executor twice on a seeded ``n_inputs`` batch
    — once clean, once faulted (with fault-aware remapping when
    ``remap=True``) — and returns the fraction of inputs whose argmax
    over the (flattened) first graph output agrees.  Both executors and
    the calibration pass run on ``device`` (on the card: the CUDA
    kernel); ``mode`` forces their crossbar-MVM route.
    """
    from ..core import compiler
    from ..kernels.backend import resolve_device
    from ..kernels.cim_mvm import cim_mvm_params
    from .executor import lower
    from .functional import (make_input, make_weights, reference_forward,
                             reference_mvm)
    dev = resolve_device(device)
    p = params or cim_mvm_params(arch)
    weights = make_weights(graph, seed)
    inputs = [make_input(graph, seed + i) for i in range(n_inputs)]
    _, shifts = reference_forward(graph, weights, inputs[0],
                                  mvm=reference_mvm(p, dev, mode))
    batched = {name: np.stack([x[name] for x in inputs])
               for name in graph.inputs}

    base = compiler.compile_graph(graph, arch, level=level,
                                  **compile_kwargs)
    clean_exe = lower(base.plan, base.program, params=p, mode=mode,
                      device=dev)
    clean = clean_exe.run_batch(batched, weights=weights, shifts=shifts)

    if remap:
        fc = fault_aware_compile(graph, arch, model, level=level,
                                 **compile_kwargs)
        faulted_exe = lower(fc.result.plan, fc.result.program, params=p,
                            mode=mode, device=dev, faults=fc.faults)
    else:
        faulted_exe = lower(base.plan, base.program, params=p, mode=mode,
                            device=dev, faults=FaultMap(model, arch))
    faulted = faulted_exe.run_batch(batched, weights=weights,
                                    shifts=shifts)

    out = graph.outputs[0]
    a = np.asarray(clean[out]).reshape(n_inputs, -1).argmax(axis=1)
    b = np.asarray(faulted[out]).reshape(n_inputs, -1).argmax(axis=1)
    return float((a == b).mean())
