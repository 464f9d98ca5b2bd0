"""VXB (Virtual Crossbar) construction and dimension binding (§3.3.3, Fig. 7).

A *VXB* is the set of physical crossbars that collaborate to perform a
single MVM: the logical weight matrix (R rows x C cols x B weight bits)
is bound onto the physical crossbar grid.  The paper's dimension-binding
scheme offers two placements for the bit dimension:

  * ``B -> XBC`` (default): weight bits spread to *adjacent columns* of the
    same crossbar, so a logical column consumes ``ceil(B/cell_precision)``
    physical columns.
  * ``B -> XB``: bit slices live on *different crossbars*, each crossbar
    holding one slice of the full R x C matrix.

R always binds to XBR (wordlines) and C to XBC (bitlines).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import List

from ..obs import hooks as obs_hooks
from .abstraction import CIMArch
from .graph import Node, weight_matrix_shape


class BitBinding(enum.Enum):
    B_TO_XBC = "B->XBC"     # bits to adjacent columns (Figure 7 default)
    B_TO_XB = "B->XB"       # bits to separate crossbars


def bind_error_msg(cols: int, slices: int) -> str:
    """The ``bind`` infeasibility message for B->XBC with too few columns.

    Single-sourced so the batched proxy's masked-infeasibility reasons
    (dse.proxy_vec) can never drift from the scalar raise."""
    return (f"crossbar has {cols} columns < {slices} bit slices; "
            "use BitBinding.B_TO_XB for this cell precision")


def vxb_span_error(name: str, span: int, cap: int) -> str:
    """The over-capacity message for a VXB column unit spanning more
    crossbars than the chip offers (cg_opt chunking, proxy screening)."""
    return (f"{name}: one VXB column unit spans {span} crossbars but the "
            f"chip offers only {cap}")


@dataclasses.dataclass(frozen=True)
class VXBMapping:
    """How one operator copy's weight matrix occupies physical crossbars."""

    r: int                      # logical rows of weight matrix
    c: int                      # logical cols
    binding: BitBinding
    col_slices: int             # physical columns per logical weight
    grid_r: int                 # crossbars stacked along R
    grid_c: int                 # crossbars stacked along C (incl. bit slices)
    rows_used_last: int         # wordlines used in the last row-tile
    cols_used_last: int         # bitlines used in the last col-tile

    @property
    def n_xbs(self) -> int:
        """Physical crossbars holding one full copy of the weight matrix."""
        return self.grid_r * self.grid_c

    @property
    def xbs_per_vxb(self) -> int:
        """Crossbars composing one VXB (the unit computing one sub-MVM tile
        at full weight precision).  With ``B->XBC`` the bit slices share a
        crossbar, so a VXB is a single crossbar; with ``B->XB`` one VXB
        spans ``col_slices`` crossbars."""
        return self.col_slices if self.binding is BitBinding.B_TO_XB else 1

    @property
    def n_vxb(self) -> int:
        """VXB tiles needed to cover the whole weight matrix (``num_VXB``
        of Eq. 1)."""
        return self.n_xbs // self.xbs_per_vxb


def bind(node_or_rc, arch: CIMArch,
         binding: BitBinding = BitBinding.B_TO_XBC) -> VXBMapping:
    """Bind a weight matrix to the crossbar grid of ``arch``."""
    if isinstance(node_or_rc, Node):
        r, c = weight_matrix_shape(node_or_rc)
    else:
        r, c = node_or_rc
    slices = math.ceil(arch.weight_bits / arch.xb.cell_precision)
    xr, xc = arch.xb.rows, arch.xb.cols

    grid_r = math.ceil(r / xr)
    if binding is BitBinding.B_TO_XBC:
        # a logical column's bit slices live in adjacent physical columns
        # of the same crossbar (never straddling two crossbars), so each
        # crossbar holds floor(cols / slices) logical columns
        if xc < slices:
            raise ValueError(bind_error_msg(xc, slices))
        cols_per_xb = xc // slices
        grid_c = math.ceil(c / cols_per_xb)
        cols_last = (c - (grid_c - 1) * cols_per_xb) * slices
    else:
        per_slice_grid_c = math.ceil(c / xc)
        grid_c = per_slice_grid_c * slices
        cols_last = c - (per_slice_grid_c - 1) * xc

    rows_last = r - (grid_r - 1) * xr
    m = VXBMapping(r=r, c=c, binding=binding, col_slices=slices,
                   grid_r=grid_r, grid_c=grid_c,
                   rows_used_last=rows_last, cols_used_last=cols_last)
    # gated at the call site: bind runs in DSE inner loops, so the
    # payload must not be built unless a provenance subscriber is live
    if obs_hooks.subscribed():
        obs_hooks.emit("mapping.bind", r=r, c=c, binding=binding.value,
                       col_slices=slices, grid_r=grid_r, grid_c=grid_c,
                       n_xbs=m.n_xbs)
    return m


def bind_arrays(r, c, *, rows, cols, slices, b_to_xb):
    """Array-shaped twin of ``bind`` over a (points x nodes) broadcast.

    ``r``/``c`` are per-node integer arrays (shape ``(N,)`` or ``(P, N)``)
    and ``rows``/``cols``/``slices``/``b_to_xb`` per-point columns (shape
    ``(P, 1)``); everything broadcasts to ``(P, N)``.  Returns a dict of
    int64 arrays ``grid_r``/``grid_c``/``n_xbs``/``xbs_per_vxb`` plus the
    boolean ``feasible`` mask (False exactly where scalar ``bind`` raises:
    B->XBC with fewer physical columns than bit slices).  Entries of
    infeasible points are computed with guarded denominators and carry no
    meaning — mask before use.

    Bit-exact against ``bind``: every quantity is the same integer
    ceiling/floor arithmetic, just broadcast.  The scalar path stays the
    oracle (tests/test_proxy_vec.py anchors the equivalence).
    """
    import numpy as np

    r = np.asarray(r, dtype=np.int64)
    c = np.asarray(c, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    slices = np.asarray(slices, dtype=np.int64)
    b_to_xb = np.asarray(b_to_xb, dtype=bool)

    feasible = b_to_xb | (cols >= slices)
    grid_r = -(-r // np.maximum(rows, 1))
    # B->XBC: bit slices share a crossbar -> floor(cols/slices) logical
    # columns per crossbar; B->XB: one slice per crossbar, full columns
    cols_per_xb = np.maximum(cols // np.maximum(slices, 1), 1)
    grid_c_xbc = -(-c // cols_per_xb)
    grid_c_xb = -(-c // np.maximum(cols, 1)) * slices
    grid_c = np.where(b_to_xb, grid_c_xb, grid_c_xbc)
    n_xbs = grid_r * grid_c
    xbs_per_vxb = np.where(b_to_xb, slices, 1)
    out = np.broadcast_arrays(grid_r, grid_c, n_xbs, xbs_per_vxb,
                              feasible | np.zeros_like(grid_r, dtype=bool))
    return {"grid_r": out[0], "grid_c": out[1], "n_xbs": out[2],
            "xbs_per_vxb": out[3], "feasible": out[4]}


class FaultBudgetError(ValueError):
    """Fault retirement exceeds the crossbar's capacity: after retiring
    the requested faulty wordlines/bitlines the remaining geometry cannot
    bind any weight tile (or the fault-aware compile loop could not find
    enough clean lines within its retirement budget).  Carries
    ``retire_rows``/``retire_cols`` so callers can report how far the
    retirement climbed before giving up."""

    def __init__(self, msg: str, *, retire_rows: int = 0,
                 retire_cols: int = 0):
        self.retire_rows = retire_rows
        self.retire_cols = retire_cols
        super().__init__(msg)


def retired_geometry(arch: CIMArch, retire_rows: int = 0,
                     retire_cols: int = 0) -> CIMArch:
    """``arch`` with ``retire_rows`` wordlines and ``retire_cols``
    bitlines removed from every crossbar's bindable geometry.

    This is the compiler half of fault-aware remapping: compiling
    against the shrunk crossbar leaves each physical tile spare lines,
    which the runtime fault map's clean-line selection then uses to
    steer every weight row/column group away from faulty hardware
    (``cimsim.faults.FaultMap(remap=True)``).  ``parallel_row`` is
    clamped to the surviving rows.  Raises ``FaultBudgetError`` when the
    retirement leaves no bindable geometry (no rows, or fewer columns
    than one logical weight's bit slices).
    """
    rows = arch.xb.rows - int(retire_rows)
    cols = arch.xb.cols - int(retire_cols)
    slices = math.ceil(arch.weight_bits / arch.xb.cell_precision)
    if rows < 1 or cols < slices:
        raise FaultBudgetError(
            f"retiring {retire_rows} rows / {retire_cols} cols of a "
            f"{arch.xb.rows}x{arch.xb.cols} crossbar leaves {rows}x{cols} "
            f"— below the {max(1, slices)}-column minimum for "
            f"{arch.weight_bits}-bit weights",
            retire_rows=retire_rows, retire_cols=retire_cols)
    xb = dataclasses.replace(
        arch.xb, xb_size=(rows, cols),
        parallel_row=min(arch.xb.parallel_row, rows))
    name = arch.name
    if retire_rows or retire_cols:
        name = f"{arch.name}-ret{retire_rows}r{retire_cols}c"
    return arch.replace(xb=xb, name=name)


def vxbs_per_core(arch: CIMArch, mapping: VXBMapping) -> int:
    """``Core_VXB`` of Eq. (1): VXBs that fit in one core."""
    return arch.core.n_xbs // mapping.xbs_per_vxb


def cores_per_copy(arch: CIMArch, mapping: VXBMapping) -> int:
    """Cores one operator copy occupies (CG-grained granularity)."""
    return max(1, math.ceil(mapping.n_xbs / arch.core.n_xbs))


def row_tile_rows(mapping: VXBMapping, arch: CIMArch) -> List[int]:
    """Wordlines used by each row tile of the VXB."""
    full = arch.xb.rows
    return [full] * (mapping.grid_r - 1) + [mapping.rows_used_last]


def logical_cols_per_xb(mapping: VXBMapping, arch: CIMArch) -> int:
    """Logical (full-precision) weight columns held by one crossbar."""
    if mapping.binding is BitBinding.B_TO_XBC:
        return max(1, arch.xb.cols // mapping.col_slices)
    return arch.xb.cols
