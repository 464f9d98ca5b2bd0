"""Batched, structure-of-arrays proxy cost model.

``compiler.proxy_metrics`` — the cheap rung of the multi-fidelity DSE
searcher — evaluates one design point at a time in pure Python: one
``CostModel.placement`` object per CIM node, a Python duplication
search, a per-point latency estimate.  That is fine for dozens of
points and hopeless for the 10^5-10^6-point spaces the roadmap's
Bayesian/bandit searches need: the rung's cost scales linearly in
Python-interpreter time with space size.

``proxy_metrics_batch`` evaluates the *same analytic model* for an
entire array of design points in one vectorized NumPy pass:

  * the per-workload **node tensor** (weight-matrix shapes, MVM window
    counts, fused-epilogue element counts — everything the graph
    contributes) is computed once per graph and broadcast against the
    per-point axis;
  * per-point Abs-arch scalars (crossbar geometry, cell/DAC precision,
    core and chip counts, bandwidths) form ``(n_points, 1)`` columns, so
    every placement attribute (``n_mvm``, ``cores``, ``phases``,
    ``row_groups``, ``t_load``, ``alu_epilogue``, ``n_xbs``) becomes one
    ``(n_points, n_nodes)`` tensor (``mapping.bind_arrays``);
  * the duplication searches run as their array twins
    (``cg_opt.balance_duplication_arr`` / ``greedy_duplication_arr``),
    the WLM row-spread heuristic as a rank-ordered vector scan, and the
    latency/power/crossbar reductions as per-point columns.

**Bit-exactness contract**: for every feasible point the batched result
equals the scalar ``proxy_metrics`` dict bit for bit — same bisection
trajectory, same heap pop order, same floating-point operation order
(tests/test_proxy_vec.py anchors this, point by point, against the
scalar oracle).  Points the scalar path would *raise* on come back as
masked entries (``feasible[i] == False``) whose ``errors[i]`` string
equals ``f"{type}: {message}"`` of the scalar raise, so the searcher can
rank what survives without a single try/except.

Degenerate arch parameters (zero-sized crossbars, zero bandwidths, zero
DAC bits...) would need per-point exception replay that vectorization
cannot express; those rare points are routed through the scalar oracle
itself, keeping the contract exact everywhere.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core import compiler
from ..core.abstraction import CIMArch, ComputingMode
from ..core.cg_opt import (balance_duplication_arr,
                           estimate_segment_cycles_arr,
                           fused_epilogue_elems, greedy_duplication_arr,
                           seq_sum)
from ..core.graph import Graph, n_mvm, weight_matrix_shape
from ..core.mapping import (BitBinding, bind_arrays, bind_error_msg,
                            vxb_span_error)
from .runner import resolve_space
from .space import DesignPoint, DesignSpace


# ---------------------------------------------------------------------------
# Per-workload node tensor (arch-independent, computed once per graph)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NodeTensor:
    """Everything one graph contributes to a placement, as arrays.

    One row per CIM node (topological order, like ``graph.cim_nodes``):
    weight-matrix shape, MVM window count, and the ordered fused-epilogue
    element counts (zero-padded — a zero contributes ``0.0 / alu = 0.0``
    to the epilogue sum, preserving the scalar summation order exactly).
    """

    names: List[str]
    r: np.ndarray               # (N,) weight-matrix rows
    c: np.ndarray               # (N,) weight-matrix cols
    windows: np.ndarray         # (N,) MVMs per inference
    epi_elems: np.ndarray       # (N, S) fused successor output elements

    @classmethod
    def from_graph(cls, graph: Graph) -> "NodeTensor":
        nodes = graph.cim_nodes
        rc = [weight_matrix_shape(nd) for nd in nodes]
        epi = [fused_epilogue_elems(nd, graph) for nd in nodes]
        width = max((len(e) for e in epi), default=0)
        return cls(
            names=[nd.name for nd in nodes],
            r=np.array([r for r, _ in rc], dtype=np.int64),
            c=np.array([c for _, c in rc], dtype=np.int64),
            windows=np.array([n_mvm(nd, graph.shapes) for nd in nodes],
                             dtype=np.int64),
            epi_elems=np.array(
                [e + [0] * (width - len(e)) for e in epi],
                dtype=np.int64).reshape(len(nodes), width),
        )

    def __len__(self) -> int:
        return len(self.names)


# ---------------------------------------------------------------------------
# Result container
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BatchedProxyMetrics:
    """Structure-of-arrays proxy metrics for a batch of design points."""

    points: List[DesignPoint]
    feasible: np.ndarray            # (P,) bool
    latency_cycles: np.ndarray      # (P,) float64
    compute_cycles: np.ndarray      # (P,) float64
    rewrite_cycles: np.ndarray      # (P,) float64
    peak_power: np.ndarray          # (P,) float64
    crossbars_used: np.ndarray      # (P,) int64
    #: per point: ``None`` when feasible, else the scalar path's
    #: ``f"{ExceptionType}: {message}"`` string
    errors: List[Optional[str]]

    def __len__(self) -> int:
        return len(self.points)

    def metrics(self, i: int) -> Optional[Dict[str, float]]:
        """The scalar ``proxy_metrics`` dict of point ``i`` (bit-exact),
        or ``None`` if the point is masked infeasible."""
        if not self.feasible[i]:
            return None
        return {
            "latency_cycles": float(self.latency_cycles[i]),
            "compute_cycles": float(self.compute_cycles[i]),
            "rewrite_cycles": float(self.rewrite_cycles[i]),
            "peak_power": float(self.peak_power[i]),
            "crossbars_used": int(self.crossbars_used[i]),
            "fidelity": "proxy",
        }

    def metrics_list(self) -> List[Optional[Dict[str, float]]]:
        return [self.metrics(i) for i in range(len(self.points))]


# ---------------------------------------------------------------------------
# Per-point scalar extraction
# ---------------------------------------------------------------------------

#: per-point Abs-arch scalars consumed by the vector path (column order
#: of the extraction matrix)
_FIELDS = ("rows", "cols", "par_row", "dac", "slices", "act", "nxbs_core",
           "ncores", "l1", "alu", "t_write")
_RANK = {"CM": 0, "XBM": 1, "WLM": 2}


def _arch_scalars(arch: CIMArch) -> Dict[str, float]:
    return {
        "rows": arch.xb.rows, "cols": arch.xb.cols,
        "par_row": arch.xb.parallel_row, "dac": arch.xb.dac_bits,
        "slices": arch.col_slices, "act": arch.act_bits,
        "nxbs_core": arch.core.n_xbs, "ncores": arch.chip.n_cores,
        "l1": arch.core.l1_bw_bits, "alu": arch.chip.alu_ops_per_cycle,
        "t_write": arch.t_write_xb(),
    }


def _is_degenerate(s: Dict[str, float], arch: CIMArch) -> bool:
    """Parameters whose exception behaviour (zero divisions raised node
    by node) only the scalar path replays faithfully."""
    return (s["rows"] <= 0 or s["cols"] <= 0 or s["dac"] <= 0
            or s["slices"] <= 0 or s["ncores"] <= 0 or s["nxbs_core"] <= 0
            or s["act"] <= 0 or arch.weight_bits <= 0
            or s["l1"] == 0 or s["alu"] == 0)


def _extract_point(arch0: CIMArch, pt: DesignPoint, n_nodes: int) -> Tuple:
    """Per-(overrides, level) extraction record, memoized by the caller.

    Returns ``("vec", scalar_row, mode_wlm, level_xbm, level_wlm)`` for
    vector-path points, ``("fallback",)`` for degenerate arches, and two
    error kinds that preserve the scalar path's raise *order* around the
    per-point binding normalization: ``("error_pre", msg)`` for failures
    that precede it (bad override path, invalid level value) and
    ``("error_mode", msg)`` for the mode-allows rejection that follows
    it."""
    try:
        arch = pt.arch_for(arch0)
    except Exception as e:   # bad override path: per-point error, like
        return ("error_pre", f"{type(e).__name__}: {e}")   # the scalar job
    s = _arch_scalars(arch)
    if n_nodes and _is_degenerate(s, arch):
        return ("fallback",)
    # the scalar paths normalize via ComputingMode(level): accept enum
    # values, replay the exact raise for invalid ones
    lvl = pt.level.value if isinstance(pt.level, ComputingMode) else pt.level
    rank = _RANK.get(lvl)
    if rank is None:
        try:
            rank = ComputingMode(pt.level).rank
        except Exception as e:
            return ("error_pre", f"{type(e).__name__}: {e}")
    if rank > arch.mode.rank:
        return ("error_mode", "ValueError: " + compiler.mode_error(
            arch, ComputingMode(lvl)))
    return ("vec", tuple(s[f] for f in _FIELDS),
            arch.mode is ComputingMode.WLM, rank >= 1, rank >= 2)


def _scalar_oracle(graph: Graph, arch: CIMArch, point: DesignPoint,
                   ) -> Tuple[Optional[dict], Optional[str]]:
    """(metrics, error) via the scalar ``proxy_metrics`` — the fallback
    for degenerate points and the semantics net of the runner."""
    try:
        return compiler.proxy_metrics(graph, arch,
                                      **point.compile_kwargs()), None
    except Exception as e:
        return None, f"{type(e).__name__}: {e}"


# ---------------------------------------------------------------------------
# The batched evaluation
# ---------------------------------------------------------------------------

def proxy_metrics_batch(
    graph: Graph,
    space: Union[DesignSpace, Sequence[DesignPoint]],
    base_arch: Optional[CIMArch] = None, *,
    node_tensor: Optional[NodeTensor] = None,
) -> BatchedProxyMetrics:
    """Analytic proxy metrics for *every* point of ``space`` in one
    vectorized pass.

    ``space`` is a ``DesignSpace`` (its ``arch`` is the base) or an
    explicit point list plus ``base_arch`` — the same convention as
    ``dse.sweep``.  Pass ``node_tensor`` (``NodeTensor.from_graph``) to
    amortize the per-graph extraction across calls.

    Bit-exact against scalar ``compiler.proxy_metrics`` per point;
    infeasible points are masked, not raised (see module docstring).
    """
    points, arch0 = resolve_space(space, base_arch)
    nt = node_tensor if node_tensor is not None else NodeTensor.from_graph(graph)
    n_points, n_nodes = len(points), len(nt)
    if n_points == 0:
        z = np.zeros(0)
        return BatchedProxyMetrics([], np.zeros(0, dtype=bool), z, z, z, z,
                                   np.zeros(0, dtype=np.int64), [])

    feasible = np.zeros(n_points, dtype=bool)
    latency = np.zeros(n_points)
    compute = np.zeros(n_points)
    rewrite = np.zeros(n_points)
    peak = np.zeros(n_points)
    xbs_used = np.zeros(n_points, dtype=np.int64)
    errors: List[Optional[str]] = [None] * n_points

    # -- per-point scalar extraction (the only per-point Python loop).
    # The arch build and scalar bundle are memoized per distinct
    # (overrides, level) pair — a cross-product space shares a handful of
    # those across thousands of points.  The hot probe keys on the
    # *identity* of the overrides tuple (DesignSpace reuses one tuple per
    # arch variant, and the points keep them alive for the duration of
    # this call); value-equal but distinct tuples (hand-built or
    # unpickled points) fall back to a value-keyed lookup and register an
    # id alias, so memoization never silently degrades to per-point cost.
    zero_row = (0.0,) * (len(_FIELDS) + 3)
    table: List[Tuple] = []                 # distinct extraction rows
    kinds: List[int] = []                   # 0 = vec, 1 = error, 2 = fallback
    msgs: List[Optional[str]] = []
    memo_id: Dict[Tuple, int] = {}
    memo_val: Dict[Tuple, int] = {}
    rid_list: List[int] = []
    _KIND = {"vec": 0, "error_pre": 1, "fallback": 2, "error_mode": 3}
    for pt in points:
        key = (id(pt.arch_overrides), pt.level)
        rid = memo_id.get(key)
        if rid is None:
            vkey = (pt.arch_overrides, pt.level)
            try:
                rid = memo_val.get(vkey)
            except TypeError:       # unhashable override value: no value
                vkey = None         # aliasing, id memo still applies
                rid = None
            if rid is None:
                ent = _extract_point(arch0, pt, n_nodes)
                rid = len(kinds)
                kinds.append(_KIND[ent[0]])
                if ent[0] == "vec":
                    msgs.append(None)
                    table.append(ent[1] + (ent[2], ent[3], ent[4]))
                else:
                    msgs.append(ent[1] if len(ent) > 1 else None)
                    table.append(zero_row)
                if vkey is not None:
                    memo_val[vkey] = rid
            memo_id[key] = rid
        rid_list.append(rid)

    rid_arr = np.array(rid_list, dtype=np.int64)
    kind_pt = np.array(kinds, dtype=np.int64)[rid_arr]
    # binding is normalized like the scalar BitBinding(self.binding):
    # enum values accepted, invalid values replayed as the scalar raise.
    # Scalar raise order around it: override/level errors come first,
    # binding errors next, the mode-allows rejection after.
    bvals = [p.binding for p in points]
    b_to_xb = np.fromiter(
        (b == "B->XB" or b is BitBinding.B_TO_XB for b in bvals),
        dtype=bool, count=n_points)
    valid_b = np.fromiter(
        (b == "B->XB" or b == "B->XBC" or b is BitBinding.B_TO_XB
         or b is BitBinding.B_TO_XBC for b in bvals),
        dtype=bool, count=n_points)
    for k in np.flatnonzero(kind_pt == 1):            # error_pre
        errors[k] = msgs[rid_arr[k]]
    fallback = list(np.flatnonzero(kind_pt == 2))
    for k in np.flatnonzero(~valid_b & (kind_pt != 1) & (kind_pt != 2)):
        try:
            b = BitBinding(bvals[k])
        except Exception as e:
            errors[k] = f"{type(e).__name__}: {e}"
        else:                   # normalizable after all (e.g. str subclass)
            valid_b[k] = True
            b_to_xb[k] = b is BitBinding.B_TO_XB
    for k in np.flatnonzero((kind_pt == 3) & valid_b):  # error_mode
        errors[k] = msgs[rid_arr[k]]
    vec = (kind_pt == 0) & valid_b          # points on the vector path
    cols_mat = np.array(table, dtype=np.float64)[rid_arr]
    cols_f = {f: cols_mat[:, i] for i, f in enumerate(_FIELDS)}
    nf = len(_FIELDS)
    mode_wlm = cols_mat[:, nf].astype(bool)
    level_xbm = cols_mat[:, nf + 1].astype(bool)
    level_wlm = cols_mat[:, nf + 2].astype(bool)
    pipe = np.fromiter((p.use_pipeline for p in points),
                       dtype=bool, count=n_points)
    dupflag = np.fromiter((p.use_duplication for p in points),
                          dtype=bool, count=n_points)

    for k in fallback:              # degenerate arches: scalar oracle
        m, err = _scalar_oracle(graph, points[k].arch_for(arch0), points[k])
        errors[k] = err
        if m is not None:
            feasible[k] = True
            latency[k] = m["latency_cycles"]
            compute[k] = m["compute_cycles"]
            rewrite[k] = m["rewrite_cycles"]
            peak[k] = m["peak_power"]
            xbs_used[k] = m["crossbars_used"]

    if n_nodes == 0:
        # no CIM node: the scalar path skips every check but the mode one
        ok = vec
        feasible[ok] = True
        latency[ok] = 1e-9          # max(0.0, 1e-9)
        return BatchedProxyMetrics(points, feasible, latency, compute,
                                   rewrite, peak, xbs_used, errors)
    if not vec.any():
        return BatchedProxyMetrics(points, feasible, latency, compute,
                                   rewrite, peak, xbs_used, errors)

    # -- compact to the vector-path subset -------------------------------
    sub = np.flatnonzero(vec)
    P = sub.size
    fi = {f: cols_f[f][sub].astype(np.int64)[:, None] for f in
          ("rows", "cols", "par_row", "dac", "slices", "act",
           "nxbs_core", "ncores")}
    l1 = cols_f["l1"][sub][:, None]
    alu = cols_f["alu"][sub][:, None]
    t_write = cols_f["t_write"][sub]
    s_mode_wlm = mode_wlm[sub][:, None]
    s_level_xbm = level_xbm[sub]
    s_level_wlm = level_wlm[sub]
    s_b_to_xb = b_to_xb[sub][:, None]
    s_pipe = pipe[sub]
    s_dup = dupflag[sub]

    cap_xbs = (fi["ncores"] * fi["nxbs_core"])[:, 0]      # (P,)
    n_cores = fi["ncores"][:, 0]

    # -- placement attributes as (P, N) tensors --------------------------
    bound = bind_arrays(nt.r, nt.c, rows=fi["rows"], cols=fi["cols"],
                        slices=fi["slices"], b_to_xb=s_b_to_xb)
    n_xbs = bound["n_xbs"]
    grid_r = bound["grid_r"]
    cores = np.maximum(1, -(-n_xbs // fi["nxbs_core"]))
    windows = np.broadcast_to(nt.windows, (P, len(nt)))
    phases = np.maximum(1, -(-fi["act"] // fi["dac"]))
    rows_used = np.where(s_mode_wlm, np.minimum(nt.r, fi["rows"]),
                         fi["rows"])
    row_groups = np.maximum(1, -(-np.minimum(rows_used, fi["rows"])
                                 // fi["par_row"]))
    t_load = (nt.r * fi["act"]) / l1          # l1=inf -> 0.0, like scalar
    epi = np.zeros((P, len(nt)))
    for j in range(nt.epi_elems.shape[1]):    # scalar summation order
        epi = epi + nt.epi_elems[:, j] / alu
    epi = epi / np.maximum(windows, 1)
    epi = np.where(np.isfinite(alu), epi, 0.0)

    # -- infeasibility masks (same priority order as the scalar raises) --
    ok = np.ones(P, dtype=bool)
    bind_bad = ~bound["feasible"].all(axis=1)
    for i in np.flatnonzero(bind_bad):
        errors[sub[i]] = "ValueError: " + bind_error_msg(
            int(fi["cols"][i, 0]), int(fi["slices"][i, 0]))
    ok &= ~bind_bad
    span = bound["xbs_per_vxb"][:, 0]         # node-independent per point
    span_bad = ok & (span > cap_xbs)
    for i in np.flatnonzero(span_bad):
        errors[sub[i]] = "ValueError: " + vxb_span_error(
            nt.names[0], int(span[i]), int(cap_xbs[i]))
    ok &= ~span_bad

    # -- duplication (single-segment points only, like the scalar path) --
    t_mvm = phases * row_groups               # row_spread == 1 here
    t_window = np.maximum(np.maximum(t_mvm, t_load), epi)
    multi_segment = cores.sum(axis=1) > n_cores
    budget = np.where(s_level_xbm, cap_xbs, n_cores)
    cost = np.where(s_level_xbm[:, None], n_xbs, cores)
    searchable = ok & s_dup & ~multi_segment
    dup = balance_duplication_arr(windows, t_window, cost, budget,
                                  active=searchable & s_pipe)
    dup_g = greedy_duplication_arr(windows, t_window, cost, budget,
                                   active=searchable & ~s_pipe)
    dup = np.where((searchable & ~s_pipe)[:, None], dup_g, dup)

    # -- WLM row-spread heuristic (vvm_opt's remap, first order).  Only
    # rows that can actually spread (WLM level, spare crossbars, at least
    # one multi-group placement) enter the rank-ordered scan; for every
    # other row the scalar loop provably leaves row_spread at 1. --------
    row_spread = np.ones((P, len(nt)), dtype=np.int64)
    xbs_tot = (dup * n_xbs).sum(axis=1)     # dup is final: reused below
    spare0 = np.maximum(0, cap_xbs - xbs_tot)
    sp_rows = np.flatnonzero(s_level_wlm & ok & (spare0 > 0)
                             & (row_groups > 1).any(axis=1))
    if sp_rows.size:
        dup_s = dup[sp_rows]
        nx_s = n_xbs[sp_rows]
        rg_s = row_groups[sp_rows]
        stage_s = np.ceil(windows[sp_rows] / dup_s) * t_window[sp_rows]
        order = np.argsort(-stage_s, axis=1, kind="stable")
        spare = spare0[sp_rows]
        rs_s = np.ones_like(dup_s)
        pr = np.arange(sp_rows.size)
        for j in range(len(nt)):
            idx = order[:, j]
            rg = rg_s[pr, idx]
            per_spread = np.maximum(1, dup_s[pr, idx] * nx_s[pr, idx])
            k = np.minimum(rg, 1 + spare // per_spread)
            do = (rg > 1) & (k > 1)
            spare -= np.where(do, (k - 1) * per_spread, 0)
            rs_s[pr, idx] = np.where(do, k, 1)
        row_spread[sp_rows] = rs_s

    # -- latency / power / crossbar reductions ---------------------------
    t_mvm = phases * -(-row_groups // row_spread)
    t_window = np.maximum(np.maximum(t_mvm, t_load), epi)
    stage = np.ceil(windows / dup) * t_window
    lat = estimate_segment_cycles_arr(windows, dup, t_window, s_pipe)
    rew = np.where(multi_segment,
                   xbs_tot * t_write / np.maximum(n_cores, 1), 0.0)
    lat = lat + rew
    per_copy = np.where(s_level_xbm[:, None] & (grid_r > 1),
                        -(-n_xbs // grid_r), n_xbs)
    active_xbs = dup * per_copy
    pk = np.where(s_pipe, active_xbs.sum(axis=1), active_xbs.max(axis=1))
    used = np.where(multi_segment, np.minimum(xbs_tot, cap_xbs), xbs_tot)

    feasible[sub[ok]] = True
    latency[sub] = np.where(ok, np.maximum(lat, 1e-9), 0.0)
    compute[sub] = np.where(ok, seq_sum(stage), 0.0)
    rewrite[sub] = np.where(ok, rew, 0.0)
    peak[sub] = np.where(ok, pk.astype(np.float64), 0.0)
    xbs_used[sub] = np.where(ok, used, 0)
    return BatchedProxyMetrics(points, feasible, latency, compute, rewrite,
                               peak, xbs_used, errors)
