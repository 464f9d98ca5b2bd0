"""Compile provenance — "why does my network run the way it runs".

CIM-MLC's output is a pile of cross-tier decisions: which scheduling
tier each operator was compiled under, how its weight matrix was bound
onto crossbars, how many copies the duplication search paid for, which
schedule segment it landed in, whether the pipeline or the ping-pong
rebuild won, and (under faults) how many lines were retired.  All of
it is recorded on the ``SchedulePlan`` — but scattered over
placements, ``node.sched`` annotations and ``plan.notes``.

``ExplainReport`` flattens one compile into a per-node provenance
table (every graph node gets a row — DCOM nodes show as the digital
tier) plus a metadata header with the plan-level decisions, rendered
as a markdown pipe table (via the DSE :class:`~repro_torch.dse.report.
Scorecard`) or stable JSON.  ``explain_compile`` runs a compile with
the :mod:`repro_torch.obs.hooks` provenance events captured, so the report
also carries what only the compile *driver* knows — wall time, cache
provenance, the ping-pong decision.

The JAX package's ``tools/explain.py`` CLI has no counterpart here yet.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from . import hooks

__all__ = ["ExplainReport", "explain_compile"]

#: per-node provenance columns, in render order
COLUMNS = ["node", "op", "tier", "segment", "chunks", "dup", "cores",
           "xbs", "grid", "binding", "row_spread", "vxb_slots", "windows"]


@dataclasses.dataclass
class ExplainReport:
    """Per-node compile provenance for one compiled plan."""

    rows: List[Dict[str, Any]]
    meta: Dict[str, Any]
    columns: List[str] = dataclasses.field(
        default_factory=lambda: list(COLUMNS))

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_result(cls, result) -> "ExplainReport":
        """Build from a ``compiler.CompileResult`` (adds the cache key)."""
        report = cls.from_plan(result.plan)
        report.meta["key"] = result.key
        return report

    @classmethod
    def from_plan(cls, plan) -> "ExplainReport":
        """Build from a ``SchedulePlan``: one row per graph node.

        CIM nodes aggregate over their chunks (an operator split across
        segments keeps one row; ``segment`` lists every segment it
        touches); DCOM nodes report the digital tier.
        """
        graph, arch = plan.graph, plan.arch
        by_node: Dict[str, List] = {}
        seg_of: Dict[str, List[int]] = {}
        for si, seg in enumerate(plan.segments):
            for p in seg.placements:
                by_node.setdefault(p.node.name, []).append(p)
                seg_of.setdefault(p.node.name, []).append(si)

        level = plan.notes.get("level")
        level_v = getattr(level, "value", level) or arch.mode.value
        rows: List[Dict[str, Any]] = []
        for node in graph.nodes:
            if node.is_cim:
                pls = by_node.get(node.name, [])
                if not pls:          # defensive: a CIM node must be placed
                    raise ValueError(f"{node.name}: CIM node has no "
                                     f"placement in the plan")
                m = pls[0].mapping
                segs = sorted(set(seg_of[node.name]))
                rows.append({
                    "node": node.name, "op": node.op_type, "tier": level_v,
                    "segment": "+".join(str(s) for s in segs),
                    "chunks": len(pls),
                    "dup": max(p.dup for p in pls),
                    "cores": sum(p.dup * p.cores for p in pls),
                    "xbs": sum(p.dup * p.mapping.n_xbs for p in pls),
                    "grid": f"{m.grid_r}x{m.grid_c}",
                    "binding": m.binding.value,
                    "row_spread": max(p.row_spread for p in pls),
                    "vxb_slots": max(p.vxb_slots for p in pls),
                    "windows": max(p.n_mvm for p in pls),
                })
            else:
                rows.append({
                    "node": node.name, "op": node.op_type, "tier": "digital",
                    "segment": "-", "chunks": 0, "dup": 0, "cores": 0,
                    "xbs": 0, "grid": "-", "binding": "-",
                    "row_spread": 0, "vxb_slots": 0, "windows": 0,
                })

        meta: Dict[str, Any] = {
            "workload": graph.name,
            "arch": arch.name,
            "arch_mode": arch.mode.value,
            "level": level_v,
            "use_pipeline": plan.use_pipeline,
            "use_duplication": plan.use_duplication,
            "ping_pong": bool(plan.notes.get("ping_pong", False)),
            "mvm_pipeline": plan.mvm_pipeline,
            "vvm_remap": plan.vvm_remap,
            "segments": len(plan.segments),
            "nodes": len(graph.nodes),
            "cim_nodes": len(graph.cim_nodes),
            "crossbars_used": sum(p.dup * p.mapping.n_xbs
                                  for p in plan.placements),
        }
        policy = plan.notes.get("policy")
        if policy:
            meta["policy"] = policy
        retired = plan.notes.get("fault_retired")
        if retired:
            meta["fault_retired_rows"] = retired.get("rows", 0)
            meta["fault_retired_cols"] = retired.get("cols", 0)
            meta["fault_retire_attempts"] = retired.get("attempts", 0)
        return cls(rows=rows, meta=meta)

    # -- accessors --------------------------------------------------------
    @property
    def coverage(self) -> float:
        """Fraction of the compiled graph's nodes carrying a row (the
        acceptance bar is 1.0 — every node explained)."""
        nodes = self.meta.get("nodes", 0)
        return len(self.rows) / nodes if nodes else 0.0

    # -- renderings -------------------------------------------------------
    def scorecard(self):
        """The report as a ``dse.report.Scorecard`` (markdown/JSON)."""
        from ..dse.report import Scorecard
        title = (f"explain {self.meta.get('workload', '?')} on "
                 f"{self.meta.get('arch', '?')}")
        return Scorecard(title=title, columns=list(self.columns),
                         rows=self.rows, meta=dict(self.meta))

    def to_markdown(self) -> str:
        return self.scorecard().to_markdown()

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps({"meta": self.meta, "columns": self.columns,
                           "rows": self.rows},
                          sort_keys=True, indent=indent)

    def __str__(self) -> str:
        return self.to_markdown()


def explain_compile(graph, arch, *, fault_model=None,
                    **compile_kwargs) -> ExplainReport:
    """Compile ``graph`` for ``arch`` and return its provenance report.

    Runs the real compiler with the provenance hooks captured, so the
    report's metadata carries the driver-side decisions (wall seconds,
    whether the artifact came from cache) on top of everything the plan
    records.  ``fault_model`` (a ``cimsim.faults.FaultModel``) routes
    through ``fault_aware_compile`` instead, adding the retired-line
    provenance.  Remaining keyword arguments are ``compile_graph``
    knobs (``level=``, ``binding=``, ``use_pipeline=``, ``cache=``...).
    """
    from ..core import compiler

    captured: Dict[str, Any] = {}

    def _capture(kind: str, payload: Dict[str, Any]) -> None:
        if kind == "compile.done":
            captured.update(payload)

    unsubscribe = hooks.subscribe(_capture)
    try:
        if fault_model is not None:
            from ..cimsim.faults import fault_aware_compile
            result = fault_aware_compile(graph, arch, fault_model,
                                         **compile_kwargs).result
        else:
            result = compiler.compile_graph(graph, arch, **compile_kwargs)
    finally:
        unsubscribe()

    report = ExplainReport.from_result(result)
    if "wall_s" in captured:
        report.meta["compile_wall_s"] = round(captured["wall_s"], 6)
    if "cached" in captured:
        report.meta["cache_hit"] = bool(captured["cached"])
    return report
