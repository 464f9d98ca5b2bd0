"""Campaign scorecards — lm-eval-harness-style result tables.

A DSE campaign produces a pile of nested dataclasses; comparing two
campaigns (halving vs adaptive, last week's space vs this week's) means
diffing them by hand.  This module flattens a campaign — or a single
search — into a ``Scorecard``: a named table with typed rows, a metadata
header, and two serializations:

  * ``to_markdown()`` — the pipe-table format eval harnesses print, so a
    scorecard drops into a PR description or a benchmark log verbatim;
  * ``to_json()``     — a stable machine-readable form (sorted keys) for
    committing next to ``BENCH_dse.json`` or diffing across runs.

Every row carries the *spend* (full-fidelity compiles paid, against the
exhaustive price) next to the *outcome* (best objective, frontier size),
so "same best point, 40x cheaper" is one line, not an archaeology
session.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from ..obs import metrics as obs_metrics

__all__ = ["Scorecard", "campaign_scorecard", "search_scorecard"]


def _obs_meta(meta: Dict[str, Any]) -> Dict[str, Any]:
    """Fold the live metrics registry's compile-cache and DSE series
    into a scorecard's metadata (``obs_<series>`` keys) — when telemetry
    is enabled, every scorecard shows what the process actually paid."""
    reg = obs_metrics.active()
    if reg is not None:
        for series, v in reg.flat(prefix=("compile_cache_", "dse_")).items():
            meta[f"obs_{series}"] = v
    return meta


def _fmt(v: Any) -> str:
    if isinstance(v, bool) or v is None:
        return str(v)
    if isinstance(v, float):
        if v != v:                      # nan
            return "-"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return f"{v:.4g}"
    return str(v)


@dataclasses.dataclass
class Scorecard:
    """A named result table (rows are column->value mappings)."""

    title: str
    columns: List[str]
    rows: List[Dict[str, Any]]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps({"title": self.title, "meta": self.meta,
                           "columns": self.columns, "rows": self.rows},
                          sort_keys=True, indent=indent)

    def to_markdown(self) -> str:
        """Pipe table plus a ``key: value`` metadata header."""
        lines = [f"### {self.title}"]
        for k in sorted(self.meta):
            lines.append(f"{k}: {_fmt(self.meta[k])}")
        if self.meta:
            lines.append("")
        widths = {c: max(len(c), *(len(_fmt(r.get(c))) for r in self.rows))
                  if self.rows else len(c) for c in self.columns}
        lines.append("|" + "|".join(c.ljust(widths[c])
                                    for c in self.columns) + "|")
        lines.append("|" + "|".join("-" * widths[c]
                                    for c in self.columns) + "|")
        for r in self.rows:
            lines.append("|" + "|".join(
                _fmt(r.get(c)).ljust(widths[c]) for c in self.columns) + "|")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.to_markdown()


def campaign_scorecard(campaign, title: str = "DSE campaign") -> Scorecard:
    """One row per workload of a ``CampaignResult``.

    Works for every campaign mode; adaptive campaigns additionally
    surface the per-workload proxy spend when the outcome's rung log
    carries it.  ``meta`` records the campaign shape, the cache counters
    (including cross-campaign ``foreign_hits`` when the store is
    shared), and the robust-point count.
    """
    columns = ["workload", "points", "feasible", "frontier",
               "full_evals", "exhaustive", "reduction",
               "best_cost", "best_point"]
    rows: List[Dict[str, Any]] = []
    for name, w in campaign.workloads.items():
        b = w.best
        n_points = campaign.n_points
        rows.append({
            "workload": name,
            "points": n_points,
            "feasible": sum(r.ok for r in w.results),
            "frontier": len(w.frontier),
            "full_evals": w.full_evals,
            "exhaustive": n_points,
            "reduction": (f"{n_points / w.full_evals:.1f}x"
                          if w.full_evals else "-"),
            "best_cost": (b.metrics[w.objective] if b else None),
            "best_point": (b.point.label() if b else "infeasible"),
        })
    meta: Dict[str, Any] = {
        "mode": campaign.mode,
        "workloads": len(campaign.workloads),
        "n_points": campaign.n_points,
        "full_evals": campaign.full_evals,
        "exhaustive_evals": campaign.exhaustive_evals,
        "robust_points": len(campaign.robust),
        "robust_tol": campaign.robust_tol,
    }
    if campaign.cache_stats is not None:
        for k, v in sorted(campaign.cache_stats.items()):
            meta[f"cache_{k}"] = v
    return Scorecard(title=title, columns=columns, rows=rows,
                     meta=_obs_meta(meta))


def search_scorecard(result, name: str = "search",
                     title: Optional[str] = None) -> Scorecard:
    """One row per rung of a ``SearchResult`` / ``AdaptiveResult``."""
    columns = ["rung", "fidelity", "evaluated", "promoted", "full_evals"]
    rows = [{"rung": r.rung, "fidelity": r.fidelity,
             "evaluated": r.evaluated, "promoted": r.promoted,
             "full_evals": r.full_evals} for r in result.rungs]
    b = result.best
    meta: Dict[str, Any] = {
        "workload": name,
        "n_points": result.n_points,
        "objective": result.objective,
        "full_evals": result.full_evals,
        "best_cost": (b.metrics[result.objective] if b else None),
        "best_point": (b.point.label() if b else "infeasible"),
    }
    for extra in ("proxy_evals", "prefix_evals", "ask_rounds"):
        v = getattr(result, extra, None)
        if v is not None:
            meta[extra] = v
    return Scorecard(title=title or f"{name} search", columns=columns,
                     rows=rows, meta=_obs_meta(meta))
