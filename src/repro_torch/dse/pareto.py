"""Pareto frontier over sweep results (all objectives minimized)."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

#: default objective vector: runtime, thermal envelope, silicon footprint
DEFAULT_OBJECTIVES: Tuple[str, ...] = (
    "latency_cycles", "peak_power", "crossbars_used")


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True if objective vector ``a`` Pareto-dominates ``b`` (minimize)."""
    return all(x <= y for x, y in zip(a, b)) and \
        any(x < y for x, y in zip(a, b))


def _vector(metrics: Dict[str, float],
            objectives: Sequence[str]) -> Tuple[float, ...]:
    return tuple(float(metrics[o]) for o in objectives)


def pareto_frontier(results: Sequence,
                    objectives: Sequence[str] = DEFAULT_OBJECTIVES) -> List:
    """Non-dominated subset of ``results``, sorted by the first objective.

    ``results`` may be ``runner.SweepResult``s (failed points are ignored)
    or plain metric dicts.  A point dominated by any other — or an exact
    duplicate of an earlier kept point — is dropped.
    """
    rows = []
    for r in results:
        metrics = r if isinstance(r, dict) else r.metrics
        if metrics is None:
            continue
        rows.append((_vector(metrics, objectives), r))

    front: List[Tuple[Tuple[float, ...], object]] = []
    for vec, r in rows:
        if any(dominates(fv, vec) or fv == vec for fv, _ in front):
            continue
        front = [(fv, fr) for fv, fr in front if not dominates(vec, fv)]
        front.append((vec, r))
    front.sort(key=lambda t: t[0])
    return [r for _, r in front]
