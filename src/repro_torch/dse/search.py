"""Multi-fidelity successive halving over a ``DesignSpace``.

Exhaustive enumeration (``runner.sweep``) pays one full compile per
point, which stops being tractable the moment ``arch_axes`` grows past a
few values per axis — the cross product is multiplicative.  Successive
halving evaluates *every* candidate only at the cheapest fidelity and
spends full compiles on a geometrically-shrinking survivor set:

  rung 0 (``proxy``)   — the analytic proxy cost model: real cost model
                         + duplication search, no codegen, no
                         event-driven simulation.  Evaluated through the
                         *batched* structure-of-arrays path
                         (``dse.proxy_vec``): the whole rung is a few
                         vectorized NumPy passes, bit-exact against
                         per-point ``compiler.proxy_metrics``, so the
                         cheap rung stays cheap at 10^5+ points;
  rung 1 (``prefix``)  — full compile of ``Graph.prefix(frac * n)``, a
                         truncated workload that costs a fraction of the
                         full model but ranks points like it;
  rung 2 (``full``)    — full compile of the full graph.

After each rung the top ``1/eta`` of surviving points (by the scalar
``objective``, ties broken by enumeration order — fully deterministic)
are promoted.  All fidelities share one ``CompileCache``: a promoted
point's prefix and full compiles are content-addressed like any other,
so re-running a search — or following it with an exhaustive sweep — pays
nothing twice.

``HalvingSearch`` is an incremental state machine (``jobs`` →
``run_jobs`` → ``observe``) so a campaign can interleave the rungs of
many workloads into a single job queue; ``successive_halving`` is the
one-workload convenience loop.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple, Union

from ..core.abstraction import CIMArch
from ..core.graph import Graph
from .cache import CompileCache
from .runner import EvalJob, SweepResult, resolve_space, run_jobs
from .space import DesignPoint, DesignSpace


@dataclasses.dataclass(frozen=True)
class Rung:
    """One step of the fidelity ladder."""

    fidelity: str               # "proxy" | "prefix" | "full"
    frac: float = 1.0           # node fraction for "prefix"

    def __post_init__(self):
        if self.fidelity not in ("proxy", "prefix", "full"):
            raise ValueError(f"unknown fidelity {self.fidelity!r}")
        if not 0.0 < self.frac <= 1.0:
            raise ValueError("frac must be in (0, 1]")


#: proxy -> half-graph compile -> full compile
DEFAULT_LADDER: Tuple[Rung, ...] = (
    Rung("proxy"), Rung("prefix", 0.5), Rung("full"))


def rung_prefix_graph(graph: Graph, frac: float) -> Graph:
    """The prefix graph a ``frac`` rung compiles (``graph`` itself when
    the fraction rounds to the whole model).

    A prefix with no CIM node compiles to an empty plan and ranks
    nothing, so the cut is extended to cover the first CIM operator.
    """
    n = max(1, round(len(graph.nodes) * frac))
    first_cim = next((i for i, nd in enumerate(graph.nodes)
                      if nd.is_cim), None)
    if first_cim is not None:
        n = max(n, first_cim + 1)
    return graph.prefix(n)


@dataclasses.dataclass
class RungLog:
    rung: int
    fidelity: str
    evaluated: int
    promoted: int
    full_evals: int             # full-fidelity evaluations in this rung


@dataclasses.dataclass
class SearchResult:
    """Outcome of one successive-halving search."""

    results: List[SweepResult]  # full-fidelity results of the finalists
    rungs: List[RungLog]
    n_points: int               # size of the enumerated space
    full_evals: int             # total full-fidelity evaluations performed
    objective: str

    @property
    def best(self) -> Optional[SweepResult]:
        ok = [r for r in self.results if r.ok]
        if not ok:
            return None
        return min(ok, key=lambda r: (r.metrics[self.objective], r.index))


class HalvingSearch:
    """Incremental successive-halving state over one workload.

    Drive it with::

        while not search.done:
            results = run_jobs(search.jobs(), cache=cache, workers=w)
            search.observe(results)

    ``jobs(index_base=..., tag=...)`` hands out the current rung's jobs
    (survivors only, at the rung's fidelity); ``observe`` consumes that
    rung's results — in the same order — and promotes the top ``1/eta``.
    Failed points are never promoted.  ``min_keep`` floors the survivor
    count so a noisy cheap rung cannot collapse the search below a
    meaningful finalist set.
    """

    def __init__(self, graph: Graph,
                 space: Union[DesignSpace, Sequence[DesignPoint]],
                 base_arch: Optional[CIMArch] = None, *,
                 eta: int = 3,
                 ladder: Sequence[Rung] = DEFAULT_LADDER,
                 objective: str = "latency_cycles",
                 min_keep: int = 2):
        if eta < 2:
            raise ValueError("eta must be >= 2")
        self.graph = graph
        self.points, self.base_arch = resolve_space(space, base_arch)
        self.eta = eta
        self.ladder = tuple(ladder)
        if not self.ladder or self.ladder[-1].fidelity != "full":
            raise ValueError("ladder must end with a 'full' rung")
        self.objective = objective
        self.min_keep = min_keep
        self.rung = 0
        self.survivors: List[int] = list(range(len(self.points)))
        self.rung_log: List[RungLog] = []
        self.full_evals = 0
        self.results: Optional[List[SweepResult]] = None
        self._pending: Optional[List[int]] = None

    # -- state -----------------------------------------------------------
    @property
    def done(self) -> bool:
        return self.results is not None

    def _rung_graph(self, rung: Rung) -> Graph:
        if rung.fidelity != "prefix":
            return self.graph          # proxy scores the full graph
        return rung_prefix_graph(self.graph, rung.frac)

    # -- driving ---------------------------------------------------------
    def jobs(self, index_base: int = 0, tag: Any = None) -> List[EvalJob]:
        """The current rung's job list (stable order; call once per rung)."""
        if self.done:
            return []
        rung = self.ladder[self.rung]
        graph = self._rung_graph(rung)
        self._pending = list(self.survivors)
        proxy = rung.fidelity == "proxy"
        # compile rungs are *batched*: run_jobs screens the whole rung's
        # infeasibility in one vectorized pass per (graph, arch) before
        # any point reaches the compiler (identical error strings either
        # way — see runner._screen_compile_jobs)
        return [EvalJob(index=index_base + k, graph=graph,
                        point=self.points[i], arch=self.base_arch,
                        proxy=proxy, screen=not proxy, tag=tag)
                for k, i in enumerate(self._pending)]

    def observe(self, results: Sequence[SweepResult]) -> None:
        """Consume the current rung's results (same order as ``jobs()``)."""
        if self._pending is None:
            raise RuntimeError("observe() without a preceding jobs()")
        if len(results) != len(self._pending):
            raise ValueError(f"expected {len(self._pending)} results, "
                             f"got {len(results)}")
        rung = self.ladder[self.rung]
        is_full = rung.fidelity == "full" or (
            rung.fidelity == "prefix"
            and self._rung_graph(rung) is self.graph)
        full_here = len(results) if is_full else 0
        self.full_evals += full_here
        pending, self._pending = self._pending, None

        if self.rung == len(self.ladder) - 1:
            self.rung_log.append(RungLog(self.rung, rung.fidelity,
                                         len(results), 0, full_here))
            # re-key finalists by their *enumeration* index so objective
            # ties resolve exactly like an exhaustive sweep's would
            for enum_i, r in zip(pending, results):
                r.index = enum_i
            self.results = sorted(results, key=lambda r: r.index)
            return

        scored = [(r.metrics[self.objective], i, r)
                  for i, r in zip(pending, results) if r.ok]
        scored.sort(key=lambda t: (t[0], t[1]))
        keep = min(len(scored),
                   max(self.min_keep, math.ceil(len(scored) / self.eta)))
        self.survivors = [i for _, i, _ in scored[:keep]]
        self.rung_log.append(RungLog(self.rung, rung.fidelity,
                                     len(results), keep, full_here))
        if not self.survivors:
            # every point failed at this fidelity (scored is empty —
            # otherwise keep >= 1): report the failures, nothing to promote
            for enum_i, r in zip(pending, results):
                r.index = enum_i
            self.results = sorted(results, key=lambda r: r.index)
            return
        self.rung += 1

    def search_result(self) -> SearchResult:
        if not self.done:
            raise RuntimeError("search is not finished")
        return SearchResult(results=list(self.results),
                            rungs=list(self.rung_log),
                            n_points=len(self.points),
                            full_evals=self.full_evals,
                            objective=self.objective)


def successive_halving(graph: Graph,
                       space: Union[DesignSpace, Sequence[DesignPoint]],
                       base_arch: Optional[CIMArch] = None, *,
                       eta: int = 3,
                       ladder: Sequence[Rung] = DEFAULT_LADDER,
                       objective: str = "latency_cycles",
                       min_keep: int = 2,
                       cache: Optional[CompileCache] = None,
                       workers: int = 1) -> SearchResult:
    """Run a complete successive-halving search over one workload.

    Deterministic for any ``workers`` count (rungs are synchronization
    points; within a rung, results re-order by job index).
    """
    search = HalvingSearch(graph, space, base_arch, eta=eta, ladder=ladder,
                           objective=objective, min_keep=min_keep)
    proxy_memo: dict = {}    # proxy results shared across this search's rungs
    while not search.done:
        search.observe(run_jobs(search.jobs(), cache=cache, workers=workers,
                                proxy_memo=proxy_memo))
    return search.search_result()
