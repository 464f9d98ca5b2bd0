"""Budgeted ask/tell search over a ``DesignSpace`` (learned halving).

Successive halving (``search.py``) is exhaustive at the cheap rung: it
scores *every* enumerated point through the proxy, then promotes a fixed
``1/eta`` fraction rung by rung — on an 11664-point space that is
thousands of prefix/full compiles regardless of how quickly the good
region is identified.  ``AdaptiveSearch`` replaces the fixed grid with a
model-guided loop sized for the vectorized proxy:

  ask   — propose a *batch* of unevaluated points.  Categorical axes
          (scheduling level, bit binding, the CG switches) and the
          enumerated arch axes (crossbar size, cell precision, DAC bits,
          core/chip counts, ...) are scored by a TPE-style density
          model: observed points are split at the ``gamma`` quantile of
          the proxy objective into *good* and *bad* sets, each axis gets
          Laplace-smoothed categorical densities ``l`` (good) / ``g``
          (bad), and candidates rank by ``sum_axis log(l/g)`` — the
          classic Bergstra et al. acquisition, vectorized over the whole
          space with NumPy.  An ``explore`` fraction of every batch is
          drawn uniformly so the model can never paint itself into a
          corner; all randomness flows from one seeded
          ``numpy.random.Generator``, so a seed fixes the entire ask
          sequence.
  tell  — the batch comes back from the **batched proxy cost model**
          (``runner`` routes proxy jobs through ``dse.proxy_vec``, so a
          512-point ask is one structure-of-arrays pass, not 512 scalar
          proxies).  Infeasible points score ``+inf`` and teach the
          density model which axis values to avoid.

The ask/tell loop stops on any of: proxy budget exhausted, space fully
evaluated, ``max_rounds`` reached, or ``patience`` consecutive rounds
without improving the best proxy score.  The top ``prefix_keep``
feasible points then climb the same fidelity ladder halving uses —
one *batched prefix rung* (a single screened ``run_jobs`` batch of
``Graph.prefix`` compiles per (graph, arch)) and one full rung — so the
expensive fidelities are paid for a model-chosen shortlist instead of a
fixed fraction of the whole space.

``AdaptiveSearch`` exposes the same incremental driving interface as
``HalvingSearch`` (``jobs()`` → ``run_jobs`` → ``observe``; ``done``;
``search_result()``), so ``run_campaign(mode="adaptive")`` interleaves
many workloads' rounds through one job queue and one shared compile
cache, and ``points_from_campaign`` hands the winners to the serving
fleet unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.abstraction import CIMArch
from ..core.graph import Graph
from ..obs import metrics as obs_metrics
from .cache import CompileCache
from .runner import EvalJob, SweepResult, resolve_space, run_jobs
from .search import RungLog, SearchResult, rung_prefix_graph
from .space import DesignPoint, DesignSpace


@dataclasses.dataclass
class AdaptiveResult(SearchResult):
    """Outcome of one adaptive search (a ``SearchResult`` plus the
    ask/tell accounting the scorecard reports)."""

    proxy_evals: int            # proxy evaluations actually paid
    prefix_evals: int           # prefix-fidelity compiles paid
    ask_rounds: int             # ask/tell rounds before promotion
    ask_log: List[Tuple[int, ...]]   # enumeration indices asked per round


def _feature_matrix(points: Sequence[DesignPoint],
                    ) -> Tuple[np.ndarray, List[int], List[str]]:
    """Integer-coded categorical features, one row per design point.

    Axes are the four scheduling knobs plus one axis per distinct
    ``arch_overrides`` path (absent paths code as their own category).
    Codes follow first appearance in enumeration order, so the encoding
    is deterministic for a given point list.
    """
    paths = sorted({path for pt in points for path, _ in pt.arch_overrides})
    names = ["level", "binding", "pipeline", "duplication", *paths]
    rows = []
    for pt in points:
        ov = dict(pt.arch_overrides)
        rows.append((pt.level, pt.binding, pt.use_pipeline,
                     pt.use_duplication, *(ov.get(p) for p in paths)))
    feats = np.empty((len(points), len(names)), dtype=np.int64)
    n_cats: List[int] = []
    for a in range(len(names)):
        code: Dict[Any, int] = {}
        for i, row in enumerate(rows):
            v = row[a]
            if v not in code:
                code[v] = len(code)
            feats[i, a] = code[v]
        n_cats.append(len(code))
    return feats, n_cats, names


class AdaptiveSearch:
    """Incremental ask/tell state over one workload.

    Drive it exactly like ``HalvingSearch``::

        while not search.done:
            results = run_jobs(search.jobs(), cache=cache, workers=w)
            search.observe(results)

    Proxy rounds issue ``batch``-sized ask batches; once the loop
    stops, one screened prefix batch and one screened full batch
    finish the ladder.  Determinism: a fixed ``seed`` fixes the ask
    sequence, hence every downstream promotion and the final best
    point, for any ``workers`` count.
    """

    def __init__(self, graph: Graph,
                 space: Union[DesignSpace, Sequence[DesignPoint]],
                 base_arch: Optional[CIMArch] = None, *,
                 seed=0,
                 objective: str = "latency_cycles",
                 batch: int = 512,
                 max_rounds: int = 16,
                 proxy_budget: Optional[int] = None,
                 gamma: float = 0.2,
                 explore: float = 0.1,
                 patience: int = 3,
                 prefix_keep: int = 32,
                 prefix_frac: float = 0.5,
                 full_keep: int = 8,
                 min_keep: int = 2):
        if not 0.0 < gamma < 1.0:
            raise ValueError("gamma must be in (0, 1)")
        if not 0.0 <= explore <= 1.0:
            raise ValueError("explore must be in [0, 1]")
        if full_keep > prefix_keep:
            raise ValueError("full_keep cannot exceed prefix_keep")
        self.graph = graph
        self.points, self.base_arch = resolve_space(space, base_arch)
        n = len(self.points)
        self.objective = objective
        self.batch = max(1, min(batch, n)) if n else 1
        self.max_rounds = max_rounds
        self.proxy_budget = n if proxy_budget is None else min(
            max(proxy_budget, self.batch), n)
        self.gamma = gamma
        self.explore = explore
        self.patience = patience
        self.prefix_keep = prefix_keep
        self.prefix_frac = prefix_frac
        self.full_keep = full_keep
        self.min_keep = min_keep
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._feats, self._n_cats, self.axes = _feature_matrix(self.points)
        #: nan = unevaluated, +inf = proxy-infeasible, else proxy objective
        self._scores = np.full(n, np.nan)
        self._proxy_results: Dict[int, SweepResult] = {}
        self._prefix_cache: Optional[Graph] = None
        self.phase = "proxy"             # "proxy" -> "prefix" -> "full"
        self.survivors: List[int] = []
        self.rung_log: List[RungLog] = []
        self.ask_log: List[Tuple[int, ...]] = []
        self.full_evals = 0
        self.proxy_evals = 0
        self.prefix_evals = 0
        self._stall = 0
        self._best = math.inf
        self.results: Optional[List[SweepResult]] = None
        self._pending: Optional[List[int]] = None

    # -- state -----------------------------------------------------------
    @property
    def done(self) -> bool:
        return self.results is not None

    def _prefix_graph(self) -> Graph:
        # one prefix graph object per search, so batched screening and
        # the proxy memo key every prefix job to the same (graph, arch)
        if self._prefix_cache is None:
            self._prefix_cache = rung_prefix_graph(self.graph,
                                                   self.prefix_frac)
        return self._prefix_cache

    # -- the ask side ----------------------------------------------------
    def _ask(self) -> List[int]:
        """Next batch of enumeration indices to score through the proxy."""
        unev = np.flatnonzero(np.isnan(self._scores))
        k = min(self.batch, len(unev),
                max(0, self.proxy_budget - self.proxy_evals))
        if k <= 0:
            return []
        obs = np.flatnonzero(~np.isnan(self._scores))
        feas = obs[np.isfinite(self._scores[obs])]
        if len(feas) < max(4, 2 * self.min_keep):
            # cold start (or a hostile space): uniform coverage
            asked = sorted(int(i) for i in
                           self.rng.choice(unev, size=k, replace=False))
        else:
            n_good = max(1, math.ceil(self.gamma * len(feas)))
            by_score = feas[np.lexsort((feas, self._scores[feas]))]
            good = by_score[:n_good]
            bad = np.setdiff1d(obs, good)
            dens = np.zeros(len(unev))
            for a in range(self._feats.shape[1]):
                cats = self._n_cats[a]
                if cats < 2:
                    continue
                lo = np.bincount(self._feats[good, a], minlength=cats) + 1.0
                hi = np.bincount(self._feats[bad, a], minlength=cats) + 1.0
                ratio = np.log(lo / lo.sum()) - np.log(hi / hi.sum())
                dens += ratio[self._feats[unev, a]]
            n_explore = int((self.rng.random(k) < self.explore).sum())
            order = np.lexsort((unev, -dens))   # best ratio, ties by index
            exploit = [int(i) for i in unev[order[:k - n_explore]]]
            rest = np.setdiff1d(unev, np.asarray(exploit, dtype=unev.dtype))
            explore: List[int] = []
            if n_explore and len(rest):
                explore = [int(i) for i in self.rng.choice(
                    rest, size=min(n_explore, len(rest)), replace=False)]
            asked = sorted(exploit + explore)
        self.ask_log.append(tuple(asked))
        obs_metrics.count("dse_ask_rounds_total", workload=self.graph.name)
        return asked

    # -- driving ---------------------------------------------------------
    def jobs(self, index_base: int = 0, tag: Any = None) -> List[EvalJob]:
        """The next batch of jobs (proxy ask, or a screened compile rung)."""
        if self.done:
            return []
        if self.phase == "proxy":
            asked = self._ask()
            if asked:
                self._pending = list(asked)
                return [EvalJob(index=index_base + k, graph=self.graph,
                                point=self.points[i], arch=self.base_arch,
                                proxy=True, tag=tag)
                        for k, i in enumerate(asked)]
            # budget exhausted before a round could be issued
            self._promote_from_proxy()
            if self.done:
                return []
        graph = self.graph if self.phase == "full" else self._prefix_graph()
        self._pending = list(self.survivors)
        return [EvalJob(index=index_base + k, graph=graph,
                        point=self.points[i], arch=self.base_arch,
                        screen=True, tag=tag)
                for k, i in enumerate(self._pending)]

    def observe(self, results: Sequence[SweepResult]) -> None:
        """Consume the batch issued by the last ``jobs()`` (same order)."""
        if self._pending is None:
            if self.done and not results:
                return      # a driver handing back an empty final slice
            raise RuntimeError("observe() without a preceding jobs()")
        if len(results) != len(self._pending):
            raise ValueError(f"expected {len(self._pending)} results, "
                             f"got {len(results)}")
        pending, self._pending = self._pending, None
        if self.phase == "proxy":
            self._tell(pending, results)
            return
        if self.phase == "prefix":
            is_full = self._prefix_graph() is self.graph
            self.prefix_evals += len(results)
            full_here = len(results) if is_full else 0
            self.full_evals += full_here
            scored = [(r.metrics[self.objective], i, r)
                      for i, r in zip(pending, results) if r.ok]
            scored.sort(key=lambda t: (t[0], t[1]))
            keep = min(len(scored), max(self.min_keep, self.full_keep))
            self.survivors = [i for _, i, _ in scored[:keep]]
            self.rung_log.append(RungLog(len(self.rung_log), "prefix",
                                         len(results), keep, full_here))
            if not self.survivors:
                self._finalize(pending, results)
                return
            self.phase = "full"
            return
        self.full_evals += len(results)
        self.rung_log.append(RungLog(len(self.rung_log), "full",
                                     len(results), 0, len(results)))
        self._finalize(pending, results)

    def _tell(self, pending: List[int],
              results: Sequence[SweepResult]) -> None:
        self.proxy_evals += len(results)
        for i, r in zip(pending, results):
            self._proxy_results[i] = r
            self._scores[i] = (r.metrics[self.objective] if r.ok
                               else math.inf)
        feasible = int(np.isfinite(self._scores).sum())
        best = float(np.min(self._scores[~np.isnan(self._scores)])) \
            if feasible else math.inf
        if best < self._best:
            self._best, self._stall = best, 0
        else:
            self._stall += 1
        exhausted = (self.proxy_evals >= self.proxy_budget
                     or not np.isnan(self._scores).any()
                     or len(self.ask_log) >= self.max_rounds)
        converged = self._stall >= self.patience and feasible >= self.min_keep
        if exhausted or converged:
            self._promote_from_proxy()

    def _promote_from_proxy(self) -> None:
        feas = np.flatnonzero(np.isfinite(self._scores))
        by_score = feas[np.lexsort((feas, self._scores[feas]))]
        keep = min(len(feas), max(self.min_keep, self.prefix_keep))
        self.survivors = [int(i) for i in by_score[:keep]]
        if self.survivors:
            obs_metrics.count("dse_promotions_total", n=len(self.survivors),
                              workload=self.graph.name)
        self.rung_log.append(RungLog(len(self.rung_log), "proxy",
                                     self.proxy_evals,
                                     len(self.survivors), 0))
        if not self.survivors:
            # nothing feasible anywhere the model looked: report the
            # evaluated failures, exactly like an all-failed halving rung
            evaluated = sorted(self._proxy_results)
            self._finalize(evaluated,
                           [self._proxy_results[i] for i in evaluated])
            return
        self.phase = "prefix"

    def _finalize(self, pending: Sequence[int],
                  results: Sequence[SweepResult]) -> None:
        # re-key finalists by their *enumeration* index so objective ties
        # resolve exactly like an exhaustive sweep's would
        for enum_i, r in zip(pending, results):
            r.index = enum_i
        self.results = sorted(results, key=lambda r: r.index)

    def search_result(self) -> AdaptiveResult:
        if not self.done:
            raise RuntimeError("search is not finished")
        return AdaptiveResult(results=list(self.results),
                              rungs=list(self.rung_log),
                              n_points=len(self.points),
                              full_evals=self.full_evals,
                              objective=self.objective,
                              proxy_evals=self.proxy_evals,
                              prefix_evals=self.prefix_evals,
                              ask_rounds=len(self.ask_log),
                              ask_log=list(self.ask_log))


def adaptive_search(graph: Graph,
                    space: Union[DesignSpace, Sequence[DesignPoint]],
                    base_arch: Optional[CIMArch] = None, *,
                    cache: Optional[CompileCache] = None,
                    workers: int = 1,
                    **knobs) -> AdaptiveResult:
    """Run a complete adaptive search over one workload.

    ``knobs`` are ``AdaptiveSearch`` parameters (``seed``, ``batch``,
    ``prefix_keep``, ...).  Deterministic for any ``workers`` count —
    rounds are synchronization points, and the ask sequence depends only
    on the seed and the told scores.
    """
    search = AdaptiveSearch(graph, space, base_arch, **knobs)
    proxy_memo: dict = {}   # proxy results shared across this search's rounds
    while not search.done:
        batch = search.jobs()
        if not batch and search.done:
            break
        search.observe(run_jobs(batch, cache=cache, workers=workers,
                                proxy_memo=proxy_memo))
    return search.search_result()
