"""Multi-workload DSE campaigns over one shared cache and job queue.

A campaign sweeps *many* workloads (ResNets, VGGs, ViT, LM blocks, …)
against one design space.  Instead of running ``sum(per-workload
sweeps)`` back to back, every round's (workload, point) jobs are
interleaved into a single ``runner.run_jobs`` queue over one process
pool and one compile cache, so wall-clock scales with total work and a
point compiled for one workload's rung is a cache hit everywhere else it
appears.

Three modes:

  * ``"halving"`` (default) — one ``HalvingSearch`` per workload, driven
    in lockstep: each round gathers the current rung's jobs from every
    unfinished search into one queue, then routes results back.  The
    opening round screens the cross-product of all workloads x all
    points through the batched proxy cost model (one vectorized
    ``dse.proxy_vec`` pass per workload — see runner); full compiles are
    paid only for each workload's survivor set.
  * ``"adaptive"`` — one ``AdaptiveSearch`` per workload through the
    same lockstep loop: every round interleaves each workload's ask
    batch (or screened compile rung) into the shared queue.  Each
    workload's searcher gets its own ``numpy`` Generator derived from
    ``seed`` and the workload's position, so campaigns are reproducible
    end to end; extra searcher knobs pass through ``adaptive=...``.
  * ``"exhaustive"`` — every (workload, point) pair at full fidelity in
    one round-robin-interleaved queue; the reference baseline.

The result carries, per workload, the full-fidelity results, the Pareto
frontier, and the best point by the scalar objective — plus a
cross-workload *robust points* summary: points evaluated at full
fidelity on every workload whose objective is within ``robust_tol`` of
that workload's best, every time.  Those are the configurations worth
building hardware for when the deployment mix is uncertain.
"""
from __future__ import annotations

import dataclasses
from typing import (Dict, List, Mapping, Optional, Sequence, Tuple, Union)

from ..core.abstraction import CIMArch
from ..core.graph import Graph
from .cache import CompileCache
from .pareto import DEFAULT_OBJECTIVES, pareto_frontier
from .runner import EvalJob, SweepResult, resolve_space, run_jobs
from .search import DEFAULT_LADDER, HalvingSearch, Rung, RungLog
from .space import DesignPoint, DesignSpace


@dataclasses.dataclass
class WorkloadOutcome:
    """One workload's view of the campaign."""

    name: str
    results: List[SweepResult]          # full-fidelity results
    frontier: List[SweepResult]
    full_evals: int
    rungs: List[RungLog] = dataclasses.field(default_factory=list)
    objective: str = "latency_cycles"
    #: functional verification of the best point (``verify_best=True``):
    #: a cimsim.VerifyReport from the trace-lowered batched executor
    verify: Optional[object] = None

    @property
    def best(self) -> Optional[SweepResult]:
        ok = [r for r in self.results if r.ok]
        if not ok:
            return None
        return min(ok, key=lambda r: (r.metrics[self.objective], r.index))


@dataclasses.dataclass
class RobustPoint:
    """A point near-optimal on every workload of the campaign."""

    point: DesignPoint
    max_regret: float                    # worst relative gap to a best
    regret: Dict[str, float]             # per-workload relative gap


@dataclasses.dataclass
class CampaignResult:
    workloads: Dict[str, WorkloadOutcome]
    robust: List[RobustPoint]
    n_points: int
    mode: str
    robust_tol: float
    #: ``CompileCache.stats()`` snapshot taken when the campaign finished
    #: (None when the campaign ran uncached)
    cache_stats: Optional[Dict[str, int]] = None

    @property
    def full_evals(self) -> int:
        return sum(w.full_evals for w in self.workloads.values())

    @property
    def exhaustive_evals(self) -> int:
        """Full-fidelity evaluations an exhaustive campaign would pay."""
        return self.n_points * len(self.workloads)

    def summary(self) -> str:
        lines = [f"campaign: {len(self.workloads)} workloads x "
                 f"{self.n_points} points ({self.mode}); "
                 f"{self.full_evals} full-fidelity evals "
                 f"(exhaustive: {self.exhaustive_evals})"]
        for name, w in self.workloads.items():
            b = w.best
            best = (f"{b.point.label()} -> {b.metrics[w.objective]:.0f}"
                    if b else "no feasible point")
            lines.append(f"  {name}: frontier {len(w.frontier)} / "
                         f"{sum(r.ok for r in w.results)} feasible; "
                         f"best {best}")
        lines.append(f"  robust points (<= {self.robust_tol:.0%} off best "
                     f"everywhere): {len(self.robust)}")
        for rp in self.robust[:5]:
            lines.append(f"    {rp.point.label()}  "
                         f"(max regret {rp.max_regret:.1%})")
        if self.cache_stats is not None:
            s = self.cache_stats
            lines.append(f"  compile cache: {s['hits']} hits, "
                         f"{s['metrics_hits']} metric-only hits, "
                         f"{s['misses']} misses "
                         f"({s['disk_entries']} disk entries)")
        return "\n".join(lines)


def _as_workloads(workloads) -> List[Tuple[str, Graph]]:
    if isinstance(workloads, Mapping):
        return list(workloads.items())
    out = []
    for item in workloads:
        if isinstance(item, Graph):
            out.append((item.name, item))
        else:
            name, graph = item
            out.append((name, graph))
    if len({n for n, _ in out}) != len(out):
        raise ValueError("workload names must be unique")
    return out


def robust_points(outcomes: Mapping[str, WorkloadOutcome],
                  tol: float = 0.10,
                  objective: str = "latency_cycles") -> List[RobustPoint]:
    """Points near-optimal on *every* workload.

    Only points with a feasible full-fidelity result on every workload
    are comparable (under halving that is the survivor intersection);
    regret is ``obj / workload_best - 1``.  Sorted by worst-case regret,
    ties by point enumeration order.
    """
    per_point: Dict[DesignPoint, Dict[str, float]] = {}
    order: Dict[DesignPoint, int] = {}
    for name, w in outcomes.items():
        best = w.best
        if best is None:
            return []
        floor = best.metrics[objective]
        for r in w.results:
            if not r.ok:
                continue
            per_point.setdefault(r.point, {})[name] = \
                r.metrics[objective] / max(floor, 1e-12) - 1.0
            order.setdefault(r.point, r.index)
    out = []
    for point, regret in per_point.items():
        if len(regret) != len(outcomes):
            continue                     # not evaluated everywhere
        worst = max(regret.values())
        if worst <= tol:
            out.append(RobustPoint(point=point, max_regret=worst,
                                   regret=dict(regret)))
    out.sort(key=lambda rp: (rp.max_regret, order[rp.point]))
    return out


def run_campaign(workloads, space: Union[DesignSpace, Sequence[DesignPoint]],
                 base_arch: Optional[CIMArch] = None, *,
                 mode: str = "halving",
                 eta: int = 3,
                 ladder: Sequence[Rung] = DEFAULT_LADDER,
                 objective: str = "latency_cycles",
                 objectives: Sequence[str] = DEFAULT_OBJECTIVES,
                 min_keep: int = 2,
                 robust_tol: float = 0.10,
                 cache: Optional[CompileCache] = None,
                 workers: int = 1,
                 seed: int = 0,
                 adaptive: Optional[Mapping] = None,
                 verify_best: bool = False,
                 verify_batch: int = 2,
                 device="cuda",
                 kernel_mode: Optional[str] = None) -> CampaignResult:
    """Sweep every workload against ``space`` through one shared queue.

    ``workloads`` is a mapping ``name -> Graph``, a sequence of
    ``(name, graph)`` pairs, or a sequence of graphs (named by
    ``graph.name``).  Results are deterministic for any ``workers``
    count.

    ``verify_best=True`` closes the loop the paper closes by hand
    (§4.1): each workload's winning design point is functionally
    verified against the int8 fake-quant reference — via the
    trace-lowered batched executor, so the check costs one lowering plus
    one batched dispatch of ``verify_batch`` inputs.  The report lands
    on ``WorkloadOutcome.verify``.  Verification runs on ``device`` (on
    the card: the CUDA kernel); ``kernel_mode`` forces its crossbar-MVM
    route (``mode`` names the search).  A point that cannot be verified
    is reported in ``VerifyReport.error``; a ``RuntimeError`` (a kernel
    that did not build or launch, a CUDA error) propagates instead.
    """
    wls = _as_workloads(workloads)
    points, base = resolve_space(space, base_arch)
    if mode not in ("halving", "adaptive", "exhaustive"):
        raise ValueError(f"unknown campaign mode {mode!r}")

    outcomes: Dict[str, WorkloadOutcome] = {}
    if mode == "exhaustive":
        # round-robin across workloads so the single queue mixes cheap and
        # expensive graphs instead of draining them workload-by-workload
        jobs = [EvalJob(index=k, graph=g, point=p, arch=base, tag=name)
                for k, (p, (name, g)) in enumerate(
                    (p, wl) for p in points for wl in wls)]
        results = run_jobs(jobs, cache=cache, workers=workers)
        by_wl: Dict[str, List[SweepResult]] = {name: [] for name, _ in wls}
        for r in results:
            by_wl[r.tag].append(r)
        for name, _ in wls:
            rs = by_wl[name]
            outcomes[name] = WorkloadOutcome(
                name=name, results=rs,
                frontier=pareto_frontier([r for r in rs if r.ok], objectives),
                full_evals=len(rs), objective=objective)
    else:
        if mode == "adaptive":
            from .adaptive import AdaptiveSearch
            knobs = dict(adaptive or {})
            # every workload derives its own generator from one root
            # seed (the knobs' seed wins if both are given) and its
            # stable position, so campaigns replay end to end
            root_seed = knobs.pop("seed", seed)
            knobs.setdefault("objective", objective)
            knobs.setdefault("min_keep", min_keep)
            searches = {name: AdaptiveSearch(g, points, base,
                                             seed=(root_seed, k), **knobs)
                        for k, (name, g) in enumerate(wls)}
        else:
            searches = {name: HalvingSearch(g, points, base, eta=eta,
                                            ladder=ladder,
                                            objective=objective,
                                            min_keep=min_keep)
                        for name, g in wls}
        # one memo for the whole campaign: identical proxy jobs recurring
        # across rungs or rounds (multi-proxy ladders, repeated points)
        # cost a dict lookup instead of a recompute
        proxy_memo: Dict = {}
        while any(not s.done for s in searches.values()):
            jobs: List[EvalJob] = []
            slices: List[Tuple[str, int]] = []
            for name, _ in wls:           # stable workload order
                s = searches[name]
                if s.done:
                    continue
                batch = s.jobs(index_base=len(jobs), tag=name)
                jobs.extend(batch)
                slices.append((name, len(batch)))
            results = run_jobs(jobs, cache=cache, workers=workers,
                               proxy_memo=proxy_memo)
            off = 0
            for name, count in slices:
                searches[name].observe(results[off:off + count])
                off += count
        for name, _ in wls:
            sr = searches[name].search_result()
            ok = [r for r in sr.results if r.ok]
            outcomes[name] = WorkloadOutcome(
                name=name, results=sr.results,
                frontier=pareto_frontier(ok, objectives),
                full_evals=sr.full_evals, rungs=sr.rungs,
                objective=objective)

    if verify_best:
        from ..cimsim import VerifyReport, compile_and_verify
        graphs = dict(wls)
        for name, w in outcomes.items():
            b = w.best
            if b is None:
                continue
            arch_pt = b.point.arch_for(base)
            try:
                w.verify = compile_and_verify(
                    graphs[name], arch_pt, batch=verify_batch,
                    cache=cache,       # the winning compile is already here
                    device=device, mode=kernel_mode,
                    **b.point.compile_kwargs())
            except RuntimeError:     # the machinery failed, not the point
                raise
            except Exception as e:   # fail-soft, like sweep evaluation
                w.verify = VerifyReport(
                    graph=name, arch=arch_pt.name, batch=verify_batch,
                    max_abs_err={}, error=f"{type(e).__name__}: {e}")

    return CampaignResult(
        workloads=outcomes,
        robust=robust_points(outcomes, robust_tol, objective),
        n_points=len(points), mode=mode, robust_tol=robust_tol,
        cache_stats=cache.stats() if cache is not None else None)
