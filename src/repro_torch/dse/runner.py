"""Job-queue evaluation primitive shared by sweeps, searches, campaigns.

An ``EvalJob`` is one (graph, design point) evaluation at some fidelity:
a full compile + perf estimate by default, or an analytic proxy when
``proxy=True``.  ``run_jobs`` executes any job list — one workload's
exhaustive sweep, one rung of a successive-halving search, or a whole
campaign round interleaving many workloads — through a single queue, so
wall-clock scales with total work rather than with the number of
callers.

Execution model:

  * proxy jobs never reach the pool: they are grouped per (graph, base
    arch) and evaluated through the **batched proxy cost model**
    (``dse.proxy_vec.proxy_metrics_batch``) — one vectorized pass per
    group, bit-exact against per-job scalar ``compiler.proxy_metrics``
    (infeasible points come back as ``error`` results carrying the
    scalar raise's message);
  * compile jobs with ``screen=True`` first pass through the same
    batched proxy, grouped per (graph, arch): points the proxy proves
    infeasible come back as ``error`` results carrying the exact string
    the compiler would have raised, and only feasible points reach the
    compile path — this is how search rungs evaluate a whole promotion
    batch per (graph, arch) instead of compiling one point at a time;
  * compile jobs with ``workers <= 1`` (or a single job) run in-process,
    reusing the caller's cache object so its memory layer stays live;
  * compile jobs with ``workers > 1`` are farmed to a process pool; each
    worker re-opens the cache directory (``memory=False`` — workers must
    not grow resident memory) and entries are written atomically.  If
    the host cannot fork, the pool degrades to the same per-job code
    path serially.  Either way the caller's cache memory layer is
    dropped afterwards so freshly-written disk entries become visible.

Results come back ordered by job index, so outcomes are bit-identical
for any worker count.  A job whose compilation raises (e.g. an arch
override too small to hold any chunk of the model) is reported with
``error`` set rather than aborting the queue.  A ``RuntimeError`` is not
an infeasible point but a fault of the machinery — a kernel that did not
build or launch, a route the device cannot run, a CUDA error, a cache
entry of the JAX package — and propagates out of ``run_jobs``.

The pool's workers start from a ``forkserver``, never by forking the
caller: once CUDA is up the caller has driver threads, and a forked
child can deadlock on their locks.  Workers only compile; they never
touch a device.

Scoring a full-fidelity job:

  1. compute its ``compile_key``;
  2. warm path — the cache's *metrics* file answers without unpickling;
  3. cold path — ``compile_graph`` (which itself consults the cache for
     the full result) then ``perf.estimate``; the entry is persisted.

Proxy jobs are analytic and never touch the disk cache, but they are
memoized per ``(graph, base arch, point)`` within one ``run_jobs``
invocation — and across invocations when the caller threads its own
``proxy_memo`` dict through (``successive_halving`` keeps one per
search, ``run_campaign`` one per campaign, so identical proxy jobs are
never recomputed across rungs or rounds).  Memo keys use object
identity of the graph/arch; the memo pins every pair it has keyed, so
entries stay valid for as long as the dict itself lives.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Dict, Iterable, List, Optional, Sequence, Tuple,
                    Union)

from ..core import compiler
from ..core.abstraction import CIMArch
from ..core.graph import Graph
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .cache import CompileCache
from .space import DesignPoint, DesignSpace


@dataclasses.dataclass
class EvalJob:
    """One (graph, point) evaluation queued through ``run_jobs``."""

    index: int                   # global order key (results are re-sorted)
    graph: Graph
    point: DesignPoint
    arch: CIMArch                # base arch the point's overrides apply to
    proxy: bool = False          # analytic proxy_metrics instead of compile
    screen: bool = False         # batch-screen infeasibility before compiling
    tag: Any = None              # caller routing key (e.g. workload name)


@dataclasses.dataclass
class SweepResult:
    index: int
    point: DesignPoint
    metrics: Optional[Dict[str, float]]
    cached: bool = False
    error: Optional[str] = None
    tag: Any = None

    @property
    def ok(self) -> bool:
        return self.error is None and self.metrics is not None


def evaluate_point(graph: Graph, base_arch: CIMArch, point: DesignPoint,
                   cache: Optional[CompileCache] = None,
                   fault_model=None, *, device="cuda",
                   mode: Optional[str] = None,
                   ) -> Tuple[Dict[str, float], bool]:
    """(metrics, was_cached) for one design point at full fidelity.

    With ``fault_model`` (a ``cimsim.faults.FaultModel``) set, the
    metrics gain ``fault_top1``: executor-backed top-1 agreement with
    the fault-free executor under that model (see
    ``cimsim.faults.accuracy_under_faults``), run on ``device`` (on the
    card: the CUDA kernel; ``mode`` forces the crossbar-MVM route) — so
    campaigns can rank points by robustness, not just latency.
    Robustness is a property of the realized arch, so it is computed
    fresh (never answered from the metrics cache) and appended to
    whatever the cache returned.  Without ``fault_model`` nothing runs
    on a device.
    """
    arch = point.arch_for(base_arch)
    kwargs = point.compile_kwargs()
    metrics = cached = None
    if cache is not None:
        key = compiler.compile_key(graph, arch, **kwargs)
        metrics = cache.get_metrics(key)
        cached = metrics is not None
    if metrics is None:
        result = compiler.compile_graph(graph, arch, cache=cache, **kwargs)
        metrics, cached = result.metrics(), False
    if fault_model is not None:
        from ..cimsim.faults import accuracy_under_faults
        metrics = dict(metrics)
        metrics["fault_top1"] = accuracy_under_faults(
            graph, arch, fault_model, device=device, mode=mode, **kwargs)
    return metrics, cached


def _eval_job(job: EvalJob, cache: Optional[CompileCache]) -> SweepResult:
    """The one evaluation code path every execution mode shares."""
    try:
        if job.proxy:
            arch = job.point.arch_for(job.arch)
            kwargs = job.point.compile_kwargs()
            kwargs.pop("expand", None)
            metrics = compiler.proxy_metrics(job.graph, arch, **kwargs)
            return SweepResult(index=job.index, point=job.point,
                               metrics=metrics, tag=job.tag)
        metrics, cached = evaluate_point(job.graph, job.arch, job.point,
                                         cache)
        return SweepResult(index=job.index, point=job.point, metrics=metrics,
                           cached=cached, tag=job.tag)
    except RuntimeError:    # the machinery failed, not the design point
        raise
    except Exception as e:  # infeasible point: report, don't abort the queue
        return SweepResult(index=job.index, point=job.point, metrics=None,
                           error=f"{type(e).__name__}: {e}", tag=job.tag)


def _eval_job_worker(args: Tuple[EvalJob, Optional[str]]) -> SweepResult:
    """Pool entry: re-open the cache directory, then the shared path."""
    job, cache_dir = args
    cache = CompileCache(cache_dir, memory=False) if cache_dir else None
    return _eval_job(job, cache)


def _fill_proxy_memo(jobs: Sequence[EvalJob],
                     memo: Dict[Any, Tuple[Optional[Dict], Optional[str]]],
                     ) -> None:
    """Score every job's point through the batched proxy cost model.

    Jobs are grouped per (graph, base arch); each group's unmemoized
    points go through one ``proxy_metrics_batch`` pass.  ``memo`` maps
    ``(id(graph), id(arch), point)`` to ``(metrics, error)`` — reused
    duplicates (within a group, across groups, or across invocations
    when the caller threads the dict through) cost a dict lookup.  The
    memo also pins each (graph, arch) pair it has keyed, so the ids can
    never be recycled onto different objects while the dict lives.  If
    the batched path itself fails unexpectedly, the group's points fall
    back to the scalar oracle one by one, so a proxy job can never be
    *worse* off than before batching.
    """
    from .proxy_vec import NodeTensor, proxy_metrics_batch, _scalar_oracle

    groups: Dict[Tuple[int, int], List[EvalJob]] = {}
    for j in jobs:
        groups.setdefault((id(j.graph), id(j.arch)), []).append(j)

    for gkey, grp in groups.items():
        graph, arch = grp[0].graph, grp[0].arch
        memo[("__pin__", *gkey)] = (graph, arch)
        todo: List[DesignPoint] = []
        keys: List[Tuple] = []
        seen = set()
        for j in grp:
            key = (*gkey, j.point)
            if key not in memo and key not in seen:
                seen.add(key)
                todo.append(j.point)
                keys.append(key)
        if todo:
            try:
                batch = proxy_metrics_batch(
                    graph, todo, arch,
                    node_tensor=NodeTensor.from_graph(graph))
                for i, key in enumerate(keys):
                    memo[key] = (batch.metrics(i), batch.errors[i])
            except Exception:    # semantics net: replay through the oracle
                for key, pt in zip(keys, todo):
                    try:
                        arch_pt = pt.arch_for(arch)
                    except Exception as e:
                        memo[key] = (None, f"{type(e).__name__}: {e}")
                        continue
                    memo[key] = _scalar_oracle(graph, arch_pt, pt)


def _eval_proxy_jobs(jobs: Sequence[EvalJob],
                     memo: Dict[Any, Tuple[Optional[Dict], Optional[str]]],
                     ) -> List[SweepResult]:
    """Evaluate proxy jobs through the batched proxy cost model."""
    _fill_proxy_memo(jobs, memo)
    return [SweepResult(
        index=j.index, point=j.point,
        metrics=(dict(m) if (m := memo[(id(j.graph), id(j.arch),
                                        j.point)][0]) is not None else None),
        error=memo[(id(j.graph), id(j.arch), j.point)][1], tag=j.tag)
        for j in jobs]


def _screen_compile_jobs(jobs: Sequence[EvalJob],
                         memo: Dict[Any, Tuple[Optional[Dict],
                                               Optional[str]]],
                         ) -> Tuple[List[EvalJob], List[SweepResult]]:
    """Partition compile jobs by batched infeasibility screening.

    Runs the whole job list through one vectorized proxy pass per
    (graph, arch) group and splits it into (feasible jobs, infeasible
    results).  The proxy's infeasibility conditions — mode/level
    mismatch, binding below core granularity, virtual-crossbar span over
    the per-core budget — are raised by ``compile_graph`` with the
    *identical* message strings (they share ``compiler.mode_error``, the
    same ``CostModel.placement`` and the same span cap), so a screened
    rung reports the same errors the one-at-a-time compile path would,
    without paying a compile attempt per infeasible point.  Feasible
    jobs still go through the real compiler: screening changes where
    infeasibility is *detected*, never what a feasible point scores.
    """
    _fill_proxy_memo(jobs, memo)
    passed: List[EvalJob] = []
    failed: List[SweepResult] = []
    for j in jobs:
        error = memo[(id(j.graph), id(j.arch), j.point)][1]
        if error is None:
            passed.append(j)
        else:
            failed.append(SweepResult(index=j.index, point=j.point,
                                      metrics=None, error=error, tag=j.tag))
    return passed, failed


def run_jobs(jobs: Iterable[EvalJob],
             cache: Optional[CompileCache] = None,
             workers: int = 1,
             proxy_memo: Optional[Dict] = None) -> List[SweepResult]:
    """Evaluate ``jobs`` and return results sorted by job index.

    ``proxy_memo`` (optional) is a dict threaded through by callers that
    issue proxy jobs repeatedly for the same (graph, arch, point)
    triples; by default memoization is scoped to this invocation.
    """
    import time as _time
    jobs = list(jobs)
    t0 = _time.perf_counter()
    proxy_jobs = [j for j in jobs if j.proxy]
    compile_jobs = [j for j in jobs if not j.proxy]
    results: List[SweepResult] = []
    memo = proxy_memo if proxy_memo is not None else {}
    if proxy_jobs:
        results.extend(_eval_proxy_jobs(proxy_jobs, memo))

    screened = [j for j in compile_jobs if j.screen]
    if screened:
        # batched rung: one vectorized infeasibility pass per (graph,
        # arch) group, then only the survivors reach the compiler
        passed, failed = _screen_compile_jobs(screened, memo)
        results.extend(failed)
        compile_jobs = [j for j in compile_jobs if not j.screen] + passed

    if compile_jobs:
        if workers <= 1 or len(compile_jobs) <= 1:
            results.extend(_eval_job(j, cache) for j in compile_jobs)
        else:
            cache_dir = str(cache.root) if cache is not None else None
            args = [(j, cache_dir) for j in compile_jobs]
            try:
                import multiprocessing
                from concurrent.futures import ProcessPoolExecutor
                ctx = multiprocessing.get_context("forkserver")
                with ProcessPoolExecutor(max_workers=workers,
                                         mp_context=ctx) as pool:
                    results.extend(pool.map(_eval_job_worker, args,
                                            chunksize=1))
            except (OSError, ImportError):  # no processes: degrade serially
                results.extend(_eval_job_worker(a) for a in args)
            if cache is not None:
                # the caller's memory layer predates the workers' writes
                # (pool and fallback alike use private cache handles):
                # resync it from disk
                cache.drop_memory()
    results.sort(key=lambda r: r.index)
    obs_metrics.count("dse_jobs_total", n=len(jobs))
    tr = obs_trace.get_trace()
    if tr is not None and jobs:
        dt = _time.perf_counter() - t0
        graph = jobs[0].graph.name
        tr.complete(obs_trace.DSE_TRACK, graph, f"rung:{graph}", "dse",
                    obs_trace.now_s() - dt, dt, jobs=len(jobs),
                    proxy=len(proxy_jobs), ok=sum(r.ok for r in results))
    return results


def resolve_space(space: Union[DesignSpace, Sequence[DesignPoint]],
                  base_arch: Optional[CIMArch] = None,
                  ) -> Tuple[List[DesignPoint], CIMArch]:
    """(points, base arch) from a ``DesignSpace`` or explicit point list."""
    if isinstance(space, DesignSpace):
        return space.points(), base_arch or space.arch
    points = list(space)
    if base_arch is None:
        raise ValueError("base_arch is required with an explicit point list")
    return points, base_arch


def sweep(graph: Graph,
          space: Union[DesignSpace, Sequence[DesignPoint]],
          base_arch: Optional[CIMArch] = None,
          cache: Optional[CompileCache] = None,
          workers: int = 1) -> List[SweepResult]:
    """Exhaustively evaluate every point of ``space`` on ``graph``.

    ``space`` is a ``DesignSpace`` (its ``arch`` is the base) or an
    explicit point list plus ``base_arch``.  ``cache=None`` disables
    caching.  Thin wrapper over ``run_jobs`` — see module docstring for
    the execution model.
    """
    points, base_arch = resolve_space(space, base_arch)
    return run_jobs((EvalJob(index=i, graph=graph, point=p, arch=base_arch)
                     for i, p in enumerate(points)),
                    cache=cache, workers=workers)
