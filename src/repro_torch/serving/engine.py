"""Tenant engine pool: warm-loaded executables behind a tenancy plan.

The pool turns a ``TenancyPlan`` into running engines — one
``CimBatchService`` per tenant, compiled against that tenant's sub-arch
view (its crossbar partition) and lowered to a batched executable on
``device`` (default ``"cuda"``: every saturating crossbar MVM of every
tenant runs the CUDA kernel):

  * **compile warm-load** — every engine compile goes through the shared
    compile cache when one is passed (``get``/``put``, see
    ``core.compiler``), so a fleet restart pays a cache read instead of
    a recompile;
  * **executor reuse** — ``cimsim.executor.lower`` keys its process-wide
    cache by compile content x kernel params x route x device, so two
    tenants serving the same (graph, sub-arch, knobs) share one
    executable;
  * **DSE handoff** — ``points_from_campaign`` maps a finished
    ``CampaignResult`` to per-tenant compiler knobs, closing the
    campaign -> fleet loop (the campaign's best point becomes the
    tenant's serving configuration).

Engines warm their bucket shapes on demand (first dispatch per bucket
runs once untimed inside ``CimBatchService.dispatch``), so steady-state
fleet latencies never include first-use costs.

Units and clocks: engine serve times are **wall-clock seconds** (what
``CimBatchService.serve_padded`` measures around the executable);
compile-side costs (weight-write, schedule latency) are **compiler
cycles** and appear only in plan/compile metadata, never in serve
times.  Thread-safety: a pool is built once and then read-only;
individual engines carry mutable ``ServiceStats`` and are not
thread-safe — one fleet (thread) per pool.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

from .cim_service import CimBatchService
from .placement import TenancyPlan


def points_from_campaign(campaign_result) -> Dict[str, Dict]:
    """Per-workload compiler knobs from a DSE ``CampaignResult``.

    Returns ``{workload name: compile_kwargs}`` for every workload whose
    campaign found a feasible best point — feed it to ``EnginePool`` (or
    ``TenantSpec.compile_kwargs``) so each tenant serves its winning
    configuration.  Arch *overrides* of the best point are ignored here:
    tenancy partitions one concrete chip, so only the scheduling knobs
    transfer.
    """
    out: Dict[str, Dict] = {}
    for name, outcome in campaign_result.workloads.items():
        best = getattr(outcome, "best", None)
        if best is not None:
            out[name] = best.point.compile_kwargs()
    return out


class EnginePool:
    """One warm engine per tenant of a ``TenancyPlan``.

    Engines are keyed by tenant name; each serves on its tenant's
    crossbar partition (``plan.subarch(name)``).  Built eagerly in the
    constructor (compiles may hit ``cache``); afterwards the mapping is
    read-only.  Per-engine ``stats`` are mutable and single-threaded.
    ``device`` and ``mode`` reach every engine's ``CimBatchService``.
    """

    def __init__(self, plan: TenancyPlan, *, cache=None, seed: int = 0,
                 max_batch: int = 8, use_executor: bool = True,
                 points: Optional[Dict[str, Dict]] = None,
                 mode: Optional[str] = None, device="cuda"):
        self.plan = plan
        self.engines: Dict[str, CimBatchService] = {}
        points = points or {}
        for name, tenant in plan.tenants.items():
            kwargs = dict(tenant.spec.compile_kwargs)
            kwargs.update(points.get(name, {}))
            self.engines[name] = CimBatchService(
                tenant.graph, plan.subarch(name), seed=seed,
                max_batch=max_batch, use_executor=use_executor,
                cache=cache, mode=mode, device=device,
                compile_kwargs=kwargs)

    def __getitem__(self, name: str) -> CimBatchService:
        return self.engines[name]

    def __contains__(self, name: str) -> bool:
        return name in self.engines

    def items(self) -> Iterator[Tuple[str, CimBatchService]]:
        return iter(self.engines.items())

    @property
    def names(self):
        return list(self.engines)
