"""CIM serving fleet: single-chip router plus the cross-chip cluster.

Two tiers live here:

``CimFleet`` — N workloads co-resident on *one* chip, each owning the
crossbar partition the tenancy planner assigned it, fronted by a
deadline-aware dynamic batcher and served by a warm trace-lowered
executable on ``device`` (default ``"cuda"``; every chip is a logical
CIM chip, so every tenant of every chip runs on the one card):

    fleet = CimFleet([TenantSpec("resnet", g1, traffic=3.0),
                      TenantSpec("vit", g2, traffic=1.0)], arch)
    fleet.submit("resnet", inputs)            # -> CimRequest
    done = fleet.drain()                      # flush queues, fill outputs
    print(fleet.stats().summary())

``CimCluster`` — the fleet tier over *N chips* (per-chip arch may
differ): a 2-D ``FleetPlan`` (tenant -> chip -> crossbar pool) routes
each tenant's traffic across its chip replicas; observed per-tenant
traffic is tracked with an EWMA and, when it drifts from the plan's
assumed shares, the cluster re-plans online and migrates tenants over
the weight-rewrite path; admission control sheds lowest-priority
tenants to time-multiplexed residency before rejecting (typed
``AdmissionError``) under overload.

Request lifecycle: ``submit`` stamps the arrival time and routes by
model id; ``step`` dispatches every tenant queue whose release policy
fires (full bucket / age / deadline pressure); ``drain`` flushes
everything.  Per-request ``latency_s`` is queue wait plus batch
execution; per-tenant ``ServiceStats`` aggregate into ``FleetStats``.

Units and clocks: all public ``*_s`` values are **seconds** on one
caller-chosen service clock — wall time by default (``time.monotonic``),
synthetic when every call passes explicit ``now`` values (tests and
benchmarks do).  Engine dispatch durations are measured wall-clock
seconds placed on that same timeline; crossbar weight-rewrite costs are
**compiler cycles** and only ever appear in trace/plan metadata, never
on the clock.  Thread-safety: neither class is thread-safe — one fleet
or cluster is driven from one thread; batchers and stats are plain
mutable state.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np

from ..core.abstraction import CIMArch
from .batcher import DEFAULT_BUCKETS, DynamicBatcher
from .common import CimRequest, ServiceStats
from .engine import EnginePool
from .placement import (FleetPlan, TenancyPlan, TenantSpec, plan_fleet,
                        plan_tenancy)
from ..obs.trace import TraceRecorder


class AdmissionError(RuntimeError):
    """Typed rejection: the cluster is saturated for this tenant and the
    degradation ladder is exhausted (every lower-priority tenant is
    already time-multiplexed).  Carries ``model``, ``pending`` and
    ``limit`` so callers can back off or shed load upstream."""

    def __init__(self, model: str, pending: int, limit: int):
        self.model, self.pending, self.limit = model, pending, limit
        super().__init__(
            f"tenant {model!r} rejected: {pending} pending >= "
            f"limit {limit} and no lower-priority tenant left to shed")


class TransientKernelError(RuntimeError):
    """A kernel dispatch failed for a transient, retryable reason (a
    flaky device link, a spurious launch failure injected by a fault
    schedule).  ``CimFleet`` retries the dispatch up to ``max_retries``
    times before letting it propagate — anything *else* an engine
    raises is treated as permanent and surfaces immediately: a CUDA
    build or launch failure (``RuntimeError``) or a route the registry
    cannot satisfy (``KernelUnsupportedError``) is never retried."""


@dataclasses.dataclass(frozen=True)
class ChipFault:
    """One scheduled chip-level fault (service-clock seconds).

    ``kind="kill"`` removes the chip: its pending requests are
    evacuated onto survivors through the pending-preserving re-plan
    path.  ``kind="degrade"`` keeps the chip serving but multiplies
    its dispatch durations by ``degrade_factor`` (a thermally-throttled
    or half-dead chip), compounding across repeated degrades.
    """

    at_s: float
    chip: str
    kind: str = "kill"                  # "kill" | "degrade"
    degrade_factor: float = 2.0

    def __post_init__(self):
        if self.kind not in ("kill", "degrade"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "degrade" and self.degrade_factor <= 0:
            raise ValueError("degrade_factor must be positive")


class FaultSchedule:
    """Deterministic time-ordered chip-fault injector for a cluster.

    Faults fire when the cluster's clock passes ``at_s`` — checked on
    every ``submit``/``step``/``drain``/``control`` — each exactly
    once.  Purely driven by the caller's clock, so replays are exact.
    """

    def __init__(self, faults: Iterable[ChipFault]):
        self.faults: List[ChipFault] = sorted(faults,
                                              key=lambda f: (f.at_s, f.chip))
        self._next = 0

    def due(self, now: float) -> List[ChipFault]:
        """Pop every not-yet-fired fault with ``at_s <= now``."""
        out: List[ChipFault] = []
        while self._next < len(self.faults) \
                and self.faults[self._next].at_s <= now:
            out.append(self.faults[self._next])
            self._next += 1
        return out

    @property
    def remaining(self) -> int:
        return len(self.faults) - self._next


@dataclasses.dataclass
class FleetStats:
    """Per-tenant stats plus the fleet-wide aggregate (see
    ``ServiceStats`` for the cumulative-vs-windowed field split)."""

    tenants: Dict[str, ServiceStats]

    @property
    def aggregate(self) -> ServiceStats:
        """All tenants merged into one ``ServiceStats``."""
        total = ServiceStats()
        for s in self.tenants.values():
            total = total.merge(s)
        return total

    def summary(self) -> str:
        """Human-readable one-screen digest (latencies in ms)."""
        agg = self.aggregate
        lines = [f"fleet: {agg.requests} requests in {agg.batches} batches; "
                 f"p50 {agg.p50_latency_s * 1e3:.2f}ms / "
                 f"p95 {agg.p95_latency_s * 1e3:.2f}ms; "
                 f"{agg.deadline_misses} deadline misses"]
        for name, s in self.tenants.items():
            lines.append(f"  {name}: {s.requests} reqs / {s.batches} batches,"
                         f" p50 {s.p50_latency_s * 1e3:.2f}ms,"
                         f" p95 {s.p95_latency_s * 1e3:.2f}ms")
        return "\n".join(lines)


class CimFleet:
    """Serve N workloads on one CIM chip behind one frontend.

    Clock: every public method takes an optional ``now`` (service-clock
    seconds); omitted, it falls back to ``time.monotonic()``.  Pass a
    ``TraceRecorder`` (plus ``chip`` label) to emit batcher queue-wait
    and engine dispatch spans onto its timeline.  Not thread-safe.
    """

    def __init__(self, tenants: Sequence[TenantSpec], arch: CIMArch, *,
                 plan: Optional[TenancyPlan] = None,
                 cache=None, seed: int = 0,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_s: float = 0.002,
                 use_executor: bool = True,
                 points: Optional[Dict[str, Dict]] = None,
                 trace: Optional[TraceRecorder] = None,
                 chip: Optional[str] = None,
                 max_retries: int = 2,
                 mode: Optional[str] = None, device="cuda"):
        if plan is None:
            plan = plan_tenancy(tenants, arch)
        else:
            # an explicit plan must describe exactly these tenants on this
            # chip — a stale plan would silently serve the wrong fleet.
            # The engines run from the plan's embedded specs, so the
            # caller's specs must match them in substance (graph, knobs,
            # traffic), not just by name.
            by_name = {t.name: t for t in tenants}
            if set(plan.tenants) != set(by_name):
                raise ValueError(
                    f"plan tenants {sorted(plan.tenants)} != specs "
                    f"{sorted(by_name)}")
            if plan.arch.to_dict() != arch.to_dict():
                raise ValueError(
                    f"plan was built for arch {plan.arch.name!r}, "
                    f"fleet got {arch.name!r}")
            for name, spec in by_name.items():
                ps = plan.tenants[name].spec
                if ps is spec:
                    continue
                if (ps.traffic != spec.traffic
                        or ps.compile_kwargs != spec.compile_kwargs
                        or ps.graph.to_dict() != spec.graph.to_dict()):
                    raise ValueError(
                        f"plan tenant {name!r} was planned from a "
                        "different spec (graph/knobs/traffic) than the "
                        "one passed to the fleet")
        self.plan = plan
        self.plan.validate()
        self.trace = trace
        self.chip = chip or arch.name
        self.pool = EnginePool(self.plan, cache=cache, seed=seed,
                               max_batch=max(buckets),
                               use_executor=use_executor, points=points,
                               mode=mode, device=device)
        # deadline pressure uses observed dispatch times; before a
        # tenant's first dispatch the estimate is unknown (None), which
        # the batcher treats as "release deadlined work immediately" —
        # simulated cycles don't convert to wall time, so not waiting is
        # the only estimate-free way to avoid cold-start deadline misses
        self._batchers: Dict[str, DynamicBatcher] = {}
        self._observed_s: Dict[str, float] = {}
        for name in self.pool.names:
            self._batchers[name] = DynamicBatcher(
                buckets=tuple(buckets), max_wait_s=max_wait_s,
                est_batch_s=lambda n, t=name: self._observed_s.get(t))
        self._rid = 0
        #: bounded deterministic retry budget for TransientKernelError
        self.max_retries = max_retries
        self.retries = 0                 # cumulative retried dispatches
        #: dispatch-duration multiplier (>1 when the chip is degraded by
        #: a fault schedule; the cluster sets it)
        self.slowdown = 1.0

    # -- admission -------------------------------------------------------
    def submit(self, model: str, inputs: Dict[str, np.ndarray], *,
               deadline_s: Optional[float] = None,
               now: Optional[float] = None) -> CimRequest:
        """Admit one request for ``model``; returns the queued request.

        ``now``/``deadline_s`` are service-clock seconds; arrival is
        stamped here."""
        if model not in self.pool:
            raise KeyError(f"unknown model {model!r}; "
                           f"tenants: {self.pool.names}")
        now = time.monotonic() if now is None else now
        req = CimRequest(rid=self._rid, inputs=inputs, model=model,
                         arrival_s=now, deadline_s=deadline_s)
        self._rid += 1
        self._batchers[model].submit(req)
        return req

    def submit_request(self, req: CimRequest,
                       now: Optional[float] = None) -> CimRequest:
        """Admit a pre-built request (its ``model`` field routes it);
        re-stamps ``arrival_s`` to ``now`` (service clock)."""
        if req.model not in self.pool:
            raise KeyError(f"unknown model {req.model!r}; "
                           f"tenants: {self.pool.names}")
        req.arrival_s = time.monotonic() if now is None else now
        self._batchers[req.model].submit(req)
        return req

    def requeue(self, req: CimRequest) -> None:
        """Admit a carried-over request *preserving* its ``arrival_s``
        (cluster migration uses this so queue-wait accounting survives a
        re-plan)."""
        if req.model not in self.pool:
            raise KeyError(f"unknown model {req.model!r}; "
                           f"tenants: {self.pool.names}")
        self._batchers[req.model].submit(req)

    @property
    def pending(self) -> int:
        """Queued (not yet dispatched) requests across all tenants."""
        return sum(len(b) for b in self._batchers.values())

    def queue_depth(self, model: str) -> int:
        """Queued requests for one tenant (admission control input)."""
        return len(self._batchers[model])

    def evict_pending(self, now: Optional[float] = None) -> List[CimRequest]:
        """Remove and return every queued request (cluster migration /
        chip failover: the new plan's fleets re-admit them; nothing is
        dropped).  With ``now`` given, evicted requests already past
        their deadline are counted into the tenant's ``ServiceStats``
        here (exactly once, via ``miss_recorded``) — they may complete
        on another chip much later or never, and dropping the miss at
        eviction silently undercounted the deadline-miss counters."""
        out: List[CimRequest] = []
        for name, b in self._batchers.items():
            evicted, b.queue = b.queue, []
            if now is not None:
                n = 0
                for r in evicted:
                    if r.missed_deadline(now) and not r.miss_recorded:
                        r.miss_recorded = True
                        n += 1
                if n:
                    self.pool[name].stats.record_misses(n)
            out.extend(evicted)
        return out

    # -- dispatch --------------------------------------------------------
    def step(self, now: Optional[float] = None,
             force: bool = False) -> List[CimRequest]:
        """Dispatch every tenant queue whose release policy fires.

        Returns the requests completed this step (outputs + latency
        filled).  ``force=True`` releases partial batches regardless of
        the policy (one bucketed batch per tenant per call).
        """
        now = time.monotonic() if now is None else now
        done: List[CimRequest] = []
        for name, batcher in self._batchers.items():
            batch = batcher.next_batch(now, force=force)
            if batch is None:
                continue
            done.extend(self._dispatch(name, batch, now))
        return done

    def drain(self, now: Optional[float] = None) -> List[CimRequest]:
        """Flush every queue to empty (bucketed batches throughout)."""
        now = time.monotonic() if now is None else now
        done: List[CimRequest] = []
        for name, batcher in self._batchers.items():
            for batch in batcher.drain(now):
                done.extend(self._dispatch(name, batch, now))
        return done

    def serve(self, requests: Iterable[CimRequest],
              now: Optional[float] = None) -> List[CimRequest]:
        """Synchronous convenience: admit every request, then drain.

        Requests are routed by their ``model`` field; arrival times are
        stamped at admission (pass ``now`` for a synthetic clock).
        """
        for r in requests:
            self.submit_request(r, now=now)
        return self.drain(now=now)

    def _dispatch(self, name: str, batch, now: float) -> List[CimRequest]:
        engine = self.pool[name]
        # bounded deterministic retry: only the typed transient channel
        # is retried (no sleeps — the service clock is caller-driven);
        # exhaustion re-raises so permanent failures stay loud
        for attempt in range(self.max_retries + 1):
            try:
                dt = engine.serve_padded(batch.requests, batch.bucket)
                break
            except TransientKernelError:
                if attempt >= self.max_retries:
                    raise
                self.retries += 1
                if self.trace is not None:
                    self.trace.instant(self.chip, f"retry:{name}", "fault",
                                       now, attempt=attempt + 1,
                                       bucket=batch.bucket)
        dt *= self.slowdown
        # steady-state estimate feeding the deadline-pressure policy
        prev = self._observed_s.get(name)
        self._observed_s[name] = dt if prev is None else 0.5 * (prev + dt)
        latencies, missed = [], []
        for r in batch.requests:
            r.latency_s = (now - r.arrival_s) + dt
            latencies.append(r.latency_s)
            m = r.missed_deadline(now + dt) and not r.miss_recorded
            if m:
                r.miss_recorded = True
            missed.append(m)
        misses = sum(missed)
        engine.stats.record(latencies, dt, misses, missed=missed)
        if self.trace is not None:
            oldest = min(r.arrival_s for r in batch.requests)
            self.trace.complete(
                self.chip, name, f"queue n={len(batch.requests)}",
                "batcher", oldest, now - oldest,
                reason=batch.reason, bucket=batch.bucket)
            self.trace.complete(
                self.chip, name, f"dispatch b={batch.bucket}", "engine",
                now, dt, n=len(batch.requests), misses=misses)
        return batch.requests

    # -- introspection ---------------------------------------------------
    def stats(self) -> FleetStats:
        """Per-tenant ``ServiceStats`` for this chip."""
        return FleetStats(tenants={name: self.pool[name].stats
                                   for name in self.pool.names})

    def serve_s(self) -> float:
        """Cumulative engine busy seconds on this chip (wall-clock)."""
        return sum(self.pool[name].stats.serve_s
                   for name in self.pool.names)

    def summary(self) -> str:
        """Plan + stats digest for this chip."""
        return self.plan.summary() + "\n" + self.stats().summary()


# ---------------------------------------------------------------------------
# Cross-chip cluster: routing, traffic drift, live re-planning.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReplanPolicy:
    """When the cluster re-plans (all times service-clock seconds).

    Observed per-tenant rates are EWMA-smoothed per ``control`` window
    (``ewma_alpha`` weights the newest window).  A re-plan triggers when
    the worst per-tenant relative divergence between observed and
    planned traffic *shares* exceeds ``drift_threshold`` and at least
    ``min_requests`` arrivals were seen since the last re-plan (noise
    guard).
    """

    ewma_alpha: float = 0.5
    drift_threshold: float = 0.5
    min_requests: int = 32
    #: floor share for divergence normalization (avoids exploding
    #: ratios for near-zero planned shares)
    share_floor: float = 0.02
    #: absolute share gap below which a tenant contributes no drift —
    #: without it, tiny-share tenants keep large *relative* divergence
    #: after a re-plan and the cluster thrashes (migrates every window)
    min_share_delta: float = 0.1


class _TrafficEwma:
    """Per-tenant arrival-rate EWMA over ``control`` windows.  Rates are
    requests/second on the service clock; not thread-safe."""

    def __init__(self, alpha: float):
        self.alpha = alpha
        self.rates: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.window_total = 0
        self._last: Optional[float] = None

    def arrival(self, model: str, now: float) -> None:
        if self._last is None:
            self._last = now
        self.counts[model] = self.counts.get(model, 0) + 1
        self.window_total += 1

    def roll(self, now: float) -> float:
        """Fold the window ending at ``now`` into the EWMA; returns the
        window length in seconds (0 when no arrivals were ever seen)."""
        if self._last is None:
            return 0.0
        window = max(now - self._last, 1e-9)
        names = set(self.rates) | set(self.counts)
        for n in names:
            obs = self.counts.get(n, 0) / window
            prev = self.rates.get(n)
            self.rates[n] = obs if prev is None \
                else self.alpha * obs + (1 - self.alpha) * prev
        self.counts = {}
        self._last = now
        return window

    def shares(self) -> Dict[str, float]:
        total = sum(self.rates.values())
        if total <= 0:
            return {}
        return {k: v / total for k, v in self.rates.items()}


class CimCluster:
    """N-chip CIM serving cluster: 2-D placement, drift-driven live
    re-planning, admission control and Chrome-trace observability.

    One ``CimFleet`` per planned chip serves that chip's tenant subset;
    the cluster routes each tenant's traffic across its chip replicas
    in the ``FleetPlan``'s proportions (deterministic weighted
    round-robin).  ``control`` is the operator heartbeat: it rolls the
    traffic EWMA, samples per-chip utilization/queue counters into the
    trace, and re-plans + migrates when observed shares drift from the
    plan's assumptions.  Migration reuses the weight-rewrite path: the
    affected chips' engines are rebuilt against the new partitions
    (compiles warm-load from ``cache``), queued requests carry over,
    and the rewrite cost (crossbars x ``t_write_xb`` cycles) is
    recorded in the trace.

    Clock: explicit ``now`` (service-clock seconds) everywhere, wall
    time by default — same contract as ``CimFleet``.  Not thread-safe:
    drive one cluster from one thread.
    """

    def __init__(self, tenants: Sequence[TenantSpec],
                 chips: Mapping[str, CIMArch], *,
                 plan: Optional[FleetPlan] = None,
                 cache=None, seed: int = 0,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_s: float = 0.002,
                 use_executor: bool = True,
                 points: Optional[Dict[str, Dict]] = None,
                 trace: Optional[TraceRecorder] = None,
                 max_queue: int = 256,
                 policy: Optional[ReplanPolicy] = None,
                 faults: Optional[FaultSchedule] = None,
                 max_retries: int = 2,
                 mode: Optional[str] = None, device="cuda"):
        self.specs = {t.name: t for t in tenants}
        if len(self.specs) != len(list(tenants)):
            raise ValueError("tenant names must be unique")
        self.archs = dict(chips)
        if plan is None:
            plan = plan_fleet(tenants, self.archs)
        if set(plan.routes) != set(self.specs):
            raise ValueError(
                f"plan tenants {sorted(plan.routes)} != specs "
                f"{sorted(self.specs)}")
        self.cache = cache
        self.seed = seed
        self.buckets = tuple(buckets)
        self.max_wait_s = max_wait_s
        self.use_executor = use_executor
        self.points = points
        self.trace = trace
        self.max_queue = max_queue
        self.policy = policy or ReplanPolicy()
        self.traffic = _TrafficEwma(self.policy.ewma_alpha)
        self.fault_schedule = faults
        self.max_retries = max_retries
        self.mode = mode
        self.device = device
        # operator counters (cumulative)
        self.migrations = 0              # applied re-plans
        self.demotions = 0               # tenants shed to time-multiplexed
        self.rejected = 0                # AdmissionError count
        self.demoted: set = set()        # currently-shed tenant names
        self.failed: set = set()         # chips killed by the schedule
        self.chip_kills = 0              # cumulative kill faults applied
        self.chip_degrades = 0           # cumulative degrade faults applied
        self._chip_slowdown: Dict[str, float] = {}
        self._arrivals_since_replan = 0
        self._rid = 0
        self._retired: Dict[str, ServiceStats] = {}
        self._chip_busy_base: Dict[str, float] = {}
        self._credits: Dict[str, Dict[str, float]] = {}
        self.fleets: Dict[str, CimFleet] = {}
        self.plan = None
        self._install_plan(plan)

    # -- plan installation / migration -----------------------------------
    def _build_chip(self, chip: str, tplan: TenancyPlan) -> CimFleet:
        specs = [p.spec for p in tplan.tenants.values()]
        fleet = CimFleet(specs, self.archs[chip], plan=tplan,
                         cache=self.cache, seed=self.seed,
                         buckets=self.buckets, max_wait_s=self.max_wait_s,
                         use_executor=self.use_executor, points=self.points,
                         trace=self.trace, chip=chip,
                         max_retries=self.max_retries,
                         mode=self.mode, device=self.device)
        # an active degrade fault outlives re-plans of its chip
        fleet.slowdown = self._chip_slowdown.get(chip, 1.0)
        return fleet

    def _install_plan(self, plan: FleetPlan,
                      now: Optional[float] = None) -> None:
        plan.validate()
        old = self.plan
        pending: List[CimRequest] = []
        rebuilt = []
        for chip, tplan in plan.chips.items():
            prior = self.fleets.get(chip)
            if prior is not None and old is not None \
                    and chip in old.chips \
                    and _same_chip_plan(old.chips[chip], tplan):
                continue                       # placement unchanged: keep
            if prior is not None:
                pending.extend(prior.evict_pending(now=now))
                self._retire(prior)
                self._chip_busy_base[chip] = \
                    self._chip_busy_base.get(chip, 0.0) + prior.serve_s()
            rebuilt.append(chip)
            self.fleets[chip] = self._build_chip(chip, tplan)
        for chip in list(self.fleets):
            if chip not in plan.chips:         # chip emptied by the plan
                prior = self.fleets.pop(chip)
                pending.extend(prior.evict_pending(now=now))
                self._retire(prior)
                self._chip_busy_base[chip] = \
                    self._chip_busy_base.get(chip, 0.0) + prior.serve_s()
        self.plan = plan
        self._credits = {t: {c: 0.0 for c in plan.routes[t]}
                         for t in plan.routes}
        if self.trace is not None and now is not None:
            for chip in rebuilt:
                cost = _rewrite_cost(old, plan, chip)
                self.trace.instant(
                    chip, "migrate", "rewrite", now,
                    rewritten_xbs=cost["xbs"],
                    rewrite_cycles=cost["cycles"])
        for req in pending:                    # carried over, never dropped
            self._route(req)

    def _retire(self, fleet: CimFleet) -> None:
        for name, s in fleet.stats().tenants.items():
            prev = self._retired.get(name, ServiceStats())
            self._retired[name] = prev.merge(s)

    # -- admission + routing ---------------------------------------------
    @property
    def names(self) -> List[str]:
        """All tenant names (sorted)."""
        return sorted(self.specs)

    @property
    def pending(self) -> int:
        """Queued requests across every chip."""
        return sum(f.pending for f in self.fleets.values())

    def queue_depth(self, model: str) -> int:
        """Queued requests for one tenant across its chips."""
        return sum(f.queue_depth(model) for f in self.fleets.values()
                   if model in f.pool)

    def _admit(self, model: str, now: float) -> None:
        """Admission control: at ``max_queue`` pending, first climb the
        degradation ladder; rejection raises ``AdmissionError``."""
        if self.queue_depth(model) >= self.max_queue:
            if not self._degrade(model, now):
                self.rejected += 1
                if self.trace is not None:
                    chip = next(iter(self.plan.routes[model]))
                    self.trace.instant(chip, f"reject:{model}",
                                       "admission", now,
                                       pending=self.queue_depth(model),
                                       limit=self.max_queue)
                raise AdmissionError(model, self.queue_depth(model),
                                     self.max_queue)

    def submit(self, model: str, inputs: Dict[str, np.ndarray], *,
               deadline_s: Optional[float] = None,
               now: Optional[float] = None) -> CimRequest:
        """Admit one request: admission control, then weighted routing.

        Raises ``AdmissionError`` when the tenant's cluster-wide queue
        is at ``max_queue`` and the degradation ladder is exhausted;
        otherwise the first overload demotes the lowest-priority
        still-resident tenant to time-multiplexed residency (re-plan +
        migration) and the request is accepted.
        """
        req = CimRequest(rid=self._rid, inputs=inputs, model=model,
                         deadline_s=deadline_s)
        self._rid += 1
        return self.submit_request(req, now=now)

    def submit_request(self, req: CimRequest,
                       now: Optional[float] = None) -> CimRequest:
        """Admit a pre-built request (same admission path as
        ``submit``; ``arrival_s`` is re-stamped to ``now``).  The
        *same* object is queued, so the caller sees ``outputs`` and
        ``latency_s`` once it completes."""
        if req.model not in self.specs:
            raise KeyError(f"unknown model {req.model!r}; tenants: "
                           f"{self.names}")
        now = time.monotonic() if now is None else now
        self._apply_faults(now)
        self._admit(req.model, now)
        req.arrival_s = now
        self.traffic.arrival(req.model, now)
        self._arrivals_since_replan += 1
        self._route(req)
        return req

    def _route(self, req: CimRequest) -> None:
        """Deterministic weighted round-robin over the tenant's chips
        (Bresenham credits follow the plan's route proportions)."""
        row = self.plan.routes[req.model]
        credits = self._credits[req.model]
        for chip, w in row.items():
            credits[chip] = credits.get(chip, 0.0) + w
        chip = max(sorted(credits), key=lambda c: credits[c])
        credits[chip] -= 1.0
        self.fleets[chip].requeue(req)

    # -- degradation ladder ----------------------------------------------
    def _degrade(self, model: str, now: float) -> bool:
        """Shed the lowest-priority still-resident tenant (strictly
        below ``model``'s priority) to time-multiplexed residency.
        Returns True when a demotion was applied."""
        mine = self.specs[model].priority
        candidates = sorted(
            (s for s in self.specs.values()
             if s.name != model and s.name not in self.demoted
             and s.priority < mine
             and self.plan.total_replicas(s.name) > 0),
            key=lambda s: (s.priority, s.name))
        if not candidates:
            return False
        victim = candidates[0]
        self.demoted.add(victim.name)
        self.demotions += 1
        if self.trace is not None:
            chip = next(iter(self.plan.routes[victim.name]))
            self.trace.instant(chip, f"demote:{victim.name}",
                               "admission", now, for_tenant=model)
        self._replan(now, reason="degrade")
        return True

    # -- fault injection / failover --------------------------------------
    def _apply_faults(self, now: float) -> None:
        """Fire every due fault of the schedule (kills first would not
        matter: ``due`` preserves time order, ties break by chip)."""
        if self.fault_schedule is None:
            return
        for f in self.fault_schedule.due(now):
            if f.kind == "kill":
                if f.chip in self.archs:
                    self._fail_chip(f.chip, now)
            else:
                self._degrade_chip(f, now)

    def _degrade_chip(self, fault: ChipFault, now: float) -> None:
        factor = self._chip_slowdown.get(fault.chip, 1.0) \
            * fault.degrade_factor
        self._chip_slowdown[fault.chip] = factor
        fleet = self.fleets.get(fault.chip)
        if fleet is not None:
            fleet.slowdown = factor
        self.chip_degrades += 1
        if self.trace is not None:
            self.trace.instant(fault.chip, "chip_degrade", "fault", now,
                               factor=round(factor, 4))

    def _fail_chip(self, chip: str, now: float) -> None:
        """Chip loss: retire its stats, evacuate its queued requests,
        re-plan the survivors (climbing the degradation ladder when the
        remaining capacity cannot hold every resident tenant), and
        re-route the evacuees.  Zero accepted requests are dropped."""
        fleet = self.fleets.pop(chip, None)
        self.archs.pop(chip, None)
        self.failed.add(chip)
        self.chip_kills += 1
        pending: List[CimRequest] = []
        if fleet is not None:
            pending = fleet.evict_pending(now=now)
            self._retire(fleet)
            self._chip_busy_base[chip] = \
                self._chip_busy_base.get(chip, 0.0) + fleet.serve_s()
        if self.trace is not None:
            self.trace.instant(chip, "chip_kill", "fault", now,
                               evacuated=len(pending),
                               survivors=len(self.archs))
        if not self.archs:
            raise AdmissionError("*", len(pending), 0)
        self._failover_replan(now)
        for req in pending:                    # evacuated, never dropped
            self._route(req)

    def _failover_replan(self, now: float) -> None:
        """Re-plan onto the surviving chips.  When the lost capacity
        makes the plan infeasible, extend the degradation ladder —
        demote the lowest-priority not-yet-demoted tenant to
        time-multiplexed residency and retry — before giving up (the
        planner's error propagates once everyone is demoted)."""
        while True:
            try:
                self._replan(now, reason="failover")
                return
            except ValueError:
                candidates = sorted(
                    (s for s in self.specs.values()
                     if s.name not in self.demoted),
                    key=lambda s: (s.priority, s.name))
                if not candidates:
                    raise
                victim = candidates[0]
                self.demoted.add(victim.name)
                self.demotions += 1
                if self.trace is not None:
                    chip = sorted(self.archs)[0]
                    self.trace.instant(chip, f"demote:{victim.name}",
                                       "admission", now,
                                       for_tenant="failover")

    # -- dispatch --------------------------------------------------------
    def step(self, now: Optional[float] = None,
             force: bool = False) -> List[CimRequest]:
        """One dispatch pass over every chip (see ``CimFleet.step``)."""
        now = time.monotonic() if now is None else now
        self._apply_faults(now)
        done: List[CimRequest] = []
        for chip in sorted(self.fleets):
            done.extend(self.fleets[chip].step(now, force=force))
        return done

    def drain(self, now: Optional[float] = None) -> List[CimRequest]:
        """Flush every chip's queues to empty."""
        now = time.monotonic() if now is None else now
        self._apply_faults(now)
        done: List[CimRequest] = []
        for chip in sorted(self.fleets):
            done.extend(self.fleets[chip].drain(now))
        return done

    def serve(self, requests: Iterable[CimRequest],
              now: Optional[float] = None) -> List[CimRequest]:
        """Admit every request (admission control applies!), then
        drain.  Raises ``AdmissionError`` like ``submit``."""
        for r in requests:
            self.submit_request(r, now=now)
        return self.drain(now=now)

    # -- control loop -----------------------------------------------------
    def control(self, now: Optional[float] = None) -> dict:
        """The operator heartbeat: roll traffic EWMA, sample
        utilization/queue counters into the trace, re-plan on drift.

        Returns ``{"drift": float, "replanned": bool, "shares":
        {...}}`` for operator introspection.  Call it periodically
        (every batching window or few) on the same clock as ``submit``.
        """
        now = time.monotonic() if now is None else now
        self._apply_faults(now)
        window = self.traffic.roll(now)
        if self.trace is not None and window > 0:
            for chip in sorted(self.fleets):
                fleet = self.fleets[chip]
                busy = fleet.serve_s()
                prev = getattr(fleet, "_last_busy_s", 0.0)
                fleet._last_busy_s = busy
                self.trace.counter(
                    chip, "chip", now,
                    {"utilization": min(1.0, (busy - prev) / window),
                     "queue_depth": fleet.pending})
        observed = self.traffic.shares()
        drift = self._drift(observed)
        replanned = False
        if (drift > self.policy.drift_threshold
                and self._arrivals_since_replan
                >= self.policy.min_requests):
            if self.trace is not None:
                chip = sorted(self.fleets)[0]
                self.trace.instant(chip, "replan", "rewrite", now,
                                   drift=round(drift, 4))
            self._replan(now, reason="drift")
            replanned = True
        return {"drift": drift, "replanned": replanned,
                "shares": observed}

    def _drift(self, observed: Dict[str, float]) -> float:
        """Worst per-tenant relative divergence of observed vs planned
        traffic shares (0 when no traffic has been observed).  Tenants
        whose *absolute* share gap is under ``policy.min_share_delta``
        contribute nothing — small-share noise must not look like a
        large relative drift."""
        if not observed:
            return 0.0
        assumed = self.plan.assumed_shares
        floor = self.policy.share_floor
        worst = 0.0
        for name in self.specs:
            a = max(assumed.get(name, 0.0), floor)
            o = observed.get(name, 0.0)
            if abs(o - a) < self.policy.min_share_delta:
                continue
            worst = max(worst, abs(o - a) / a)
        return worst

    def _replan(self, now: float, reason: str) -> None:
        """Re-plan from current EWMA rates and migrate.  Tenants with
        no observed traffic get a floor share (``policy.share_floor``
        of the observed total) — observed rates are requests/second,
        so mixing in the spec's unit-less assumed traffic would skew
        the split."""
        rates = self.traffic.rates
        total = sum(rates.values())
        floor = max(total, 1.0) * self.policy.share_floor
        specs = [dataclasses.replace(spec,
                                     traffic=max(rates.get(name, 0.0),
                                                 floor))
                 for name, spec in sorted(self.specs.items())]
        new_plan = plan_fleet(specs, self.archs,
                              force_multiplexed=self.demoted)
        self._install_plan(new_plan, now=now)
        self.migrations += 1
        self._arrivals_since_replan = 0

    # -- introspection ----------------------------------------------------
    def stats(self) -> FleetStats:
        """Per-tenant stats merged across chips *and* across any
        engines retired by migration (counters are cumulative over the
        cluster's whole life)."""
        merged: Dict[str, ServiceStats] = {
            n: s for n, s in self._retired.items()}
        for fleet in self.fleets.values():
            for name, s in fleet.stats().tenants.items():
                prev = merged.get(name, ServiceStats())
                merged[name] = prev.merge(s)
        return FleetStats(tenants=merged)

    def chip_busy_s(self) -> Dict[str, float]:
        """Cumulative engine busy seconds per chip (wall-clock),
        surviving migrations — the benchmark's parallel-chips clock
        uses max-over-chips deltas of this."""
        out = dict(self._chip_busy_base)
        for chip, fleet in self.fleets.items():
            out[chip] = out.get(chip, 0.0) + fleet.serve_s()
        return out

    def summary(self) -> str:
        """Plan + stats + control-counter digest."""
        extra = (f"cluster: {self.migrations} migrations, "
                 f"{self.demotions} demotions, {self.rejected} rejected, "
                 f"demoted={sorted(self.demoted)}, "
                 f"{self.chip_kills} kills / {self.chip_degrades} degrades, "
                 f"failed={sorted(self.failed)}")
        return "\n".join([self.plan.summary(), self.stats().summary(),
                          extra])


def _same_chip_plan(a: TenancyPlan, b: TenancyPlan) -> bool:
    """True when two intra-chip plans place the same tenants with the
    same partitions (cores/replicas/residency) — i.e. no weight
    movement is needed."""
    if set(a.tenants) != set(b.tenants):
        return False
    return all(
        (a.tenants[n].cores, a.tenants[n].replicas, a.tenants[n].resident)
        == (b.tenants[n].cores, b.tenants[n].replicas,
            b.tenants[n].resident)
        for n in a.tenants)


def _rewrite_cost(old: Optional[FleetPlan], new: FleetPlan,
                  chip: str) -> Dict[str, float]:
    """Crossbars (and cycles) that must be (re)programmed to realize
    ``new`` on ``chip`` — every resident copy whose placement differs
    from ``old`` (all of them on a fresh install).  Cycles use the
    arch's ``t_write_xb`` (compiler cycles, not wall-clock)."""
    tplan = new.chips[chip]
    arch = tplan.arch
    xbs = 0
    for name, p in tplan.tenants.items():
        if not p.resident:
            continue
        prior = None
        if old is not None and chip in old.chips:
            prior = old.chips[chip].tenants.get(name)
        if prior is not None and prior.resident \
                and (prior.replicas, prior.footprint_cores) \
                == (p.replicas, p.footprint_cores):
            continue                       # weights already in place
        xbs += p.replicas * p.footprint_cores * arch.core.n_xbs
    return {"xbs": xbs, "cycles": xbs * arch.t_write_xb()}
