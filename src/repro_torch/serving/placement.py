"""Crossbar tenancy planner: partition one CIM chip across N models.

CIM serving is a *mapping* problem before it is a scheduling problem:
weights are stationary in crossbars, so which model owns which share of
the crossbar pool decides everything downstream — replica counts for hot
models, weight-rewrite time-multiplexing for cold ones, and whether a
request ever meets its deadline.  The planner answers that question with
the same machinery the compiler uses inside one model:

  1. **Footprint + service time** per tenant come from the real cost
     model: ``cg_opt.CostModel.placement`` / ``mapping.bind`` give the
     cores one resident copy occupies, and
     ``cg_opt.estimate_segment_cycles`` the pipelined cycles one copy
     needs per request.
  2. **Residency** is greedy by traffic: tenants are admitted resident
     (weights programmed once) in descending traffic order while their
     footprint fits, always reserving at least one core for every tenant
     still waiting.  Tenants that do not fit are *time-multiplexed*:
     their partition is smaller than one copy, so their compile becomes
     multi-segment and reprograms crossbars per inference — exactly the
     compiler's existing segmentation path, now used as a tenancy tier.
  3. **Replicas** for resident tenants reuse ``balance_duplication``
     verbatim: each tenant is presented to the CG duplication search as
     one pseudo-operator whose ``n_mvm`` is its traffic weight and whose
     ``t_window`` is its per-request service cycles, with one copy
     costing its footprint in cores.  The min-bottleneck search then
     equalizes per-replica offered load — hot models get duplicated
     copies, and the leftover-spending pass hands spare cores to
     whichever tenant is slowest, the same way it does for operators.

  The result is a ``TenancyPlan`` whose per-tenant ``CIMArch`` views
  (``CIMArch.subarch``) provably sum to at most the chip's crossbar
  pool (``TenancyPlan.validate``, asserted in tests).

Above the single chip sits the fleet dimension: ``plan_fleet`` assigns
tenant -> chip -> crossbar pool over an N-chip fleet (per-chip arch may
differ) by water-filling offered load across chip capacities — hot
tenants split across chips (replicas span chips), cold tenants land
whole on the least-loaded chip — then runs ``plan_tenancy`` per chip,
so every intra-chip guarantee above holds per chip of the fleet.

Units: footprints are **cores/crossbars**, service times are
**compiler cycles** (not wall-clock), traffic is a caller-scaled
relative rate.  Planning is deterministic and purely functional — no
clock, no shared state — and therefore thread-safe.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Collection, Dict, List, Mapping, Sequence

from ..core.abstraction import CIMArch
from ..core.cg_opt import CostModel, balance_duplication, \
    estimate_segment_cycles
from ..core.graph import Graph
from ..core.mapping import BitBinding


@dataclasses.dataclass
class TenantSpec:
    """One co-resident model: its graph and relative traffic share."""

    name: str
    graph: Graph
    traffic: float = 1.0             # relative request rate (any scale)
    #: compiler knob overrides for this tenant (level / binding /
    #: use_pipeline / use_duplication), e.g. a DSE campaign best point's
    #: ``DesignPoint.compile_kwargs()``
    compile_kwargs: Dict = dataclasses.field(default_factory=dict)
    #: degradation rank under overload: lower-priority tenants are shed
    #: to time-multiplexed residency first (see ``CimCluster``)
    priority: int = 0

    def __post_init__(self):
        if self.traffic <= 0:
            raise ValueError(f"tenant {self.name!r}: traffic must be > 0")


@dataclasses.dataclass
class TenantPlacement:
    """The planner's verdict for one tenant."""

    spec: TenantSpec
    cores: int                       # cores in this tenant's partition
    xbs: int                         # crossbars in the partition
    replicas: int                    # resident weight copies (>= 1)
    resident: bool                   # False -> time-multiplexed (rewrites)
    footprint_cores: int             # cores one resident copy needs
    est_cycles_per_req: float        # one copy, pipelined, no duplication

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def graph(self) -> Graph:
        return self.spec.graph


@dataclasses.dataclass
class TenancyPlan:
    """A budget-respecting partition of one chip across tenants."""

    arch: CIMArch
    tenants: Dict[str, TenantPlacement]

    @property
    def cores_used(self) -> int:
        return sum(t.cores for t in self.tenants.values())

    @property
    def xbs_used(self) -> int:
        return sum(t.xbs for t in self.tenants.values())

    def subarch(self, name: str) -> CIMArch:
        """The tenant's compiler-facing ``CIMArch`` view (its partition)."""
        t = self.tenants[name]
        return self.arch.subarch(t.cores, f"{self.arch.name}/{name}")

    def validate(self) -> None:
        """Assert the plan respects the physical chip, tenant by tenant."""
        chip_xbs = self.arch.chip.n_cores * self.arch.core.n_xbs
        if self.cores_used > self.arch.chip.n_cores:
            raise AssertionError(
                f"plan uses {self.cores_used} cores > chip "
                f"{self.arch.chip.n_cores}")
        if self.xbs_used > chip_xbs:
            raise AssertionError(
                f"plan uses {self.xbs_used} crossbars > chip {chip_xbs}")
        for t in self.tenants.values():
            if t.cores < 1:
                raise AssertionError(f"tenant {t.name} got no cores")
            if t.resident and t.cores < t.replicas * t.footprint_cores:
                raise AssertionError(
                    f"tenant {t.name}: {t.replicas} replicas x "
                    f"{t.footprint_cores} cores > partition {t.cores}")

    def summary(self) -> str:
        chip_xbs = self.arch.chip.n_cores * self.arch.core.n_xbs
        lines = [f"tenancy on {self.arch.name}: {self.cores_used}/"
                 f"{self.arch.chip.n_cores} cores, {self.xbs_used}/"
                 f"{chip_xbs} crossbars"]
        for t in sorted(self.tenants.values(),
                        key=lambda p: -p.spec.traffic):
            kind = (f"resident x{t.replicas}" if t.resident
                    else "time-multiplexed")
            lines.append(
                f"  {t.name}: traffic {t.spec.traffic:g} -> {t.cores} cores "
                f"({t.xbs} xbs), {kind} "
                f"[footprint {t.footprint_cores}c, "
                f"~{t.est_cycles_per_req:.0f}cy/req]")
        return "\n".join(lines)


def _tenant_profile(spec: TenantSpec, arch: CIMArch) -> tuple:
    """(footprint cores, pipelined cycles/request at one copy, placements).

    The real cost model, not a heuristic: ``CostModel.placement`` runs
    ``mapping.bind`` per CIM node, so the footprint is exactly the cores
    one resident weight copy occupies under this tenant's binding.
    """
    binding = spec.compile_kwargs.get("binding", BitBinding.B_TO_XBC)
    if isinstance(binding, str):
        binding = BitBinding(binding)
    cm = CostModel(arch, binding)
    pls = [cm.placement(node, spec.graph) for node in spec.graph.cim_nodes]
    footprint = sum(p.cores for p in pls)
    use_pipeline = bool(spec.compile_kwargs.get("use_pipeline", True))
    cycles = estimate_segment_cycles(pls, use_pipeline)
    return max(1, footprint), max(1.0, cycles), pls


def _traffic_weights(tenants: Sequence[TenantSpec],
                     scale: int = 10_000) -> List[int]:
    """Integer traffic weights for the duplication search's ``n_mvm``.

    ``balance_duplication`` caps a pseudo-op's replicas at its ``n_mvm``,
    so the hottest tenant gets ``scale`` quanta — far above any physical
    core count — and the rest are proportional (>= 1)."""
    top = max(t.traffic for t in tenants)
    return [max(1, round(t.traffic / top * scale)) for t in tenants]


def plan_tenancy(tenants: Sequence[TenantSpec], arch: CIMArch, *,
                 min_cores: int = 1,
                 force_multiplexed: Collection[str] = ()) -> TenancyPlan:
    """Partition ``arch``'s crossbar pool across ``tenants``.

    Deterministic: ties in traffic resolve by input order.  Raises if
    the chip cannot give every tenant ``min_cores`` cores; any other
    overload degrades to time-multiplexing, never to rejection.

    ``force_multiplexed`` names tenants demoted to time-multiplexed
    residency regardless of fit — the cluster's graceful-degradation
    ladder uses this to shed low-priority tenants' resident cores to
    overloaded neighbours before rejecting traffic.
    """
    tenants = list(tenants)
    if not tenants:
        raise ValueError("plan_tenancy needs at least one tenant")
    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"tenant names must be unique, got {names}")
    budget = arch.chip.n_cores
    if budget < min_cores * len(tenants):
        raise ValueError(
            f"chip has {budget} cores < {min_cores} x {len(tenants)} tenants")

    profiles = {t.name: _tenant_profile(t, arch) for t in tenants}
    force_multiplexed = set(force_multiplexed)

    # -- residency: traffic-desc greedy with a reservation for the rest --
    order = sorted(range(len(tenants)),
                   key=lambda i: (-tenants[i].traffic, i))
    resident: List[TenantSpec] = []
    multiplexed: List[TenantSpec] = []
    remaining = budget
    for rank, i in enumerate(order):
        spec = tenants[i]
        footprint = profiles[spec.name][0]
        reserve = min_cores * (len(order) - rank - 1)   # tenants after this
        if (spec.name not in force_multiplexed
                and footprint <= remaining - reserve):
            resident.append(spec)
            remaining -= footprint
        else:
            multiplexed.append(spec)
            remaining -= min_cores
    resident_names = {t.name for t in resident}

    # -- partition sizes ------------------------------------------------
    cores: Dict[str, int] = {}
    pos = {t.name: i for i, t in enumerate(tenants)}
    if multiplexed:
        # the multiplexed group gets cores proportional to its share of
        # the offered load (traffic x service cycles), floored at
        # min_cores each and capped so residents keep their footprints
        load = {t.name: t.traffic * profiles[t.name][1] for t in tenants}
        total_load = sum(load.values())
        mult_load = sum(load[t.name] for t in multiplexed)
        resident_floor = sum(profiles[t.name][0] for t in resident)
        pool = round(budget * mult_load / total_load)
        pool = max(min_cores * len(multiplexed),
                   min(pool, budget - resident_floor))
        shares = sorted(multiplexed, key=lambda t: (-load[t.name],
                                                    pos[t.name]))
        left = pool
        for k, spec in enumerate(shares):
            rest = len(shares) - k - 1
            c = max(min_cores,
                    math.floor(pool * load[spec.name] / mult_load))
            c = min(c, left - min_cores * rest)
            cores[spec.name] = c
            left -= c
        cores[shares[0].name] += left          # remainder to the hottest
        resident_budget = budget - pool
    else:
        resident_budget = budget

    # -- replicas for residents: the CG duplication search verbatim -----
    replicas = {t.name: 1 for t in resident}
    for spec in resident:
        cores[spec.name] = profiles[spec.name][0]
    searchable = [t for t in resident if profiles[t.name][2]]
    if searchable:
        weights = _traffic_weights(searchable)
        fixed = sum(profiles[t.name][0] for t in resident
                    if not profiles[t.name][2])
        pseudo = []
        for spec, w in zip(searchable, weights):
            footprint, cycles, pls = profiles[spec.name]
            # one pseudo-operator per tenant: n_mvm = traffic quanta,
            # t_window = service cycles (via t_load; phases=row_groups=1),
            # one copy costs the tenant's footprint in cores
            p = dataclasses.replace(pls[0], n_mvm=w, cores=footprint,
                                    phases=1, row_groups=1, row_spread=1,
                                    t_load=float(cycles), alu_epilogue=0.0,
                                    dup=1)
            pseudo.append(p)
        balance_duplication(pseudo, resident_budget - fixed, unit="cores")
        for spec, p in zip(searchable, pseudo):
            replicas[spec.name] = p.dup
            cores[spec.name] = p.dup * profiles[spec.name][0]

    placements = {}
    for spec in tenants:
        footprint, cycles, _ = profiles[spec.name]
        placements[spec.name] = TenantPlacement(
            spec=spec, cores=cores[spec.name],
            xbs=cores[spec.name] * arch.core.n_xbs,
            replicas=replicas.get(spec.name, 1),
            resident=spec.name in resident_names,
            footprint_cores=footprint, est_cycles_per_req=cycles)
    plan = TenancyPlan(arch=arch, tenants=placements)
    plan.validate()
    return plan


# ---------------------------------------------------------------------------
# Fleet dimension: tenant -> chip -> crossbar pool.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetPlan:
    """A 2-D tenancy plan: which chips a tenant lives on, and its
    crossbar partition within each.

    ``chips`` maps chip name -> intra-chip ``TenancyPlan`` (only chips
    that received tenants appear); ``routes`` maps tenant -> {chip:
    traffic fraction} and each row sums to 1 — the router splits a
    tenant's request stream across its chip replicas in these
    proportions.  ``archs`` keeps every chip of the fleet (including
    currently-empty ones) so re-planning can use the whole pool.
    Purely descriptive state — no clock, thread-safe to share read-only.
    """

    archs: Dict[str, CIMArch]
    chips: Dict[str, TenancyPlan]
    routes: Dict[str, Dict[str, float]]

    @property
    def tenant_names(self) -> List[str]:
        """All tenants, in deterministic (sorted) order."""
        return sorted(self.routes)

    @property
    def assumed_shares(self) -> Dict[str, float]:
        """The global traffic shares this plan was built for (summing
        each tenant's per-chip planned traffic; normalized to 1)."""
        tot = {}
        for plan in self.chips.values():
            for t in plan.tenants.values():
                tot[t.name] = tot.get(t.name, 0.0) + t.spec.traffic
        s = sum(tot.values())
        return {k: v / s for k, v in tot.items()}

    def total_replicas(self, tenant: str) -> int:
        """Resident weight copies of ``tenant`` across the whole fleet
        (0 when it is time-multiplexed everywhere)."""
        n = 0
        for chip in self.routes.get(tenant, {}):
            p = self.chips[chip].tenants[tenant]
            n += p.replicas if p.resident else 0
        return n

    def validate(self) -> None:
        """Assert per-chip budgets and route consistency (raises
        ``AssertionError``)."""
        for name, plan in self.chips.items():
            if plan.arch.to_dict() != self.archs[name].to_dict():
                raise AssertionError(f"chip {name}: plan arch mismatch")
            plan.validate()
        for tenant, row in self.routes.items():
            if not row:
                raise AssertionError(f"tenant {tenant} routed nowhere")
            if abs(sum(row.values()) - 1.0) > 1e-6:
                raise AssertionError(
                    f"tenant {tenant} route weights sum to "
                    f"{sum(row.values())}, want 1")
            for chip, w in row.items():
                if w <= 0:
                    raise AssertionError(
                        f"tenant {tenant} has non-positive weight on "
                        f"{chip}")
                if tenant not in self.chips[chip].tenants:
                    raise AssertionError(
                        f"tenant {tenant} routed to {chip} but not "
                        "planned there")
        for chip, plan in self.chips.items():
            for t in plan.tenants:
                if chip not in self.routes.get(t, {}):
                    raise AssertionError(
                        f"tenant {t} planned on {chip} but not routed")

    def summary(self) -> str:
        lines = [f"fleet: {len(self.routes)} tenants on "
                 f"{len(self.chips)}/{len(self.archs)} chips"]
        for chip in sorted(self.chips):
            lines.append(self.chips[chip].summary())
        for tenant in self.tenant_names:
            row = ", ".join(f"{c}:{w:.0%}"
                            for c, w in sorted(self.routes[tenant].items()))
            lines.append(f"  route {tenant}: {row}")
        return "\n".join(lines)

    @classmethod
    def from_split(cls, split: Mapping[str, Sequence[TenantSpec]],
                   archs: Mapping[str, CIMArch], *,
                   min_cores: int = 1) -> "FleetPlan":
        """A pinned plan: each chip serves exactly the tenants ``split``
        assigns it (no cross-chip replicas).  This is the reference
        construction for the N-chip == N-independent-fleets
        bit-exactness property."""
        chips, routes = {}, {}
        for chip, specs in split.items():
            if not specs:
                continue
            chips[chip] = plan_tenancy(specs, archs[chip],
                                       min_cores=min_cores)
            for s in specs:
                if s.name in routes:
                    raise ValueError(
                        f"tenant {s.name} split onto multiple chips; "
                        "use plan_fleet for spanning replicas")
                routes[s.name] = {chip: 1.0}
        plan = cls(archs=dict(archs), chips=chips, routes=routes)
        plan.validate()
        return plan


#: route-weight grid: fractions snap to multiples of 1/16 so that
#: near-identical demand estimates (e.g. EWMA-observed vs true traffic)
#: produce *identical* routes — jittery weights like 0.51/0.49 would
#: otherwise quantize into different batch buckets than 0.50/0.50 and
#: make equivalent plans perform measurably differently
_ROUTE_GRID = 16


def _snap_route(row: Dict[str, float]) -> Dict[str, float]:
    """Snap a normalized route row onto the ``1/_ROUTE_GRID`` grid
    (largest-remainder apportionment; every chip keeps >= 1 slot so no
    planned placement is silently dropped)."""
    if len(row) <= 1:
        return {c: 1.0 for c in row}
    chips = sorted(row)
    raw = {c: row[c] * _ROUTE_GRID for c in chips}
    slots = {c: max(1, int(raw[c])) for c in chips}
    while sum(slots.values()) > _ROUTE_GRID:   # floors + min-1 overshoot
        c = min((c for c in chips if slots[c] > 1),
                key=lambda k: raw[k] - slots[k])
        slots[c] -= 1
    by_remainder = sorted(chips, key=lambda c: (slots[c] - raw[c], c))
    for c in by_remainder:
        if sum(slots.values()) >= _ROUTE_GRID:
            break
        slots[c] += 1
    return {c: slots[c] / _ROUTE_GRID for c in chips}


def plan_fleet(tenants: Sequence[TenantSpec],
               archs: Mapping[str, CIMArch], *, min_cores: int = 1,
               force_multiplexed: Collection[str] = ()) -> FleetPlan:
    """Assign tenant -> chip -> crossbar pool over an N-chip fleet.

    Offered load (traffic x per-request service cycles, profiled with
    the real cost model on each chip's own arch) is water-filled across
    chip core capacities: tenants in descending-load order each grab
    the emptiest eligible chip, spilling onto further chips when their
    demand exceeds what one chip has left — so hot tenants get
    replicas *spanning* chips while cold ones land whole.  Each chip's
    subset is then partitioned by ``plan_tenancy`` (per-chip traffic
    scaled by the split), so all intra-chip invariants hold per chip.

    Deterministic: ties resolve by input order (tenants) and sorted
    name (chips).  Raises ``ValueError`` when the fleet cannot give
    every tenant ``min_cores`` somewhere.
    """
    tenants = list(tenants)
    if not tenants:
        raise ValueError("plan_fleet needs at least one tenant")
    if not archs:
        raise ValueError("plan_fleet needs at least one chip")
    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"tenant names must be unique, got {names}")
    archs = dict(archs)
    chip_names = sorted(archs)
    capacity = {c: archs[c].chip.n_cores for c in chip_names}
    if sum(capacity.values()) < min_cores * len(tenants):
        raise ValueError(
            f"fleet has {sum(capacity.values())} cores < "
            f"{min_cores} x {len(tenants)} tenants")

    # offered load per tenant: traffic x mean service cycles across the
    # (possibly heterogeneous) chips it could land on
    cycles = {t.name: [_tenant_profile(t, archs[c])[1]
                       for c in chip_names] for t in tenants}
    load = {t.name: t.traffic * sum(cycles[t.name]) / len(chip_names)
            for t in tenants}
    total_load = sum(load.values())
    total_cores = sum(capacity.values())

    # -- water-fill demand (in cores) across chip capacities ------------
    remaining = dict(capacity)
    assigned: Dict[str, List[str]] = {c: [] for c in chip_names}
    weights: Dict[str, Dict[str, float]] = {}
    order = sorted(range(len(tenants)), key=lambda i: (-load[names[i]], i))

    def eligible(c: str, tenant: str) -> bool:
        # room for one more tenant under the per-chip min_cores floor
        extra = 0 if tenant in assigned[c] else 1
        return min_cores * (len(assigned[c]) + extra) <= capacity[c]

    for i in order:
        spec = tenants[i]
        demand = max(float(min_cores),
                     load[spec.name] / total_load * total_cores)
        weights[spec.name] = {}
        while demand > 1e-9:
            open_chips = [c for c in chip_names
                          if eligible(c, spec.name) and remaining[c] > 0]
            if not open_chips:
                break
            c = max(open_chips, key=lambda k: remaining[k])
            take = min(demand, remaining[c])
            # avoid sliver replicas: a spill-over piece worth less than
            # one core folds into the previous chip's share instead
            if weights[spec.name] and take < 1.0:
                break
            weights[spec.name][c] = weights[spec.name].get(c, 0.0) + take
            assigned[c] = assigned[c] if spec.name in assigned[c] \
                else assigned[c] + [spec.name]
            remaining[c] -= take
            demand -= take
        if not weights[spec.name]:
            # fleet fully claimed: park on the least-crowded eligible
            # chip (plan_tenancy will time-multiplex it there)
            fallback = [c for c in chip_names if eligible(c, spec.name)]
            if not fallback:
                raise ValueError(
                    f"no chip can host tenant {spec.name!r} (fleet "
                    f"capacity {total_cores} cores, {len(tenants)} "
                    "tenants)")
            c = max(fallback, key=lambda k: remaining[k])
            weights[spec.name][c] = float(min_cores)
            assigned[c] = assigned[c] + [spec.name]
            remaining[c] -= min_cores

    # -- per-chip tenancy plans over the split traffic -------------------
    chips: Dict[str, TenancyPlan] = {}
    routes: Dict[str, Dict[str, float]] = {}
    for t in tenants:
        tot = sum(weights[t.name].values())
        routes[t.name] = _snap_route(
            {c: w / tot for c, w in weights[t.name].items()})
    for c in chip_names:
        subset = [t for t in tenants if c in routes[t.name]]
        if not subset:
            continue
        specs = [dataclasses.replace(t, traffic=t.traffic
                                     * routes[t.name][c])
                 for t in subset]
        chips[c] = plan_tenancy(
            specs, archs[c], min_cores=min_cores,
            force_multiplexed=[n for n in force_multiplexed
                               if any(s.name == n for s in specs)])
    plan = FleetPlan(archs=archs, chips=chips, routes=routes)
    plan.validate()
    return plan
