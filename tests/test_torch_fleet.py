"""The port's serving fleet against the JAX package's, on the CPU.

Mirrors tests/test_fleet.py and the fleet, batcher and pad-to-bucket
cases of tests/test_serving.py on ``repro_torch.serving`` with
``device="cpu"``: the planners equal the reference's, fleets and
clusters equal standalone services bit for bit (and the reference's
cluster on the same tenants, seed and trace), a chip kill loses no
accepted request, and only the typed transient error is ever retried.
"""
import copy
import json

import numpy as np
import pytest

from repro import serving as jsv
from repro.cimsim.functional import make_input as jmake_input
from repro.core import abstraction as ja
from repro.workloads import get_workload as jwl
from repro_torch.cimsim import executor as tex
from repro_torch.cimsim.functional import make_input
from repro_torch.core import abstraction as ta
from repro_torch.kernels.backend import KernelUnsupportedError
from repro_torch.serving import (AdmissionError, Batch, ChipFault,
                                 CimBatchService, CimCluster, CimFleet,
                                 CimRequest, DynamicBatcher, FaultSchedule,
                                 FleetPlan, ReplanPolicy, ServiceStats,
                                 TenantSpec, TraceRecorder, TrafficModel,
                                 TransientKernelError, bucket_for,
                                 load_trace, plan_fleet, plan_tenancy,
                                 points_from_campaign, synthetic_trace)
from repro_torch.workloads import get_workload

DEV = dict(device="cpu")
ISAAC = ta.get_arch("isaac-baseline")
CHIP8 = ISAAC.subarch(8, "isaac-8c")
CNN = get_workload("tiny_cnn")
MLP = get_workload("tiny_mlp")
GRAPHS = {"cnn": CNN, "mlp": MLP}


def _chips(mod=ta, n0=8, n1=8):
    isaac = mod.get_arch("isaac-baseline")
    return {"c0": isaac.subarch(n0, f"isaac-{n0}c-a"),
            "c1": isaac.subarch(n1, f"isaac-{n1}c-b")}


def _tenants(tc=3.0, tm=1.0, pc=1, pm=0, mod=None):
    """Port specs by default; ``mod=jsv`` gives the reference's."""
    if mod is None:
        return [TenantSpec("cnn", CNN, traffic=tc, priority=pc),
                TenantSpec("mlp", MLP, traffic=tm, priority=pm)]
    return [mod.TenantSpec("cnn", jwl("tiny_cnn"), traffic=tc, priority=pc),
            mod.TenantSpec("mlp", jwl("tiny_mlp"), traffic=tm, priority=pm)]


def _requests(n, rid_base=0):
    out = []
    for i in range(n):
        model = ("cnn", "mlp")[i % 2]
        rid = rid_base + i
        out.append(CimRequest(rid=rid, model=model,
                              inputs=make_input(GRAPHS[model], rid)))
    return out


def _fault_cluster(faults, chips=None, trace=None, **kw):
    return CimCluster(_tenants(), chips or _chips(),
                      faults=FaultSchedule(faults), trace=trace,
                      max_wait_s=0.0, **DEV, **kw)


# ------------------------------------------------------------- planners

@pytest.mark.parametrize("mix", [(1, 1), (10, 1), (1, 10), (7, 3)])
def test_planners_match_reference(mix):
    tc, tm = mix
    plan = plan_fleet(_tenants(tc, tm), _chips())
    want = jsv.plan_fleet(_tenants(tc, tm, mod=jsv), _chips(ja))
    plan.validate()
    assert plan.routes == want.routes
    for tenant, row in plan.routes.items():
        assert abs(sum(row.values()) - 1.0) < 1e-9
    tp = plan_tenancy(_tenants(tc, tm), CHIP8)
    jp = jsv.plan_tenancy(_tenants(tc, tm, mod=jsv),
                          ja.get_arch("isaac-baseline").subarch(8, "isaac-8c"))
    tp.validate()
    assert tp.cores_used <= CHIP8.chip.n_cores
    assert {n: (t.cores, t.replicas, t.resident)
            for n, t in tp.tenants.items()} == \
        {n: (t.cores, t.replicas, t.resident) for n, t in jp.tenants.items()}


def test_hot_tenant_spans_chips_and_split_pins():
    plan = plan_fleet(_tenants(20.0, 1.0), _chips())
    plan.validate()
    assert plan.total_replicas("cnn") >= 2
    with pytest.raises(ValueError, match="multiple chips"):
        FleetPlan.from_split({"c0": [_tenants()[0]],
                              "c1": [_tenants()[0]]}, _chips())


def test_over_capacity_tenant_is_time_multiplexed():
    big = get_workload("resnet18", in_hw=16)
    plan = plan_tenancy([TenantSpec("resnet", big, traffic=1.0),
                         TenantSpec("mlp", MLP, traffic=1.0)],
                        ISAAC.subarch(4, "isaac-4c"))
    assert not plan.tenants["resnet"].resident
    assert plan.tenants["mlp"].resident
    plan.validate()


# -------------------------------------------------------------- batcher

def test_batcher_release_policy_and_edf():
    assert [bucket_for(n, (1, 2, 4, 8)) for n in (1, 2, 3, 5, 8, 20)] == \
        [1, 2, 4, 8, 8, 8]
    b = DynamicBatcher(buckets=(1, 2, 4), max_wait_s=1.0, est_batch_s=0.1)
    assert b.release_reason(now=0.0) is None
    for i in range(2):
        b.submit(CimRequest(rid=i, arrival_s=0.0))
    assert b.release_reason(now=0.5) is None
    assert b.release_reason(now=1.5) == "age"
    b.submit(CimRequest(rid=2, arrival_s=0.5))
    b.submit(CimRequest(rid=3, arrival_s=0.5))
    batch = b.next_batch(now=0.6)
    assert isinstance(batch, Batch)
    assert batch.reason == "full" and batch.bucket == 4 and len(batch) == 4
    b.submit(CimRequest(rid=4, arrival_s=0.0, deadline_s=0.15))
    assert b.release_reason(now=0.1) == "deadline"
    e = DynamicBatcher(buckets=(1, 2), max_wait_s=10.0)
    e.submit(CimRequest(rid=0, arrival_s=0.0, deadline_s=9.0))
    e.submit(CimRequest(rid=1, arrival_s=0.1, deadline_s=1.0))
    e.submit(CimRequest(rid=2, arrival_s=0.2))
    batches = e.drain(now=0.3)
    assert [r.rid for x in batches for r in x.requests] == [1, 0, 2]
    assert [x.reason for x in batches] == ["full", "flush"]
    with pytest.raises(ValueError):
        DynamicBatcher(buckets=(4, 2))


# ------------------------------------------ CimBatchService additions

def test_serve_padded_matches_unpadded():
    svc = CimBatchService(MLP, CHIP8, max_batch=8, **DEV)
    reqs = [CimRequest(rid=i, inputs=make_input(MLP, i)) for i in range(3)]
    assert svc.serve_padded(reqs, bucket=8) >= 0.0    # 3 rows + 5 pads
    assert 8 in svc._warmed
    plain = [CimRequest(rid=i, inputs=make_input(MLP, i)) for i in range(3)]
    svc.serve(plain)
    for a, b in zip(reqs, plain):
        for t in MLP.outputs:
            np.testing.assert_array_equal(a.outputs[t], b.outputs[t])
    assert svc.dispatch([]) == 0.0 and svc.serve([]) == []


def test_service_compile_cache_is_used():
    class Cache:
        def __init__(self):
            self.store, self.hits = {}, 0

        def get(self, key):
            hit = self.store.get(key)
            self.hits += hit is not None
            return hit

        def put(self, key, result):
            self.store[key] = result

    cache = Cache()
    a = CimBatchService(MLP, CHIP8, cache=cache, **DEV)
    assert len(cache.store) == 1 and cache.hits == 0
    b = CimBatchService(MLP, CHIP8, cache=cache, **DEV)
    assert cache.hits == 1
    reqs = [[CimRequest(rid=0, inputs=make_input(MLP, 0))] for _ in "ab"]
    a.serve(reqs[0])
    b.serve(reqs[1])
    np.testing.assert_array_equal(reqs[0][0].outputs["fc2.out"],
                                  reqs[1][0].outputs["fc2.out"])


def test_points_from_campaign_duck_typed():
    class _Point:
        def compile_kwargs(self):
            return {"use_pipeline": True}

    class _Best:
        point = _Point()

    class _Outcome:
        best = _Best()

    class _NoBest:
        best = None

    class _Campaign:
        workloads = {"cnn": _Outcome(), "mlp": _NoBest()}

    assert points_from_campaign(_Campaign()) == {"cnn": {"use_pipeline": True}}


# ---------------------------------------------------------------- fleet

def test_fleet_bit_exact_vs_standalone_services():
    fleet = CimFleet(_tenants(), CHIP8, max_wait_s=0.0, **DEV)
    done = fleet.serve(_requests(10), now=0.0)
    assert len(done) == 10
    for name, g in GRAPHS.items():
        mine = [r for r in done if r.model == name]
        for arch in (fleet.plan.subarch(name), CHIP8):
            ref = CimBatchService(g, arch, max_batch=8, **DEV)
            refs = [CimRequest(rid=r.rid, inputs=r.inputs) for r in mine]
            ref.serve(refs)
            for a, b in zip(mine, refs):
                for t in g.outputs:
                    np.testing.assert_array_equal(a.outputs[t], b.outputs[t])


def test_fleet_interpreter_fallback_parity():
    fast = CimFleet(_tenants(), CHIP8, max_wait_s=0.0, **DEV)
    slow = CimFleet(_tenants(), CHIP8, max_wait_s=0.0, use_executor=False,
                    **DEV)
    for ra, rb in zip(fast.serve(_requests(4), now=0.0),
                      slow.serve(_requests(4), now=0.0)):
        assert ra.rid == rb.rid
        for t in GRAPHS[ra.model].outputs:
            np.testing.assert_array_equal(ra.outputs[t], rb.outputs[t])


def test_fleet_stats_routing_and_plan_checks():
    fleet = CimFleet(_tenants(), CHIP8, buckets=(1, 2), max_wait_s=10.0,
                     **DEV)
    with pytest.raises(KeyError):
        fleet.submit("nope", {})
    fleet.submit("cnn", make_input(CNN, 0), now=0.0)
    assert fleet.step(now=0.0) == []          # young + partial: wait
    fleet.submit("cnn", make_input(CNN, 1), now=0.0, deadline_s=-1.0)
    done = fleet.step(now=0.0)                # bucket 2 is full now
    assert len(done) == 2 and fleet.pending == 0
    agg = fleet.stats().aggregate
    assert agg.requests == 2 and agg.deadline_misses == 1
    assert "deadline misses" in fleet.summary()
    plan = plan_tenancy(_tenants(), CHIP8)
    with pytest.raises(ValueError, match="plan tenants"):
        CimFleet([TenantSpec("other", MLP)], CHIP8, plan=plan, **DEV)
    with pytest.raises(ValueError, match="different spec"):
        CimFleet([TenantSpec("cnn", MLP, traffic=3.0),
                  TenantSpec("mlp", MLP, traffic=1.0)], CHIP8, plan=plan,
                 **DEV)


def test_transient_kernel_error_bounded_retry():
    fleet = CimFleet(_tenants(), CHIP8, max_wait_s=0.0, max_retries=2,
                     **DEV)
    engine = fleet.pool["mlp"]
    real = engine.serve_padded
    fails = {"n": 2}

    def flaky(requests, bucket):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise TransientKernelError("injected")
        return real(requests, bucket)

    engine.serve_padded = flaky
    req = fleet.submit("mlp", make_input(MLP, 0), now=0.0)
    fleet.drain(now=0.0)
    assert req.outputs is not None and fleet.retries == 2
    fails["n"] = 10
    fleet.submit("mlp", make_input(MLP, 1), now=1.0)
    with pytest.raises(TransientKernelError):
        fleet.drain(now=1.0)


def _saturating_chip():
    """4 cores of 32x32 crossbars with a 4-bit ADC: every tenant MVM is
    a ``cim_mvm_tiles`` dispatch."""
    return ta.CIMArch(
        name="fleet-saturating", mode=ta.ComputingMode.WLM,
        chip=ta.ChipTier(core_number=(4, 1), alu_ops_per_cycle=64,
                         l0_bw_bits=1024),
        core=ta.CoreTier(xb_number=(2, 1), l1_bw_bits=1024),
        xb=ta.CrossbarTier(xb_size=(32, 32), dac_bits=1, adc_bits=4,
                           cell_type=ta.CellType.SRAM, cell_precision=2,
                           parallel_row=8))


@pytest.mark.parametrize("error", [RuntimeError, KernelUnsupportedError])
def test_mvm_route_error_propagates_unretried(monkeypatch, error):
    """A build or launch failure of the crossbar-MVM route is permanent:
    it leaves ``CimFleet._dispatch`` at once, never retried."""
    fleet = CimFleet([TenantSpec("mlp", MLP)], _saturating_chip(),
                     max_wait_s=0.0, max_retries=3, **DEV)
    assert fleet.pool["mlp"].executor_stats.matmul_nodes == 0
    calls = {"n": 0}

    def broken(*args, **kwargs):
        calls["n"] += 1
        raise error("CUDA error: unspecified launch failure")

    monkeypatch.setattr(tex, "cim_mvm_tiles", broken)
    fleet.submit("mlp", make_input(MLP, 0), now=0.0)
    with pytest.raises(error) as ei:
        fleet.drain(now=0.0)
    assert not isinstance(ei.value, TransientKernelError)
    assert calls["n"] == 1 and fleet.retries == 0


def test_evict_pending_counts_deadline_misses_exactly_once():
    fleet = CimFleet(_tenants(), CHIP8, max_wait_s=0.0, **DEV)
    late = [fleet.submit("mlp", make_input(MLP, i), now=0.0,
                         deadline_s=1.0) for i in range(3)]
    ok = fleet.submit("mlp", make_input(MLP, 3), now=0.0, deadline_s=99.0)
    evicted = fleet.evict_pending(now=5.0)
    assert len(evicted) == 4
    assert fleet.stats().tenants["mlp"].deadline_misses == 3
    for r in evicted:
        fleet.requeue(r)
    fleet.drain(now=5.0)
    assert all(r.outputs is not None for r in late + [ok])
    assert fleet.stats().tenants["mlp"].deadline_misses == 3
    assert fleet.evict_pending(now=9.0) == []


# -------------------------------------------------------------- cluster

def test_cluster_bitexact_vs_independent_single_chip_fleets():
    chips = _chips()
    cnn_spec, mlp_spec = _tenants()
    plan = FleetPlan.from_split({"c0": [cnn_spec], "c1": [mlp_spec]}, chips)
    cluster = CimCluster(_tenants(), chips, plan=plan, max_wait_s=0.0, **DEV)
    reqs = _requests(8)
    by_rid = {r.rid: r for r in cluster.serve(copy.deepcopy(reqs), now=0.0)}
    assert len(by_rid) == len(reqs)
    f0 = CimFleet([cnn_spec], chips["c0"], max_wait_s=0.0, **DEV)
    f1 = CimFleet([mlp_spec], chips["c1"], max_wait_s=0.0, **DEV)
    for r in copy.deepcopy(reqs):
        ref = (f0 if r.model == "cnn" else f1).serve([r], now=0.0)[0]
        for t in ref.outputs:
            np.testing.assert_array_equal(by_rid[ref.rid].outputs[t],
                                          ref.outputs[t])


def test_cluster_matches_reference_across_a_chip_kill():
    """Same tenants, seed, trace and kill in both packages: every
    request is served, with the reference's outputs, and the clusters
    took the same failover decisions."""
    kill = 0.5
    tm = TrafficModel(diurnal_amp=0.0, bursts_per_day=0.0)
    jtm = jsv.TrafficModel(diurnal_amp=0.0, bursts_per_day=0.0)
    graphs = {"cnn": CNN, "mlp": MLP}
    jgraphs = {"cnn": jwl("tiny_cnn"), "mlp": jwl("tiny_mlp")}
    shares = {"cnn": 1.0, "mlp": 1.0}
    trace = synthetic_trace(graphs, 16, 1.0, shares=shares, model=tm,
                            seed=4)
    jtrace = jsv.synthetic_trace(jgraphs, 16, 1.0, shares=shares,
                                 model=jtm, seed=4)
    assert [(r.rid, r.model, r.arrival_s) for r in trace] == \
        [(r.rid, r.model, r.arrival_s) for r in jtrace]
    cluster = CimCluster(_tenants(), _chips(), max_wait_s=0.0, seed=3,
                         faults=FaultSchedule([ChipFault(kill, "c0")]),
                         **DEV)
    jcluster = jsv.CimCluster(
        _tenants(mod=jsv), _chips(ja), max_wait_s=0.0, seed=3,
        faults=jsv.FaultSchedule([jsv.ChipFault(kill, "c0")]))
    for c, reqs in ((cluster, trace), (jcluster, jtrace)):
        for i, r in enumerate(reqs):
            c.submit_request(r, now=r.arrival_s)
            if i % 4 == 3:
                c.step(now=r.arrival_s)
        c.drain(now=1.0)
    assert cluster.chip_kills == jcluster.chip_kills == 1
    assert cluster.failed == jcluster.failed == {"c0"}
    assert cluster.plan.routes == jcluster.plan.routes
    for r, jr in zip(trace, jtrace):
        assert r.outputs is not None
        for t in r.outputs:
            np.testing.assert_array_equal(r.outputs[t], jr.outputs[t])


def test_cluster_replans_under_drift_and_carries_pending():
    cluster = CimCluster(
        _tenants(3.0, 1.0), _chips(), max_wait_s=0.0,
        policy=ReplanPolicy(min_requests=4, drift_threshold=0.3), **DEV)
    assert cluster.plan.assumed_shares["cnn"] > \
        cluster.plan.assumed_shares["mlp"]
    held = [cluster.submit("mlp", make_input(MLP, i), now=0.1 * i)
            for i in range(8)]
    cluster.control(now=2.0)
    assert cluster.migrations >= 1
    assert cluster.pending == len(held)       # nothing dropped by migration
    cluster.drain(now=3.0)
    assert all(r.outputs is not None for r in held)
    shares = cluster.plan.assumed_shares
    assert shares["mlp"] > shares["cnn"]


def test_overload_degrades_then_rejects_typed():
    chips = {"c0": ISAAC.subarch(6, "isaac-6c")}
    cluster = CimCluster(_tenants(1.0, 1.0, pc=1, pm=0), chips,
                         max_wait_s=0.0, max_queue=4, **DEV)
    accepted, rejected = [], 0
    for i in range(20):
        try:
            accepted.append(cluster.submit("cnn", make_input(CNN, i),
                                           now=0.0))
        except AdmissionError as e:
            rejected += 1
            assert e.model == "cnn" and e.limit == 4
    assert "mlp" in cluster.demoted and rejected > 0
    assert not cluster.plan.chips["c0"].tenants["mlp"].resident
    done = cluster.drain(now=1.0)
    assert len(done) == len(accepted)
    assert all(r.outputs is not None for r in done)


def test_chip_kill_mid_run_loses_no_accepted_requests():
    tr = TraceRecorder()
    cluster = _fault_cluster([ChipFault(at_s=3.0, chip="c0", kind="kill")],
                             trace=tr)
    submitted, t = [], 0.0
    for i in range(12):
        model = ("cnn", "mlp")[i % 2]
        submitted.append(cluster.submit(
            model, make_input(GRAPHS[model], i), now=t))
        t += 0.5
        if i % 4 == 3:
            cluster.step(now=t)
    cluster.drain(now=t)
    assert all(r.outputs is not None for r in submitted)
    assert cluster.chip_kills == 1 and cluster.failed == {"c0"}
    assert "c0" not in cluster.fleets and "c0" not in cluster.archs
    kills = [e for e in tr.events if e.get("name") == "chip_kill"]
    assert len(kills) == 1 and kills[0]["args"]["survivors"] == 1


def test_chip_degrade_slowdown_compounds_and_survives_replan():
    tr = TraceRecorder()
    cluster = _fault_cluster(
        [ChipFault(at_s=1.0, chip="c1", kind="degrade", degrade_factor=2.0),
         ChipFault(at_s=2.0, chip="c1", kind="degrade", degrade_factor=1.5)],
        trace=tr, policy=ReplanPolicy(min_requests=4, drift_threshold=0.3))
    for i in range(8):
        cluster.submit("mlp", make_input(MLP, i), now=0.5 * i)
    cluster.drain(now=8.0)
    assert cluster.chip_degrades == 2
    assert cluster.fleets["c1"].slowdown == pytest.approx(3.0)
    cluster.control(now=9.0)
    assert cluster.migrations >= 1
    assert cluster.fleets["c1"].slowdown == pytest.approx(3.0)
    assert [e["args"]["factor"] for e in tr.events
            if e.get("name") == "chip_degrade"] == [2.0, 3.0]


def test_kill_last_chip_and_failover_ladder_raise():
    one = {"c0": ISAAC.subarch(8, "isaac-8c")}
    cluster = _fault_cluster([ChipFault(at_s=2.0, chip="c0")], chips=one)
    cluster.submit("mlp", make_input(MLP, 0), now=0.0)
    with pytest.raises(AdmissionError) as ei:
        cluster.submit("mlp", make_input(MLP, 1), now=5.0)
    assert ei.value.model == "*" and ei.value.limit == 0
    tight = {"c0": ISAAC.subarch(8, "isaac-8c-a"),
             "c1": ISAAC.subarch(1, "isaac-1c")}
    cluster = _fault_cluster([ChipFault(at_s=2.0, chip="c0")], chips=tight)
    cluster.submit("mlp", make_input(MLP, 0), now=0.0)
    with pytest.raises(ValueError, match="cores"):
        cluster.submit("mlp", make_input(MLP, 1), now=5.0)
    assert cluster.demoted == {"cnn", "mlp"}


def test_failover_packing_fault_propagates_without_demotions(monkeypatch):
    """A tile that leaves the kernel's operand range while the survivor
    is re-packed is a packing fault, not an infeasible plan: it leaves
    the failover ladder as is, and no tenant is demoted for it."""
    chips = {"c0": _saturating_chip(), "c1": _saturating_chip()}
    cnn_spec, mlp_spec = _tenants()
    plan = FleetPlan.from_split({"c0": [cnn_spec], "c1": [mlp_spec]}, chips)
    cluster = _fault_cluster([ChipFault(at_s=2.0, chip="c0")], chips=chips,
                             plan=plan)
    cluster.submit("mlp", make_input(MLP, 0), now=0.0)
    cluster.drain(now=0.0)
    encode = tex.LoweredExecutable._encode
    monkeypatch.setattr(tex.LoweredExecutable, "_encode",
                        lambda self, tiles: encode(self, tiles + 1000))
    with pytest.raises(tex.TileRangeError, match="outside"):
        cluster.submit("mlp", make_input(MLP, 1), now=5.0)
    assert cluster.demoted == set() and cluster.demotions == 0


def test_trace_roundtrip_and_schema(tmp_path):
    tr = TraceRecorder()
    cluster = CimCluster(
        _tenants(), _chips(), max_wait_s=0.0, trace=tr,
        policy=ReplanPolicy(min_requests=4, drift_threshold=0.3), **DEV)
    clock = 0.0
    for rnd in range(2):
        for r in _requests(6, rid_base=rnd * 6):
            cluster.submit_request(r, now=clock + 0.1)
        cluster.drain(now=clock + 1.0)
        clock += 1.0
        cluster.control(now=clock)
    assert {"X", "C", "M"} <= {ev["ph"] for ev in tr.events}
    cats = {ev.get("cat") for ev in tr.events}
    assert "batcher" in cats and "engine" in cats
    path = tr.save(tmp_path / "trace.json")
    loaded = load_trace(path)
    assert loaded["traceEvents"] == json.loads(
        path.read_text())["traceEvents"]
    for ev in loaded["traceEvents"]:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(ev)


def test_synthetic_trace_matches_reference():
    model = TrafficModel(users=1e6, diurnal_amp=0.6, bursts_per_day=4)
    jmodel = jsv.TrafficModel(users=1e6, diurnal_amp=0.6, bursts_per_day=4)
    jgraphs = {"cnn": jwl("tiny_cnn"), "mlp": jwl("tiny_mlp")}
    a = synthetic_trace(GRAPHS, 32, 3600.0, shares={"cnn": 1, "mlp": 1},
                        model=model, seed=11, deadline_s=0.5)
    b = jsv.synthetic_trace(jgraphs, 32, 3600.0,
                            shares={"cnn": 1, "mlp": 1}, model=jmodel,
                            seed=11, deadline_s=0.5)
    assert [(r.rid, r.model, r.arrival_s, r.deadline_s) for r in a] == \
        [(r.rid, r.model, r.arrival_s, r.deadline_s) for r in b]
    for r, q in zip(a, b):
        for k in r.inputs:
            np.testing.assert_array_equal(r.inputs[k], q.inputs[k])
    assert [r.arrival_s for r in a] == sorted(r.arrival_s for r in a)
    np.testing.assert_array_equal(make_input(CNN, 3)["input"],
                                  jmake_input(jwl("tiny_cnn"), 3)["input"])


def test_service_stats_merge_and_fleet_default_device(monkeypatch):
    s = ServiceStats()
    s.record([i / 100.0 for i in range(1, 101)], batch_s=1.0)
    t = ServiceStats()
    t.record([10.0], batch_s=2.0, misses=1)
    m = s.merge(t)
    assert m.requests == 101 and m.deadline_misses == 1
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CimFleet(_tenants(), CHIP8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CimCluster(_tenants(), _chips())
