"""Serve two workloads co-resident on one CIM chip — the multi-tenant
fleet end to end, on ``repro_torch``.

ResNet-18 and a ViT share the ISAAC-like Table-3 chip: the tenancy
planner partitions the crossbar pool by traffic share (each tenant gets
a feasible ``CIMArch`` sub-view), the engine pool warm-loads one
trace-lowered executable per tenant on ``--device``, and the
deadline-aware batcher drains an interleaved request trace into
bucketed batches.

The demo asserts the property that makes the fleet trustworthy: every
tenant's outputs are bit-exact against a standalone single-workload
``CimBatchService`` running on the whole chip on the same device —
co-tenancy, partition compiles, bucket padding and batching change
*when* work runs, never what it computes.

  PYTHONPATH=src python examples/serve_cim_fleet_torch.py [--device cpu]

``examples/serve_cim_fleet.py`` is the same demo on the JAX package.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np

from repro_torch.cimsim.functional import make_input
from repro_torch.core.abstraction import get_arch
from repro_torch.kernels.backend import resolve_device
from repro_torch.serving import (CimBatchService, CimFleet, CimRequest,
                                 TenantSpec, plan_tenancy)
from repro_torch.workloads import get_workload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fleet and the standalone "
                         "services (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)   # no card: refuse now

    arch = get_arch("isaac-baseline")
    resnet = get_workload("resnet18", in_hw=16)
    vit = get_workload("vit", n_layers=2)
    tenants = [TenantSpec("resnet18", resnet, traffic=3.0),
               TenantSpec("vit", vit, traffic=1.0)]

    plan = plan_tenancy(tenants, arch)
    print(plan.summary(), "\n")
    plan.validate()                      # crossbar budget provably respected

    t0 = time.time()
    fleet = CimFleet(tenants, arch, plan=plan, max_wait_s=0.0,
                     device=device)
    print(f"fleet warm-up (compile + lower + pack): {time.time() - t0:.1f}s")

    # an interleaved trace, 3:1 resnet:vit like the traffic shares
    graphs = {"resnet18": resnet, "vit": vit}
    trace = []
    for i in range(12):
        model = "vit" if i % 4 == 3 else "resnet18"
        trace.append(CimRequest(rid=i, model=model,
                                inputs=make_input(graphs[model], i)))

    t0 = time.time()
    done = fleet.serve(trace, now=0.0)
    print(f"served {len(done)} requests in {time.time() - t0:.1f}s")
    print(fleet.stats().summary(), "\n")

    # ---- bit-exactness vs the standalone single-workload service ------
    for model, graph in graphs.items():
        svc = CimBatchService(graph, arch, max_batch=8, device=device)
        mine = [r for r in done if r.model == model]
        refs = [CimRequest(rid=r.rid, inputs=r.inputs) for r in mine]
        svc.serve(refs)
        for a, b in zip(mine, refs):
            for t in graph.outputs:
                np.testing.assert_array_equal(a.outputs[t], b.outputs[t])
        print(f"{model}: {len(mine)} fleet outputs bit-exact vs standalone "
              "CimBatchService on the full chip")
    print("\nco-tenancy changed scheduling, not semantics ✓")
    return done


if __name__ == "__main__":
    main()
