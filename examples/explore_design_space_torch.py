"""Explore the cross-tier CIM design space — now as a multi-workload
campaign with successive halving.

Default run (``--mode campaign``): sweep several workloads against one
design space through a single shared job queue and compile cache, using
the multi-fidelity successive-halving searcher (analytic proxy → prefix
compile → full compile), then report per-workload Pareto frontiers and
the cross-workload robust points.  On one comparison workload the script
also runs exhaustive enumeration and demonstrates that halving pays a
small fraction of the full-fidelity compiles (>= 5x fewer) while
returning the same best-latency configuration, then runs the seeded
adaptive (ask/tell) searcher on the same space and prints its
scorecard next to the campaign's.  Everything runs on the host with
``repro_torch``; the compile cache is the port's own
(``$REPRO_TORCH_COMPILE_CACHE_DIR``), never the JAX package's.

``--mode sweep`` keeps the original single-workload exhaustive sweep
with the warm-cache rerun demonstration.

    PYTHONPATH=src python examples/explore_design_space_torch.py \
        --workloads resnet18,vgg7,tiny_cnn --arch isaac-baseline --workers 4

See docs/DSE.md for the guide; ``examples/explore_design_space.py`` is
the same demo on the JAX package.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core.abstraction import PRESETS, get_arch    # noqa: E402
from repro_torch.dse import (CompileCache, DesignSpace,       # noqa: E402
                       adaptive_search, campaign_scorecard, pareto_frontier,
                       run_campaign, search_scorecard, successive_halving)
from repro_torch.dse.cache import default_cache_dir           # noqa: E402
from repro_torch.dse.runner import sweep                      # noqa: E402
from repro_torch.workloads import WORKLOADS, get_workload     # noqa: E402

OBJECTIVES = ("latency_cycles", "peak_power", "crossbars_used")


def build_space(arch_name: str) -> DesignSpace:
    arch = get_arch(arch_name)
    xr, xc = arch.xb.xb_size
    return DesignSpace(
        arch,
        arch_axes={"xb.xb_size": [(xr, xc), (xr * 2, xc * 2)]},
    )


def load(name: str, in_hw: int):
    kw = {"in_hw": in_hw} if name.startswith(("resnet", "vgg")) else {}
    return get_workload(name, **kw)


def print_frontier(front, header: str) -> None:
    print(f"\n{header} ({len(front)} points, "
          f"minimizing {', '.join(OBJECTIVES)}):")
    hdr = f"{'latency':>12} {'peak_pwr':>9} {'xbs':>6}   configuration"
    print(hdr)
    print("-" * len(hdr))
    for r in front:
        m = r.metrics
        print(f"{m['latency_cycles']:12.1f} {m['peak_power']:9.1f} "
              f"{int(m['crossbars_used']):6d}   {r.point.label()}")


def run_campaign_demo(args, space, cache) -> int:
    graphs = {}
    for name in args.workloads.split(","):
        name = name.strip()
        graphs[name] = load(name, args.in_hw)
    points = space.points()
    print(f"workloads={','.join(graphs)} arch={args.arch} "
          f"points={len(points)} workers={args.workers} eta={args.eta}")
    print(f"cache: {cache.root}")

    t0 = time.perf_counter()
    camp = run_campaign(graphs, space, cache=cache, workers=args.workers,
                        eta=args.eta, robust_tol=args.robust_tol)
    camp_s = time.perf_counter() - t0
    print(f"\ncampaign finished in {camp_s:.2f}s")
    print(camp.summary())
    print()
    print(campaign_scorecard(camp).to_markdown())
    for name, w in camp.workloads.items():
        print_frontier(w.frontier, f"{name} Pareto frontier")

    # --- exhaustive-vs-halving demonstration on one workload -------------
    ref = args.compare_workload or next(iter(graphs))
    graph = graphs.get(ref) or load(ref, args.in_hw)
    print(f"\n=== exhaustive vs successive halving on {ref} ===")
    t0 = time.perf_counter()
    exhaustive = sweep(graph, space, cache=cache, workers=args.workers)
    ex_s = time.perf_counter() - t0
    ok = [r for r in exhaustive if r.ok]
    best_ex = min(ok, key=lambda r: (r.metrics["latency_cycles"], r.index))
    t0 = time.perf_counter()
    sr = successive_halving(graph, space, cache=cache, workers=args.workers,
                            eta=args.eta)
    sh_s = time.perf_counter() - t0
    for log in sr.rungs:
        print(f"  rung {log.rung} [{log.fidelity:6s}] evaluated "
              f"{log.evaluated:3d} -> promoted {log.promoted}")
    reduction = len(exhaustive) / max(sr.full_evals, 1)
    print(f"  exhaustive: {len(exhaustive)} full compiles in {ex_s:.2f}s")
    print(f"  halving:    {sr.full_evals} full compiles in {sh_s:.2f}s "
          f"-> {reduction:.1f}x fewer full-fidelity compiles")
    print(f"  exhaustive best: {best_ex.point.label()} "
          f"({best_ex.metrics['latency_cycles']:.0f} cycles)")
    assert sr.best is not None and sr.best.point == best_ex.point, \
        "halving diverged from the exhaustive best point"
    print("  halving returns the same best point: OK")
    assert reduction >= 5, \
        f"halving should compile >=5x fewer points (got {reduction:.1f}x)"

    # --- adaptive searcher on the same workload --------------------------
    print(f"\n=== adaptive (learned, budgeted) search on {ref} ===")
    t0 = time.perf_counter()
    asr = adaptive_search(graph, space, cache=cache, workers=args.workers,
                          seed=args.seed, batch=16,
                          prefix_keep=max(8, len(exhaustive) // 3),
                          full_keep=max(4, len(exhaustive) // 8))
    ad_s = time.perf_counter() - t0
    print(search_scorecard(asr, name=ref).to_markdown())
    gap = (asr.best.metrics["latency_cycles"]
           / best_ex.metrics["latency_cycles"] - 1.0)
    print(f"  adaptive: {asr.full_evals} full compiles in {ad_s:.2f}s; "
          f"best within {gap:.1%} of the exhaustive best")
    assert asr.best is not None, "adaptive found no feasible point"
    assert asr.full_evals * 3 <= len(exhaustive), \
        "adaptive should compile at most a third of the space at full fidelity"
    print(f"cache entries on disk: {cache.stats()['disk_entries']}")
    return 0


def run_sweep_demo(args, space, cache) -> int:
    graph = load(args.workloads.split(",")[0].strip(), args.in_hw)
    points = space.points()
    print(f"workload={graph.name} arch={args.arch} "
          f"points={len(points)} workers={args.workers}")
    print(f"cache: {cache.root}")

    t0 = time.perf_counter()
    results = sweep(graph, space, cache=cache, workers=args.workers)
    cold_s = time.perf_counter() - t0
    ok = [r for r in results if r.ok]
    n_hit = sum(r.cached for r in results)
    print(f"sweep 1: {len(ok)}/{len(results)} points in {cold_s:.2f}s "
          f"({n_hit} cache hits)")
    for r in results:
        if not r.ok:
            print(f"  infeasible: {r.point.label()}: {r.error}")

    if not args.no_warm_rerun:
        cache.drop_memory()      # force the disk path, not process memory
        t0 = time.perf_counter()
        rerun = sweep(graph, space, cache=cache, workers=args.workers)
        warm_s = time.perf_counter() - t0
        speedup = cold_s / max(warm_s, 1e-9)
        print(f"sweep 2 (warm cache): {warm_s:.2f}s -> {speedup:.1f}x "
              f"{'faster' if speedup >= 1 else 'SLOWER'} than sweep 1")
        assert all(r.cached for r in rerun if r.ok), \
            "warm sweep recompiled points that should have been cached"
        assert [r.metrics for r in rerun] == [r.metrics for r in results], \
            "warm sweep diverged from cold sweep"

    front = pareto_frontier(ok, OBJECTIVES)
    print_frontier(front, f"Pareto frontier ({len(ok)} feasible points)")
    best = front[0]
    print(f"\nlowest-latency config: {best.point.label()} "
          f"({best.metrics['latency_cycles']:.0f} cycles)")
    print(f"cache entries on disk: {cache.stats()['disk_entries']}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="campaign",
                    choices=("campaign", "sweep"))
    ap.add_argument("--workloads", default="resnet18,vgg7,tiny_cnn",
                    help="comma-separated workload names "
                         f"(from {sorted(WORKLOADS)} or lmblock:<cfg>)")
    ap.add_argument("--compare-workload", default="resnet18",
                    help="workload for the exhaustive-vs-halving section")
    ap.add_argument("--in-hw", type=int, default=32,
                    help="input resolution for conv workloads")
    ap.add_argument("--arch", default="isaac-baseline",
                    choices=sorted(PRESETS))
    ap.add_argument("--workers", type=int, default=1,
                    help="process-pool width for the job queue")
    ap.add_argument("--eta", type=int, default=3,
                    help="successive-halving promotion factor")
    ap.add_argument("--seed", type=int, default=0,
                    help="adaptive-search RNG seed (pins the trajectory)")
    ap.add_argument("--robust-tol", type=float, default=0.10,
                    help="robust-point tolerance (relative to per-workload "
                         "best)")
    ap.add_argument("--cache-dir", default=None,
                    help=f"compile cache root (default {default_cache_dir()})")
    ap.add_argument("--fresh", action="store_true",
                    help="clear the cache first (forces a cold run)")
    ap.add_argument("--no-warm-rerun", action="store_true",
                    help="sweep mode: skip the warm-cache demonstration")
    args = ap.parse_args(argv)

    space = build_space(args.arch)
    cache = CompileCache(args.cache_dir)
    if args.fresh:
        cache.clear()
    if args.mode == "campaign":
        return run_campaign_demo(args, space, cache)
    return run_sweep_demo(args, space, cache)


if __name__ == "__main__":
    sys.exit(main())
