"""Dry run: every (architecture x input shape) cell built as a DTensor
program on the ``DeviceMesh`` of a production plan, on the ``meta``
device, with its per-device bytes, counted operations, collectives and
roofline terms.

A port of ``repro.launch.dryrun``, which lowers and compiles each cell
for the 16x16 and 2x16x16 TPU meshes and reads the SPMD module of one
partition.  Here a cell's parameters, optimizer state, cache and batch
are DTensors placed by their partition specs (``launch.sharding``) on
the plan's mesh over a fake process group (``launch.mesh``), each local
shard on "meta" (shapes and dtypes, no data, no device); the cell runs
with its sharding constraints as redistributions, under the counting
mode of ``analysis.roofline``, which reads this device's local ops and
the collectives of every redistribution.  Each record holds:

  * the per-device bytes of the params, optimizer state, cache and batch
    (their local shards), and whether they fit one H100's 80 GB
    (resident state only: activations are not counted);
  * the cell's counted matmul FLOPs and bytes per device (``flops``,
    ``hbm_bytes``) and the collectives by kind, count and ring-model
    wire bytes (``collective_bytes``, ``collective_count``,
    ``collectives``), the reference's keys;
  * the ops DTensor could not partition, which ran on replicated
    operands (``replicated_ops``, name -> count a step);
  * the roofline terms (``roofline.terms``), ``collective_s`` among
    them, and which link each mesh axis rides (``links``).

Every repeat of the layer unit after the first costs what the second
costs, so the cell is counted with one repeat and with two (and,
enc-dec, with two encoder layers), and the totals are ``one + (repeats
- 1) x (two - one)``, as the reference multiplies a loop body by its
trip count; ``pre`` layers, the first repeat and the head count as they
run.  (Not from no repeat: DTensor picks each op's sharding from its
operands', so the head of a model with no layer is another program
than the head after one, and the difference can come out negative.)

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --opt --workers 6
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --reduced   # CPU check
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence

import torch

from ..analysis import roofline
from ..configs import ARCHS, get_config, reduced
from ..configs.base import SHAPES, ModelConfig, ShapeSpec, shapes_for
from ..models import lm
from ..models.layers import tree_leaves
from ..models.perfopts import OPTIMIZED
from . import sharding as shd
from .mesh import Mesh, make_production_mesh, plan_group
from .steps import _enc_len, build_cell, placed_zeros

#: the shape cut ``--reduced`` makes
REDUCED_SEQ, REDUCED_BATCH = 64, 4


def _depth(cfg: ModelConfig, repeats: int, enc_layers: int) -> ModelConfig:
    """``cfg`` with ``repeats`` repeats of its unit (and ``enc_layers``
    encoder layers, enc-dec only)."""
    if cfg.enc_dec:
        return dataclasses.replace(cfg, n_layers=repeats * len(cfg.unit),
                                   n_enc_layers=enc_layers)
    return dataclasses.replace(cfg, n_layers=len(cfg.pre)
                               + repeats * len(cfg.unit))


def local_bytes(tree) -> int:
    """Bytes of this device's shards of a tree of DTensors."""
    return sum(t.to_local().numel() * t.element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def run_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
             optimized: bool = False) -> dict:
    """The dry-run record of one cell (status "fail" with the error where
    building or counting it raises).  A plan's cell runs inside
    ``plan_group``."""
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh.name,
           "n_chips": mesh.size, "status": "ok",
           "variant": "optimized" if optimized else "baseline",
           "global_batch": shape.global_batch, "seq_len": shape.seq_len}
    perf = OPTIMIZED if optimized else None
    t0 = time.time()
    try:
        with plan_group() if not mesh.devices else contextlib.nullcontext():
            _count_cell(rec, cfg, shape, mesh, perf)
    except Exception as e:  # a failing cell is a bug — record and surface
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def _count_cell(rec: dict, cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
                perf) -> None:
    dm = mesh.device_mesh()
    cell = build_cell(cfg, shape, mesh, perf=perf)
    names = {"train": ("params", "opt_state", "batch"),
             "prefill": ("params", "batch"),
             "decode": ("params", "cache", "batch")}[shape.kind]
    per_dev = {n: local_bytes(a) for n, a in
               zip(names, cell.materialize("meta", mesh=dm))}
    if shape.kind == "prefill":     # the cache is the prefill's result
        per_dev["cache"] = local_bytes(shd.tree_zip(
            lambda t, spec: placed_zeros(t, spec, mesh, dm, "meta"),
            lm.cache_specs(cfg, shape.global_batch, shape.seq_len,
                           _enc_len(cfg, shape)), cell.out_shardings[1]))
    per_dev["total"] = sum(per_dev.values())
    rec["bytes_per_device"] = per_dev
    rec["fits_80gb"] = per_dev["total"] <= roofline.HBM_BYTES
    rec["links"] = roofline.axis_links(dm)

    counts = {}
    for r, e in [(1, 1), (2, 1)] + ([(1, 2)] if cfg.enc_dec else []):
        c = build_cell(_depth(cfg, r, e), shape, mesh, perf=perf)
        counter = roofline.count_all(c.fn, *c.materialize("meta", mesh=dm))
        counts[r, e] = dict(
            flops=counter.flops, bytes=counter.bytes,
            collective_count=counter.collective_count,
            collective_s=counter.collective_s,
            **{f"coll:{k}": v for k, v in counter.collectives.items()},
            **{f"rep:{k}": v for k, v in c.replicated_ops.items()})

    def total(key):
        one = counts[1, 1].get(key, 0)
        out = one + (cfg.n_unit_repeats - 1) * (counts[2, 1].get(key, 0)
                                                - one)
        if cfg.enc_dec:
            out += (cfg.n_enc_layers - 1) * (counts[1, 2].get(key, 0) - one)
        return out
    keys = {k for c in counts.values() for k in c}
    coll = {k[5:]: total(k) for k in sorted(keys) if k.startswith("coll:")}
    rec.update(flops=total("flops"), hbm_bytes=total("bytes"),
               collective_bytes=sum(coll.values()),
               collective_count=total("collective_count"),
               collectives=coll, collective_s=total("collective_s"),
               replicated_ops={k[4:]: total(k) for k in sorted(keys)
                               if k.startswith("rep:")})
    rec.update(roofline.terms(rec, cfg, shape, mesh.size))


def summary(rec: dict) -> str:
    """One line of a record: resident bytes per device, counts, terms."""
    if rec["status"] != "ok":
        return f"FAIL: {rec['error']}"
    gib = {k: v / 2 ** 30 for k, v in rec["bytes_per_device"].items()}
    kinds = ", ".join(f"{k} {v / 1e9:.4g} GB"
                      for k, v in rec["collectives"].items()) or "none"
    return (f"ok in {rec['total_s']} s; per device: "
            + ", ".join(f"{k} {v:.3f}" for k, v in gib.items())
            + f" GiB (fits 80 GB: {rec['fits_80gb']}); flops "
            f"{rec['flops']:.4g}, bytes {rec['hbm_bytes']:.4g}; "
            f"{rec['collective_count']} collectives, "
            f"{rec['collective_bytes'] / 1e9:.4g} GB on the wire ({kinds}); "
            f"compute {rec['compute_s']:.4g} s, memory "
            f"{rec['memory_s']:.4g} s, collective {rec['collective_s']:.4g} "
            f"s; {rec['bottleneck']}-bound, useful flops "
            f"{rec['useful_flops_frac']:.3f}, roofline "
            f"{rec['roofline_frac']:.3f}; replicated ops "
            f"{rec['replicated_ops'] or 'none'}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true",
                    help="run every applicable (arch x shape) cell")
    ap.add_argument("--opt", action="store_true",
                    help="enable the optimized PerfOpts set")
    ap.add_argument("--reduced", action="store_true",
                    help=f"reduced() configs, shapes cut to B <= "
                    f"{REDUCED_BATCH} and S <= {REDUCED_SEQ}")
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    ap.add_argument("--workers", type=int, default=1,
                    help="cells run in this many child processes at once")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape.name) for arch, cfg in ARCHS.items()
                 for shape in shapes_for(cfg)]
    else:
        if not args.arch:
            ap.error("--arch required unless --all")
        shapes = ([SHAPES[args.shape]] if args.shape
                  else shapes_for(get_config(args.arch)))
        cells = [(args.arch, s.name) for s in shapes]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    records = json.loads(out_path.read_text()) if out_path.exists() else []
    key = ("arch", "shape", "mesh", "variant")
    done = {tuple(r[k] for k in key) for r in records
            if r.get("status") == "ok"}
    variant = "optimized" if args.opt else "baseline"
    jobs = []
    for arch, shape_name in cells:
        cfg, shape = get_config(arch), SHAPES[shape_name]
        if args.reduced:
            cfg = reduced(cfg)
            shape = dataclasses.replace(
                shape, seq_len=min(shape.seq_len, REDUCED_SEQ),
                global_batch=min(shape.global_batch, REDUCED_BATCH))
        for multi in meshes:
            mesh = make_production_mesh(multi_pod=multi)
            if (cfg.name, shape.name, mesh.name, variant) in done:
                print(f"[skip] {cfg.name} x {shape.name} on {mesh.name} "
                      "(cached)")
            else:
                jobs.append((cfg, shape, mesh, args.opt))

    n_fail = 0
    for rec in _records(jobs, args.workers):
        this = tuple(rec[k] for k in key)
        records = [r for r in records
                   if tuple(r[k] for k in key) != this] + [rec]
        out_path.write_text(json.dumps(records, indent=1))
        n_fail += rec["status"] != "ok"
        print(f"[dryrun] {rec['arch']} x {rec['shape']} on {rec['mesh']}: "
              f"{summary(rec)}", flush=True)
    print(f"\n{len(records)} records in {out_path}; {n_fail} failures")
    return 1 if n_fail else 0


def _run_job(job) -> dict:
    cfg, shape, mesh, opt = job
    return run_cell(cfg, shape, mesh, optimized=opt)


def _records(jobs, workers: int):
    """The records of ``jobs`` as they finish: in this process inside one
    fake group, or in ``workers`` child processes, each with its own."""
    if workers <= 1:
        with plan_group():
            for job in jobs:
                yield _run_job(job)
        return
    import concurrent.futures as cf
    import multiprocessing as mp
    with cf.ProcessPoolExecutor(workers,
                                mp_context=mp.get_context("spawn")) as ex:
        for fut in cf.as_completed([ex.submit(_run_job, j) for j in jobs]):
            yield fut.result()


if __name__ == "__main__":
    raise SystemExit(main())
