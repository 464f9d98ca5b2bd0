"""Dry run: every (architecture x input shape) cell built on the ``meta``
device, with its per-device bytes, counted operations and roofline
terms.

A port of ``repro.launch.dryrun``, which lowers and compiles each cell
for the 16x16 and 2x16x16 TPU meshes.  Here a cell runs on "meta"
(shapes and dtypes, no data, no device) under the counting modes of
``analysis.roofline``.  Each record holds:

  * the per-device bytes of the params, optimizer state, cache and batch
    under the mesh's partition specs (``launch.sharding``), and whether
    they fit one H100's 80 GB (resident state only: activations are not
    counted);
  * the cell's counted matmul FLOPs and bytes, in all and per device
    (split evenly over the mesh);
  * the roofline terms (``roofline.terms``).

Counting one repeat of the layer unit costs what every repeat costs, so
the cell is counted with no repeat, with one, and (enc-dec) with one
encoder layer, and the totals are ``base + repeats x unit + layers x
encoder layer``, as the reference multiplies a loop body by its trip
count; ``pre`` layers and the head count as they run.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --opt
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --reduced   # CPU check
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence

from ..analysis import roofline
from ..configs import ARCHS, get_config, reduced
from ..configs.base import SHAPES, ModelConfig, ShapeSpec, shapes_for
from ..models import lm
from ..models.perfopts import OPTIMIZED
from . import sharding as shd
from .mesh import Mesh, make_production_mesh
from .steps import _enc_len, build_cell

#: the shape cut ``--reduced`` makes
REDUCED_SEQ, REDUCED_BATCH = 64, 4


def _depth(cfg: ModelConfig, repeats: int, enc_layers: int) -> ModelConfig:
    """``cfg`` with ``repeats`` repeats of its unit (and ``enc_layers``
    encoder layers)."""
    if cfg.enc_dec:
        return dataclasses.replace(cfg, n_layers=repeats * len(cfg.unit),
                                   n_enc_layers=enc_layers)
    return dataclasses.replace(cfg, n_layers=len(cfg.pre)
                               + repeats * len(cfg.unit))


def run_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
             optimized: bool = False) -> dict:
    """The dry-run record of one cell (status "fail" with the error where
    building or counting it raises)."""
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh.name,
           "n_chips": mesh.size, "status": "ok",
           "variant": "optimized" if optimized else "baseline",
           "global_batch": shape.global_batch, "seq_len": shape.seq_len}
    perf = OPTIMIZED if optimized else None
    t0 = time.time()
    try:
        cell = build_cell(cfg, shape, mesh, perf=perf)
        names = {"train": ("params", "opt_state", "batch"),
                 "prefill": ("params", "batch"),
                 "decode": ("params", "cache", "batch")}[shape.kind]
        per_dev = {n: shd.tree_shard_bytes(a, p, mesh) for n, a, p in
                   zip(names, cell.args, cell.in_shardings)}
        if shape.kind == "prefill":     # the cache is the prefill's result
            per_dev["cache"] = shd.tree_shard_bytes(
                lm.cache_specs(cfg, shape.global_batch, shape.seq_len,
                               _enc_len(cfg, shape)),
                cell.out_shardings[1], mesh)
        per_dev["total"] = sum(per_dev.values())
        rec["bytes_per_device"] = per_dev
        rec["fits_80gb"] = per_dev["total"] <= roofline.HBM_BYTES

        counts = {}
        for r, e in [(0, 0), (1, 0)] + ([(0, 1)] if cfg.enc_dec else []):
            c = build_cell(_depth(cfg, r, e), shape, mesh, perf=perf)
            counts[r, e] = roofline.count(c.fn, *c.materialize("meta"))
        base = counts[0, 0]
        total = [base[i] + cfg.n_unit_repeats * (counts[1, 0][i] - base[i])
                 + (cfg.n_enc_layers * (counts[0, 1][i] - base[i])
                    if cfg.enc_dec else 0) for i in range(2)]
        rec.update(global_flops=total[0], global_bytes=total[1],
                   flops=total[0] / mesh.size,
                   hbm_bytes=total[1] / mesh.size)
        rec.update(roofline.terms(rec, cfg, shape, mesh.size))
    except Exception as e:  # a failing cell is a bug — record and surface
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def summary(rec: dict) -> str:
    """One line of a record: resident bytes per device, counts, terms."""
    if rec["status"] != "ok":
        return f"FAIL: {rec['error']}"
    gib = {k: v / 2 ** 30 for k, v in rec["bytes_per_device"].items()}
    coll = rec["collective"] if rec["collective_s"] is None \
        else f"{rec['collective_s']:.3g} s"
    return (f"ok in {rec['total_s']} s; per device: "
            + ", ".join(f"{k} {v:.3f}" for k, v in gib.items())
            + f" GiB (fits 80 GB: {rec['fits_80gb']}); flops "
            f"{rec['flops']:.4g}, bytes {rec['hbm_bytes']:.4g}; compute "
            f"{rec['compute_s']:.4g} s, memory {rec['memory_s']:.4g} s, "
            f"collective {coll}; {rec['bottleneck']}-bound, useful flops "
            f"{rec['useful_flops_frac']:.3f}, roofline "
            f"{rec['roofline_frac']:.3f}")


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
    n_fail = 0
    for arch, shape_name in cells:
        cfg, shape = get_config(arch), SHAPES[shape_name]
        if args.reduced:
            cfg = reduced(cfg)
            shape = dataclasses.replace(
                shape, seq_len=min(shape.seq_len, REDUCED_SEQ),
                global_batch=min(shape.global_batch, REDUCED_BATCH))
        for multi in meshes:
            mesh = make_production_mesh(multi_pod=multi)
            this = (cfg.name, shape.name, mesh.name,
                    "optimized" if args.opt else "baseline")
            if this in done:
                print(f"[skip] {cfg.name} x {shape.name} on {mesh.name} "
                      "(cached)")
                continue
            print(f"[dryrun] {cfg.name} x {shape.name} on {mesh.name} ...",
                  flush=True)
            rec = run_cell(cfg, shape, mesh, optimized=args.opt)
            records = [r for r in records
                       if tuple(r[k] for k in key) != this] + [rec]
            out_path.write_text(json.dumps(records, indent=1))
            n_fail += rec["status"] != "ok"
            print(f"  {summary(rec)}", flush=True)
    print(f"\n{len(records)} records in {out_path}; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
