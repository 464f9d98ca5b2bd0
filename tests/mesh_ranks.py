"""One rank of a multi-rank case of ``test_torch_mesh_*.py``, run by
``python -m torch.distributed.run --standalone --nproc-per-node N``;
each rank is a gloo rank on the CPU.

  cells OUT        the reduced qwen1.5-4b and mixtral-8x7b prefill,
                   decode and train cells as DTensor programs on a
                   ("data", "model") = (N/2, 2) host mesh, default and
                   ``OPTIMIZED``, each beside the plain cell on the same
                   draw; rank 0 writes each case's largest error relative
                   to the largest value, whether the integer leaves are
                   equal and the ops run replicated, to OUT (JSON)
  train OUT ARGS   the training launcher's trainer (``launch.train``'s
                   ``build`` on ARGS) of the config ARGS name in float32,
                   logging every step, for its steps; every rank writes
                   the ``full_tensor()`` of each leaf of its final params
                   and moments to OUT.rank<r>.npz
"""
import dataclasses
import json
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import mesh as tmesh, steps, train
from repro_torch.models.layers import tree_leaves
from repro_torch.models.perfopts import OPTIMIZED

CELL_ARCHS = ("qwen1.5-4b", "mixtral-8x7b")
CELL_SHAPES = (ShapeSpec("p", "prefill", 64, 2),
               ShapeSpec("d", "decode", 32, 2),
               ShapeSpec("t", "train", 32, 2))
PERFS = {"default": None, "optimized": OPTIMIZED}
#: torch's DTensor before 2.13 has no sharding rule for ``index_put``,
#: which a train step runs (seen under 2.11; 2.12 untried), so it runs
#: replicated there; 2.13 has one.  No other op may run replicated.
OLD_DTENSOR = tuple(int(x) for x in
                    torch.__version__.split("+")[0].split(".")[:2]) < (2, 13)


def replicated_allowed(kind: str) -> set:
    """The ops a ``kind`` cell may run replicated under this torch."""
    return {"index_put"} if kind == "train" and OLD_DTENSOR else set()


def train_config(args):
    """The config the launcher's ``args`` name, in float32 (so that
    tolerances of 1e-5 mean something: bf16 partial sums rounded per rank
    differ by ~1e-3)."""
    cfg = ARCHS[args.arch]
    return dataclasses.replace(reduced(cfg) if args.reduced else cfg,
                               dtype=torch.float32)


def _full(tree):
    return [t.full_tensor() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree)]


def cells(out: str) -> None:
    m = tmesh.make_host_mesh(model=2, device="cpu")
    dm = m.device_mesh()
    res = {}
    for name in CELL_ARCHS:
        cfg = dataclasses.replace(reduced(ARCHS[name]), dtype=torch.float32)
        for perf_name, perf in PERFS.items():
            for shape in CELL_SHAPES:
                cell = steps.build_cell(cfg, shape, m, perf=perf)
                plain = cell.materialize(
                    "cpu", torch.Generator().manual_seed(3))
                spmd = cell.materialize(
                    "cpu", torch.Generator().manual_seed(3), mesh=dm)
                if shape.kind == "train":   # drawn second moments: >= 0
                    for args in (plain, spmd):
                        for v in tree_leaves(args[1].nu):
                            v.abs_()
                want = _full(cell.fn(*plain))
                got = _full(cell.fn(*spmd))
                if shape.kind == "train":   # and the updated state
                    want += _full(plain[:2])
                    got += _full(spmd[:2])
                err, ints, finite = 0.0, True, True
                for w, g in zip(want, got):
                    if not w.is_floating_point():
                        ints &= torch.equal(w, g)
                        continue
                    finite &= bool(torch.isfinite(w).all())
                    top = float(w.detach().abs().max())
                    if top:
                        err = max(err, float(
                            (w - g).detach().abs().max()) / top)
                res[f"{name}:{perf_name}:{shape.kind}"] = {
                    "err": err, "ints_equal": ints, "finite": finite,
                    "replicated_ops": dict(cell.replicated_ops)}
    if dm.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def train_run(out: str, argv) -> None:
    args = train.parse_args(argv)
    trainer, _ = train.build(args, train_config(args))
    trainer.tcfg.log_every = 1
    trainer.train(seed=args.seed)
    leaves = _full((trainer.params, trainer.opt_state))
    np.savez(f"{out}.rank{dist.get_rank()}.npz",
             **{f"leaf_{i:05d}": t.detach().float().numpy()
                for i, t in enumerate(leaves)})
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "cells":
        cells(sys.argv[2])
    else:
        train_run(sys.argv[2], sys.argv[3:])
