"""Checkpoints with atomic writes, in the reference's layout.

Layout (one directory per step), as ``repro.checkpoint`` writes it:

    <dir>/step_00000042.tmp-*/     # staged, then atomically renamed to:
    <dir>/step_00000042/
        manifest.json              # step, leaf shapes and dtypes, extra
        arrays_p0.npz              # leaf_00000, leaf_00001, ... (one process)

Leaves are flattened in the reference's order (``tree_leaves``: sorted
dict keys, tuples in order, ``AdamWState`` as count, mu, nu), so either
package restores what the other wrote.  A bfloat16 leaf is stored as its
raw 2-byte words (npz dtype ``|V2``, manifest dtype ``"bfloat16"``),
which is what numpy makes of an ml_dtypes array: the reference reads it
back as bfloat16, and this package reads it through a ``uint16`` view
(it imports no ml_dtypes).  A crashed writer leaves only a ``.tmp-``
directory, which nothing restores.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.layers import tree_leaves, tree_unflatten

_BF16 = "bfloat16"


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array npz stores, the manifest's dtype) of one leaf."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, want: Optional[str]) -> torch.Tensor:
    if want == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    if want and str(arr.dtype) != want:
        arr = arr.astype(np.dtype(want))
    return torch.from_numpy(arr)


def save_checkpoint(directory, step: int, tree: Any,
                    extra: Optional[Dict] = None) -> str:
    """Atomically write a checkpoint of ``tree``'s tensor leaves (from any
    device); returns the final path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    staging = Path(tempfile.mkdtemp(prefix=final.name + ".tmp-",
                                    dir=directory))
    try:
        flat, dtypes = {}, {}
        for i, leaf in enumerate(tree_leaves(tree)):
            key = f"leaf_{i:05d}"
            flat[key], dtypes[key] = _to_numpy(leaf)
        np.savez(staging / "arrays_p0.npz", **flat)
        manifest = {
            "step": int(step),
            "time": time.time(),
            "n_leaves": len(flat),
            "process_count": 1,
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": dtypes,
            "extra": extra or {},
        }
        (staging / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(staging, final)
        return str(final)
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise


def _steps(directory: Path):
    """Published step directories, oldest first."""
    return sorted(p for p in directory.iterdir()
                  if p.is_dir() and p.name.startswith("step_")
                  and ".tmp-" not in p.name)


def latest_checkpoint(directory) -> Optional[str]:
    d = Path(directory)
    if not d.exists():
        return None
    steps = [p for p in _steps(d) if (p / "manifest.json").exists()]
    return str(steps[-1]) if steps else None


def restore_checkpoint(path, like: Any) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (a matching tree of tensors
    or ``TensorSpec``s) as CPU tensors; returns (tree, extra)."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    dtypes = manifest.get("dtypes", {})
    flat: Dict[str, torch.Tensor] = {}
    for f in sorted(path.glob("arrays_p*.npz")):
        with np.load(f) as z:
            for k in z.files:
                flat[k] = _from_numpy(z[k], dtypes.get(k))
    specs = tree_leaves(like)
    if len(specs) != manifest["n_leaves"]:
        raise ValueError(f"{path}: {manifest['n_leaves']} leaves, the tree "
                         f"has {len(specs)}")
    vals = [flat[f"leaf_{i:05d}"] for i in range(len(specs))]
    for i, (v, s) in enumerate(zip(vals, specs)):
        if tuple(v.shape) != tuple(s.shape):
            raise ValueError(f"{path}: leaf {i} has shape {tuple(v.shape)}, "
                             f"the tree {tuple(s.shape)}")
    return tree_unflatten(like, vals), manifest["extra"]


def restore_on_device(path, like: Any, device) -> Tuple[Any, Dict]:
    """``restore_checkpoint`` with every leaf placed on ``device``: the
    counterpart of the reference's ``restore_resharded``, for one card.
    The checkpoint holds logical arrays, so it may come from any run."""
    tree, extra = restore_checkpoint(path, like)
    leaves = [t.to(device) for t in tree_leaves(tree)]
    return tree_unflatten(like, leaves), extra


class CheckpointManager:
    """Save every N steps with retention; ``latest()`` resumes."""

    def __init__(self, directory, save_every: int = 100, keep: int = 3):
        self.directory = Path(directory)
        self.save_every = save_every
        self.keep = keep

    def maybe_save(self, step: int, tree: Any,
                   extra: Optional[Dict] = None) -> Optional[str]:
        if step % self.save_every:
            return None
        path = save_checkpoint(self.directory, step, tree, extra)
        for p in _steps(self.directory)[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)
        return path

    def latest(self) -> Optional[str]:
        return latest_checkpoint(self.directory)
