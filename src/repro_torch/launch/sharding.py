"""Logical-axis sharding rules (MaxText-style), with divisibility
fallback so odd dimensions (vocab 50280, 25 SSM heads, batch 1) degrade
to replication instead of erroring.

A port of ``repro.launch.sharding`` over ``launch.mesh.Mesh``.  A
partition spec is a plain tuple with an entry per leading dim of its
tensor (a mesh axis name, a tuple of them, or None): the reference's
``PartitionSpec`` as a tuple.

Train:   FSDP x TP — reduction dims shard on "data", model dims on
         "model"; batch on ("pod","data"); optimizer state follows
         params (ZeRO-3-like memory).
Serve:   params shard on "model" only; batch on ("pod","data");
         KV-cache sequence on "model".
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

from ..configs.base import ModelConfig
from ..models.layers import TensorSpec
from .mesh import Mesh

Rules = Dict[Optional[str], Optional[Tuple[str, ...]]]
Spec = Tuple[Any, ...]


def _batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def param_rules(cfg: ModelConfig, mesh: Mesh, kind: str) -> Rules:
    """logical axis name -> mesh axes (or None = replicate)."""
    model_size = mesh.shape["model"]
    # experts: expert-parallel when the expert count fills the axis,
    # otherwise tensor-parallel inside each expert
    if cfg.n_experts and cfg.n_experts % model_size == 0:
        expert, mlp_e = ("model",), None
    else:
        expert, mlp_e = None, ("model",)
    return {
        "vocab": ("model",),
        "embed": ("data",) if kind == "train" else None,
        "heads": ("model",),
        "kv": ("model",),
        "mlp": ("model",),
        "inner": ("model",),
        "expert": expert,
        "mlp_e": mlp_e,
        "layers": None,
        None: None,
    }


def cache_rules(cfg: ModelConfig, mesh: Mesh, kind: str) -> Rules:
    return {
        "batch": _batch_axes(mesh),
        "kvseq": ("model",),
        "ssm_heads": ("model",),
        "layers": None,
        None: None,
    }


def spec_for(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
             mesh: Mesh, rules: Rules) -> Spec:
    """A partition spec, dropping assignments that don't divide."""
    assert len(shape) == len(axes), (shape, axes)
    used = set()
    parts = []
    for dim, ax in zip(shape, axes):
        mesh_axes = rules.get(ax)
        if not mesh_axes:
            parts.append(None)
            continue
        mesh_axes = tuple(a for a in mesh_axes if a not in used)
        total = math.prod(mesh.shape[a] for a in mesh_axes) if mesh_axes else 1
        if not mesh_axes or dim % total != 0:
            parts.append(None)
            continue
        used.update(mesh_axes)
        parts.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def tree_shardings(specs_tree: Any, axes_tree: Any, mesh: Mesh,
                   rules: Rules) -> Any:
    """A partition-spec tree matching a ``TensorSpec`` tree; ``axes_tree``
    has the same structure with a tuple of logical axes per leaf."""
    if isinstance(specs_tree, TensorSpec):
        return spec_for(tuple(specs_tree.shape), tuple(axes_tree), mesh,
                        rules)
    if isinstance(specs_tree, dict):
        return {k: tree_shardings(v, axes_tree[k], mesh, rules)
                for k, v in specs_tree.items()}
    out = [tree_shardings(s, a, mesh, rules)
           for s, a in zip(specs_tree, axes_tree)]
    if hasattr(specs_tree, "_fields"):          # a NamedTuple
        return type(specs_tree)(*out)
    return type(specs_tree)(out)


def batch_sharding(mesh: Mesh, ndim: int, batch_dim: int = 0) -> Spec:
    parts = [None] * ndim
    ax = _batch_axes(mesh)
    parts[batch_dim] = ax if len(ax) > 1 else ax[0]
    return tuple(parts)


def replicated(mesh: Mesh) -> Spec:
    return ()


def tree_shard_bytes(specs_tree: Any, shardings_tree: Any, mesh: Mesh) -> int:
    """Bytes one device holds of a ``TensorSpec`` tree under a matching
    tree of partition specs."""
    if isinstance(specs_tree, TensorSpec):
        div = math.prod(mesh.shape[ax] for entry in shardings_tree
                        for ax in (entry if isinstance(entry, tuple)
                                   else (entry,)) if ax is not None)
        return math.prod(specs_tree.shape) * specs_tree.dtype.itemsize // div
    if isinstance(specs_tree, dict):
        return sum(tree_shard_bytes(v, shardings_tree[k], mesh)
                   for k, v in specs_tree.items())
    return sum(tree_shard_bytes(s, p, mesh)
               for s, p in zip(specs_tree, shardings_tree))
