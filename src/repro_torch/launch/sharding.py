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

``placements`` turns a partition spec into the DTensor placements of a
tensor on the mesh's ``DeviceMesh`` (``Mesh.device_mesh``), and
``distribute`` places a tree of tensors by a tree of specs.
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


def tree_zip(fn, specs_tree: Any, shardings_tree: Any) -> Any:
    """``fn(leaf, spec)`` over a tree whose leaves are not tuples (a
    ``TensorSpec`` or tensor tree) and its matching tree of partition
    specs, keeping the first tree's structure."""
    if isinstance(specs_tree, dict):
        return {k: tree_zip(fn, v, shardings_tree[k])
                for k, v in specs_tree.items()}
    if isinstance(specs_tree, (tuple, list)):
        out = [tree_zip(fn, s, p) for s, p in zip(specs_tree, shardings_tree)]
        if hasattr(specs_tree, "_fields"):      # a NamedTuple
            return type(specs_tree)(*out)
        return type(specs_tree)(out)
    return fn(specs_tree, shardings_tree)


def batch_sharding(mesh: Mesh, ndim: int, batch_dim: int = 0) -> Spec:
    parts = [None] * ndim
    ax = _batch_axes(mesh)
    parts[batch_dim] = ax if len(ax) > 1 else ax[0]
    return tuple(parts)


def replicated(mesh: Mesh) -> Spec:
    return ()


def placements(spec: Spec, mesh: Mesh) -> tuple:
    """The DTensor placements, one per mesh axis, of a tensor under the
    partition spec ``spec``: ``Shard(d)`` on every mesh axis that entry
    ``d`` names, ``Replicate()`` on the rest.  A dim over an axis tuple
    such as ``("pod", "data")`` is split by its axes major to minor, as
    JAX splits it, which is DTensor's order when the tuple follows the
    mesh's axis order (the only order ``spec_for`` makes)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.axis_names)
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [mesh.axis_names.index(a) for a in axes if a is not None]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of dim {d} are not in "
                             f"the mesh's order {mesh.axis_names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis "
                                 f"{mesh.axis_names[i]!r} used twice")
            out[i] = Shard(d)
    return tuple(out)


def distribute(tree: Any, specs: Any, mesh: Mesh, device_mesh) -> Any:
    """A tree of tensors, whole and alike on every rank, as DTensors
    placed by a matching tree of partition specs on ``device_mesh`` (the
    ``DeviceMesh`` of ``mesh``): each rank keeps its own slices of its
    copy, so no data moves."""
    from torch.distributed.tensor import distribute_tensor
    return tree_zip(lambda t, spec: distribute_tensor(
        t, device_mesh, placements(spec, mesh), src_data_rank=None),
        tree, specs)


def local_shape(shape: Tuple[int, ...], spec: Spec,
                mesh: Mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` tensor under
    ``spec``; raises where an assignment does not divide (``spec_for``
    drops those)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for ax in entry if isinstance(entry, tuple) else (entry,):
            if ax is None:
                continue
            if out[d] % mesh.shape[ax]:
                raise ValueError(f"dim {d} of {shape} does not split "
                                 f"over {ax!r} ({mesh.shape[ax]})")
            out[d] //= mesh.shape[ax]
    return tuple(out)


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
