"""Step builders: the training step, and a cell — (fn, argument specs,
partition specs) — for every (architecture x workload-shape) pair,
consumed by the dry run, the trainer and ``chip_smoke.py``.

A port of ``repro.launch.steps``.  Cells:
  train_*   -> ``train_step`` (loss + grads + AdamW update, remat'd)
  prefill_* -> ``lm.prefill`` (prompt -> last logits + decode cache)
  decode_* / long_* -> ``lm.decode_step`` (one new token against the
               cache)

A cell runs on plain tensors on one device (the card, the CPU, or
"meta"), or as a DTensor program on its mesh's ``DeviceMesh``
(``Cell.materialize(..., mesh=...)``): its leaves placed by their
partition specs, its sharding constraints redistributions, the ops
DTensor cannot partition run on replicated operands
(``models.layers.ReplicateUnpropagated``) and named in
``Cell.replicated_ops``.
The training step is split where the trainer needs it split:
``loss_and_grads`` leaves the state untouched, so a caller can look at
the loss before ``apply_update`` changes the params and moments in
place (the reference's step is functional and its trainer drops a bad
update instead).  A train cell carries the two halves as it runs them
(``Cell.loss_and_grads``, ``Cell.apply_update``), and its ``fn`` is
the one then the other, so the mesh trainer's step is the cell's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..models import lm
from ..models.layers import (ReplicateUnpropagated, TensorSpec,
                             init_from_specs, tree_leaves,
                             tree_map, tree_unflatten)
from ..models.perfopts import PerfOpts, use_perf_opts
from ..optim import adamw
from . import sharding as shd
from .mesh import Mesh

ENC_LEN_CAP = 4096        # encoder context for enc-dec decode shapes

#: gradient-accumulation depth of the wider models (the reference's,
#: sized there for 16 GB of device memory per chip)
MICROBATCH_OVERRIDES = {
    "mixtral-8x7b": 16,
    "starcoder2-15b": 16,
    "deepseek-v2-lite-16b": 16,
    "minitron-4b": 16,
}

MAX_GRAD_NORM = 1.0


def default_microbatches(cfg: ModelConfig, shape: ShapeSpec,
                         mesh: Optional[Mesh] = None) -> int:
    """Gradient-accumulation depth: the reference's choice for the
    per-device batch of ``mesh`` (default: the whole global batch on one
    card)."""
    div = _batch_div(mesh) if mesh is not None else 1
    return min(MICROBATCH_OVERRIDES.get(cfg.name, 8),
               max(1, shape.global_batch // div))


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _split(batch: Dict[str, torch.Tensor], mb: int, i: int):
    """Microbatch ``i`` of ``mb``: rows i*B/mb .. (i+1)*B/mb of the batch
    dim (dim 1 of ``positions3``, dim 0 of the rest).

    A DTensor batch split over devices along that dim gives each device
    the i-th block of its own rows instead, as data-parallel gradient
    accumulation does, so a microbatch needs no collective; on one
    device the two are the same rows."""
    from torch.distributed.tensor import DTensor, Shard
    out = {}
    for k, v in batch.items():
        dim = 1 if k == "positions3" else 0
        n = v.shape[dim] // mb
        if isinstance(v, DTensor) and Shard(dim) in v.placements \
                and v.to_local().shape[dim] % mb == 0:
            local = v.to_local()
            nl = local.shape[dim] // mb
            shape = list(v.shape)
            shape[dim] = n
            out[k] = DTensor.from_local(
                local.narrow(dim, i * nl, nl), v.device_mesh, v.placements,
                run_check=False, shape=torch.Size(shape),
                stride=torch.empty(shape, device="meta").stride())
        else:
            out[k] = v.narrow(dim, i * n, n)
    return out


def loss_and_grads(params: Any, cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor], microbatches: int = 1
                   ) -> Tuple[torch.Tensor, Any]:
    """Mean loss and its gradients (a tree like ``params``).

    Turns gradients on for the parameter leaves, which must all be
    floating (``jax.grad`` refuses others too).  With ``microbatches`` >
    1 the batch is split along its batch dim, each microbatch's
    gradients are added up in float32, and loss and gradients are
    divided by the count, as the reference's scan does; the gradients
    are then float32 whatever the params' dtype."""
    leaves = tree_leaves(params)
    for p in leaves:
        if not p.is_floating_point():
            raise TypeError(f"a {p.dtype} parameter leaf cannot take a "
                            "gradient")
        p.requires_grad_(True)

    def micro(b):
        loss = lm.lm_loss(params, cfg, b)
        # a leaf the loss does not reach gets zeros, as from jax.grad
        return loss.detach(), list(torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True))

    mb = microbatches
    bsz = batch["tokens"].shape[0]
    if bsz % mb:
        raise ValueError(f"batch {bsz} does not split into {mb} "
                         "microbatches")
    if mb == 1:
        loss, grads = micro(batch)
    else:
        loss = torch.zeros((), dtype=torch.float32,
                           device=leaves[0].device)
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        for i in range(mb):
            li, gi = micro(_split(batch, mb, i))
            loss = loss + li
            for a, g in zip(grads, gi):
                a.add_(g.float())
            del gi
        loss = loss / mb
        for a in grads:
            a.div_(mb)
    return loss, tree_unflatten(params, grads)


def apply_update(params: Any, opt_state: adamw.AdamWState, grads: Any,
                 lr: float) -> Tuple[adamw.AdamWState, torch.Tensor]:
    """Clip ``grads`` at a global norm of 1.0 and take one AdamW step,
    in place; returns (the new state, the norm before clipping)."""
    grads, gnorm = adamw.clip_by_global_norm(grads, MAX_GRAD_NORM)
    _, opt_state = adamw.adamw_update(grads, opt_state, params, lr=lr)
    return opt_state, gnorm


def train_step(params: Any, opt_state: adamw.AdamWState,
               batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
               lr: float = 3e-4, microbatches: Optional[int] = None,
               shape: Optional[ShapeSpec] = None
               ) -> Tuple[Any, adamw.AdamWState, Dict[str, torch.Tensor]]:
    """One step: (params, new state, {"loss", "grad_norm"}); the params
    and moments change in place.  ``microbatches`` defaults to
    ``default_microbatches(cfg, shape)`` (``shape`` is then required)."""
    mb = microbatches or default_microbatches(cfg, shape)
    loss, grads = loss_and_grads(params, cfg, batch, mb)
    opt_state, gnorm = apply_update(params, opt_state, grads, lr)
    return params, opt_state, {"loss": loss, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def _enc_len(cfg: ModelConfig, shape: ShapeSpec) -> int:
    if shape.kind == "train":
        return shape.seq_len
    return min(shape.seq_len, ENC_LEN_CAP)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, TensorSpec]:
    """``TensorSpec`` stand-ins for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        specs = {"tokens": TensorSpec((b, 1), i32)}
        if cfg.mrope:
            specs["positions3"] = TensorSpec((3, b, 1), i32)
        return specs
    specs = {"tokens": TensorSpec((b, s), i32)}
    if shape.kind == "train":
        specs["labels"] = TensorSpec((b, s), i32)
    if cfg.vision_stub:
        specs["vision_embeds"] = TensorSpec(
            (b, cfg.n_vision_tokens, cfg.d_model), cfg.dtype)
        specs["positions3"] = TensorSpec((3, b, s), i32)
    if cfg.enc_dec:
        specs["enc_embeds"] = TensorSpec((b, _enc_len(cfg, shape),
                                          cfg.d_model), cfg.dtype)
    return specs


def _batch_div(mesh: Mesh) -> int:
    d = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        d *= mesh.shape["pod"]
    return d


def batch_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
                    specs: Dict[str, TensorSpec]) -> Dict[str, tuple]:
    out = {}
    for k, v in specs.items():
        bdim = 1 if k == "positions3" else 0
        out[k] = shd.batch_sharding(mesh, len(v.shape), bdim)
        if v.shape[bdim] % _batch_div(mesh) != 0:
            out[k] = shd.replicated(mesh)
    return out


#: the mesh of a cell built without one: one device
ONE_DEVICE = Mesh(("data", "model"), (1, 1))


@dataclasses.dataclass
class Cell:
    """One (architecture x shape) step: ``fn(*args)`` where ``args`` are
    ``TensorSpec`` trees (the decode cell's last argument is the
    position it decodes at, an int), with the partition specs of its
    arguments and results on ``mesh``."""
    name: str
    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    mesh: Mesh
    #: the ops run replicated on a ``DeviceMesh`` (``ReplicateUnpropagated``),
    #: by name, with how often, over every call of ``fn``
    replicated_ops: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: a train cell's halves, as ``fn`` runs them: ``(params, batch) ->
    #: (loss, grads)`` and ``(params, opt_state, grads) -> (opt_state,
    #: grad_norm)``; None for the other cells
    loss_and_grads: Optional[Callable] = None
    apply_update: Optional[Callable] = None

    def materialize(self, device, generator: Optional[torch.Generator] = None,
                    mesh=None) -> Tuple[Any, ...]:
        """``args`` as tensors on ``device``: uninitialised on "meta",
        else drawn as ``lm.init_params`` draws parameters (scaled-normal
        floats, zero integers) from ``generator``, on that device.

        With ``mesh`` (the ``DeviceMesh`` of ``self.mesh``) every leaf is
        a DTensor placed by its partition spec: on "meta" only this
        device's shard is made; drawn leaves are drawn whole, in the
        same order, and distributed."""
        def make(tree, specs):
            if isinstance(tree, int):
                return tree
            meta = torch.device(device).type == "meta"
            if meta and mesh is not None:
                return shd.tree_zip(lambda t, spec: placed_zeros(
                    t, spec, self.mesh, mesh, "meta"), tree, specs)
            if meta:
                return tree_map(lambda t: torch.empty(
                    t.shape, dtype=t.dtype, device="meta"), tree)
            with torch.no_grad():
                full = init_from_specs(tree, generator, device)
            if mesh is None:
                return full
            return shd.distribute(full, specs, self.mesh, mesh)
        return tuple(make(a, s) for a, s in zip(self.args, self.in_shardings))


def placed_zeros(leaf: TensorSpec, spec, plan: Mesh, dmesh, device):
    """A zero DTensor of ``leaf``'s shape placed by ``spec``: only this
    device's shard is made, on ``device``."""
    from torch.distributed.tensor import DTensor
    local = torch.zeros(shd.local_shape(tuple(leaf.shape), spec, plan),
                        dtype=leaf.dtype, device=device)
    full = torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
    return DTensor.from_local(local, dmesh, shd.placements(spec, plan),
                              run_check=False, shape=full.shape,
                              stride=full.stride())


def _device_mesh(tree):
    """The ``DeviceMesh`` of a tree of DTensors; None for plain tensors."""
    from torch.distributed.tensor import DTensor
    leaf = tree_leaves(tree)[0]
    return leaf.device_mesh if isinstance(leaf, DTensor) else None


def _spmd(fn: Callable, replicated_ops: Dict[str, int]) -> Callable:
    """``fn``, which on DTensor arguments runs under
    ``ReplicateUnpropagated`` and adds the ops it replicated to
    ``replicated_ops``; on plain tensors it runs as it is."""
    def run(*args):
        if _device_mesh(args[0]) is None:
            return fn(*args)
        with ReplicateUnpropagated() as rep:
            try:
                return fn(*args)
            finally:
                for k, v in rep.ops.items():
                    replicated_ops[k] = replicated_ops.get(k, 0) + v
    return run


def _cell(name, fn, *rest) -> Cell:
    """A ``Cell`` whose ``fn`` also runs on DTensors (``_spmd``)."""
    ops: Dict[str, int] = {}
    return Cell(name, _spmd(fn, ops), *rest, replicated_ops=ops)


def build_cell(cfg: ModelConfig, shape: ShapeSpec,
               mesh: Optional[Mesh] = None,
               perf: Optional[PerfOpts] = None, lr: float = 3e-4,
               microbatches: Optional[int] = None) -> Cell:
    """The cell of ``cfg`` at ``shape``; its ``fn`` runs under ``perf``
    (default ``PerfOpts()``) with the mesh and batch axes set, as the
    reference's cells run."""
    mesh = mesh or ONE_DEVICE
    perf = dataclasses.replace(
        perf or PerfOpts(), mesh=mesh,
        batch_axes=("pod", "data") if "pod" in mesh.axis_names
        else ("data",))
    name = f"{cfg.name}:{shape.name}"
    p_specs, p_axes = lm.param_specs(cfg), lm.logical_axes(cfg)
    kind = "train" if shape.kind == "train" else "serve"
    p_rules = shd.param_rules(cfg, mesh, kind)
    p_shard = shd.tree_shardings(p_specs, p_axes, mesh, p_rules)
    b_specs = batch_specs(cfg, shape)
    b_shard = batch_shardings(cfg, shape, mesh, b_specs)

    if shape.kind == "train":
        o_specs = adamw.adamw_state_specs(p_specs)
        o_shard = adamw.AdamWState(
            count=shd.replicated(mesh),
            mu=shd.tree_shardings(o_specs.mu, p_axes, mesh, p_rules),
            nu=shd.tree_shardings(o_specs.nu, p_axes, mesh, p_rules))
        mb = microbatches or default_microbatches(cfg, shape, mesh)

        def grads_half(params, batch):
            with use_perf_opts(perf):
                return loss_and_grads(params, cfg, batch, mb)

        def update_half(params, opt_state, grads):
            with use_perf_opts(perf):
                return apply_update(params, opt_state, grads, lr)
        ops: Dict[str, int] = {}
        grads_fn, update_fn = _spmd(grads_half, ops), _spmd(update_half, ops)

        def train_cell(params, opt_state, batch):   # ``train_step``, halved
            loss, grads = grads_fn(params, batch)
            opt_state, gnorm = update_fn(params, opt_state, grads)
            return params, opt_state, {"loss": loss, "grad_norm": gnorm}
        return Cell(name, train_cell, (p_specs, o_specs, b_specs),
                    (p_shard, o_shard, b_shard),
                    (p_shard, o_shard, {"loss": shd.replicated(mesh),
                                        "grad_norm": shd.replicated(mesh)}),
                    mesh, replicated_ops=ops, loss_and_grads=grads_fn,
                    apply_update=update_fn)

    b, s = shape.global_batch, shape.seq_len
    c_rules = shd.cache_rules(cfg, mesh, kind)
    c_specs = lm.cache_specs(cfg, b, s, enc_len=_enc_len(cfg, shape))
    c_axes = lm.cache_axes(cfg, b, s, enc_len=_enc_len(cfg, shape))
    c_shard = shd.tree_shardings(c_specs, c_axes, mesh, c_rules)
    logits_shard = shd.batch_sharding(mesh, 3)
    if b % _batch_div(mesh) != 0:
        logits_shard = shd.replicated(mesh)

    if shape.kind == "prefill":
        def prefill_cell(params, batch):
            dm = _device_mesh(params)

            def placed(specs):      # the cache, placed by its specs
                dev = tree_leaves(params)[0].to_local().device
                return shd.tree_zip(lambda t, sp: placed_zeros(
                    t, sp, mesh, dm, dev), specs, c_shard)
            with use_perf_opts(perf):
                return lm.prefill(params, cfg, batch,
                                  alloc=placed if dm is not None else None)
        return _cell(name, prefill_cell, (p_specs, b_specs),
                     (p_shard, b_shard), (logits_shard, c_shard), mesh)

    def decode_cell(params, cache, batch, pos):
        with use_perf_opts(perf):
            return lm.decode_step(params, cfg, cache, batch, pos)
    # the last slot: the step attends over the whole cache
    return _cell(name, decode_cell, (p_specs, c_specs, b_specs, s - 1),
                 (p_shard, c_shard, b_shard, shd.replicated(mesh)),
                 (logits_shard, c_shard), mesh)
