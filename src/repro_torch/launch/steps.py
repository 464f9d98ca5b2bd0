"""The training step: loss and gradients (accumulated over microbatches
in float32), global-norm clipping at 1.0, AdamW.

A port of the train cell of ``repro.launch.steps.build_cell``, as plain
functions: one card, no mesh, so the local batch is the global batch.
The step is split where the trainer needs it split: ``loss_and_grads``
leaves the state untouched, so a caller can look at the loss before
``apply_update`` changes the params and moments in place (the
reference's step is functional and its trainer drops a bad update
instead).  The prefill and decode cells are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..models import lm
from ..models.layers import tree_leaves, tree_unflatten
from ..optim import adamw

#: gradient-accumulation depth of the wider models (the reference's,
#: sized there for 16 GB of device memory per chip)
MICROBATCH_OVERRIDES = {
    "mixtral-8x7b": 16,
    "starcoder2-15b": 16,
    "deepseek-v2-lite-16b": 16,
    "minitron-4b": 16,
}

MAX_GRAD_NORM = 1.0


def default_microbatches(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Gradient-accumulation depth: the reference's choice with the whole
    global batch local to one card."""
    return min(MICROBATCH_OVERRIDES.get(cfg.name, 8),
               max(1, shape.global_batch))


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _split(batch: Dict[str, torch.Tensor], mb: int, i: int):
    """Microbatch ``i`` of ``mb``: rows i*B/mb .. (i+1)*B/mb of the batch
    dim (dim 1 of ``positions3``, dim 0 of the rest)."""
    out = {}
    for k, v in batch.items():
        dim = 1 if k == "positions3" else 0
        n = v.shape[dim] // mb
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
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

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
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
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
