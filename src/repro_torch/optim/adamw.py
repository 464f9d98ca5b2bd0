"""AdamW on torch tensors: state trees mirror the params, plus
global-norm clipping and int8 gradient compression with error feedback.

A port of ``repro.optim.adamw``, with its arithmetic: float32 moments
whatever the params' dtype, bias corrections in float32 from an int32
step count, weight decay added to the Adam step before the learning
rate scales it, and each update computed in float32 and cast back to
the leaf's dtype.  (``torch.optim.AdamW`` keeps bf16 moments for bf16
params and decays the weights before the Adam step, so it is not this.)

The reference is functional; here the clipped gradients, the moments
and the params are updated in place, so a step at full width needs no
second copy of any of them.  The step count is a new tensor.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..models.layers import TensorSpec, tree_leaves, tree_map

F32 = torch.float32


class AdamWState(NamedTuple):
    count: torch.Tensor          # int32, 0-d
    mu: Any
    nu: Any


def adamw_init(params: Any) -> AdamWState:
    """Zero float32 moments beside each leaf, on its device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(count=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def adamw_state_specs(param_specs: Any) -> AdamWState:
    """The state's ``TensorSpec`` tree for a ``TensorSpec`` param tree."""
    def f32(p):
        return TensorSpec(tuple(p.shape), F32)
    return AdamWState(count=TensorSpec((), torch.int32),
                      mu=tree_map(f32, param_specs),
                      nu=tree_map(f32, param_specs))


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """Scale ``grads`` in place so their global norm (float32) is at most
    ``max_norm``; each leaf is scaled in float32 and cast back to its
    dtype.  Returns (grads, the norm before clipping)."""
    leaves = tree_leaves(grads)
    sq = sum(torch.sum(torch.square(g.float())) for g in leaves)
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    for g in leaves:
        g.copy_(g.float() * scale)
    return grads, norm


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any, *,
                 lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1
                 ) -> Tuple[Any, AdamWState]:
    """One AdamW step: ``params`` and the moments are updated in place;
    returns (params, the state with the count advanced)."""
    count = state.count + 1
    c = count.float()
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(params)):
        gf = g.float()
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * torch.square(gf))
        del gf
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        pf = p.float()
        step = step + weight_decay * pf
        p.copy_(pf - lr * step)
    return params, AdamWState(count=count, mu=state.mu, nu=state.nu)


# ---------------------------------------------------------------------------
# Gradient compression (int8 + error feedback), for an all-reduce over a
# slow interconnect
# ---------------------------------------------------------------------------

def compress_int8(g: torch.Tensor, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q, scale, new_err); the dequantized value is q * scale."""
    gf = g.float() + err
    scale = torch.clamp_min(torch.max(torch.abs(gf)), 1e-9) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.float() * scale
    return q, scale, new_err


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
