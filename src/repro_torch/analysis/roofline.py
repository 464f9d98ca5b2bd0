"""Roofline terms of a cell on one NVIDIA H100, from counts taken while
the cell runs on the ``meta`` device.

A port of ``repro.analysis.roofline``.  The reference walks the
post-optimization HLO text of a compiled cell, counting ``dot`` FLOPs
and the operand and result bytes of top-level instructions, with each
loop body multiplied by its trip count.  The port produces no HLO (a
cell runs eagerly, op by op), so two dispatch modes count the same
quantities as the cell runs, every loop iteration as it happens:

  * ``FlopCounterMode``: matmul FLOPs, 2 x M x N x K per ``mm``,
    ``bmm`` (with ``out_dtype`` too), ``addmm``, ``baddbmm``,
    convolution and attention product;
  * ``ByteCounter``: the bytes of every tensor argument and result of
    each aten op that is not a view, which is eager's unfused memory
    traffic (an in-place op's result is its argument and counts again,
    so this is an upper estimate).

Per device, on an ``n``-device mesh, with the cell's work split evenly:

    compute_s    = flops / n / PEAK_FLOPS
    memory_s     = bytes / n / HBM_BW
    collective_s = 0 on one device; on a larger mesh None, "not
                   modelled" (the port has no partitioner, so no
                   collective is issued to count)

Hardware constants: NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit) — 989 TFLOP/s bf16, 3.35 TB/s HBM3, 80 GB.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pt_leaves
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = 989e12           # bf16 tensor cores, dense
HBM_BW = 3.35e12              # bytes/s
HBM_BYTES = 80e9              # device memory

aten = torch.ops.aten
#: ops whose result aliases or only reserves memory: no traffic
_NO_TRAFFIC = {aten._unsafe_view.default, aten.empty.memory_format,
               aten.empty_strided.default, aten.detach.default,
               aten.lift_fresh.default}


def _bmm_flops(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    """``bmm`` and ``bmm.dtype`` (whose third argument is the result's
    dtype, which the stock formula takes for a shape)."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[-1]


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of the tensor arguments and results of every aten
    op that is not a view."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _NO_TRAFFIC:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _pt_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def count(fn: Callable, *args) -> Tuple[int, int]:
    """(matmul FLOPs, bytes) of ``fn(*args)``, run under both modes."""
    flops = FlopCounterMode(display=False,
                            custom_mapping={aten.bmm: _bmm_flops})
    with flops, ByteCounter() as traffic:
        fn(*args)
    return flops.get_total_flops(), traffic.bytes


# ---------------------------------------------------------------------------
# Roofline terms + useful-FLOPs accounting
# ---------------------------------------------------------------------------

def model_params(cfg) -> Tuple[int, int]:
    """(N_total, N_active) parameter counts."""
    from ..models import lm
    from ..models.layers import tree_leaves
    total = sum(math.prod(x.shape) for x in tree_leaves(lm.param_specs(cfg)))
    active = total
    if cfg.n_experts and cfg.top_k:
        # routed expert params counted at top_k/E utilization
        e, fm, d = cfg.n_experts, cfg.moe_d_ff, cfg.d_model
        n_moe_layers = sum(1 for s in cfg.unit if s.mlp == "moe") \
            * cfg.n_unit_repeats + sum(1 for s in cfg.pre if s.mlp == "moe")
        routed = n_moe_layers * e * (3 * d * fm)
        active = total - routed + routed * cfg.top_k / e
    return total, int(active)


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs of one step: 6*N*D train, 2*N_active*tokens
    for forward-only (prefill/decode)."""
    n_total, n_active = model_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch          # one token / seq


def terms(rec: Dict, cfg, shape, n_chips: int) -> Dict:
    """Roofline terms (seconds per device) from a record with per-device
    ``flops`` and ``hbm_bytes``."""
    flops, hbm = rec["flops"], rec["hbm_bytes"]
    mf = model_flops(cfg, shape)
    out = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": hbm / HBM_BW,
        "collective_s": 0.0 if n_chips == 1 else None,
        "model_flops": mf,
        "model_flops_per_chip": mf / n_chips,
        "useful_flops_frac": (mf / n_chips) / flops if flops else 0.0,
    }
    if out["collective_s"] is None:
        out["collective"] = "not modelled"
    dom = max((k for k in ("compute_s", "memory_s", "collective_s")
               if out[k] is not None), key=out.__getitem__)
    out["bottleneck"] = dom.split("_")[0]
    total = out[dom]
    ideal = (mf / n_chips) / PEAK_FLOPS
    out["roofline_frac"] = ideal / total if total > 0 else 0.0
    return out
