"""Roofline terms of a cell on NVIDIA H100s, from counts taken while the
cell runs on the ``meta`` device.

A port of ``repro.analysis.roofline``.  The reference walks the
post-optimization HLO text of a compiled cell, counting ``dot`` FLOPs,
the operand and result bytes of top-level instructions and the wire
bytes of each collective, with each loop body multiplied by its trip
count; the SPMD module it walks is one partition's, so every count is
per device.  The port produces no HLO (a cell runs eagerly, op by op),
so one dispatch mode, ``OpCounter``, counts the same quantities as the
cell runs, every loop iteration as it happens:

  * matmul FLOPs, 2 x M x N x K per ``mm``, ``bmm`` (with
    ``out_dtype`` too), ``addmm``, ``baddbmm``, convolution and
    attention product (``torch.utils.flop_counter``'s formulas);
  * the bytes of every tensor argument and result of each aten op that
    is not a view, which is eager's unfused memory traffic (an in-place
    op's result is its argument and counts again, so this is an upper
    estimate);
  * each collective's kind, count and wire bytes.

On a DTensor program (``launch.steps``, a cell on a ``DeviceMesh``) the
mode lets DTensor run first and counts the local ops it issues on this
device's shards and the collectives of its redistributions, so every
count is per device, as the reference's are.  (A mode that counted the
DTensor ops themselves would see global shapes: ``FlopCounterMode``
around a sharded matmul counts the whole product.)  The ops DTensor's
sharding propagation runs on fake tensors are not counted.

Collective wire bytes follow the reference's ring model, with ``g``
the size of the group the op spans (one mesh axis):

    all-reduce          2 * size * (g-1)/g
    all-gather          out  * (g-1)/g
    reduce-scatter      out  * (g-1)          (input = g * output)
    all-to-all          size * (g-1)/g
    collective-permute  size

Per device:

    compute_s    = flops / PEAK_FLOPS
    memory_s     = bytes / HBM_BW
    collective_s = sum over collectives of wire bytes / link rate

Hardware constants: NVIDIA H100 SXM5 data sheet, dense, at its 700 W
limit — 989 TFLOP/s bf16, 3.35 TB/s HBM3, 80 GB; NVLink 4 at 900 GB/s
per GPU in all, 450 GB/s each way, between the 8 GPUs of a node
(HGX H100 / DGX H100); across nodes one 400 Gb/s NDR InfiniBand NIC
(ConnectX-7) per GPU, 50 GB/s each way (DGX H100 user guide).  Ranks
fill nodes of ``GPUS_PER_NODE`` in order, so a group whose ranks lie in
one node rides NVLink and any other group InfiniBand.  On the 16x16
plan (256 ranks, 32 nodes) the "model" axis (16 consecutive ranks, two
nodes) and the "data" axis (stride 16) both cross nodes: InfiniBand.
On 2x16x16 the "pod" axis (stride 256) does too, so every axis of both
production plans gets 50 GB/s; only a group of at most 8 ranks inside
one node, as on a host mesh of one node, gets NVLink.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Callable, Dict, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pt_leaves
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = 989e12           # bf16 tensor cores, dense
HBM_BW = 3.35e12              # bytes/s
HBM_BYTES = 80e9              # device memory
NVLINK_BW = 450e9             # bytes/s each way per GPU, inside a node
IB_BW = 50e9                  # bytes/s each way per GPU, across nodes
GPUS_PER_NODE = 8

aten = torch.ops.aten
#: ops whose result aliases or only reserves memory: no traffic
_NO_TRAFFIC = {aten._unsafe_view.default, aten.empty.memory_format,
               aten.empty_strided.default, aten.detach.default,
               aten.lift_fresh.default}

#: the reference's collective kinds, in its order
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _collective_kinds() -> Dict[object, str]:
    """Op packet -> collective kind, for the collectives DTensor and the
    functional collectives issue."""
    import torch.distributed._functional_collectives  # noqa: F401 (ops)
    f = torch.ops._c10d_functional
    kinds = {}
    for kind, names in [
            ("all-reduce", ("all_reduce", "all_reduce_",
                            "all_reduce_coalesced", "all_reduce_coalesced_")),
            ("all-gather", ("all_gather_into_tensor",
                            "all_gather_into_tensor_out",
                            "all_gather_into_tensor_coalesced")),
            ("reduce-scatter", ("reduce_scatter_tensor",
                                "reduce_scatter_tensor_coalesced")),
            ("all-to-all", ("all_to_all_single",))]:
        for n in names:
            if hasattr(f, n):
                kinds[getattr(f, n)] = kind
    kinds[torch.ops._dtensor.shard_dim_alltoall] = "all-to-all"
    return kinds


#: functional-collective ops that move no data, on the wire or in memory
_NO_WIRE = {"wait_tensor", "_wrap_tensor_autograd"}


def wire_bytes(kind: str, out_bytes: float, g: int) -> float:
    """Bytes one device sends for a collective of ``kind`` whose result
    is ``out_bytes`` over a group of ``g``, by the ring model."""
    frac = (g - 1) / max(g, 1)
    if kind == "all-reduce":
        return 2 * out_bytes * frac
    if kind in ("all-gather", "all-to-all"):
        return out_bytes * frac
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)
    if kind == "collective-permute":
        return out_bytes
    raise ValueError(kind)


def link_bw(ranks: Sequence[int]) -> float:
    """The per-GPU rate of a group: NVLink when its ranks share a node,
    InfiniBand otherwise."""
    return NVLINK_BW if len({r // GPUS_PER_NODE for r in ranks}) <= 1 \
        else IB_BW


def axis_links(device_mesh) -> Dict[str, str]:
    """Mesh axis name -> "nvlink" or "infiniband", for this rank's group
    along each axis of a ``DeviceMesh``."""
    import torch.distributed as dist
    out = {}
    for i, name in enumerate(device_mesh.mesh_dim_names):
        ranks = dist.get_process_group_ranks(device_mesh.get_group(i))
        out[name] = "nvlink" if link_bw(ranks) == NVLINK_BW \
            else "infiniband"
    return out


def _bmm_flops(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    """``bmm`` and ``bmm.dtype`` (whose third argument is the result's
    dtype, which the stock formula takes for a shape)."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[-1]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _pt_leaves(tree)
               if isinstance(t, torch.Tensor))


class OpCounter(TorchDispatchMode):
    """Counts the matmul FLOPs, the bytes of the tensor arguments and
    results of every aten op that is not a view, and the collectives of
    what runs under it; on DTensors, of the local ops DTensor issues."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, float] = defaultdict(float)
        self.collective_count = 0
        self.collective_s = 0.0
        self._registry = FlopCounterMode(
            display=False, custom_mapping={aten.bmm: _bmm_flops}
        ).flop_registry
        self._kinds = _collective_kinds()
        self._groups: Dict[str, Tuple[int, float]] = {}
        self._decomposing = 0

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs, we see its local ops
        # DTensor's sharding propagation on fake tensors: not this device's
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        kind = self._kinds.get(packet)
        if kind is not None:
            out = func(*args, **kwargs)
            self._count_collective(kind, args, out)
            return out
        if func.namespace == "_c10d_functional":
            if packet.__name__ not in _NO_WIRE:
                raise NotImplementedError(f"no wire model for {func}")
            return func(*args, **kwargs)    # moves no bytes
        # as FlopCounterMode: a composite op counts through its parts
        self._decomposing += 1
        try:
            with self:
                out = func.decompose(*args, **kwargs)
        finally:
            self._decomposing -= 1
        if out is NotImplemented:
            out = func(*args, **kwargs)
            if any(isinstance(t, FakeTensor) for t in _pt_leaves(out)):
                return out                  # made under a fake mode
            formula = self._registry.get(packet)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
        elif any(isinstance(t, FakeTensor) for t in _pt_leaves(out)):
            return out
        if not self._decomposing and not func.is_view \
                and func not in _NO_TRAFFIC:
            self.bytes += _nbytes((args, kwargs, out))
        return out

    def _count_collective(self, kind: str, args, out) -> None:
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group
        name = [a for a in args if isinstance(a, str)][-1]
        if name not in self._groups:
            ranks = dist.get_process_group_ranks(_resolve_process_group(name))
            self._groups[name] = (len(ranks), link_bw(ranks))
        g, bw = self._groups[name]
        wire = wire_bytes(kind, _nbytes(out), g)
        self.collectives[kind] += wire
        self.collective_count += 1
        self.collective_s += wire / bw
        if not self._decomposing:
            self.bytes += _nbytes((args, out))


def count(fn: Callable, *args) -> Tuple[int, int]:
    """(matmul FLOPs, bytes) of ``fn(*args)``."""
    c = count_all(fn, *args)
    return c.flops, c.bytes


def count_all(fn: Callable, *args) -> OpCounter:
    """The ``OpCounter`` of ``fn(*args)``: FLOPs, bytes and collectives,
    per device on a DTensor program."""
    with OpCounter() as c:
        fn(*args)
    return c


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
    ``flops``, ``hbm_bytes`` and ``collective_s`` (the link-weighted
    time of its collectives; 0 where there are none)."""
    flops, hbm = rec["flops"], rec["hbm_bytes"]
    mf = model_flops(cfg, shape)
    out = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": hbm / HBM_BW,
        "collective_s": rec.get("collective_s", 0.0),
        "model_flops": mf,
        "model_flops_per_chip": mf / n_chips,
        "useful_flops_frac": (mf / n_chips) / flops if flops else 0.0,
    }
    dom = max(("compute_s", "memory_s", "collective_s"), key=out.__getitem__)
    out["bottleneck"] = dom.split("_")[0]
    total = out[dom]
    ideal = (mf / n_chips) / PEAK_FLOPS
    out["roofline_frac"] = ideal / total if total > 0 else 0.0
    return out
