"""Shared neural layers: norms, RoPE / M-RoPE, blockwise attention,
KV caches, MLPs, MoE dispatch — plain functions over tensors and
parameter dicts.

A port of ``repro.models.layers`` in eager PyTorch.  The reference's
``lax.scan`` loops are Python loops here, with the same block sizes,
padding, masking and float32 accumulation, so the two agree to float32
rounding.  Attention is blockwise with an online softmax (no S x S score
matrix); the softcap sits inside the softmax, which is why this is not
``scaled_dot_product_attention``.  Parameter specs are ``TensorSpec``
leaves of nested dicts and tuples (``tree_map`` / ``tree_leaves``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pt_leaves

from .perfopts import current

Params = Dict[str, Any]

NEG_INF = -1e30
F32 = torch.float32


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one parameter or cache leaf."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _rebuild(tree, children):
    """A tuple or list of ``tree``'s type (a NamedTuple too) holding
    ``children``."""
    if hasattr(tree, "_fields"):
        return type(tree)(*children)
    return type(tree)(children)


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of nested dicts, tuples (NamedTuples
    included) and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return _rebuild(tree, [tree_map(fn, v) for v in tree])
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts (in sorted key order), tuples and lists:
    ``jax.tree.leaves``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """``leaves``, in ``tree_leaves`` order, placed into the structure of
    ``like``; raises if their number differs from ``like``'s."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            done = {k: walk(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (tuple, list)):
            return _rebuild(t, [walk(v) for v in t])
        try:
            return next(it)
        except StopIteration:
            raise ValueError("fewer leaves than the tree has") from None
    out = walk(like)
    end = object()
    if next(it, end) is not end:
        raise ValueError("more leaves than the tree has")
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    s = (1.0 + scale.float()) if plus_one else scale.float()
    return (y * s).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (torch.tanh(x.float() / cap) * cap).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin,
                      x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (D/2,)
    ang = positions[..., None].float() * freqs              # (..., S, D/2)
    return _rotate(x, ang)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: Tuple[int, int, int],
                theta: float = 10000.0) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the head dim is split into
    (temporal, height, width) sections, each rotated by its own position
    stream.  positions3: (3, ..., S)."""
    d = x.shape[-1]
    assert sum(sections) == d // 2, (sections, d)
    freqs = rope_freqs(d, theta, x.device)                  # (D/2,)
    sec_ids = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device),
        output_size=d // 2)                                 # (D/2,)
    p = torch.movedim(positions3, 0, -1)                    # (..., S, 3)
    ang = p[..., sec_ids].float() * freqs                   # (..., S, D/2)
    return _rotate(x, ang)


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    causal: bool = True
    window: Optional[int] = None          # sliding-window size (None = full)
    logit_softcap: Optional[float] = None
    q_block: int = 512
    kv_block: int = 512


def _block_mask(qi: int, kj: int, spec: AttnSpec, q_block: int,
                kv_block: int, kv_len: int, device) -> torch.Tensor:
    """(q_block, kv_block) bool mask for query block qi, kv block kj."""
    q_pos = qi * q_block + torch.arange(q_block, device=device)[:, None]
    k_pos = kj * kv_block + torch.arange(kv_block, device=device)[None, :]
    m = k_pos < kv_len          # masks the padded tail of K/V
    if spec.causal:
        m = m & (k_pos <= q_pos)
    if spec.window is not None:
        m = m & (k_pos > q_pos - spec.window)
    return m


def _visible_pairs(nq: int, nk: int, qb: int, kb: int, spec: AttnSpec):
    """(q-block, kv-block) pairs with at least one unmasked element."""
    pairs = []
    for qi in range(nq):
        for kj in range(nk):
            if spec.causal and kj * kb > qi * qb + qb - 1:
                continue
            if spec.window is not None and \
                    kj * kb + kb - 1 <= qi * qb - spec.window:
                continue
            pairs.append((qi, kj))
    return pairs


def pad_seq(t: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad axis 1 of a (B, S, ...) tensor by ``n``."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, n)) if n else t


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              spec: AttnSpec = AttnSpec()) -> torch.Tensor:
    """Blockwise multi-query/grouped attention with online softmax.

    q: (B, S, Hq, D); k, v: (B, S, Hkv, D); Hq % Hkv == 0.
    Memory is O(q_block x kv_block) per step instead of O(S^2).  Every
    (q block, kv block) pair is visited, masked ones too, as the
    reference's scan does; with ``PerfOpts.triangular_attention`` and a
    causal or windowed spec, only the visible pairs (the causal lower
    triangle, the window's band), as the reference's ``_pair_attention``
    does.  A q block then skips only fully masked kv blocks, whose
    updates leave its online softmax as it was, so the two agree.
    """
    b, sq, hq, d = q.shape
    s = k.shape[1]
    dv = v.shape[-1]                 # may differ from d (MLA)
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qb = min(spec.q_block, sq)
    kb = min(spec.kv_block, s)
    # pad to whole blocks; padded keys are masked, padded queries sliced off
    pq, pk = (-sq) % qb, (-s) % kb
    q, k, v = pad_seq(q, pq), pad_seq(k, pk), pad_seq(v, pk)
    nq, nk = (sq + pq) // qb, (s + pk) // kb

    qr = q.reshape(b, nq, qb, hkv, g, d)
    kr = k.reshape(b, nk, kb, hkv, d)
    vr = v.reshape(b, nk, kb, hkv, dv)

    if current().triangular_attention and (spec.causal or
                                           spec.window is not None):
        pairs = _visible_pairs(nq, nk, qb, kb, spec)
    else:
        pairs = [(qi, kj) for qi in range(nq) for kj in range(nk)]
    kv_blocks = [[] for _ in range(nq)]
    for qi, kj in pairs:
        kv_blocks[qi].append(kj)

    outs = []
    for qi in range(nq):
        qblk = qr[:, qi].float() * scale                # (B,qb,hkv,g,D)
        m = torch.full((b, hkv, g, qb), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, qb), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, qb, dv), dtype=torch.float32,
                          device=q.device)
        for kj in kv_blocks[qi]:
            kblk = kr[:, kj].float()
            vblk = vr[:, kj].float()
            sblk = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kblk)
            if spec.logit_softcap is not None:
                sblk = torch.tanh(sblk / spec.logit_softcap) \
                    * spec.logit_softcap
            mask = _block_mask(qi, kj, spec, qb, kb, s, q.device)
            sblk = torch.where(mask, sblk, NEG_INF)
            m_new = torch.maximum(m, sblk.amax(dim=-1))
            p = torch.exp(sblk - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vblk)
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]  # (B,hkv,g,qb,Dv)
        outs.append(out.to(q.dtype))
    out = torch.stack(outs, dim=1)                        # (B,nq,hkv,g,qb,Dv)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, sq + pq, hq, dv)
    return out[:, :sq]


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm`` with float32 results from operands in their own
    dtype (JAX's ``preferred_element_type=float32``)."""
    if a.dtype == b.dtype == F32:
        return torch.bmm(a, b)
    if a.device.type == "cpu":          # the CPU build has no bmm.dtype
        return torch.bmm(a.float(), b.float())
    return torch.bmm(a, b, out_dtype=F32)


def _seq_bmm(a: torch.Tensor, cache: torch.Tensor, perm) -> torch.Tensor:
    """One ``_bmm_f32`` per sequence i: ``a[i]`` times ``cache[i]`` (its
    (S, Hkv, D) slice) permuted by ``perm``, a view in place."""
    return torch.stack([_bmm_f32(a[i], cache[i].permute(*perm))
                        for i in range(a.shape[0])])


#: decode_opt's two products over a (B, S, Hkv, D) cache shard, per
#: cache dim a mesh axis splits: (the other operand's placement, the
#: result's) as "shard" dim, "rep" or "partial" (a sum over the split);
#: scores (B, Hkv, g, D) x cache -> (B, Hkv, g, S), and
#: attend (B, Hkv, g, S) x cache -> (B, Hkv, g, D)
_SCORE_DIMS = {0: (0, 0), 1: ("rep", 3), 2: (1, 1), 3: (3, "partial")}
_ATTEND_DIMS = {0: (0, 0), 1: (3, "partial"), 2: (1, 1), 3: ("rep", 3)}


def _on_shards(fn: Callable, a: torch.Tensor, cache: torch.Tensor,
               dims: Dict[int, Tuple], shape: Tuple[int, ...]):
    """``fn(a, cache)``; on a DTensor ``cache``, ``fn`` of each device's
    own shards, with ``a`` brought to the placements ``dims`` gives it
    beside the cache's and the result placed by ``dims`` (global
    ``shape``).  DTensor would replicate both operands of a ``bmm.dtype``
    (it has no sharding for it) and gather the batch to select a
    sequence: the whole cache on every device."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(cache, DTensor):
        return fn(a, cache)
    mesh = cache.device_mesh
    if not isinstance(a, DTensor):
        a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)

    def place(d):
        return {"rep": Replicate(), "partial": Partial()}.get(d) \
            if isinstance(d, str) else Shard(d)
    a_place, out_place = [], []
    for p in cache.placements:
        if p.is_replicate():
            a_place.append(Replicate())
            out_place.append(Replicate())
            continue
        if not p.is_shard():
            raise ValueError(f"a cache placed {cache.placements}")
        da, do = dims[p.dim]
        a_place.append(place(da))
        out_place.append(place(do))
    a = a.redistribute(mesh, a_place)
    local = fn(a.to_local(), cache.to_local())
    full = torch.empty(shape, device="meta")
    return DTensor.from_local(local, mesh, out_place, run_check=False,
                              shape=full.shape, stride=full.stride())


def _reduced(t: torch.Tensor) -> torch.Tensor:
    """``t`` with any partial placement reduced (a DTensor max over a
    sequence-sharded cache is a partial max, which torch 2.11's DTensor
    cannot carry into the sums that follow it); a plain tensor as it
    is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor) or \
            not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length,
                     spec: AttnSpec = AttnSpec(),
                     extra_kv=None, invalid_slot=None) -> torch.Tensor:
    """Single-step attention over a KV cache.

    q: (B, 1, Hq, D); caches: (B, S, Hkv, D); length: current length
    (entries with index < length are valid).

    ``extra_kv=(k_new, v_new)`` — append-style decode: the cache holds
    only past tokens and the current token's K/V ride separately,
    joined by a two-part online softmax; the caller writes them to the
    cache afterwards.  ``invalid_slot`` masks the rolling-window slot
    about to be overwritten (it holds the expired token).

    Under ``PerfOpts.decode_opt`` the cache is read in its storage dtype
    with float32 results and no float32 copy of it is made: one ``bmm``
    per sequence views its (S, Hkv, D) slice as Hkv matrices in place.
    A DTensor cache stays where it lies: each device runs those ``bmm``s
    over its own shard (``_on_shards``).
    """
    opt = current().decode_opt
    b, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    s = k_cache.shape[1]
    scale = 1.0 / math.sqrt(d)
    if opt:
        qr = (q.reshape(b, hkv, g, d).float() * scale).to(k_cache.dtype)
        scores = _on_shards(lambda a, c: _seq_bmm(a, c, (1, 2, 0)),
                            qr, k_cache, _SCORE_DIMS, (b, hkv, g, s))
    else:
        qr = q.reshape(b, hkv, g, d).float() * scale
        scores = torch.einsum("bhgd,bshd->bhgs", qr, k_cache.float())
    if spec.logit_softcap is not None:
        scores = torch.tanh(scores / spec.logit_softcap) * spec.logit_softcap
    pos = torch.arange(s, device=q.device)
    valid = pos[None] < length
    if spec.window is not None:
        valid = valid & (pos[None] > length - 1 - spec.window)
    if invalid_slot is not None:
        valid = valid & (pos[None] != invalid_slot)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)

    def attend(p):                      # (B, Hkv, g, S) -> (B, Hkv, g, D)
        if opt:
            return _on_shards(lambda a, c: _seq_bmm(a, c, (1, 0, 2)),
                              p.to(v_cache.dtype), v_cache, _ATTEND_DIMS,
                              (b, hkv, g, v_cache.shape[-1]))
        return torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())

    if extra_kv is None:
        out = attend(torch.softmax(scores, dim=-1))
        return out.reshape(b, 1, hq, d).to(q.dtype)

    k_new, v_new = extra_kv                        # (B, 1, Hkv, D)
    s_new = torch.einsum("bhgd,bshd->bhgs", qr.float(),
                         k_new.float())[..., 0]     # (B, Hkv, g)
    if spec.logit_softcap is not None:
        s_new = torch.tanh(s_new / spec.logit_softcap) * spec.logit_softcap
    m = torch.maximum(_reduced(scores.amax(dim=-1)), s_new)
    p_cache = torch.exp(scores - m[..., None])
    p_new = torch.exp(s_new - m)
    denom = p_cache.sum(dim=-1) + p_new
    ctx = attend(p_cache) + p_new[..., None] \
        * v_new[:, 0, :, None, :].float()
    return (ctx / denom[..., None]).reshape(b, 1, hq, d).to(q.dtype)


def cache_update(cache: torch.Tensor, new: torch.Tensor,
                 pos: int) -> torch.Tensor:
    """Write one token's K or V at position ``pos`` of axis 1, in place.

    The start is clamped so the update fits, as
    ``lax.dynamic_update_slice`` clamps it.
    """
    n = new.shape[1]
    start = min(max(int(pos), 0), cache.shape[1] - n)
    write_seq(cache, new, start)
    return cache


def write_seq(dst: torch.Tensor, src: torch.Tensor, start: int) -> None:
    """``dst[:, start:start + n] = src`` (n = ``src.shape[1]``), in
    ``dst``'s dtype, in place.

    A DTensor ``dst`` whose axis 1 is sharded (a cache sharded over its
    sequence) takes the write shard by shard: each device writes the
    part of [start, start + n) that its shard holds, from ``src``
    brought to ``dst``'s placements on the other axes, as GSPMD
    partitions a dynamic-update-slice.  (DTensor would gather the whole
    of ``dst`` to slice it, and write the gathered copy.)"""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(dst, DTensor) or \
            Shard(1) not in dst.placements:
        dst[:, start:start + src.shape[1]] = src.to(dst.dtype)
        return
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = dst.device_mesh
    place = [Replicate() if p == Shard(1) else p for p in dst.placements]
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    src = src.redistribute(mesh, place).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        dst.shape, mesh, dst.placements)
    lo = max(start, offset[1])
    hi = min(start + src.shape[1], offset[1] + shape[1])
    if lo < hi:
        local = dst._local_tensor
        local[:, lo - offset[1]:hi - offset[1]] = \
            src[:, lo - start:hi - start].to(dst.dtype)


def with_sharding_constraint(t: torch.Tensor, mesh,
                             spec: Tuple) -> torch.Tensor:
    """``jax.lax.with_sharding_constraint``: ``spec`` (a partition-spec
    tuple over the axes of ``mesh``, a ``launch.mesh.Mesh``) is checked
    against ``t`` and ``mesh``; a DTensor is redistributed to the spec's
    placements on its ``DeviceMesh``, and a plain tensor, which one
    device holds whole, comes back unchanged."""
    if len(spec) > t.dim():
        raise ValueError(f"spec {spec} has more entries than a "
                         f"{t.dim()}-d tensor has dims")
    for part in spec:
        for ax in part if isinstance(part, tuple) else (part,):
            if ax is not None and ax not in mesh.shape:
                raise ValueError(f"spec {spec}: the mesh has no axis {ax!r}")
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    from ..launch.sharding import placements
    dm = t.device_mesh
    if tuple(dm.mesh_dim_names) != tuple(mesh.axis_names):
        raise ValueError(f"the tensor's mesh has axes {dm.mesh_dim_names}, "
                         f"the spec's {mesh.axis_names}")
    return t.redistribute(dm, placements(spec, mesh))


class ReplicateUnpropagated(TorchDispatchMode):
    """Runs a DTensor program through the ops DTensor has no sharding
    for: where sharding propagation refuses an aten op (no strategy, or
    a view it cannot split evenly, such as 20 heads over 16 devices),
    the op's DTensor operands are replicated and it runs again, as GSPMD
    rematerializes a tensor it cannot reshard ("involuntary full
    rematerialization"), and runs on every device's whole copy; the
    gathers are collectives like any other.  A view DTensor would get
    wrong reshards first (``_view_ready``); one that a shard's strides
    refuse (a view the whole tensor's strides allow) takes a contiguous
    copy, as ``reshape`` would.
    Propagation comes before any local work, so a refused op has done
    nothing yet.  What the op computes does not change; an op that
    writes its first operand writes the replica, which is then copied
    back.  ``ops`` counts each such op by name, backward ops included.
    Plain tensors that meet DTensors are replicated tensors
    (``implicit_replication``), as every device computes them whole.
    Enter it after (inside) a counting mode, whose count then includes
    the replicating collectives."""

    def __init__(self):
        super().__init__()
        self.ops: Dict[str, int] = {}

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        self._dispatcher = DTensor._op_dispatcher
        self._implicit = self._dispatcher._allow_implicit_replication
        self._dispatcher._allow_implicit_replication = True
        return super().__enter__()

    def __exit__(self, *exc):
        self._dispatcher._allow_implicit_replication = self._implicit
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        if func in _LOOKUPS:
            return _lookup(func, *args)
        if func is torch.ops.aten.copy_.default and _into_partial(*args):
            return _copy_into_partial(*args)
        try:
            if func in _VIEWS:
                size = args[1] if len(args) > 1 else kwargs["size"]
                args = (_view_ready(args[0], size),) + tuple(args[1:])
                try:
                    return func(*args, **kwargs)
                except RuntimeError as e:   # a shard's strides refuse it
                    if "view size is not compatible" not in str(e):
                        raise
                    args = (args[0].contiguous(),) + tuple(args[1:])
            return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as e:
            if "Sharding propagation failed" not in str(e) and \
                    "does not have a sharding strategy" not in str(e):
                raise
        from torch.utils._pytree import tree_map

        def whole(t):
            if isinstance(t, DTensor) and \
                    not all(p.is_replicate() for p in t.placements):
                return t.redistribute(t.device_mesh,
                                      [Replicate()] * t.device_mesh.ndim)
            return t
        name = str(func.overloadpacket).split(".")[-1]
        self.ops[name] = self.ops.get(name, 0) + 1
        mesh = next(t.device_mesh for t in _pt_leaves((args, kwargs))
                    if isinstance(t, DTensor))
        rargs, rkwargs = tree_map(whole, (args, kwargs))
        # every operand whole: the op runs as on one device
        largs, lkwargs = tree_map(lambda t: t.to_local() if isinstance(
            t, DTensor) else t, (rargs, rkwargs))
        out = func(*largs, **lkwargs)
        first = func._schema.arguments[0] if func._schema.arguments else None
        if first is not None and first.alias_info is not None and \
                first.alias_info.is_write:
            if rargs[0] is not args[0]:
                args[0].copy_(rargs[0])
            return args[0]
        return tree_map(lambda t: DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim, run_check=False)
            if isinstance(t, torch.Tensor) else t, out)


def _into_partial(dst, src, *_) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(dst, DTensor) and isinstance(src, DTensor) and \
        any(p.is_partial() for p in dst.placements) and \
        src.placements != dst.placements


def _copy_into_partial(dst, src, non_blocking=False):
    """``dst.copy_(src)`` for a partial ``dst`` (a gradient being
    accumulated), which DTensor cannot do from ``src``'s placements:
    ``src`` is made whole along ``dst``'s partial axes and laid out as
    ``dst`` along the others; the first device along every partial
    axis takes it and the rest zeros, so the partial sum is ``src``."""
    from torch.distributed.tensor import Replicate
    mesh = dst.device_mesh
    src = src.redistribute(mesh, [Replicate() if p.is_partial() else p
                                  for p in dst.placements]).to_local()
    first = all(mesh.get_local_rank(i) == 0
                for i, p in enumerate(dst.placements) if p.is_partial())
    local = dst.to_local()
    if first:
        local.copy_(src, non_blocking)
    else:
        local.zero_()
    return dst


_VIEWS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)


def _view_groups(old, new):
    """The (old dims, new dims) that a view of shape ``old`` to ``new``
    maps onto each other, size-1 dims aside; [] where it cannot tell."""
    o = [(i, n) for i, n in enumerate(old) if n != 1]
    w = [(j, n) for j, n in enumerate(new) if n != 1]
    groups, i, j = [], 0, 0
    while i < len(o) and j < len(w):
        gi, gj = [o[i][0]], [w[j][0]]
        a, b = o[i][1], w[j][1]
        i, j = i + 1, j + 1
        while a != b:
            if a < b and i < len(o):
                a *= o[i][1]
                gi.append(o[i][0])
                i += 1
            elif b < a and j < len(w):
                b *= w[j][1]
                gj.append(w[j][0])
                j += 1
            else:
                return []
        groups.append((tuple(gi), tuple(gj)))
    return groups


def _view_ready(t, size):
    """``t``, resharded where DTensor's view to ``size`` goes wrong: a
    dim split unevenly over a mesh axis (which DTensor allows, and whose
    local views can fail), or a unit dim "split" over an axis of one
    (which DTensor will not drop), is gathered along that axis; a merge
    of a dim it is split on into the dim before it (which DTensor
    represents as a strided shard, whose redistributions it plans by a
    search that grows with the mesh's rank) moves that axis to the
    first dim the view keeps whole, by an all-to-all, or gathers it
    where there is none; a split of a sharded dim keeps the mesh axes
    whose product divides its first part and gathers the rest (DTensor
    refuses such a split over one axis, as of 20 heads over 16 devices,
    and gives it the wrong local shape over several)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return t
    size = list(size)
    if -1 in size:              # the one inferred dim
        size[size.index(-1)] = t.numel() // -math.prod(size)
    groups = _view_groups(tuple(t.shape), tuple(size))
    inner = {d for g, _ in groups for d in g[1:]}
    merged = {d for g, _ in groups if len(g) > 1 for d in g}
    #: a split dim -> the size of the first dim it splits into
    split = {g[0]: size[h[0]] for g, h in groups
             if len(g) == 1 and len(h) > 1}
    place = list(t.placements)
    ways = {}
    for i, p in enumerate(place):
        if not isinstance(p, Shard):
            continue
        n = t.device_mesh.shape[i]
        if t.shape[p.dim] == 1 or t.shape[p.dim] % (ways.get(p.dim, 1) * n):
            place[i] = Replicate()      # split unevenly, or a unit dim
        elif p.dim in inner:
            free = [d for d in range(t.dim()) if d not in merged
                    and t.shape[d] % n == 0 and Shard(d) not in place]
            place[i] = Shard(free[0]) if free else Replicate()
        elif p.dim in split and split[p.dim] % (ways.get(p.dim, 1) * n):
            place[i] = Replicate()
        else:
            ways[p.dim] = ways.get(p.dim, 1) * n
    if place == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, place)


_LOOKUPS = (torch.ops.aten.index.Tensor, torch.ops.aten.gather.default)


def _lookup(func, src, dim_or_indices, index=None):
    """A row lookup on DTensors, partitioned as GSPMD partitions a
    gather: ``src[idx]`` (``aten.index`` with one index, on dim 0) or
    ``gather(src, dim, index)``.  Along a mesh axis that splits the
    looked-up dim (a vocab-sharded embedding or logits), each device
    looks up the rows it holds, zeroes the rest, and the partial sums
    are all-reduced over that axis; a partial ``src`` stays partial (the
    lookup is linear in it); along any other axis the lookup is local.
    (DTensor's own rule for these, a masked partial, compares its masks
    with ``torch.equal``, which meta tensors lack.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    if func is torch.ops.aten.gather.default:
        dim, idx = dim_or_indices % src.dim(), index
    else:
        if len(dim_or_indices) != 1 or dim_or_indices[0] is None:
            return func(src, dim_or_indices)
        dim, idx = 0, dim_or_indices[0]
    mesh = src.device_mesh
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    if any(p.is_partial() for p in idx.placements):
        idx = idx.redistribute(mesh, [Replicate() if p.is_partial() else p
                                      for p in idx.placements])
    shape, offset = compute_local_shape_and_global_offset(
        src.shape, mesh, src.placements)
    split = shape[dim] < src.shape[dim]
    idx_place, out_place = [], []
    for ps, pi in zip(src.placements, idx.placements):
        if ps.is_partial():         # a lookup is linear in ``src``
            idx_place.append(Replicate())
            out_place.append(ps)
        elif ps == Shard(dim):
            idx_place.append(Replicate())
            out_place.append(Partial() if split else Replicate())
        elif func is torch.ops.aten.gather.default:     # same-rank index
            idx_place.append(ps)
            out_place.append(ps)
        elif isinstance(ps, Shard):
            idx_place.append(Replicate())
            out_place.append(Shard(idx.dim() + ps.dim - 1))
        else:
            idx_place.append(pi)
            out_place.append(pi)
    il = idx.redistribute(mesh, idx_place).to_local()
    sl = src.to_local()
    if split:
        il = il - offset[dim]
        valid = (il >= 0) & (il < shape[dim])
        il = torch.clamp(il, 0, shape[dim] - 1)
    if func is torch.ops.aten.gather.default:
        out = func(sl, dim, il)
        if split:
            out = torch.where(valid, out, torch.zeros((), dtype=out.dtype,
                                                      device=out.device))
    else:
        out = func(sl, [il])
        if split:
            out = torch.where(valid.reshape(valid.shape + (1,) * (
                out.dim() - valid.dim())), out, torch.zeros(
                    (), dtype=out.dtype, device=out.device))
    out_shape = tuple(idx.shape) + (tuple(src.shape[1:])
                                    if func is torch.ops.aten.index.Tensor
                                    else ())
    full = torch.empty(out_shape, dtype=out.dtype, device="meta")
    out = DTensor.from_local(out, mesh, out_place, run_check=False,
                             shape=full.shape, stride=full.stride())
    if split:                   # the partial sums reduced, as GSPMD does
        out = out.redistribute(mesh, [Replicate() if ps == Shard(dim)
                                      else p for p, ps in
                                      zip(out_place, src.placements)])
    return out


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def gated_mlp(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
              wo: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = x @ wi
    gate = _act(x @ wg, act)
    return (h * gate) @ wo


def dense_mlp(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
              act: str = "gelu") -> torch.Tensor:
    return _act(x @ wi, act) @ wo


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":         # jax.nn.gelu's default is the tanh form
        return F.gelu(x, approximate="tanh")
    if act == "silu":
        return F.silu(x)
    if act == "relu":
        return F.relu(x)
    if act == "relu2":      # squared ReLU (nemotron/minitron)
        r = F.relu(x)
        return r * r
    raise ValueError(act)


# ---------------------------------------------------------------------------
# MoE (dense one-hot dispatch)
# ---------------------------------------------------------------------------

def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot rows; an index outside [0, n) gives a zero row, as in
    ``jax.nn.one_hot``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor, wi: torch.Tensor,
            wg: torch.Tensor, wo: torch.Tensor, top_k: int,
            act: str = "silu",
            shared: Optional[Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]] = None,
            capacity_factor: float = 1.25,
            token_chunk: int = 2048) -> torch.Tensor:
    """Capacity-based top-k MoE (Switch/mesh-TF-style dispatch).

    x: (B,S,D); wi/wg: (E,D,F); wo: (E,F,D); router_w: (D,E).

    Tokens are processed in chunks; per chunk every expert receives at
    most C = ceil(top_k * chunk * cf / E) tokens, claimed in token order
    by a cumulative count (overflow drops — standard).  Under
    ``PerfOpts.moe_capacity_shard`` and a mesh, each chunk's per-expert
    token buffers take the reference's ``(None, "data", None)``
    constraint.
    """
    opts = current()
    b, s, d = x.shape
    e = router_w.shape[-1]
    tokens = x.reshape(b * s, d)
    t_all = tokens.shape[0]
    tc = min(token_chunk, t_all)
    pad = (-t_all) % tc
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    nchunk = tokens.shape[0] // tc
    cap = max(1, int(math.ceil(top_k * tc * capacity_factor / e)))

    ys = []
    for ci in range(nchunk):
        xt = tokens[ci * tc:(ci + 1) * tc]               # (tc, d)
        logits = xt.float() @ router_w.float()
        gates = torch.softmax(logits, dim=-1)
        weights, ids = torch.topk(gates, top_k, dim=-1)  # (tc, k)
        weights = weights / torch.clamp_min(
            weights.sum(-1, keepdim=True), 1e-9)
        # position of each (token, slot) within its expert's capacity
        flat = _one_hot(ids, e, torch.int32).reshape(tc * top_k, e)
        pos = torch.cumsum(flat, dim=0) - flat           # entries before us
        pos = (pos.float() * flat.float()).sum(-1).to(torch.int32)
        pos = pos.reshape(tc, top_k)
        keep = pos < cap
        disp = torch.zeros((tc, e, cap), dtype=x.dtype, device=x.device)
        comb = torch.zeros((tc, e, cap), dtype=torch.float32,
                           device=x.device)
        for j in range(top_k):
            oh_e = _one_hot(ids[:, j], e, x.dtype)
            oh_c = _one_hot(pos[:, j], cap, x.dtype)
            oh_c = oh_c * keep[:, j][:, None].to(x.dtype)
            dk = torch.einsum("te,tc->tec", oh_e, oh_c)
            disp = disp + dk
            comb = comb + dk.float() * weights[:, j][:, None, None]
        xe = torch.einsum("tec,td->ecd", disp, xt)       # (e, cap, d)
        if opts.moe_capacity_shard and opts.mesh is not None:
            xe = with_sharding_constraint(xe, opts.mesh, (None, "data", None))
        h = torch.bmm(xe, wi)
        g = _act(torch.bmm(xe, wg), act)
        ye = torch.bmm(h * g, wo)                        # (e, cap, d)
        ys.append(torch.einsum("tec,ecd->td", comb.to(x.dtype), ye))
    y = torch.cat(ys)[:t_all].reshape(b, s, d)
    if shared is not None:
        swi, swg, swo = shared
        y = y + gated_mlp(x, swi, swg, swo, act)
    return y


# ---------------------------------------------------------------------------
# Parameter initialization over spec trees
# ---------------------------------------------------------------------------

def init_from_specs(specs: Params, generator: torch.Generator, device,
                    scale: float = 0.02) -> Params:
    """Materialize a ``TensorSpec`` tree with scaled-normal params drawn
    on ``device`` from ``generator`` (which must live on that device)."""
    def draw(leaf: TensorSpec) -> torch.Tensor:
        if leaf.dtype.is_floating_point:
            v = torch.randn(leaf.shape, generator=generator,
                            dtype=torch.float32, device=device).mul_(scale)
            return v.to(leaf.dtype)
        return torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
    return tree_map(draw, specs)
