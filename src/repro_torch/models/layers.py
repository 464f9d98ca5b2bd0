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
    """
    opt = current().decode_opt
    b, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    s = k_cache.shape[1]
    scale = 1.0 / math.sqrt(d)
    if opt:
        qr = (q.reshape(b, hkv, g, d).float() * scale).to(k_cache.dtype)
        scores = torch.stack([_bmm_f32(qr[i], k_cache[i].permute(1, 2, 0))
                              for i in range(b)])
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
            p = p.to(v_cache.dtype)
            return torch.stack([_bmm_f32(p[i], v_cache[i].transpose(0, 1))
                                for i in range(b)])
        return torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())

    if extra_kv is None:
        out = attend(torch.softmax(scores, dim=-1))
        return out.reshape(b, 1, hq, d).to(q.dtype)

    k_new, v_new = extra_kv                        # (B, 1, Hkv, D)
    s_new = torch.einsum("bhgd,bshd->bhgs", qr.float(),
                         k_new.float())[..., 0]     # (B, Hkv, g)
    if spec.logit_softcap is not None:
        s_new = torch.tanh(s_new / spec.logit_softcap) * spec.logit_softcap
    m = torch.maximum(scores.amax(dim=-1), s_new)
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
    cache[:, start:start + n] = new.to(cache.dtype)
    return cache


def with_sharding_constraint(t: torch.Tensor, mesh,
                             spec: Tuple) -> torch.Tensor:
    """``jax.lax.with_sharding_constraint`` for a cell that runs on one
    device: ``spec`` (a partition-spec tuple over the axes of ``mesh``,
    a ``launch.mesh.Mesh``) is checked against ``t`` and ``mesh``, and
    ``t`` comes back unchanged, as a constraint leaves the data where
    one device holds every shard.  The port has no SPMD partitioner."""
    if len(spec) > t.dim():
        raise ValueError(f"spec {spec} has more entries than a "
                         f"{t.dim()}-d tensor has dims")
    for part in spec:
        for ax in part if isinstance(part, tuple) else (part,):
            if ax is not None and ax not in mesh.shape:
                raise ValueError(f"spec {spec}: the mesh has no axis {ax!r}")
    return t


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
