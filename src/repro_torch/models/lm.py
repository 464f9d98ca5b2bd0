"""Generic language model covering the assigned architecture pool, in
eager PyTorch.

A port of ``repro.models.lm``.  One config-driven implementation
provides:
  * attention mixers: GQA/MHA (full, sliding-window, alternating),
    softcaps, QKV bias, RoPE / M-RoPE; MLA (DeepSeek-V2) with compressed
    KV cache and absorbed decode; Mamba2 SSD; Hymba parallel attn+SSM.
  * MLPs: gated (SwiGLU/GeGLU), dense, MoE (top-k, shared experts), none.
  * encoder-decoder (Seamless-M4T): bidirectional encoder + causal
    decoder with cross-attention.

Parameters are nested dicts with the reference's tree: the repeating
``cfg.unit`` recipe's leaves are stacked on a leading repeat axis, and
the reference's ``lax.scan`` over that axis is a Python loop over the
repeat index here.  Weights take ``cfg.dtype``; norms, SSM decay and
skip terms and the MoE router stay float32, as in the reference.  A
parallel tree of logical axes (``logical_axes``, ``cache_axes``) is
read by ``launch/sharding.py``; the ``PerfOpts`` levers
(``models/perfopts.py``) act where the reference's do.
Entry points: ``init_params`` / ``params_from_reference``, ``forward``
/ ``logits_fn`` / ``lm_loss`` (differentiable, with the reference's
activation checkpointing under ``remat``), ``prefill`` and
``decode_step`` (serving).  The decode cache that ``prefill`` returns is
allocated once at ``cache_len`` and ``decode_step`` updates it in place.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from ..configs.base import LayerSpec, ModelConfig
from ..kernels.backend import resolve_device
from . import ssm as ssm_mod
from .layers import (AttnSpec, TensorSpec, apply_mrope, apply_rope,
                     attention, cache_update, decode_attention, dense_mlp,
                     gated_mlp, init_from_specs, moe_mlp, rms_norm, softcap,
                     tree_leaves, tree_map, tree_unflatten,
                     with_sharding_constraint, write_seq)
from .perfopts import current

Params = Dict[str, Any]

def _sds(cfg: ModelConfig, shape, dtype=None) -> TensorSpec:
    """A leaf of ``cfg.dtype`` unless ``dtype`` says otherwise."""
    return TensorSpec(tuple(shape), dtype or cfg.dtype)


F32 = torch.float32


# ---------------------------------------------------------------------------
# Parameter specs + logical axes
# ---------------------------------------------------------------------------

def _attn_specs(cfg: ModelConfig):
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sp = {"wq": _sds(cfg, (d, h * hd)), "wk": _sds(cfg, (d, k * hd)),
          "wv": _sds(cfg, (d, k * hd)), "wo": _sds(cfg, (h * hd, d))}
    ax = {"wq": ("embed", "heads"), "wk": ("embed", "kv"),
          "wv": ("embed", "kv"), "wo": ("heads", "embed")}
    if cfg.qkv_bias:
        sp.update({"bq": _sds(cfg, (h * hd,)), "bk": _sds(cfg, (k * hd,)),
                   "bv": _sds(cfg, (k * hd,))})
        ax.update({"bq": ("heads",), "bk": ("kv",), "bv": ("kv",)})
    return sp, ax


def _mla_specs(cfg: ModelConfig):
    d, h = cfg.d_model, cfg.n_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    sp = {"wq": _sds(cfg, (d, h * qd)),
          "w_dkv": _sds(cfg, (d, cfg.kv_lora + cfg.qk_rope_dim)),
          "kv_norm": _sds(cfg, (cfg.kv_lora,), F32),
          "w_uk": _sds(cfg, (cfg.kv_lora, h * cfg.qk_nope_dim)),
          "w_uv": _sds(cfg, (cfg.kv_lora, h * cfg.v_head_dim)),
          "wo": _sds(cfg, (h * cfg.v_head_dim, d))}
    ax = {"wq": ("embed", "heads"), "w_dkv": ("embed", None),
          "kv_norm": (None,), "w_uk": (None, "heads"),
          "w_uv": (None, "heads"), "wo": ("heads", "embed")}
    return sp, ax


def _ssm_specs(cfg: ModelConfig):
    d = cfg.d_model
    di = cfg.d_inner
    h = cfg.n_ssm_heads
    n = cfg.ssm_state
    sp = {"w_z": _sds(cfg, (d, di)), "w_x": _sds(cfg, (d, di)),
          "w_B": _sds(cfg, (d, n)), "w_C": _sds(cfg, (d, n)),
          "w_dt": _sds(cfg, (d, h)),
          "A_log": _sds(cfg, (h,), F32), "D_skip": _sds(cfg, (h,), F32),
          "dt_bias": _sds(cfg, (h,), F32),
          "ssm_norm": _sds(cfg, (di,), F32),
          "out_proj": _sds(cfg, (di, d))}
    ax = {"w_z": ("embed", "inner"), "w_x": ("embed", "inner"),
          "w_B": ("embed", None), "w_C": ("embed", None),
          "w_dt": ("embed", None), "A_log": (None,), "D_skip": (None,),
          "dt_bias": (None,), "ssm_norm": (None,),
          "out_proj": ("inner", "embed")}
    return sp, ax


def _mlp_specs(cfg: ModelConfig, kind: str):
    d, f = cfg.d_model, cfg.d_ff
    if kind == "none":
        return {}, {}
    if kind == "gated":
        return ({"wi": _sds(cfg, (d, f)), "wg": _sds(cfg, (d, f)),
                 "wo_mlp": _sds(cfg, (f, d))},
                {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
                 "wo_mlp": ("mlp", "embed")})
    if kind == "dense":
        return ({"wi": _sds(cfg, (d, f)), "wo_mlp": _sds(cfg, (f, d))},
                {"wi": ("embed", "mlp"), "wo_mlp": ("mlp", "embed")})
    if kind == "moe":
        e, fm = cfg.n_experts, cfg.moe_d_ff
        sp = {"router": _sds(cfg, (d, e), F32),
              "wi": _sds(cfg, (e, d, fm)), "wg": _sds(cfg, (e, d, fm)),
              "wo_mlp": _sds(cfg, (e, fm, d))}
        ax = {"router": ("embed", None),
              "wi": ("expert", "embed", "mlp_e"),
              "wg": ("expert", "embed", "mlp_e"),
              "wo_mlp": ("expert", "mlp_e", "embed")}
        if cfg.n_shared_experts:
            fs = fm * cfg.n_shared_experts
            sp.update({"swi": _sds(cfg, (d, fs)), "swg": _sds(cfg, (d, fs)),
                       "swo": _sds(cfg, (fs, d))})
            ax.update({"swi": ("embed", "mlp"), "swg": ("embed", "mlp"),
                       "swo": ("mlp", "embed")})
        return sp, ax
    raise ValueError(kind)


def _layer_specs(cfg: ModelConfig, spec: LayerSpec, cross_attn: bool = False):
    sp: Params = {"norm": _sds(cfg, (cfg.d_model,), F32)}
    ax: Params = {"norm": (None,)}
    if spec.mixer == "attn":
        _merge(sp, ax, _attn_specs(cfg))
    elif spec.mixer == "mla":
        _merge(sp, ax, _mla_specs(cfg))
    elif spec.mixer == "ssm":
        _merge(sp, ax, _ssm_specs(cfg))
    elif spec.mixer == "hybrid":
        sp["attn"], ax["attn"] = _attn_specs(cfg)
        s, a = _ssm_specs(cfg)
        del s["w_z"], a["w_z"]          # hymba branch: no gate path
        sp["ssm"], ax["ssm"] = s, a
        sp.update({"fuse_a": _sds(cfg, (cfg.d_model,), F32),
                   "fuse_s": _sds(cfg, (cfg.d_model,), F32)})
        ax.update({"fuse_a": (None,), "fuse_s": (None,)})
    else:
        raise ValueError(spec.mixer)
    if cross_attn:
        sp["cross"], ax["cross"] = _attn_specs(cfg)
        sp["cross_norm"] = _sds(cfg, (cfg.d_model,), F32)
        ax["cross_norm"] = (None,)
    if spec.mlp != "none":
        sp["mlp_norm"] = _sds(cfg, (cfg.d_model,), F32)
        ax["mlp_norm"] = (None,)
        _merge(sp, ax, _mlp_specs(cfg, spec.mlp))
    return sp, ax


def _merge(sp: Params, ax: Params, more) -> None:
    sp.update(more[0])
    ax.update(more[1])


def _stack(tree: Params, n: int) -> Params:
    return tree_map(lambda x: TensorSpec((n,) + x.shape, x.dtype), tree)


def _stack_axes(tree: Params) -> Params:
    """``tree`` of logical-axes tuples with a leading "layers" axis."""
    if isinstance(tree, dict):
        return {k: _stack_axes(v) for k, v in tree.items()}
    return ("layers",) + tuple(tree)


def param_specs(cfg: ModelConfig) -> Params:
    """The parameter tree's ``TensorSpec`` leaves: the reference's tree
    and shapes."""
    return _specs_and_axes(cfg)[0]


def logical_axes(cfg: ModelConfig) -> Params:
    """The parameter tree's logical axes (a tuple of axis names or None
    per leaf), read by ``launch.sharding``: the reference's."""
    return _specs_and_axes(cfg)[1]


def _specs_and_axes(cfg: ModelConfig):
    # the embedding's feature dim stays unsharded, as in the reference
    sp: Params = {"embed": _sds(cfg, (cfg.vocab, cfg.d_model)),
                  "final_norm": _sds(cfg, (cfg.d_model,), F32)}
    ax: Params = {"embed": ("vocab", None), "final_norm": (None,)}
    if cfg.pre:
        pre = [_layer_specs(cfg, spec) for spec in cfg.pre]
        sp["pre"] = tuple(s for s, _ in pre)
        ax["pre"] = tuple(a for _, a in pre)
    r = cfg.n_unit_repeats
    sp["unit"], ax["unit"] = {}, {}
    for i, spec in enumerate(cfg.unit):
        s, a = _layer_specs(cfg, spec, cross_attn=cfg.enc_dec)
        sp["unit"][f"u{i}"] = _stack(s, r)
        ax["unit"][f"u{i}"] = _stack_axes(a)
    if cfg.enc_dec:
        s, a = _layer_specs(cfg, LayerSpec(mixer="attn", mlp="dense"))
        sp["enc_unit"] = _stack(s, cfg.n_enc_layers)
        ax["enc_unit"] = _stack_axes(a)
        sp["enc_norm"] = _sds(cfg, (cfg.d_model,), F32)
        ax["enc_norm"] = (None,)
    return sp, ax


def _fix_ssm_init(params: Params) -> Params:
    """SSM decay init: A in [-1, -e] keeps exp(dt*A) in (0,1)."""
    for key, val in params.items():
        if isinstance(val, dict):
            _fix_ssm_init(val)
        elif isinstance(val, tuple):
            for v in val:
                _fix_ssm_init(v)
        elif key == "A_log":
            val.zero_()                       # A = -1
        elif key == "dt_bias":
            val.fill_(-2.0)                   # small positive dt
    return params


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Scaled-normal parameters drawn on ``device`` (default the card)
    from ``generator``, which lives on that device, with the reference's
    SSM fix-ups (``A_log`` = 0, ``dt_bias`` = -2)."""
    dev = resolve_device(device)
    with torch.no_grad():
        return _fix_ssm_init(init_from_specs(param_specs(cfg), generator,
                                             dev))


def params_from_reference(tree: Params, cfg: ModelConfig,
                          device=None) -> Params:
    """The JAX package's parameter tree (numpy or array-like leaves, any
    float dtype including bfloat16) as this package's, on ``device``:
    each leaf goes through float32 to the port's dtype for it."""
    dev = resolve_device(device)

    def walk(spec, ref, path):
        if isinstance(spec, dict):
            if set(spec) != set(ref):
                raise KeyError(f"{path or 'params'}: keys {sorted(ref)} "
                               f"where {sorted(spec)} were expected")
            return {k: walk(spec[k], ref[k], f"{path}/{k}") for k in spec}
        if isinstance(spec, tuple):
            if len(spec) != len(ref):
                raise KeyError(f"{path}: {len(ref)} entries, expected "
                               f"{len(spec)}")
            return tuple(walk(s, r, f"{path}/{i}")
                         for i, (s, r) in enumerate(zip(spec, ref)))
        arr = np.array(ref, dtype=np.float32)
        if arr.shape != spec.shape:
            raise ValueError(f"{path}: shape {arr.shape}, expected "
                             f"{spec.shape}")
        return torch.from_numpy(arr).to(device=dev, dtype=spec.dtype)
    return walk(param_specs(cfg), tree, "")


# ---------------------------------------------------------------------------
# Mixers (forward, full sequence)
# ---------------------------------------------------------------------------

def _attn_spec(cfg: ModelConfig, spec: LayerSpec, causal: bool = True):
    return AttnSpec(causal=causal, window=spec.window,
                    logit_softcap=cfg.attn_softcap)


def _qkv(p: Params, cfg: ModelConfig, x: torch.Tensor):
    b, s, _ = x.shape
    h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, kk, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, kk, v = q + p["bq"], kk + p["bk"], v + p["bv"]
    return (q.reshape(b, s, h, hd), kk.reshape(b, s, k, hd),
            v.reshape(b, s, k, hd))


def _rope_qk(cfg: ModelConfig, q, k, positions, positions3):
    if cfg.mrope and positions3 is not None:
        q = apply_mrope(q, positions3, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions3, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k


def attn_reshard_spec(n_heads: int) -> Optional[tuple]:
    """The partition spec the ``attn_reshard`` lever gives a (B, S, H,
    D) attention activation with ``n_heads`` heads under the current
    options, or None where it gives none: batch on the batch axes, heads
    on "model" where they divide it, else replicated over "model"."""
    opts = current()
    if opts.attn_reshard == "none" or opts.mesh is None:
        return None
    batch = opts.batch_axes if len(opts.batch_axes) > 1 \
        else opts.batch_axes[0]
    head_ax = "model" if n_heads % opts.mesh.shape["model"] == 0 else None
    return (batch, None, head_ax, None)


def _attn_reshard(t: torch.Tensor) -> torch.Tensor:
    """PerfOpts lever: the reference's sharding constraint on an
    attention activation (identity on one device)."""
    spec = attn_reshard_spec(t.shape[2])
    if spec is None:
        return t
    return with_sharding_constraint(t, current().mesh, spec)


def attn_mixer(p: Params, cfg: ModelConfig, spec: LayerSpec, x, positions,
               positions3=None, causal=True):
    q, k, v = _qkv(p, cfg, x)
    q, k, v = _attn_reshard(q), _attn_reshard(k), _attn_reshard(v)
    q, k = _rope_qk(cfg, q, k, positions, positions3)
    out = attention(q, k, v, _attn_spec(cfg, spec, causal))
    b, s, _, _ = q.shape
    y = out.reshape(b, s, -1) @ p["wo"]
    return y, {"k": k, "v": v}


def mla_mixer(p: Params, cfg: ModelConfig, spec: LayerSpec, x, positions):
    b, s, d = x.shape
    h = cfg.n_heads
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q = (x @ p["wq"]).reshape(b, s, h, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    dkv = x @ p["w_dkv"]
    ckv, k_rope = dkv[..., :cfg.kv_lora], dkv[..., cfg.kv_lora:]
    ckv = rms_norm(ckv, p["kv_norm"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)                   # (B,S,1,rd)
    k_nope = (ckv @ p["w_uk"]).reshape(b, s, h, nd)
    v = (ckv @ p["w_uv"]).reshape(b, s, h, vd)

    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(b, s, h, rd)], dim=-1)
    out = attention(qf, kf, v, _attn_spec(cfg, spec))
    y = out.reshape(b, s, h * vd) @ p["wo"]
    return y, {"ckv": ckv, "kr": k_rope[:, :, 0, :]}


def _ssm_inputs(p: Params, cfg: ModelConfig, x):
    xs = x @ p["w_x"]
    B = x @ p["w_B"]
    C = x @ p["w_C"]
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return xs, B, C, dt, A


def ssm_mixer(p: Params, cfg: ModelConfig, x, gated: bool = True):
    b, s, _ = x.shape
    h, hp = cfg.n_ssm_heads, cfg.ssm_headdim
    xs, B, C, dt, A = _ssm_inputs(p, cfg, x)
    y = ssm_mod.ssd_scan(xs.reshape(b, s, h, hp), dt, A, B, C,
                         p["D_skip"], cfg.ssm_chunk).reshape(b, s, -1)
    if gated and "w_z" in p:
        y = y * F.silu(x @ p["w_z"])
    y = rms_norm(y, p["ssm_norm"])
    return y @ p["out_proj"]


def hybrid_mixer(p: Params, cfg: ModelConfig, spec: LayerSpec, x, positions):
    ya, kv = attn_mixer(p["attn"], cfg, spec, x, positions)
    ys = ssm_mixer(p["ssm"], cfg, x, gated=False)
    y = 0.5 * (rms_norm(ya, p["fuse_a"]) + rms_norm(ys, p["fuse_s"]))
    return y, kv


def mlp_block(p: Params, cfg: ModelConfig, spec: LayerSpec, x):
    if spec.mlp == "none":
        return None
    h = rms_norm(x, p["mlp_norm"])
    if spec.mlp == "gated":
        return gated_mlp(h, p["wi"], p["wg"], p["wo_mlp"], cfg.act)
    if spec.mlp == "dense":
        return dense_mlp(h, p["wi"], p["wo_mlp"], cfg.act)
    shared = (p["swi"], p["swg"], p["swo"]) if "swi" in p else None
    return moe_mlp(h, p["router"], p["wi"], p["wg"], p["wo_mlp"],
                   cfg.top_k, cfg.act, shared)


# ---------------------------------------------------------------------------
# Full-sequence layer + stack
# ---------------------------------------------------------------------------

def _repeat(tree: Params, j: int) -> Params:
    """Repeat ``j`` of a stacked tree (views, so writes reach the stack)."""
    return tree_map(lambda t: t[j], tree)


def _unstack(tree: Params, n: int) -> list:
    """The ``n`` repeats of a stacked tree, from one ``unbind`` per leaf.
    Its backward stacks the repeats' gradients in one copy, where a view
    per repeat (``_repeat``) would add a zero-padded full-size gradient
    for every repeat."""
    parts = [t.unbind(0) for t in tree_leaves(tree)]
    return [tree_unflatten(tree, [u[j] for u in parts]) for j in range(n)]


def _cross_kv(p: Params, cfg: ModelConfig, enc_out):
    b, se, _ = enc_out.shape
    ck = (enc_out @ p["cross"]["wk"]).reshape(b, se, cfg.n_kv_heads,
                                              cfg.head_dim)
    cv = (enc_out @ p["cross"]["wv"]).reshape(b, se, cfg.n_kv_heads,
                                              cfg.head_dim)
    return ck, cv


def layer_forward(p: Params, cfg: ModelConfig, spec: LayerSpec, x,
                  positions, positions3=None, enc_out=None):
    """One transformer layer; returns (x, the mixer's K/V or None)."""
    h = rms_norm(x, p["norm"])
    if spec.mixer == "attn":
        y, kv = attn_mixer(p, cfg, spec, h, positions, positions3)
    elif spec.mixer == "mla":
        y, kv = mla_mixer(p, cfg, spec, h, positions)
    elif spec.mixer == "ssm":
        y, kv = ssm_mixer(p, cfg, h), None
    elif spec.mixer == "hybrid":
        y, kv = hybrid_mixer(p, cfg, spec, h, positions)
    else:
        raise ValueError(spec.mixer)
    x = x + y

    if enc_out is not None:                      # decoder cross-attention
        hc = rms_norm(x, p["cross_norm"])
        q, _, _ = _qkv(p["cross"], cfg, hc)
        ck, cv = _cross_kv(p, cfg, enc_out)
        out = attention(q, ck, cv, AttnSpec(causal=False))
        x = x + out.reshape(*out.shape[:2], -1) @ p["cross"]["wo"]

    y = mlp_block(p, cfg, spec, x)
    if y is not None:
        x = x + y
    return x, kv


def _cache_seq_len(cfg: ModelConfig, spec: LayerSpec, seq_len: int) -> int:
    if spec.window is not None:
        return min(seq_len, spec.window)
    return seq_len


def _embed(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    x = params["embed"][batch["tokens"]].to(cfg.dtype)
    if cfg.vision_stub and "vision_embeds" in batch:
        ve = batch["vision_embeds"].to(cfg.dtype)
        x = x.clone()
        x[:, :ve.shape[1]] = ve
    return x


def _positions(batch, s: int, device) -> torch.Tensor:
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=device)[None, :]
    return positions


def _checkpointed(remat: bool, fn, *args, policy: str = "full"):
    """``fn(*args)``, under activation checkpointing when ``remat`` is on
    and autograd records: its activations are recomputed in the
    backward instead of kept (the reference's ``jax.checkpoint``).
    ``policy="dots"`` keeps the outputs of matmuls without batch dims
    and recomputes the rest (``dots_with_no_batch_dims_saveable``)."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*args)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))
    return checkpoint(fn, *args, use_reentrant=False)


#: aten matmuls without batch dims: a (..., K) @ (K, N) projection
#: reaches ``mm``; the attention and MoE einsums reach ``bmm``
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _NO_BATCH_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: bool = False) -> torch.Tensor:
    """Token (+stub-modality) inputs -> final hidden states (B,S,D).

    ``remat`` checkpoints each repeat of the layer unit with the
    ``PerfOpts.remat_policy`` ("full" or "dots"), and each encoder layer
    fully whatever the policy, as the reference does."""
    x = _embed(params, cfg, batch)
    positions = _positions(batch, x.shape[1], x.device)
    positions3 = batch.get("positions3")

    enc_out = None
    if cfg.enc_dec:
        enc_out = encode(params, cfg, batch["enc_embeds"], remat=remat)

    for p, spec in zip(params.get("pre", ()), cfg.pre):
        x, _ = layer_forward(p, cfg, spec, x, positions, positions3, None)

    def unit(x, unit_p):
        for i, spec in enumerate(cfg.unit):
            x, _ = layer_forward(unit_p[f"u{i}"], cfg, spec, x, positions,
                                 positions3, enc_out)
        return x

    policy = current().remat_policy
    for unit_p in _unstack(params["unit"], cfg.n_unit_repeats):
        x = _checkpointed(remat, unit, x, unit_p, policy=policy)
    return rms_norm(x, params["final_norm"])


def encode(params: Params, cfg: ModelConfig, enc_embeds: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    x = enc_embeds.to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    spec = LayerSpec(mixer="attn", mlp="dense")

    def layer(x, p):
        h = rms_norm(x, p["norm"])
        y, _ = attn_mixer(p, cfg, spec, h, positions, causal=False)
        x = x + y
        return x + mlp_block(p, cfg, spec, x)

    for p in _unstack(params["enc_unit"], cfg.n_enc_layers):
        x = _checkpointed(remat, layer, x, p)
    return rms_norm(x, params["enc_norm"])


# ---------------------------------------------------------------------------
# Loss (chunked over sequence to bound the logits temp)
# ---------------------------------------------------------------------------

def logits_fn(params: Params, cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits in float32, with the logit softcap."""
    logits = (x @ params["embed"].T).float()
    return softcap(logits, cfg.logit_softcap)


def lm_loss(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            chunk: int = 512, remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy, chunked over the sequence.

    S must be a multiple of ``min(chunk, S)`` (the reference's reshape
    refuses a ragged last chunk too).  Each chunk's (B, chunk, vocab)
    float32 logits are recomputed in the backward instead of being kept
    for every chunk, as the reference checkpoints its chunk step."""
    x = forward(params, cfg, batch, remat=remat)
    labels = batch["labels"]
    b, s, d = x.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"lm_loss: S = {s} is not a multiple of "
                         f"chunk = {c} (min(chunk, S))")

    def nll(xc, lc):
        logits = logits_fn(params, cfg, xc)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.take_along_dim(logits, lc[..., None].long(),
                                  dim=-1)[..., 0]
        return torch.sum(lse - ll)

    tot = torch.zeros((), dtype=F32, device=x.device)
    for i in range(s // c):
        tot = tot + _checkpointed(True, nll, x[:, i * c:(i + 1) * c],
                                  labels[:, i * c:(i + 1) * c])
    return tot / (b * s)


# ---------------------------------------------------------------------------
# Serving: cache specs, prefill, decode
# ---------------------------------------------------------------------------

def _layer_cache_specs(cfg: ModelConfig, spec: LayerSpec, batch: int,
                       seq_len: int):
    cl = _cache_seq_len(cfg, spec, seq_len)
    k, hd = cfg.n_kv_heads, cfg.head_dim
    kv = _sds(cfg, (batch, cl, k, hd))
    kv_ax = ("batch", "kvseq", None, None)
    state = _sds(cfg, (batch, cfg.n_ssm_heads, cfg.ssm_headdim,
                       cfg.ssm_state), F32)
    state_ax = ("batch", "ssm_heads", None, None)
    if spec.mixer == "attn":
        return {"k": kv, "v": kv}, {"k": kv_ax, "v": kv_ax}
    if spec.mixer == "mla":
        return ({"ckv": _sds(cfg, (batch, cl, cfg.kv_lora)),
                 "kr": _sds(cfg, (batch, cl, cfg.qk_rope_dim))},
                {"ckv": ("batch", "kvseq", None),
                 "kr": ("batch", "kvseq", None)})
    if spec.mixer == "ssm":
        return {"h": state}, {"h": state_ax}
    if spec.mixer == "hybrid":
        return ({"k": kv, "v": kv, "h": state},
                {"k": kv_ax, "v": kv_ax, "h": state_ax})
    raise ValueError(spec.mixer)


def _cache_specs_and_axes(cfg: ModelConfig, batch: int, seq_len: int,
                          enc_len: int):
    sp: Params = {}
    ax: Params = {}
    if cfg.pre:
        pre = [_layer_cache_specs(cfg, spec, batch, seq_len)
               for spec in cfg.pre]
        sp["pre"] = tuple(s for s, _ in pre)
        ax["pre"] = tuple(a for _, a in pre)
    r = cfg.n_unit_repeats
    sp["unit"], ax["unit"] = {}, {}
    for i, spec in enumerate(cfg.unit):
        s, a = _layer_cache_specs(cfg, spec, batch, seq_len)
        sp["unit"][f"u{i}"] = _stack(s, r)
        ax["unit"][f"u{i}"] = _stack_axes(a)
    if cfg.enc_dec:
        k, hd = cfg.n_kv_heads, cfg.head_dim
        sp["cross"] = {"k": _sds(cfg, (r, batch, enc_len, k, hd)),
                       "v": _sds(cfg, (r, batch, enc_len, k, hd))}
        ax["cross"] = {"k": ("layers", "batch", None, None, None),
                       "v": ("layers", "batch", None, None, None)}
    return sp, ax


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int,
                enc_len: int = 0) -> Params:
    """The decode cache's ``TensorSpec`` tree (the reference's tree and
    shapes; K/V in ``cfg.dtype``, SSM states in float32)."""
    return _cache_specs_and_axes(cfg, batch, seq_len, enc_len)[0]


def cache_axes(cfg: ModelConfig, batch: int, seq_len: int,
               enc_len: int = 0) -> Params:
    """The decode cache's logical axes: the reference's."""
    return _cache_specs_and_axes(cfg, batch, seq_len, enc_len)[1]


def _decode_mixer(p, cfg, spec, h, cache, pos: int, positions3=None):
    """One-token mixer against the cache, which it updates in place;
    returns y.

    Under ``PerfOpts.decode_opt`` the mixer attends over the past
    entries plus the current token's K/V (append style) and writes the
    token into the cache afterwards; the reference's ``decode_step``
    writes every layer's token after its scan, which reads the same
    entries, because a layer attends over its own cache only."""
    b = h.shape[0]
    append = current().decode_opt
    if spec.mixer in ("attn", "hybrid"):
        ap = p["attn"] if spec.mixer == "hybrid" else p
        q, k, v = _qkv(ap, cfg, h)
        posv = torch.full((b, 1), pos, device=h.device)
        if cfg.mrope and positions3 is not None:
            q = apply_mrope(q, positions3, cfg.mrope_sections, cfg.rope_theta)
            k = apply_mrope(k, positions3, cfg.mrope_sections, cfg.rope_theta)
        else:
            q = apply_rope(q, posv, cfg.rope_theta)
            k = apply_rope(k, posv, cfg.rope_theta)
        cl = cache["k"].shape[1]
        slot = pos if spec.window is None else pos % cl
        aspec = AttnSpec(causal=True, window=None,
                         logit_softcap=cfg.attn_softcap)
        if append:
            length = pos if spec.window is None else min(pos, cl)
            inv = slot if spec.window is not None else None
            out = decode_attention(q, cache["k"], cache["v"], length, aspec,
                                   extra_kv=(k, v), invalid_slot=inv)
            cache_update(cache["k"], k, slot)
            cache_update(cache["v"], v, slot)
        else:
            cache_update(cache["k"], k, slot)
            cache_update(cache["v"], v, slot)
            # rolling window cache: slots < min(pos+1, cl) are valid
            length = pos + 1 if spec.window is None else min(pos + 1, cl)
            out = decode_attention(q, cache["k"], cache["v"], length, aspec)
        ya = out.reshape(b, 1, -1) @ ap["wo"]
        if spec.mixer == "attn":
            return ya
        # hybrid: add the SSM branch
        ys = _decode_ssm(p["ssm"], cfg, h, cache, gated=False)
        return 0.5 * (rms_norm(ya, p["fuse_a"]) + rms_norm(ys, p["fuse_s"]))

    if spec.mixer == "ssm":
        return _decode_ssm(p, cfg, h, cache, gated=True)

    if spec.mixer == "mla":
        # absorbed MLA decode: score against the compressed cache directly
        nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        hH = cfg.n_heads
        q = (h @ p["wq"]).reshape(b, 1, hH, nd + rd)
        q_nope, q_rope = q[..., :nd], q[..., nd:]
        posv = torch.full((b, 1), pos, device=h.device)
        q_rope = apply_rope(q_rope, posv, cfg.rope_theta)
        dkv = h @ p["w_dkv"]
        ckv_new = rms_norm(dkv[..., :cfg.kv_lora], p["kv_norm"])
        kr_new = apply_rope(dkv[:, :, None, cfg.kv_lora:], posv,
                            cfg.rope_theta)[:, :, 0]
        if append:
            ckv, kr, n_valid = cache["ckv"], cache["kr"], pos
        else:
            ckv = cache_update(cache["ckv"], ckv_new, pos)
            kr = cache_update(cache["kr"], kr_new, pos)
            n_valid = pos + 1
        # absorb W_uk into q: q' = q_nope @ W_uk^T  -> (B,H,lora)
        w_uk = p["w_uk"].reshape(cfg.kv_lora, hH, nd)
        q_abs = torch.einsum("bhd,lhd->bhl", q_nope[:, 0], w_uk).float()
        qr = q_rope[:, 0].float()
        scores = (torch.einsum("bhl,bsl->bhs", q_abs, ckv.float())
                  + torch.einsum("bhr,bsr->bhs", qr, kr.float()))
        valid = torch.arange(ckv.shape[1], device=h.device)[None] < n_valid
        scores = scores / math.sqrt(nd + rd)
        scores = torch.where(valid[:, None], scores, -1e30)
        if append:
            # two-part online softmax over the cache and the new token
            s_new = (torch.einsum("bhl,bsl->bhs", q_abs, ckv_new.float())
                     + torch.einsum("bhr,bsr->bhs", qr, kr_new.float())
                     )[..., 0] / math.sqrt(nd + rd)
            m = torch.maximum(scores.amax(dim=-1), s_new)
            p_cache = torch.exp(scores - m[..., None])
            p_new = torch.exp(s_new - m)
            denom = p_cache.sum(dim=-1) + p_new
            ctx = torch.einsum("bhs,bsl->bhl", p_cache, ckv.float())
            ctx = (ctx + p_new[..., None] * ckv_new[:, 0, None, :].float()) \
                / denom[..., None]
            cache_update(cache["ckv"], ckv_new, pos)
            cache_update(cache["kr"], kr_new, pos)
        else:
            pr = torch.softmax(scores, dim=-1)
            ctx = torch.einsum("bhs,bsl->bhl", pr, ckv.float())  # (B,H,lora)
        w_uv = p["w_uv"].reshape(cfg.kv_lora, hH, vd)
        out = torch.einsum("bhl,lhd->bhd", ctx, w_uv.float()).to(h.dtype)
        return (out.reshape(b, hH * vd) @ p["wo"])[:, None]

    raise ValueError(spec.mixer)


def _decode_ssm(p, cfg, h, cache, gated: bool):
    """One SSM step from ``cache["h"]``, which it replaces in place."""
    b = h.shape[0]
    xs = (h @ p["w_x"])[:, 0]
    B = (h @ p["w_B"])[:, 0]
    C = (h @ p["w_C"])[:, 0]
    dt = F.softplus((h @ p["w_dt"])[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    hs, hp_ = cfg.n_ssm_heads, cfg.ssm_headdim
    hn, y = ssm_mod.ssd_decode_step(cache["h"], xs.reshape(b, hs, hp_),
                                    dt, A, B, C, p["D_skip"])
    cache["h"].copy_(hn)
    y = y.reshape(b, 1, -1)
    if gated and "w_z" in p:
        y = y * F.silu((h @ p["w_z"])[:, 0])[:, None]
    y = rms_norm(y, p["ssm_norm"])
    return y @ p["out_proj"]


def _decode_layer(p, cfg, spec, x, c, pos, positions3, cross_kv=None):
    h = rms_norm(x, p["norm"])
    x = x + _decode_mixer(p, cfg, spec, h, c, pos, positions3)
    if cfg.enc_dec and cross_kv is not None:
        hc = rms_norm(x, p["cross_norm"])
        q, _, _ = _qkv(p["cross"], cfg, hc)
        out = decode_attention(q, cross_kv["k"], cross_kv["v"],
                               cross_kv["k"].shape[1],
                               AttnSpec(causal=False))
        x = x + out.reshape(x.shape[0], 1, -1) @ p["cross"]["wo"]
    y = mlp_block(p, cfg, spec, x)
    return x if y is None else x + y


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                batch: Dict[str, torch.Tensor], pos: int):
    """One token for every sequence in the batch, at position ``pos``.

    batch: {"tokens": (B,1)} (+ positions3 for M-RoPE).
    Returns (logits (B,1,V) fp32, cache) — the cache is updated in place
    and returned.
    """
    pos = int(pos)
    x = _embed(params, cfg, {"tokens": batch["tokens"]})
    positions3 = batch.get("positions3")

    for p, spec, c in zip(params.get("pre", ()), cfg.pre,
                          cache.get("pre", ())):
        x = _decode_layer(p, cfg, spec, x, c, pos, positions3)

    cross = cache.get("cross")
    for j in range(cfg.n_unit_repeats):
        for i, spec in enumerate(cfg.unit):
            key = f"u{i}"
            x = _decode_layer(_repeat(params["unit"][key], j), cfg, spec, x,
                              _repeat(cache["unit"][key], j), pos, positions3,
                              None if cross is None else _repeat(cross, j))
    x = rms_norm(x, params["final_norm"])
    return logits_fn(params, cfg, x), cache


def _fill_cache_entry(entry: Params, kv: Optional[Params]) -> None:
    """Write prefill-computed K/V into a cache entry: keep the last
    ``cache_len`` positions (window layers keep the window), the rest of
    the entry stays zero."""
    for key, val in (kv or {}).items():
        s, cache_len = val.shape[1], entry[key].shape[1]
        keep = min(cache_len, s)
        write_seq(entry[key], val[:, s - keep:], 0)


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            cache_len: Optional[int] = None, alloc=None):
    """Run the full prompt, return (last-position logits, decode cache).

    The cache is allocated once at ``cache_len`` (default the prompt
    length) for ``decode_step`` to update in place, by ``alloc`` (a
    ``TensorSpec`` tree -> the same tree of zero tensors; default plain
    zeros on the activations' device, where a DTensor program places
    them).  SSM/hybrid states come from running the chunked recurrence
    over the prompt."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache_len = cache_len or s
    x = _embed(params, cfg, batch)
    positions = _positions(batch, s, x.device)
    positions3 = batch.get("positions3")

    enc_out = None
    enc_len = 0
    if cfg.enc_dec:
        enc_out = encode(params, cfg, batch["enc_embeds"])
        enc_len = enc_out.shape[1]
    specs = cache_specs(cfg, b, cache_len, enc_len)
    cache = alloc(specs) if alloc is not None else tree_map(
        lambda t: torch.zeros(t.shape, dtype=t.dtype, device=x.device),
        specs)

    for p, spec, c in zip(params.get("pre", ()), cfg.pre,
                          cache.get("pre", ())):
        xin = x
        x, kv = layer_forward(p, cfg, spec, x, positions, positions3,
                              enc_out)
        _fill_cache_entry(c, kv)
        _prefill_ssm_state(p, cfg, spec, c, xin)

    for j in range(cfg.n_unit_repeats):
        for i, spec in enumerate(cfg.unit):
            p = _repeat(params["unit"][f"u{i}"], j)
            c = _repeat(cache["unit"][f"u{i}"], j)
            xin = x
            x, kv = layer_forward(p, cfg, spec, x, positions, positions3,
                                  enc_out)
            _fill_cache_entry(c, kv)
            _prefill_ssm_state(p, cfg, spec, c, xin)
            if cfg.enc_dec:
                ck, cv = _cross_kv(p, cfg, enc_out)
                cache["cross"]["k"][j] = ck
                cache["cross"]["v"][j] = cv
    x = rms_norm(x, params["final_norm"])
    return logits_fn(params, cfg, x[:, -1:]), cache


def _prefill_ssm_state(p, cfg, spec, c, xin) -> None:
    """Write the post-prompt SSM state into a prefill cache entry."""
    if spec.mixer not in ("ssm", "hybrid"):
        return
    pp = p["ssm"] if spec.mixer == "hybrid" else p
    h = rms_norm(xin, p["norm"])
    b, s, _ = h.shape
    hs, hp_ = cfg.n_ssm_heads, cfg.ssm_headdim
    xs, B, _, dt, A = _ssm_inputs(pp, cfg, h)
    c["h"].copy_(ssm_mod.ssd_final_state(xs.reshape(b, s, hs, hp_), dt, A,
                                         B, cfg.ssm_chunk))
