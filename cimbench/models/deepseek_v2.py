"""DeepSeek-V2-Lite (DeepSeek-AI, arXiv:2405.04434; ``config.json`` and
``modeling_deepseek.py`` of deepseek-ai/DeepSeek-V2-Lite) as a plain
layer list for ``cimbench.reference``, with the operators the reference
lacks in ``OPS``.

One input is one prompt's int8 embedding rows (``prompt_tokens``,
``hidden_size``) at positions 0, 1, ..., clipped to int8 (``embed``).
Layers are named as the served graph names its nodes.  Each layer
``l{i}.`` is pre-norm:

* multi-head latent attention: ``attn_norm``; ``wq`` gives each head's
  ``qk_nope_head_dim`` part and its ``qk_rope_head_dim`` part; ``wkva``
  the latent ``c_kv`` (``kv_lora_rank``) and one rope key for all heads;
  ``kv_norm`` and ``wkvb`` each head's key and value part; both rope
  parts take YaRN's rotary embedding (``rope``), the rope key is
  repeated over the heads; the scores ``qkt`` go through a causal
  ``softmax`` scaled by ``q_head_dim ** -0.5 * mscale**2``, then ``av``,
  the heads merge, ``wo`` and the residual ``res1``;
* ``ffn_norm``, then the first ``first_k_dense_replace`` layers a dense
  SwiGLU (``w_gate``, ``act``, ``w_up``, ``gu``, ``w_down``) of
  ``intermediate_size``; the others a mixture of experts: ``router``
  gives one logit for each of the published ``n_routed_experts`` of the
  source, ``route`` their softmax's top ``num_experts_per_tok`` as gates,
  each held expert ``e{j}.`` a SwiGLU of ``moe_intermediate_size`` on
  every token, ``moe`` the gated sum of the held experts' rows over the
  tokens routed to them, ``shared.`` the shared experts, one SwiGLU of
  ``n_shared_experts * moe_intermediate_size``; ``ffn`` and ``res2``;

then ``norm``, the last position (``last``) and ``lm_head`` over the
vocabulary slice.  The weights are keyed by the crossbar layers' names.

The flow's conventions (departures from the source):

* int8 fake quantisation: every crossbar layer, ``add``, ``matmul``,
  ``mul`` and ``moe`` requantises its integer accumulator by a
  calibrated right shift; RMSNorm (no gain, ``rms_norm_eps``), SiLU and
  Softmax run in float64 on the int8-grid values and return ``round(y *
  32)`` clamped to [-128, 127]; the rotary embedding returns ``round(y)``
  clamped, since a rotation keeps its operand's scale;
* a gate is ``clamp(round(32 * w))`` of the token's softmax weight ``w``,
  not renormalised (``norm_topk_prob`` false), times
  ``routed_scaling_factor``; equal weights go to the lower expert; the
  router's output is a token's gate for each routed expert and -1 for
  the others;
* the rotary tables are float64, where the source computes them in
  float32.

Every expert runs on every token here, which gives the routed tokens'
rows exactly and calibrates each expert's shifts over every token of
the calibration prompt.  A ``release`` layer frees the memory of the
tensors no later layer reads, so that a forward of a block of prompts
of 2048 tokens fits one card beside the crossbar planes.

Imports torch and the standard library only.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

#: ops whose output shares its first input's memory
_VIEWS = ("reshape", "transpose", "split", "repeat")


def _published(cfg: Dict, key: str):
    """A count as the source publishes it, where the configuration
    holds this chip's share of it."""
    return cfg.get("published", {}).get(key, cfg[key])


def rows_per_expert(cfg: Dict) -> int:
    """Tokens a held expert takes from one prompt on average: its share
    ``num_experts_per_tok / n_routed_experts`` of the prompt."""
    return cfg["prompt_tokens"] * cfg["num_experts_per_tok"] \
        // _published(cfg, "n_routed_experts")


def layers(cfg: Dict) -> List[Dict]:
    t, d = cfg["prompt_tokens"], cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    lora = cfg["kv_lora_rank"]
    moe_ff = cfg["moe_intermediate_size"]
    out: List[Dict] = []

    def op(kind, name, inputs, **kw):
        out.append(dict(op=kind, name=name, inputs=inputs,
                        output=f"{name}.out", **kw))
        return f"{name}.out"

    def gemm(name, x, cin, cout, rows=t):
        return op("fc", name, [x], cin=cin, cout=cout, rows=rows)

    def part(name, x, axis, parts, index):
        return op("split", name, [x], axis=axis, parts=parts, index=index)

    def swiglu(p, x, width, rows=t):
        g = op("silu", f"{p}act", [gemm(f"{p}w_gate", x, d, width, rows)])
        u = gemm(f"{p}w_up", x, d, width, rows)
        g = op("mul", f"{p}gu", [g, u], requant=True)
        return gemm(f"{p}w_down", g, width, d, rows)

    def rotary(name, x):
        return op("rope", name, [x], dim=rope, theta=cfg["rope_theta"],
                  **cfg["rope_scaling"])

    x = op("clip", "embed", ["input"], min=-128, max=127)
    for i in range(cfg["num_hidden_layers"]):
        p = f"l{i}."
        h = op("rmsnorm", f"{p}attn_norm", [x])
        q = op("reshape", f"{p}q.split",
               [gemm(f"{p}wq", h, d, heads * (nope + rope))],
               shape=(t, heads, nope + rope))
        q_pe = rotary(f"{p}q_rope", part(f"{p}q.pe", q, -1, (nope, rope), 1))
        q = op("concat", f"{p}q.cat",
               [part(f"{p}q.nope", q, -1, (nope, rope), 0), q_pe], axis=-1)
        q = op("transpose", f"{p}q.heads", [q], perm=(1, 0, 2))
        kva = gemm(f"{p}wkva", h, d, lora + rope)
        c_kv = part(f"{p}kva.ckv", kva, -1, (lora, rope), 0)
        k_pe = rotary(f"{p}k_rope", part(f"{p}kva.kpe", kva, -1,
                                        (lora, rope), 1))
        kv = gemm(f"{p}wkvb", op("rmsnorm", f"{p}kv_norm", [c_kv]), lora,
                  heads * (nope + vd))
        kv = op("reshape", f"{p}kv.split", [kv], shape=(t, heads, nope + vd))
        k_pe = op("repeat", f"{p}k_pe.heads", [k_pe], heads=heads)
        k = op("concat", f"{p}k.cat",
               [part(f"{p}kv.k", kv, -1, (nope, vd), 0), k_pe], axis=-1)
        k = op("transpose", f"{p}k.heads", [k], perm=(1, 0, 2))
        v = op("transpose", f"{p}v.heads",
               [part(f"{p}kv.v", kv, -1, (nope, vd), 1)], perm=(1, 0, 2))
        a = op("matmul", f"{p}qkt", [q, k], transpose_b=True, requant=True)
        a = op("softmax", f"{p}smax", [a], causal=True,
               scale=attention_scale(cfg))
        a = op("matmul", f"{p}av", [a, v], requant=True)
        a = op("transpose", f"{p}merge", [a], perm=(1, 0, 2))
        a = op("reshape", f"{p}merge.flat", [a], shape=(t, heads * vd))
        x = op("add", f"{p}res1", [x, gemm(f"{p}wo", a, heads * vd, d)])
        h = op("rmsnorm", f"{p}ffn_norm", [x])
        if i < cfg["first_k_dense_replace"]:
            y = swiglu(p, h, cfg["intermediate_size"])
        else:
            r = op("router", f"{p}route",
                   [gemm(f"{p}router", h, d,
                         _published(cfg, "n_routed_experts"))],
                   top_k=cfg["num_experts_per_tok"],
                   scaling=cfg["routed_scaling_factor"])
            held = cfg["experts_held"]
            outs = [swiglu(f"{p}e{e}.", h, moe_ff, rows_per_expert(cfg))
                    for e in held]
            y = op("moe", f"{p}moe", [r] + outs, experts=held, requant=True)
            y = op("add", f"{p}ffn",
                   [y, swiglu(f"{p}shared.", h,
                              cfg["n_shared_experts"] * moe_ff)])
        x = op("add", f"{p}res2", [x, y])
    x = op("rmsnorm", "norm", [x])
    x = part("last", x, 0, (t - 1, 1), 1)
    gemm("lm_head", x, d, cfg["vocab_size"], rows=1)
    return _with_releases(out, {"input", *cfg["outputs"]})


def _with_releases(layers: List[Dict], keep) -> List[Dict]:
    """``layers`` with a ``release`` layer after each last read of a
    tensor and of the views of it, none of them in ``keep`` (the input
    may be the caller's own memory)."""
    root = {"input": "input"}
    for layer in layers:
        o = layer["output"]
        root[o] = root[layer["inputs"][0]] if layer["op"] in _VIEWS else o
    group: Dict[str, List[str]] = {}
    for name, r in root.items():
        group.setdefault(r, []).append(name)
    last = {}
    for i, layer in enumerate(layers):
        for name in layer["inputs"]:
            last[root[name]] = i
    dead: Dict[int, List[str]] = {}
    for r, i in last.items():
        if not keep.intersection(group[r]):
            dead.setdefault(i, []).extend(group[r])
    out = []
    for i, layer in enumerate(layers):
        out.append(layer)
        if i in dead:
            name = f"{layer['name']}.release"
            out.append(dict(op="release", name=name, inputs=dead[i],
                            output=f"{name}.out"))
    return out


def input_shape(cfg: Dict):
    return (cfg["prompt_tokens"], cfg["hidden_size"])


def build_kwargs(cfg: Dict) -> Dict:
    """The served graph builder's keyword arguments."""
    sc = cfg["rope_scaling"]
    return dict(
        seq=cfg["prompt_tokens"], d=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        qk_nope=cfg["qk_nope_head_dim"], qk_rope=cfg["qk_rope_head_dim"],
        v_dim=cfg["v_head_dim"], kv_lora=cfg["kv_lora_rank"],
        d_ff=cfg["intermediate_size"], moe_d_ff=cfg["moe_intermediate_size"],
        n_experts=_published(cfg, "n_routed_experts"),
        top_k=cfg["num_experts_per_tok"], n_shared=cfg["n_shared_experts"],
        first_k_dense=cfg["first_k_dense_replace"],
        experts_held=tuple(cfg["experts_held"]), vocab=cfg["vocab_size"],
        yarn=dict(base=float(cfg["rope_theta"]),
                  **{k: sc[k] for k in (
                      "factor", "original_max_position_embeddings",
                      "beta_fast", "beta_slow", "mscale",
                      "mscale_all_dim")}))


# -- the operators the reference lacks -------------------------------------------

def _mscale(scale: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def attention_scale(cfg: Dict) -> float:
    """``softmax_scale`` of ``DeepseekV2Attention`` under YaRN."""
    sc = cfg["rope_scaling"]
    m = _mscale(sc["factor"], sc["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def rope_tables(layer: Dict, n_pos: int, device):
    """cos and sin (n_pos, dim) of ``DeepseekV2YarnRotaryEmbedding``, in
    float64."""
    dim, base = layer["dim"], float(layer["theta"])
    factor = layer["factor"]
    max_pos = layer["original_max_position_embeddings"]

    def correction_dim(rotations):
        return (dim * math.log(max_pos / (rotations * 2 * math.pi))) \
            / (2 * math.log(base))

    low = max(math.floor(correction_dim(layer["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(layer["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    f64 = dict(dtype=torch.float64, device=device)
    ramp = torch.clamp((torch.arange(dim // 2, **f64) - low) / (high - low),
                       0, 1)
    mask = 1.0 - ramp
    pos = torch.arange(0, dim, 2, **f64) / dim
    extra = 1.0 / base ** pos
    inter = 1.0 / (factor * base ** pos)
    inv_freq = inter * (1 - mask) + extra * mask
    freqs = torch.outer(torch.arange(n_pos, **f64), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    m = _mscale(factor, layer["mscale"]) \
        / _mscale(factor, layer["mscale_all_dim"])
    return emb.cos() * m, emb.sin() * m


def _clip(xs, layer):
    return torch.clamp(xs[0], layer["min"], layer["max"])


def _rope(xs, layer):
    """``apply_rotary_pos_emb``: interleaved pairs to halves, then ``x *
    cos + rotate_half(x) * sin`` at the positions of axis 1."""
    x = xs[0]
    b, t, dim = x.shape[0], x.shape[1], x.shape[-1]
    cos, sin = rope_tables(layer, t, x.device)
    shape = (t,) + (1,) * (x.dim() - 3) + (dim,)
    x = x.reshape(*x.shape[:-1], dim // 2, 2).transpose(-1, -2) \
        .reshape(x.shape).to(torch.float64)
    rot = torch.cat((-x[..., dim // 2:], x[..., :dim // 2]), dim=-1)
    y = x * cos.reshape(shape) + rot * sin.reshape(shape)
    return torch.clamp(torch.round(y), -128, 127).to(torch.int64)


def _axis(layer, x) -> int:
    """A per-prompt axis as an axis of the batched tensor ``x``."""
    return layer["axis"] % (x.dim() - 1) + 1


def _reshape(xs, layer):
    return xs[0].reshape(xs[0].shape[0], *layer["shape"])


def _transpose(xs, layer):
    return xs[0].permute(0, *(p + 1 for p in layer["perm"]))


def _split(xs, layer):
    """Part ``index`` of ``parts`` along ``axis``."""
    parts, i = layer["parts"], layer["index"]
    return xs[0].narrow(_axis(layer, xs[0]), sum(parts[:i]), parts[i])


def _concat(xs, layer):
    return torch.cat([x.to(torch.int64) for x in xs],
                     dim=_axis(layer, xs[0]))


def _repeat(xs, layer):
    """(B, T, dim) -> (B, T, heads, dim): one rope key for every head."""
    x = xs[0]
    return x[:, :, None, :].expand(-1, -1, layer["heads"], -1)


def _matmul(xs, layer):
    """Activation x activation product, exact in float64 (int8
    operands), one prompt at a time; int32 holds the product."""
    outs = []
    for a, b in zip(xs[0], xs[1]):
        if layer.get("transpose_b"):
            b = b.transpose(-1, -2)
        outs.append((a.to(torch.float64) @ b.to(torch.float64))
                    .to(torch.int32))
    return torch.stack(outs)


def _requant(y):
    return torch.clamp(torch.round(y * 32.0), -128, 127)


def _softmax_rows(x, layer):
    x = x.to(torch.float64) * layer.get("scale", 1.0)
    if layer.get("causal"):
        n_q, n_k = x.shape[-2:]
        keep = torch.ones(n_q, n_k, dtype=torch.bool,
                          device=x.device).tril(n_k - n_q)
        x = x.masked_fill(~keep, float("-inf"))
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _softmax(xs, layer):
    """One prompt at a time; the (heads, T, T) answers held as int8."""
    return torch.stack([_requant(_softmax_rows(x, layer)).to(torch.int8)
                        for x in xs[0]])


def _rmsnorm(xs, layer):
    x = xs[0].to(torch.float64)
    y = x / torch.sqrt((x ** 2).mean(dim=-1, keepdim=True) + 1e-6)
    return _requant(y).to(torch.int64)


def _silu(xs, layer):
    x = xs[0].to(torch.float64)
    return _requant(x / (1.0 + torch.exp(-x))).to(torch.int64)


def _mul(xs, layer):
    return xs[0].to(torch.int64) * xs[1].to(torch.int64)


def _router(xs, layer):
    """Each token's gate for its ``top_k`` experts by softmax weight (the
    lower expert first among equal weights), -1 for the others."""
    w = _softmax_rows(xs[0], {}) * layer["scaling"]
    order = torch.sort(w, dim=-1, descending=True, stable=True).indices
    routed = torch.zeros_like(w, dtype=torch.bool).scatter_(
        -1, order[..., :layer["top_k"]], True)
    return torch.where(routed, _requant(w), -1.0).to(torch.int64)


def _moe(xs, layer):
    """Sum over the held experts of each routed token's gate times the
    expert's row; the reference requantises it."""
    gates, outs = xs[0], xs[1:]
    y = torch.zeros(outs[0].shape, dtype=torch.int64, device=gates.device)
    for e, out in zip(layer["experts"], outs):
        y += torch.clamp(gates[..., e], min=0)[..., None] * out
    return y


def _release(xs, layer):
    for x in xs:
        x.untyped_storage().resize_(0)
    return torch.empty(0)


OPS = {
    "clip": _clip, "reshape": _reshape, "transpose": _transpose,
    "split": _split,
    "concat": _concat, "repeat": _repeat, "matmul": _matmul,
    "softmax": _softmax, "rmsnorm": _rmsnorm, "silu": _silu, "mul": _mul,
    "rope": _rope, "router": _router, "moe": _moe, "release": _release,
}
