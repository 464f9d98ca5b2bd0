"""The port's LM substrate against the JAX package's, on the CPU.

Every case feeds the same inputs, made by numpy from a seed, through
``repro.models`` and ``repro_torch.models``.  The layers (norms, RoPE
and M-RoPE, blockwise attention with several blocks and a padded tail,
decode attention), the SSD scan and the decode step agree to 1e-5
absolute in float32, times the output's largest magnitude where that
exceeds 1 (the SSD's outputs reach ~5 on these inputs, and another
summation order moves them by a few float32 ulps).  For every
architecture's ``reduced()`` config in float32, ``forward``, ``prefill``
and two ``decode_step`` calls agree to 1e-4 of the largest reference
logit, with greedy tokens equal.  Reference parameters are drawn by
numpy from a seed at the reference's spec dtypes (bfloat16 weights) and
reach the port through ``params_from_reference``.  The reference runs
under ``jax.jit``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm

ATOL = 1e-5          # layers and SSD, float32
REL = 1e-4           # logits, max |delta| / max |ref|
B, S = 2, 24


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.detach().float().numpy()


def f32_configs(name: str):
    """(reference, port) ``reduced()`` configs of ``name`` in float32."""
    return (dataclasses.replace(jreduced(JARCHS[name]), dtype=jnp.float32),
            dataclasses.replace(reduced(ARCHS[name]), dtype=torch.float32))


def ref_params(jcfg, seed: int = 0):
    """Reference parameters drawn by numpy at the reference's spec
    dtypes, with ``init_params``'s SSM fix-ups."""
    rng = np.random.default_rng(seed)

    def draw(path, spec):
        name = path[-1].key
        if name == "A_log":
            return jnp.zeros(spec.shape, spec.dtype)
        if name == "dt_bias":
            return jnp.full(spec.shape, -2.0, spec.dtype)
        return jnp.asarray(rng.normal(size=spec.shape) * 0.02, spec.dtype)
    return jax.tree_util.tree_map_with_path(draw, jlm.param_specs(jcfg))


def both_params(name: str, seed: int = 0):
    jcfg, tcfg = f32_configs(name)
    jp = ref_params(jcfg, seed)
    return jcfg, tcfg, jp, tlm.params_from_reference(
        jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def close(got, want) -> None:
    """|got - want| <= ATOL, scaled by max |want| where that exceeds 1."""
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(_np(got), want, atol=ATOL * scale, rtol=0)


def rel_err(got, want) -> float:
    want = _np(want)
    return float(np.abs(_np(got) - want).max() / (np.abs(want).max() + 1e-9))


# ------------------------------------------------------------- layers

@pytest.mark.parametrize("plus_one", [False, True])
def test_norms_and_softcap_match_reference(plus_one):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32) * 3
    scale = rng.normal(size=(32,)).astype(np.float32)
    bias = rng.normal(size=(32,)).astype(np.float32)
    jx, js, jb = map(jnp.asarray, (x, scale, bias))
    close(tlayers.rms_norm(_t(x), _t(scale), plus_one=plus_one),
          jlayers.rms_norm(jx, js, plus_one=plus_one))
    close(tlayers.layer_norm(_t(x), _t(scale), _t(bias)),
          jlayers.layer_norm(jx, js, jb))
    close(tlayers.softcap(_t(x), 2.5), jlayers.softcap(jx, 2.5))


@pytest.mark.parametrize("theta", [10000.0, 100000.0])
def test_rope_and_mrope_match_reference(theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7))
    close(tlayers.apply_rope(_t(x), _t(pos), theta),
          jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    pos3 = rng.integers(0, 300, (3, 2, 7))
    close(tlayers.apply_mrope(_t(x), _t(pos3), (2, 3, 3), theta),
          jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), (2, 3, 3),
                              theta))


ATTN_CASES = [
    # (s, hq, hkv, causal, window, softcap, q_block, kv_block)
    (37, 4, 4, True, None, None, 8, 16),      # causal MHA, padded tails
    (37, 4, 2, True, 5, None, 16, 8),         # sliding window, GQA
    (30, 4, 1, False, None, 20.0, 8, 8),      # bidirectional, softcap, MQA
    (33, 6, 2, True, 16, 50.0, 16, 16),       # window + softcap + GQA
    (20, 2, 2, False, 7, None, 32, 32),       # one block, window
]


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_attention_matches_reference(case):
    s, hq, hkv, causal, window, cap, qb, kb = case
    rng = np.random.default_rng(s * 7 + hq)
    q = rng.normal(size=(2, s, hq, 8)).astype(np.float32)
    k = rng.normal(size=(2, s, hkv, 8)).astype(np.float32)
    v = rng.normal(size=(2, s, hkv, 8)).astype(np.float32)
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_block=qb,
              kv_block=kb)
    got = tlayers.attention(_t(q), _t(k), _t(v), tlayers.AttnSpec(**kw))
    want = jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jlayers.AttnSpec(**kw))
    assert got.shape == want.shape
    close(got, want)


@pytest.mark.parametrize("hkv,length,window,cap", [
    (2, 33, None, 50.0), (4, 20, None, None), (1, 33, 6, None),
    (2, 9, 4, 30.0)])
def test_decode_attention_matches_reference(hkv, length, window, cap):
    rng = np.random.default_rng(length + hkv)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 33, hkv, 16)).astype(np.float32)
    v = rng.normal(size=(2, 33, hkv, 16)).astype(np.float32)
    kw = dict(causal=True, window=window, logit_softcap=cap)
    got = tlayers.decode_attention(_t(q), _t(k), _t(v), length,
                                   tlayers.AttnSpec(**kw))
    want = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.int32(length),
                                    jlayers.AttnSpec(**kw))
    close(got, want)


def test_cache_update_writes_in_place_and_clamps():
    rng = np.random.default_rng(3)
    cache = rng.normal(size=(2, 6, 2, 4)).astype(np.float32)
    new = rng.normal(size=(2, 1, 2, 4)).astype(np.float32)
    for pos in (0, 3, 5, 9):
        tc = _t(cache)
        out = tlayers.cache_update(tc, _t(new), pos)
        assert out is tc
        np.testing.assert_array_equal(
            _np(tc), _np(jlayers.cache_update(jnp.asarray(cache),
                                              jnp.asarray(new),
                                              jnp.int32(pos))))


def _ssd_inputs(s, h, seed):
    rng = np.random.default_rng(seed)
    p, n, bt = 4, 8, 2
    x = rng.normal(size=(bt, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(bt, s, h)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,)) * 0.3).astype(np.float32)
    Bm = rng.normal(size=(bt, s, n)).astype(np.float32)
    C = rng.normal(size=(bt, s, n)).astype(np.float32)
    D = rng.normal(size=(h,)).astype(np.float32)
    return x, dt, A, Bm, C, D


@pytest.mark.parametrize("s,h,chunk", [(37, 4, 8), (16, 1, 16), (50, 2, 32)])
def test_ssd_scan_matches_reference(s, h, chunk):
    ins = _ssd_inputs(s, h, s * 13 + h)
    got = tssm.ssd_scan(*map(_t, ins), chunk=chunk)
    want = jssm.ssd_scan(*map(jnp.asarray, ins), chunk=chunk)
    close(got, want)
    close(tssm.ssd_reference(*map(_t, ins)),
          jssm.ssd_reference(*map(jnp.asarray, ins)))
    dtA = _t(ins[1][0, :, 0] * ins[2][0])
    np.testing.assert_allclose(_np(tssm.segsum(dtA)),
                               _np(jssm.segsum(jnp.asarray(_np(dtA)))),
                               atol=ATOL, rtol=0)


def test_ssd_decode_step_matches_reference():
    x, dt, A, Bm, C, D = _ssd_inputs(3, 4, 5)
    h0 = np.random.default_rng(6).normal(size=(2, 4, 4, 8)).astype(
        np.float32)
    args = (h0, x[:, 0], dt[:, 0], A, Bm[:, 0], C[:, 0], D)
    got = tssm.ssd_decode_step(*map(_t, args))
    want = jssm.ssd_decode_step(*map(jnp.asarray, args))
    for g, w in zip(got, want):
        close(g, w)


# ------------------------------------------------------ architectures

def _inputs(jcfg, n: int, seed: int = 0):
    """A seeded numpy batch of ``n`` tokens (+ stub modalities)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (B, n))}
    if jcfg.vision_stub:
        batch["vision_embeds"] = (rng.normal(size=(
            B, jcfg.n_vision_tokens, jcfg.d_model)) * 0.1).astype(np.float32)
        batch["positions3"] = np.broadcast_to(
            np.arange(n)[None, None], (3, B, n)).copy()
    if jcfg.enc_dec:
        batch["enc_embeds"] = (rng.normal(size=(B, 8, jcfg.d_model))
                               * 0.1).astype(np.float32)
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_arch_specs_and_param_count_match_reference(name):
    for jcfg, tcfg in ((JARCHS[name], ARCHS[name]), f32_configs(name)):
        want = jax.tree.map(lambda s: tuple(s.shape), jlm.param_specs(jcfg))
        got = tlayers.tree_map(lambda s: s.shape, tlm.param_specs(tcfg))
        assert got == want
        assert tcfg.param_count() == jcfg.param_count()
        cs = tlayers.tree_map(lambda s: s.shape, tlm.cache_specs(tcfg, 2, 40, 8))
        assert cs == jax.tree.map(lambda s: tuple(s.shape),
                                  jlm.cache_specs(jcfg, 2, 40, 8)[0])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_arch_forward_prefill_decode_match_reference(name):
    jcfg, tcfg, jp, tp = both_params(name, seed=1)
    full = _inputs(jcfg, S + 2)
    prompt = dict(full, tokens=full["tokens"][:, :S])
    if jcfg.vision_stub:
        prompt["positions3"] = full["positions3"][:, :, :S]

    fwd = jax.jit(lambda p, b: jlm.logits_fn(p, jcfg, jlm.forward(p, jcfg, b)))
    want = fwd(jp, _jb(full))
    got = tlm.logits_fn(tp, tcfg, tlm.forward(tp, tcfg, _tb(full)))
    assert rel_err(got, want) <= REL

    cache_len = S + 4
    pre = jax.jit(lambda p, b: jlm.prefill(p, jcfg, b, cache_len=cache_len))
    jl, jc = pre(jp, _jb(prompt))
    tl, tc = tlm.prefill(tp, tcfg, _tb(prompt), cache_len=cache_len)
    assert tl.shape == jl.shape and rel_err(tl, jl) <= REL
    assert tlayers.tree_map(lambda t: tuple(t.shape), tc) == \
        jax.tree.map(lambda t: t.shape, jc)

    dec = jax.jit(lambda p, c, b, pos: jlm.decode_step(p, jcfg, c, b, pos))
    for pos in (S, S + 1):
        step = {"tokens": full["tokens"][:, pos:pos + 1]}
        if jcfg.mrope:
            step["positions3"] = np.full((3, B, 1), pos)
        jl, jc = dec(jp, jc, _jb(step), jnp.int32(pos))
        tl, tc2 = tlm.decode_step(tp, tcfg, tc, _tb(step), pos)
        assert tc2 is tc                          # updated in place
        assert rel_err(tl, jl) <= REL, pos
        np.testing.assert_array_equal(_np(tl).argmax(-1),
                                      _np(jl).argmax(-1))
        for got_leaf, want_leaf in zip(tlayers.tree_leaves(tc),
                                       jax.tree.leaves(jc)):
            close(got_leaf, want_leaf)


@pytest.mark.parametrize("prompt", [16, 13])
def test_rolling_window_cache_matches_reference(prompt):
    """A window (8) smaller than the prompt: prefill keeps the window's
    last positions in slots 0..7 and decode writes slot ``pos % 8`` —
    the same cache, slot for slot, and the same logits as the reference.
    A reference property rides along: the two slot rules agree only when
    the prompt length is a multiple of the window, so at 13 the
    reference's decode evicts the wrong position and departs from its
    own forward; the port departs the same way."""
    jcfg, tcfg = f32_configs("gemma2-2b")
    unit = tuple(dataclasses.replace(u, window=u.window and 8)
                 for u in jcfg.unit)
    jcfg = dataclasses.replace(jcfg, unit=unit)
    tcfg = dataclasses.replace(tcfg, unit=unit)
    jp = ref_params(jcfg, 4)
    tp = tlm.params_from_reference(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (B, prompt + 4))
    full = tlm.logits_fn(tp, tcfg, tlm.forward(tp, tcfg, {"tokens": _t(toks)}))
    jl, jc = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :prompt])},
                         cache_len=prompt + 4)
    tl, tc = tlm.prefill(tp, tcfg, {"tokens": _t(toks[:, :prompt])},
                         cache_len=prompt + 4)
    assert tc["unit"]["u0"]["k"].shape[2] == 8     # window layer's cache
    dec = jax.jit(lambda p, c, b, pos: jlm.decode_step(p, jcfg, c, b, pos))
    drift = []
    for pos in range(prompt, prompt + 4):
        step = toks[:, pos:pos + 1]
        jl, jc = dec(jp, jc, {"tokens": jnp.asarray(step)}, jnp.int32(pos))
        tl, tc = tlm.decode_step(tp, tcfg, tc, {"tokens": _t(step)}, pos)
        assert rel_err(tl, jl) <= REL, pos
        for got_leaf, want_leaf in zip(tlayers.tree_leaves(tc),
                                       jax.tree.leaves(jc)):
            close(got_leaf, want_leaf)
        drift.append(rel_err(tl[:, 0], full[:, pos]))
    if prompt % 8 == 0:
        assert max(drift) <= REL
    else:
        assert min(drift) > 10 * REL


def test_decode_past_the_cache_clamps_like_reference():
    """``prefill`` without ``cache_len`` sizes the cache to the prompt,
    so a decode at pos = S writes slot S - 1 (``dynamic_update_slice``
    clamps its start) and no longer sees position S - 1: the reference
    test's decode-vs-forward gap.  The port clamps the same way."""
    jcfg, tcfg, jp, tp = both_params("qwen1.5-4b", seed=7)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (B, S + 1))
    jl, jc = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])})
    tl, tc = tlm.prefill(tp, tcfg, {"tokens": _t(toks[:, :S])})
    assert tc["unit"]["u0"]["k"].shape[2] == S
    step = toks[:, S:]
    jd, jc = jlm.decode_step(jp, jcfg, jc, {"tokens": jnp.asarray(step)},
                             jnp.int32(S))
    td, tc = tlm.decode_step(tp, tcfg, tc, {"tokens": _t(step)}, S)
    assert rel_err(td, jd) <= REL
    for got_leaf, want_leaf in zip(tlayers.tree_leaves(tc), jax.tree.leaves(jc)):
        close(got_leaf, want_leaf)
    full = tlm.logits_fn(tp, tcfg, tlm.forward(tp, tcfg,
                                               {"tokens": _t(toks)}))
    assert rel_err(td[:, 0], full[:, S]) > 10 * REL      # S - 1 was lost


@pytest.mark.parametrize("name", ["qwen1.5-4b", "mixtral-8x7b"])
def test_lm_loss_matches_reference(name):
    jcfg, tcfg, jp, tp = both_params(name, seed=2)
    batch = _inputs(jcfg, 16, seed=3)
    batch["labels"] = np.random.default_rng(4).integers(0, jcfg.vocab,
                                                        (B, 16))
    want = jax.jit(lambda p, b: jlm.lm_loss(p, jcfg, b, chunk=8))(
        jp, _jb(batch))
    got = tlm.lm_loss(tp, tcfg, _tb(batch), chunk=8)
    assert abs(float(got) - float(want)) <= REL * abs(float(want))


# ---------------------------------------------------------------- init

def test_init_params_on_cpu():
    cfg = reduced(get_config("hymba-1.5b"))
    a = tlm.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    b = tlm.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    specs = tlm.param_specs(cfg)
    assert tlayers.tree_map(lambda t: (tuple(t.shape), t.dtype), a) == \
        tlayers.tree_map(lambda s: (s.shape, s.dtype), specs)
    for x, y in zip(tlayers.tree_leaves(a), tlayers.tree_leaves(b)):
        assert torch.equal(x, y)
    ssm_p = a["unit"]["u0"]["ssm"]
    assert torch.all(ssm_p["A_log"] == 0)
    assert torch.all(ssm_p["dt_bias"] == -2.0)
    assert a["embed"].dtype == torch.bfloat16
    assert float(a["embed"].float().std()) == pytest.approx(0.02, rel=0.1)
    x = tlm.forward(a, cfg, {"tokens": torch.zeros((1, 5), dtype=torch.long)})
    assert x.shape == (1, 5, cfg.d_model) and torch.isfinite(x.float()).all()


def test_params_from_reference_checks_the_tree():
    jcfg, tcfg = f32_configs("qwen1.5-4b")
    tree = jax.tree.map(np.asarray, ref_params(jcfg))
    tp = tlm.params_from_reference(tree, tcfg, device="cpu")
    assert tp["unit"]["u0"]["wq"].dtype == torch.float32
    assert tp["final_norm"].dtype == torch.float32
    bf = tlm.params_from_reference(
        tree, dataclasses.replace(tcfg, dtype=torch.bfloat16), device="cpu")
    assert bf["unit"]["u0"]["wq"].dtype == torch.bfloat16
    assert bf["unit"]["u0"]["norm"].dtype == torch.float32
    with pytest.raises(KeyError):
        tlm.params_from_reference(dict(tree, extra=tree["embed"]), tcfg,
                                  device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tlm.params_from_reference(dict(tree, embed=tree["embed"][:3]), tcfg,
                                  device="cpu")
