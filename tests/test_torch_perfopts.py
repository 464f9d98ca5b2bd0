"""Every ``PerfOpts`` lever of the port against the JAX package's, on the
CPU.

The reference and the port run with the same options, each in its own
``use_perf_opts``, on ``reduced()`` configs in float32 with numpy-seeded
parameters carried over by ``params_from_reference``; the reference
runs under ``jax.jit``.  Tolerances, as in ``test_torch_lm.py`` and
``test_torch_train.py``: logits within 1e-4 of the largest reference
logit with greedy tokens equal, cache leaves within 1e-5 absolute
(scaled by their magnitude above 1), the loss within 1e-5 relative and
each gradient leaf within 1e-4 of its largest reference gradient.

Port against port, bit for bit: the triangular pass against the dense
one (a q block skips only fully masked kv blocks, which leave its
online softmax as it was), ``kv_quant_int8`` against the default (no
code reads it, in either package), and the sharding levers on a 1 x 1
mesh against the levers off (a constraint is the identity on one
device).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import perfopts as jperf
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.perfopts import OPTIMIZED, PerfOpts, use_perf_opts
from test_torch_lm import (REL, _inputs, _jb, _np, _tb, close, f32_configs,
                           ref_params, rel_err)
from test_torch_train import GRAD_REL, LOSS_REL, leaf_err

B = 2


def _configs(name: str, window=None):
    """(reference, port) float32 reduced configs of ``name``, with every
    windowed layer's window set to ``window`` when it is given."""
    jcfg, tcfg = f32_configs(name)
    if window is not None:
        unit = tuple(dataclasses.replace(u, window=u.window and window)
                     for u in jcfg.unit)
        jcfg = dataclasses.replace(jcfg, unit=unit)
        tcfg = dataclasses.replace(tcfg, unit=unit)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed: int = 0):
    jp = ref_params(jcfg, seed)
    return jp, tlm.params_from_reference(jax.tree.map(np.asarray, jp), tcfg,
                                         device="cpu")


def _ref(opts: jperf.PerfOpts, fn, *args):
    """``fn(*args)`` jitted and traced under the reference's ``opts``."""
    with jperf.use_perf_opts(opts):
        return jax.jit(fn)(*args)


def _forward_logits(tp, tcfg, batch):
    return tlm.logits_fn(tp, tcfg, tlm.forward(tp, tcfg, batch))


# ------------------------------------------------- triangular attention

# (arch, window, S): two 512-token blocks skip 1 of 4 causal pairs; a
# 256 window over three blocks also skips the band's far pair
TRI_CASES = [(name, None, 600) for name in sorted(ARCHS)] \
    + [("gemma2-2b", 256, 1040)]


@pytest.mark.parametrize("name,window,s", TRI_CASES,
                         ids=lambda v: str(v) if v else "")
def test_triangular_forward_matches_reference(name, window, s):
    jcfg, tcfg = _configs(name, window)
    jp, tp = _params(jcfg, tcfg, seed=1)
    batch = _inputs(jcfg, s)
    want = _ref(jperf.PerfOpts(triangular_attention=True),
                lambda p, b: jlm.logits_fn(p, jcfg, jlm.forward(p, jcfg, b)),
                jp, _jb(batch))
    dense = _forward_logits(tp, tcfg, _tb(batch))
    with use_perf_opts(PerfOpts(triangular_attention=True)):
        got = _forward_logits(tp, tcfg, _tb(batch))
    assert rel_err(got, want) <= REL
    assert torch.equal(got, dense)


def test_triangular_visits_only_visible_block_pairs():
    spec = tlayers.AttnSpec(causal=True, q_block=4, kv_block=4)
    assert tlayers._visible_pairs(3, 3, 4, 4, spec) == [
        (0, 0), (1, 0), (1, 1), (2, 0), (2, 1), (2, 2)]
    band = tlayers.AttnSpec(causal=True, window=4, q_block=4, kv_block=4)
    assert tlayers._visible_pairs(3, 3, 4, 4, band) == [
        (0, 0), (1, 0), (1, 1), (2, 1), (2, 2)]
    # 8 x 8 blocks of 512 at S = 4096 (the card's prefill): 36 of 64
    assert len(tlayers._visible_pairs(8, 8, 512, 512, tlayers.AttnSpec())) \
        == 36


# ------------------------------------------------------------ decode_opt

DECODE_CASES = [(name, None, 24) for name in sorted(ARCHS)] \
    + [("gemma2-2b", 8, 16)]      # rolling window: slots pos % 8


@pytest.mark.parametrize("name,window,prompt", DECODE_CASES,
                         ids=lambda v: str(v) if v else "")
def test_decode_opt_prefill_and_decode_match_reference(name, window, prompt):
    jcfg, tcfg = _configs(name, window)
    jp, tp = _params(jcfg, tcfg, seed=2)
    full = _inputs(jcfg, prompt + 3, seed=2)
    batch = dict(full, tokens=full["tokens"][:, :prompt])
    if jcfg.vision_stub:
        batch["positions3"] = full["positions3"][:, :, :prompt]
    # the reference's decode_step keeps a pre layer's per-token update
    # as that layer's whole cache under decode_opt (ROADMAP queue 3), so
    # from the second step on a model with pre layers is held to the
    # reference's default path, which the lever must not change
    chains = {"opt": jperf.PerfOpts(decode_opt=True)}
    if jcfg.pre:
        chains["default"] = jperf.PerfOpts()
    held = "default" if jcfg.pre else "opt"
    cache_len = prompt + 3
    jl, jc = _ref(chains["opt"], lambda p, b: jlm.prefill(
        p, jcfg, b, cache_len=cache_len), jp, _jb(batch))
    with use_perf_opts(PerfOpts(decode_opt=True)):
        tl, tc = tlm.prefill(tp, tcfg, _tb(batch), cache_len=cache_len)
    assert rel_err(tl, jl) <= REL
    jcs, decs = {}, {}
    for k, opts in chains.items():
        jcs[k] = jc
        with jperf.use_perf_opts(opts):
            decs[k] = jax.jit(lambda p, c, b, pos: jlm.decode_step(
                p, jcfg, c, b, pos))
    for pos in range(prompt, prompt + 3):
        step = {"tokens": full["tokens"][:, pos:pos + 1]}
        if jcfg.mrope:
            step["positions3"] = np.full((3, B, 1), pos)
        jls = {}
        for k, opts in chains.items():
            with jperf.use_perf_opts(opts):
                jls[k], jcs[k] = decs[k](jp, jcs[k], _jb(step),
                                         jnp.int32(pos))
        with use_perf_opts(PerfOpts(decode_opt=True)):
            tl, tc2 = tlm.decode_step(tp, tcfg, tc, _tb(step), pos)
        assert tc2 is tc                          # updated in place
        want = jls["opt" if pos == prompt else held]
        assert rel_err(tl, want) <= REL, pos
        np.testing.assert_array_equal(_np(tl).argmax(-1), _np(want).argmax(-1))
        for got_leaf, want_leaf in zip(tlayers.tree_leaves(tc),
                                       jax.tree.leaves(jcs[held])):
            close(got_leaf, want_leaf)
    if jcfg.pre:
        lost = jax.tree.leaves(jcs["opt"]["pre"])
        assert all(t.shape[1] == 1 for t in lost)


@pytest.mark.parametrize("window,length", [(None, 20), (3, 9), (None, 33)])
def test_append_decode_attention_matches_reference(window, length):
    """The two-part online softmax, with the rolling window's invalid
    slot, under ``decode_opt``."""
    rng = np.random.default_rng(length)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 33, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 33, 2, 16)).astype(np.float32)
    kn = rng.normal(size=(2, 1, 2, 16)).astype(np.float32)
    vn = rng.normal(size=(2, 1, 2, 16)).astype(np.float32)
    inv = None if window is None else length % 33
    kw = dict(causal=True, window=window, logit_softcap=30.0)
    with jperf.use_perf_opts(jperf.PerfOpts(decode_opt=True)):
        want = jax.jit(lambda q, k, v, kn, vn, n: jlayers.decode_attention(
            q, k, v, n, jlayers.AttnSpec(**kw), extra_kv=(kn, vn),
            invalid_slot=inv))(q, k, v, kn, vn, jnp.int32(length))
    with use_perf_opts(PerfOpts(decode_opt=True)):
        got = tlayers.decode_attention(
            *map(torch.from_numpy, (q, k, v)), length, tlayers.AttnSpec(**kw),
            extra_kv=(torch.from_numpy(kn), torch.from_numpy(vn)),
            invalid_slot=inv)
    close(got, want)


# ------------------------------------------------- remat_policy="dots"

def _loss_grads(tp, tcfg, batch, chunk: int = 8):
    leaves = tlayers.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = tlm.lm_loss(tp, tcfg, batch, chunk=chunk)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _check_grads(jcfg, jp, batch, loss, grads, opts, chunk: int = 8):
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    want_loss, want = _ref(opts, jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, jcfg, b, chunk=chunk)), jp32, _jb(batch))
    assert abs(float(loss) - float(want_loss)) \
        <= LOSS_REL * abs(float(want_loss))
    want = jax.tree.leaves(want)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert leaf_err(g, w) <= GRAD_REL, (i, leaf_err(g, w))


def _train_batch(jcfg, s: int, seed: int = 3):
    batch = _inputs(jcfg, s, seed=seed)
    batch["labels"] = np.random.default_rng(seed + 1).integers(
        0, jcfg.vocab, (B, s))
    return batch


@pytest.mark.parametrize("name", ["qwen1.5-4b", "mixtral-8x7b", "hymba-1.5b",
                                  "seamless-m4t-large-v2"])
def test_dots_remat_loss_and_grads_match_reference(name):
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg, tcfg, seed=2)
    batch = _train_batch(jcfg, 16)
    with use_perf_opts(PerfOpts(remat_policy="dots")):
        loss, grads = _loss_grads(tp, tcfg, _tb(batch))
    _check_grads(jcfg, jp, batch, loss, grads,
                 jperf.PerfOpts(remat_policy="dots"))


class _CountMm(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts ``aten.mm`` calls (the unit's projections and MLP)."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def test_dots_backward_recomputes_no_forward_mm():
    """The backward issues as many ``mm`` calls under "dots" as without
    remat (the logits' chunk recompute is in both), and full remat's
    backward more: its recompute repeats the forward projections."""
    _, tcfg = _configs("qwen1.5-4b")
    params = tlm.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    batch = {"tokens": torch.randint(0, tcfg.vocab, (B, 16),
                                     generator=torch.Generator()),
             "labels": torch.zeros((B, 16), dtype=torch.long)}
    leaves = tlayers.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    counts = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        with use_perf_opts(PerfOpts(remat_policy=policy)):
            loss = tlm.lm_loss(params, tcfg, batch, chunk=8, remat=remat)
            with _CountMm() as mode:
                torch.autograd.grad(loss, leaves)
        counts[(remat, policy)] = mode.mm
    assert counts[(True, "dots")] == counts[(False, "full")]
    assert counts[(True, "full")] > counts[(False, "full")]


# ------------------------------------------------------ OPTIMIZED, int8

@pytest.mark.parametrize("name", ["qwen1.5-4b", "mixtral-8x7b"])
def test_optimized_matches_reference_end_to_end(name):
    """``OPTIMIZED`` (triangular, attn_reshard "auto" without a mesh,
    "dots", decode_opt) in both packages: the loss and gradients over
    two 512-token blocks, then prefill and two decode steps."""
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg, tcfg, seed=5)
    batch = _train_batch(jcfg, 1024, seed=5)
    with use_perf_opts(OPTIMIZED):
        loss, grads = _loss_grads(tp, tcfg, _tb(batch), chunk=512)
    _check_grads(jcfg, jp, batch, loss, grads, jperf.OPTIMIZED, chunk=512)

    prompt = {"tokens": batch["tokens"][:, :1000]}
    jl, jc = _ref(jperf.OPTIMIZED, lambda p, b: jlm.prefill(
        p, jcfg, b, cache_len=1002), jp, _jb(prompt))
    with use_perf_opts(OPTIMIZED), torch.no_grad():
        tl, tc = tlm.prefill(tp, tcfg, _tb(prompt), cache_len=1002)
    assert rel_err(tl, jl) <= REL
    with jperf.use_perf_opts(jperf.OPTIMIZED):
        dec = jax.jit(lambda p, c, b, pos: jlm.decode_step(p, jcfg, c, b,
                                                           pos))
    for pos in (1000, 1001):
        step = {"tokens": batch["tokens"][:, pos:pos + 1]}
        with jperf.use_perf_opts(jperf.OPTIMIZED):
            jl, jc = dec(jp, jc, _jb(step), jnp.int32(pos))
        with use_perf_opts(OPTIMIZED), torch.no_grad():
            tl, tc = tlm.decode_step(tp, tcfg, tc, _tb(step), pos)
        assert rel_err(tl, jl) <= REL
        np.testing.assert_array_equal(_np(tl).argmax(-1), _np(jl).argmax(-1))


def test_kv_quant_int8_is_the_default_bit_for_bit():
    jcfg, tcfg = _configs("qwen1.5-4b")
    jp, tp = _params(jcfg, tcfg, seed=6)
    batch = _inputs(jcfg, 20, seed=6)
    runs = []
    for on in (False, True):
        with use_perf_opts(PerfOpts(kv_quant_int8=on)):
            lp, cache = tlm.prefill(tp, tcfg, {"tokens": _tb(batch)["tokens"]
                                               [:, :18]}, cache_len=20)
            ld, _ = tlm.decode_step(tp, tcfg, cache, {"tokens": _tb(
                batch)["tokens"][:, 18:19]}, 18)
        runs.append((lp, ld, tlayers.tree_leaves(cache)))
    for a, b in zip(tlayers.tree_leaves(runs[0]), tlayers.tree_leaves(runs[1])):
        assert torch.equal(a, b)
    # the reference ignores the lever too
    want = _ref(jperf.PerfOpts(kv_quant_int8=True),
                lambda p, b: jlm.prefill(p, jcfg, b, cache_len=20)[0],
                jp, {"tokens": jnp.asarray(batch["tokens"][:, :18])})
    assert rel_err(runs[1][0], want) <= REL


# ----------------------------------------------------- sharding levers

def _jax_host_mesh():
    # the JAX package's make_host_mesh gives Explicit axes under jax
    # 0.9.0, where with_sharding_constraint raises; an Auto mesh runs
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.mark.parametrize("name", ["qwen1.5-4b", "mixtral-8x7b"])
def test_sharding_levers_on_one_device_are_the_identity(name):
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg, tcfg, seed=7)
    batch = _tb(_inputs(jcfg, 24, seed=7))
    lever = dict(attn_reshard="auto", moe_capacity_shard=True)
    off = _forward_logits(tp, tcfg, batch)
    with use_perf_opts(PerfOpts(mesh=Mesh(("data", "model"), (1, 1)),
                                **lever)):
        on = _forward_logits(tp, tcfg, batch)
    assert torch.equal(on, off)
    want = _ref(jperf.PerfOpts(mesh=_jax_host_mesh(), **lever),
                lambda p, b: jlm.logits_fn(p, jcfg, jlm.forward(p, jcfg, b)),
                jp, _jb(_inputs(jcfg, 24, seed=7)))
    assert rel_err(on, want) <= REL


def test_attn_reshard_spec_follows_the_reference_rule():
    mesh = make_production_mesh()                    # 16 x 16
    with use_perf_opts(PerfOpts(attn_reshard="auto", mesh=mesh)):
        assert tlm.attn_reshard_spec(32) == ("data", None, "model", None)
        assert tlm.attn_reshard_spec(20) == ("data", None, None, None)
    pod = make_production_mesh(multi_pod=True)
    with use_perf_opts(PerfOpts(attn_reshard="auto", mesh=pod,
                                batch_axes=("pod", "data"))):
        assert tlm.attn_reshard_spec(16) == (("pod", "data"), None, "model",
                                             None)
    with use_perf_opts(PerfOpts(attn_reshard="auto")):
        assert tlm.attn_reshard_spec(32) is None         # no mesh
    t = torch.zeros(2, 3, 4, 5)
    assert tlayers.with_sharding_constraint(t, mesh, ("data", None)) is t
    with pytest.raises(ValueError, match="no axis 'pod'"):
        tlayers.with_sharding_constraint(t, mesh, ("pod",))
    with pytest.raises(ValueError, match="more entries"):
        tlayers.with_sharding_constraint(t, mesh, (None,) * 5)
