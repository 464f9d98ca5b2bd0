"""The port's training path against the JAX package's, on the CPU.

Inputs are made by numpy from a seed and fed to ``repro`` and
``repro_torch`` alike.  Tolerances, float32 unless a case says so:

* ``lm_loss`` and its gradients, every ``reduced()`` architecture, B = 2,
  S = 16, ``chunk=8``: the loss within 1e-5 relative, each gradient leaf
  within 1e-4 of that leaf's largest reference gradient.  The reference
  differentiates float32 casts of its bf16-drawn parameters (on bf16
  leaves ``jax.grad`` returns bf16 gradients, whose own rounding is
  ~3e-3); the port gets the same values through
  ``params_from_reference``.
* ``clip_by_global_norm`` + ``adamw_update`` on identical inputs (the
  same numpy gradients, params and state), two steps, float32 and bf16
  params: within 1e-6 of each leaf's largest magnitude.
* Port against port: ``remat=True`` against ``remat=False`` within 1e-6
  (the recompute is deterministic, so in practice bit-equal); two
  microbatches against one within 1e-5; a resumed run against an
  uninterrupted one bit for bit.
* Data streams and checkpoints cross between the packages bit for bit.

The reference's own ``Trainer`` cannot run here (its jitted step raises
under jax 0.9.0, ``tests/test_train_substrate.py``), so the port's
trainer is held to its own resume, guard and loss-decrease properties.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.data import FileCorpus as JFileCorpus
from repro.data import TokenStream as JTokenStream
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import checkpoint as tckpt
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import FileCorpus, TokenStream, make_batch_iterator
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.models import lm as tlm
from repro_torch.models.layers import (TensorSpec, tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.optim import adamw
from repro_torch.train import Trainer, TrainerConfig
from test_torch_lm import _inputs, both_params, f32_configs, ref_params

B, S, CHUNK = 2, 16, 8
LOSS_REL = 1e-5
GRAD_REL = 1e-4      # of each leaf's largest reference gradient
OPT_REL = 1e-6


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def leaf_err(got, want) -> float:
    """max |got - want| over max |want|."""
    want = _np(want)
    return float(np.abs(_np(got) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _batch(jcfg, seed: int = 3, s: int = S):
    batch = _inputs(jcfg, s, seed=seed)
    batch["labels"] = np.random.default_rng(seed + 1).integers(
        0, jcfg.vocab, (B, s))
    return batch


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _grads(params, cfg, batch, **kw):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = tlm.lm_loss(params, cfg, batch, **kw)
    return loss.detach(), torch.autograd.grad(loss, leaves)


# ------------------------------------------------------- loss, gradients

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_loss_and_grads_match_reference(name):
    jcfg, tcfg, jp, tp = both_params(name, seed=2)
    batch = _batch(jcfg)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, jcfg, b, chunk=CHUNK)))(
            jp32, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _grads(tp, tcfg, _tb(batch), chunk=CHUNK)
    assert abs(float(loss) - float(want_loss)) \
        <= LOSS_REL * abs(float(want_loss))
    want = jax.tree.leaves(want)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert tuple(g.shape) == w.shape, i
        assert leaf_err(g, w) <= GRAD_REL, (i, leaf_err(g, w))


def test_lm_loss_refuses_a_ragged_last_chunk():
    jcfg, tcfg, jp, tp = both_params("qwen1.5-4b")
    batch = _batch(jcfg, s=24)
    with pytest.raises((TypeError, ValueError)):
        jlm.lm_loss(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                    chunk=16)
    with pytest.raises(ValueError, match=r"S = 24 .* chunk = 16"):
        tlm.lm_loss(tp, tcfg, _tb(batch), chunk=16)
    # S = 24 in one chunk, or in chunks of 8, is whole
    assert torch.isfinite(tlm.lm_loss(tp, tcfg, _tb(batch), chunk=24))
    assert torch.isfinite(tlm.lm_loss(tp, tcfg, _tb(batch), chunk=8))


@pytest.mark.parametrize("name", ["qwen1.5-4b", "mixtral-8x7b",
                                  "mamba2-780m", "seamless-m4t-large-v2"])
def test_remat_gradients_equal_plain(name):
    """Dense, MoE (top-k routing recomputed), SSM (the SSD scan
    recomputed) and encoder-decoder (encoder layers checkpointed)."""
    _, tcfg, _, tp = both_params(name, seed=5)
    jcfg, _ = f32_configs(name)
    batch = _tb(_batch(jcfg))
    l1, g1 = _grads(tp, tcfg, batch, chunk=CHUNK, remat=True)
    l0, g0 = _grads(tp, tcfg, batch, chunk=CHUNK, remat=False)
    assert float(l1) == float(l0)
    for a, b in zip(g1, g0):
        assert leaf_err(a, b) <= 1e-6


@pytest.mark.parametrize("name", ["qwen1.5-4b", "qwen2-vl-2b"])
def test_microbatched_gradients_match_one_batch(name):
    """Two microbatches (``positions3`` split along its dim 1) against
    the whole batch: the float32 mean loss and gradients within 1e-5 of
    each leaf's largest magnitude."""
    jcfg, tcfg = f32_configs(name)
    tp = tlm.params_from_reference(jax.tree.map(np.asarray,
                                                ref_params(jcfg, 4)), tcfg,
                                   device="cpu")
    batch = _tb(_batch(jcfg, seed=6))
    l1, g1 = steps.loss_and_grads(tp, tcfg, batch, 1)
    l2, g2 = steps.loss_and_grads(tp, tcfg, batch, 2)
    assert abs(float(l2) - float(l1)) <= 1e-5 * abs(float(l1))
    for a, b in zip(tree_leaves(g2), tree_leaves(g1)):
        assert a.dtype == torch.float32
        assert leaf_err(a, b) <= 1e-5
    with pytest.raises(ValueError, match="microbatches"):
        steps.loss_and_grads(tp, tcfg, batch, 3)


# ------------------------------------------------------------- optimizer

def _opt_inputs(seed: int):
    rng = np.random.default_rng(seed)
    like = {"a": np.zeros((8, 16)), "b": {"c": np.zeros(33),
                                          "d": np.zeros((4, 4, 4))},
            "e": np.zeros(())}
    params = tree_map(lambda z: np.asarray(rng.normal(size=z.shape),
                                           np.float32), like)
    grads = [tree_map(lambda z: np.asarray(rng.normal(size=z.shape) * 3,
                                           np.float32), like)
             for _ in range(2)]
    return params, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_and_adamw_match_reference(dtype):
    params, grads = _opt_inputs(7)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    tp = tree_map(lambda a: torch.from_numpy(a).to(tdt), params)
    jopt, topt = jadamw.adamw_init(jp), adamw.adamw_init(tp)
    for g in grads:                      # the first step, then the second
        jg, jnorm = jadamw.clip_by_global_norm(
            jax.tree.map(lambda a: jnp.asarray(a, jdt), g), 1.0)
        tg, tnorm = adamw.clip_by_global_norm(
            tree_map(lambda a: torch.from_numpy(a).to(tdt), g), 1.0)
        assert leaf_err(tnorm, jnorm) <= OPT_REL
        for a, b in zip(tree_leaves(tg), jax.tree.leaves(jg)):
            assert a.dtype == tdt and leaf_err(a, b) <= OPT_REL
        jp, jopt = jadamw.adamw_update(jg, jopt, jp, lr=1e-2)
        tp, topt = adamw.adamw_update(tg, topt, tp, lr=1e-2)
        assert int(topt.count) == int(jopt.count)
        assert topt.count.dtype == torch.int32
        for a, b in zip(tree_leaves((tp, topt.mu, topt.nu)),
                        jax.tree.leaves((jp, jopt.mu, jopt.nu))):
            assert leaf_err(a, b) <= OPT_REL
    assert all(t.dtype == tdt for t in tree_leaves(tp))
    assert all(t.dtype == torch.float32 for t in tree_leaves(topt.mu))


def test_adamw_minimizes_quadratic():
    params = {"w": torch.full((8,), 5.0)}
    opt = adamw.adamw_init(params)
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        params, opt = adamw.adamw_update({"w": g}, opt, params, lr=0.1,
                                         weight_decay=0.0)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2
    specs = adamw.adamw_state_specs({"w": TensorSpec((8,), torch.bfloat16)})
    assert specs.mu["w"] == TensorSpec((8,), torch.float32)
    assert specs.count == TensorSpec((), torch.int32)


def test_int8_compression_matches_reference():
    """Twenty rounds of error feedback on the same gradients: equal
    codes, scales and residuals, and the residual bounds the drift of
    the dequantized sum."""
    rng = np.random.default_rng(11)
    jerr, terr = jnp.zeros((32,)), torch.zeros(32)
    true_sum, deq_sum = np.zeros(32), np.zeros(32)
    for _ in range(20):
        g = rng.normal(size=(32,)).astype(np.float32)
        jq, jscale, jerr = jadamw.compress_int8(jnp.asarray(g), jerr)
        q, scale, terr = adamw.compress_int8(torch.from_numpy(g), terr)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert q.dtype == torch.int8
        assert leaf_err(scale, jscale) <= OPT_REL
        assert np.abs(terr.numpy() - np.asarray(jerr)).max() <= 1e-6
        deq_sum += adamw.decompress_int8(q, scale).numpy()
        true_sum += g
    assert np.abs(true_sum - deq_sum).max() <= float(terr.abs().max()) + 1e-4


def test_tree_helpers_keep_named_tuples_and_sorted_order():
    state = adamw.adamw_init({"z": torch.ones(2), "a": torch.ones(3)})
    doubled = tree_map(lambda t: t + 1, state)
    assert isinstance(doubled, adamw.AdamWState)
    assert int(doubled.count) == 1 and list(doubled.mu) == ["z", "a"]
    like = {"z": TensorSpec((2,), torch.float32),
            "a": (TensorSpec((3,), torch.float32),) * 2}
    tree = tree_unflatten(like, ["a0", "a1", "z"])
    assert tree == {"z": "z", "a": ("a0", "a1")}
    assert tree_leaves(tree) == ["a0", "a1", "z"]
    with pytest.raises(ValueError, match="fewer"):
        tree_unflatten(like, ["a0"])
    with pytest.raises(ValueError, match="more"):
        tree_unflatten(like, ["a0", "a1", "z", "extra"])


# ------------------------------------------------------------------ data

def test_data_streams_match_reference(tmp_path):
    ours, theirs = TokenStream(300, 3, 20, seed=7), JTokenStream(300, 3, 20,
                                                                  seed=7)
    for _ in range(3):
        a, b = ours.next_batch(), theirs.next_batch()
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    resumed = TokenStream(300, 3, 20, seed=7)
    resumed.state.step = 2
    ours = TokenStream(300, 3, 20, seed=7)
    ours.next_batch(), ours.next_batch()
    np.testing.assert_array_equal(resumed.next_batch()["tokens"],
                                  ours.next_batch()["tokens"])
    path = tmp_path / "corpus.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    fc, jfc = FileCorpus(str(path), 1000, 2, 16, seed=3), \
        JFileCorpus(str(path), 1000, 2, 16, seed=3)
    for _ in range(2):
        a, b = fc.next_batch(), jfc.next_batch()
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    it = make_batch_iterator(fc, {"extra": np.ones(2)})
    assert fc.state.to_dict() == {"seed": 3, "step": 2}
    assert set(next(it)) == {"tokens", "labels", "extra"}


# ------------------------------------------------------------ checkpoint

def _bits(a) -> np.ndarray:
    """The raw bits of a leaf of either package."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _train_state(name="gemma2-2b"):
    """The reference's bf16 params (numpy, ml_dtypes) and an AdamW state
    with nonzero moments, and the same state in the port."""
    jcfg = jreduced(JARCHS[name])
    jp = jax.tree.map(np.asarray, ref_params(jcfg, 9))
    rng = np.random.default_rng(10)
    jopt = jadamw.AdamWState(
        count=np.asarray(3, np.int32),
        mu=jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            np.float32), jp),
        nu=jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32),
                        jp))
    cfg = reduced(ARCHS[name])
    like = (tlm.param_specs(cfg), adamw.adamw_state_specs(
        tlm.param_specs(cfg)))
    return (jp, jopt), like, jcfg


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jtree, like, _ = _train_state()
    path = jsave(tmp_path, 4, jtree, extra={"step": 4})
    (params, opt), extra = tckpt.restore_checkpoint(path, like)
    assert extra == {"step": 4} and isinstance(opt, adamw.AdamWState)
    assert params["embed"].dtype == torch.bfloat16
    assert opt.count.dtype == torch.int32 and int(opt.count) == 3
    got, want = tree_leaves((params, opt)), jax.tree.leaves(jtree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jtree, like, jcfg = _train_state()
    (params, opt), _ = tckpt.restore_checkpoint(
        jsave(tmp_path / "j", 4, jtree), like)
    path = tckpt.save_checkpoint(tmp_path / "t", 4, (params, opt),
                                 extra={"step": 4, "data": {"seed": 1,
                                                            "step": 4}})
    manifest = json.loads((Path(path) / "manifest.json").read_text())
    assert manifest["process_count"] == 1
    assert manifest["dtypes"]["leaf_00000"] == "bfloat16"
    jlike = (jlm.param_specs(jcfg), jadamw.adamw_state_specs(
        jlm.param_specs(jcfg)))
    back, extra = jrestore(path, jlike)
    assert extra["data"] == {"seed": 1, "step": 4}
    assert np.asarray(jax.tree.leaves(back)[0]).dtype == jnp.bfloat16
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # on a device: the same bits, as leaves of that device
    (p2, o2), _ = tckpt.restore_on_device(path, like, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((p2, o2)),
                                                 tree_leaves((params, opt))))


def test_checkpoint_retention_and_atomicity(tmp_path):
    mgr = tckpt.CheckpointManager(tmp_path, save_every=2, keep=2)
    for step in range(1, 8):
        mgr.maybe_save(step, {"x": torch.full((3,), step)})
    dirs = sorted(d.name for d in tmp_path.iterdir())
    assert dirs == ["step_00000004", "step_00000006"]
    # a crashed writer leaves only a staging dir, which nothing restores
    (tmp_path / "step_00000009.tmp-dead").mkdir()
    assert mgr.latest().endswith("step_00000006")
    tree, _ = tckpt.restore_checkpoint(mgr.latest(),
                                       {"x": TensorSpec((3,), torch.int64)})
    assert tree["x"].tolist() == [6, 6, 6]
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore_checkpoint(mgr.latest(), {"x": 0, "y": 0})
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(mgr.latest(),
                                 {"x": TensorSpec((4,), torch.int64)})


# --------------------------------------------------------------- trainer

def _trainer(workdir, steps_, save_every=2, **kw):
    cfg = reduced(ARCHS["gemma2-2b"])
    stream = TokenStream(cfg.vocab, 4, 32, seed=1)
    tcfg = TrainerConfig(workdir=str(workdir), num_steps=steps_,
                         save_every=save_every, log_every=1, lr=1e-3, **kw)
    return Trainer(cfg, ShapeSpec("t", "train", 32, 4), tcfg,
                   make_batch_iterator(stream), data_state=stream.state,
                   device="cpu"), stream


def _records(workdir):
    return [json.loads(line) for line in
            (Path(workdir) / "metrics.jsonl").read_text().splitlines()]


def test_trainer_resume_equals_an_uninterrupted_run(tmp_path):
    whole, _ = _trainer(tmp_path / "a", 6)
    assert whole.train()["steps"] == 6
    first, _ = _trainer(tmp_path / "b", 4)
    assert first.train()["steps"] == 4
    again, stream = _trainer(tmp_path / "b", 6)
    assert again.train()["steps"] == 6
    assert stream.state.step == 6          # resumed past 4 consumed batches
    for a, b in zip(tree_leaves((whole.params, whole.opt_state)),
                    tree_leaves((again.params, again.opt_state))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    losses = [{r["step"]: r["loss"] for r in _records(d) if "ema" in r}
              for d in (tmp_path / "a", tmp_path / "b")]
    assert losses[0] == losses[1] and sorted(losses[0]) == [1, 2, 3, 4, 5, 6]
    rec = next(r for r in _records(tmp_path / "a") if "ema" in r)
    assert set(rec) == {"step", "loss", "ema", "grad_norm", "step_s"}
    assert _records(tmp_path / "a")[-1]["event"] == "done"


def test_trainer_loss_decreases(tmp_path):
    trainer, _ = _trainer(tmp_path, 30, save_every=100)
    trainer.train()
    losses = [r["loss"] for r in _records(tmp_path) if "ema" in r]
    assert len(losses) == 30
    assert np.mean(losses[-3:]) < losses[0]


def test_trainer_nan_guard_keeps_the_state(tmp_path, monkeypatch):
    """Steps whose loss is not finite change neither params nor moments,
    and past ``nan_limit`` the trainer aborts."""
    ref, _ = _trainer(tmp_path / "ref", 1, save_every=100)
    ref.train()
    real = steps.loss_and_grads
    calls = []

    def poisoned(*args, **kw):
        loss, grads = real(*args, **kw)
        calls.append(1)
        return (loss if len(calls) == 1 else loss * float("nan")), grads
    monkeypatch.setattr(steps, "loss_and_grads", poisoned)
    trainer, _ = _trainer(tmp_path / "nan", 3, save_every=100)
    res = trainer.train()
    assert res["nan_steps"] == 2 and res["steps"] == 3
    assert int(trainer.opt_state.count) == 1
    for a, b in zip(tree_leaves((trainer.params, trainer.opt_state)),
                    tree_leaves((ref.params, ref.opt_state))):
        assert torch.equal(a, b)
    events = [r.get("event") for r in _records(tmp_path / "nan")]
    assert events.count("nan_skip") == 2
    calls.clear()
    strict, _ = _trainer(tmp_path / "abort", 4, save_every=100, nan_limit=1)
    with pytest.raises(RuntimeError, match="non-finite"):
        strict.train()


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-vl-2b",
                                  "seamless-m4t-large-v2"])
def test_train_cli_runs(tmp_path, arch):
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--seq-len", "16", "--workdir", str(tmp_path)]
    res = train_cli.main(args + ["--steps", "2", "--save-every", "2",
                                 "--microbatches", "2"])
    assert res["steps"] == 2 and np.isfinite(res["final_loss"])
    again = train_cli.main(args + ["--steps", "3"])       # resumes at 2
    assert again["steps"] == 3 and np.isfinite(again["final_loss"])
    assert [r["step"] for r in _records(tmp_path) if "ema" in r] == [2, 3]


def test_default_microbatches():
    shape = ShapeSpec("t", "train", 64, 4)
    assert steps.default_microbatches(ARCHS["mixtral-8x7b"], shape) == 4
    assert steps.default_microbatches(
        ARCHS["qwen1.5-4b"], dataclasses.replace(shape, global_batch=256)) \
        == 8
    assert steps.default_microbatches(
        ARCHS["starcoder2-15b"],
        dataclasses.replace(shape, global_batch=256)) == 16
