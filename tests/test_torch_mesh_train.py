"""The mesh trainer, the training launcher across ranks and decode
attention on a mesh, on the CPU.

* ``decode_opt`` keeps a batch-sharded cache sharded: full-width
  qwen1.5-4b decoding at S = 2048, B = 16 on the 16x16 plan under
  ``OPTIMIZED`` runs no op replicated and moves at most twice the
  collective bytes of the default options on the same cell (it gathered
  26.0 GB, the whole cache, when each sequence's ``bmm.dtype`` ran
  replicated).
* ``Trainer(..., mesh=...)`` on a 1x1 gloo mesh: 3 steps of reduced
  qwen1.5-4b in float32, losses and final params and moments bit-equal
  to the one-device ``Trainer``.
* The launcher's trainer (``launch.train.build``) on a 2x2 host mesh of
  4 gloo ranks (``python -m torch.distributed.run``), in float32, for 6
  steps against the one-device trainer the launcher builds: each step's
  loss within 1e-5 relative, the final params and moments within 1e-5 of
  each leaf's largest value (measured on this CPU: 1.3e-6 for params,
  3.3e-6 for moments, whose Adam normalisation lifts the last bits of
  small gradients), and one ``metrics.jsonl`` with one record per step.
  ``python -m repro_torch.launch.train --mesh host`` itself, on the
  same 4 ranks at the config's dtype, prints one ``final:`` line and
  writes one ``metrics.jsonl``.
* Elastic restart: a 2x2 run to its step-3 checkpoint, relaunched on 2
  ranks (2x1) to step 6, gives steps 4-6 the losses of the
  uninterrupted 2x2 run within 1e-5 relative; that checkpoint restores
  in the one-device ``Trainer`` and in the JAX package's reader to the
  ranks' ``full_tensor()`` values bit for bit.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import TokenStream, make_batch_iterator
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.launch import train as train_cli
from repro_torch.models.layers import tree_leaves
from repro_torch.train import Trainer, TrainerConfig

from mesh_ranks import replicated_allowed, train_config

ROOT = pathlib.Path(__file__).resolve().parent.parent
DRIVER = ROOT / "tests" / "mesh_ranks.py"
LOSS_REL = 1e-5
STATE_REL = 1e-5        # of each leaf's largest value
#: the launcher's arguments shared by every run here
CLI = ["--arch", "qwen1.5-4b", "--reduced", "--device", "cpu", "--batch",
       "4", "--seq-len", "32", "--save-every", "3"]
MESH_CLI = ["--mesh", "host", "--model", "2"] + CLI


def run_ranks(n: int, args, timeout: int = 240) -> str:
    """``args`` (a module's ``-m`` form or a script) on ``n`` gloo ranks
    under ``torch.distributed.run --standalone`` (a free port of its
    own); returns its output, raising with it when a rank fails."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src") + os.pathsep + str(ROOT / "tests"))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n)] + [str(a) for a in args],
        env=env, capture_output=True, text=True, timeout=timeout)
    if out.returncode:
        raise AssertionError(f"{n} ranks exited {out.returncode}:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-6000:]}")
    return out.stdout


def _records(workdir):
    return [json.loads(line) for line in
            (pathlib.Path(workdir) / "metrics.jsonl").read_text()
            .splitlines()]


def _losses(workdir):
    return {r["step"]: r["loss"] for r in _records(workdir) if "ema" in r}


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def _cfg():
    return dataclasses.replace(reduced(get_config("qwen1.5-4b")),
                               dtype=torch.float32)


def _state_like():
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    p = lm.param_specs(_cfg())
    return p, adamw.adamw_state_specs(p)


def _leaf_err(want, got) -> float:
    """The largest difference of two leaf lists, relative to each leaf's
    largest value."""
    err = 0.0
    for w, g in zip(want, got):
        w, g = torch.as_tensor(w).double(), torch.as_tensor(g).double()
        top = float(w.abs().max())
        if top:
            err = max(err, float((w - g).abs().max()) / top)
    return err


# ------------------------------------------------------- decode on a mesh

def test_decode_opt_keeps_a_sharded_cache_sharded():
    cfg = get_config("qwen1.5-4b")
    shape = ShapeSpec("d", "decode", 2048, 16)
    plan = tmesh.make_production_mesh()
    base = dryrun.run_cell(cfg, shape, plan)
    opt = dryrun.run_cell(cfg, shape, plan, optimized=True)
    assert base["status"] == opt["status"] == "ok", opt.get("error")
    assert "bmm" not in opt["replicated_ops"], opt["replicated_ops"]
    assert opt["replicated_ops"] == base["replicated_ops"] == {}
    assert 0 < opt["collective_bytes"] <= 2 * base["collective_bytes"], \
        (opt["collectives"], base["collectives"])


# ------------------------------------------------- the trainer on a mesh

def _trainer(workdir, mesh=None, steps=3):
    cfg = _cfg()
    stream = TokenStream(cfg.vocab, 4, 32, seed=0)
    tcfg = TrainerConfig(workdir=str(workdir), num_steps=steps,
                         save_every=100, log_every=1, lr=1e-3)
    kw = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    return Trainer(cfg, ShapeSpec("t", "train", 32, 4), tcfg,
                   make_batch_iterator(stream), data_state=stream.state,
                   **kw)


def test_mesh_trainer_on_one_device_equals_the_one_device_trainer(tmp_path):
    plain = _trainer(tmp_path / "plain")
    plain.train()
    m = tmesh.make_host_mesh(device="cpu")
    try:
        spmd = _trainer(tmp_path / "mesh", mesh=m)
        assert spmd.is_writer and spmd.cell is not None
        spmd.train()
        got = [t.full_tensor() for t in
               tree_leaves((spmd.params, spmd.opt_state))]
        assert set(spmd.replicated_ops) <= replicated_allowed("train")
    finally:
        dist.destroy_process_group()
    want = tree_leaves((plain.params, plain.opt_state))
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and torch.equal(w, g)
    assert _losses(tmp_path / "plain") == _losses(tmp_path / "mesh")
    assert sorted(_losses(tmp_path / "mesh")) == [1, 2, 3]


def test_mesh_trainer_refuses_a_plan_and_a_device(tmp_path):
    with pytest.raises(ValueError, match="no devices"):
        _trainer(tmp_path, mesh=tmesh.make_production_mesh())
    cfg = _cfg()
    with pytest.raises(ValueError, match="pass no device"):
        Trainer(cfg, ShapeSpec("t", "train", 32, 4),
                TrainerConfig(workdir=str(tmp_path)), iter(()),
                device="cpu", mesh=tmesh.make_host_mesh(device="cpu"))


# ----------------------------------------------- the launcher across ranks

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """In their workdirs: the launcher's one-device trainer and its
    trainer on 2x2 for 6 steps, a 2x2 run to step 3 relaunched on 2x1 to
    step 6 (all in float32, logging every step), and the launcher itself
    on 2x2 for 2 steps."""
    root = tmp_path_factory.mktemp("mesh_train")
    one, whole, cut, cli = (root / k for k in ("one", "whole", "cut", "cli"))
    args = train_cli.parse_args(CLI + ["--steps", "6", "--workdir", str(one)])
    trainer, _ = train_cli.build(args, train_config(args))
    trainer.tcfg.log_every = 1
    trainer.train(seed=args.seed)
    run_ranks(4, [DRIVER, "train", whole / "dump"] + MESH_CLI
              + ["--steps", "6", "--workdir", whole])
    run_ranks(4, [DRIVER, "train", cut / "dump"] + MESH_CLI
              + ["--steps", "3", "--workdir", cut])
    step3 = {"ckpt": sorted((cut / "ckpt").iterdir())[-1],
             "dumps": [np.load(cut / f"dump.rank{r}.npz") for r in range(4)]}
    again = run_ranks(2, [DRIVER, "train", cut / "again", "--mesh", "host",
                          "--model", "1"] + CLI
                      + ["--steps", "6", "--workdir", cut])
    out = run_ranks(4, ["-m", "repro_torch.launch.train"] + MESH_CLI
                    + ["--steps", "2", "--workdir", cli])
    return {"one": one, "whole": whole, "cut": cut, "cli": cli, "out": out,
            "again": again, "step3": step3}


def test_launcher_on_2x2_prints_and_logs_once(runs):
    finals = [line for line in runs["out"].splitlines()
              if line.startswith("final:")]
    assert len(finals) == 1                     # rank 0 alone prints
    assert list(runs["cli"].glob("**/metrics.jsonl")) == \
        [runs["cli"] / "metrics.jsonl"]
    recs = _records(runs["cli"])
    assert [r["step"] for r in recs if "ema" in r] == [2]
    assert recs[-1]["event"] == "done" and recs[-1]["steps"] == 2, recs
    assert all(np.isfinite(r["loss"]) for r in recs if "ema" in r)


def test_launcher_on_2x2_matches_one_device(runs):
    assert list(runs["whole"].glob("**/metrics.jsonl")) == \
        [runs["whole"] / "metrics.jsonl"]
    recs = [r for r in _records(runs["whole"]) if "ema" in r]
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5, 6]
    one, whole = _losses(runs["one"]), _losses(runs["whole"])
    for step in range(1, 7):
        assert _rel(whole[step], one[step]) <= LOSS_REL, step
    from repro_torch.checkpoint import restore_checkpoint
    like = _state_like()
    want, _ = restore_checkpoint(runs["one"] / "ckpt" / "step_00000006",
                                 like)
    got, extra = restore_checkpoint(
        runs["whole"] / "ckpt" / "step_00000006", like)
    assert extra["step"] == 6
    assert _leaf_err(tree_leaves(want[0]), tree_leaves(got[0])) <= STATE_REL
    assert _leaf_err(tree_leaves(want[1]), tree_leaves(got[1])) <= STATE_REL


def test_restart_on_2x1_continues_the_2x2_run(runs):
    assert "resumed from" in runs["again"] and \
        "at step 3" in runs["again"]
    whole, cut = _losses(runs["whole"]), _losses(runs["cut"])
    assert sorted(cut) == [1, 2, 3, 4, 5, 6]
    for step in (4, 5, 6):
        assert _rel(cut[step], whole[step]) <= LOSS_REL, step


def test_step3_checkpoint_restores_on_one_device_and_in_the_reference(runs):
    from repro.checkpoint.checkpoint import restore_checkpoint as jrestore
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    from repro.models import lm as jlm
    from repro.optim import adamw as jadamw
    import jax
    ckpt, dumps = runs["step3"]["ckpt"], runs["step3"]["dumps"]
    assert ckpt.name == "step_00000003"
    ranks = [[d[k] for k in sorted(d.files)] for d in dumps]
    for r in ranks[1:]:                 # every rank's whole tensors agree
        assert all(np.array_equal(a, b) for a, b in zip(ranks[0], r))
    # the one-device trainer resumes from it (a copy, alone in a workdir)
    import shutil
    work = runs["cut"].parent / "restore_one"
    shutil.copytree(ckpt, work / "ckpt" / ckpt.name)
    params, opt, step = _trainer(work).restore_or_init()
    assert step == 3
    got = [t.numpy() for t in tree_leaves((params, opt))]
    assert len(got) == len(ranks[0])
    for a, b in zip(got, ranks[0]):
        np.testing.assert_array_equal(a.astype(np.float32), b)
    jcfg = dataclasses.replace(jreduced(jget("qwen1.5-4b")),
                               dtype=np.float32)
    jp = jlm.param_specs(jcfg)
    back, extra = jrestore(str(ckpt), (jp, jadamw.adamw_state_specs(jp)))
    assert extra["step"] == 3
    leaves = jax.tree.leaves(back)
    assert len(leaves) == len(ranks[0])
    for a, b in zip(leaves, ranks[0]):
        np.testing.assert_array_equal(np.asarray(a).astype(np.float32), b)


def test_host_mesh_needs_its_ranks(monkeypatch):
    """Under ``torch.distributed.run`` the host mesh spans ``WORLD_SIZE``
    ranks; a mesh of more devices than the world refuses to start
    instead of carrying on as one device."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    m = tmesh.make_host_mesh(model=2, device="cpu")
    assert m.shape == {"data": 2, "model": 2} and m.size == 4
    assert m.local_device == torch.device("cpu")
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_host_mesh(model=3, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="one process per device"):
        m.device_mesh()
    assert not dist.is_initialized()


def test_host_mesh_puts_each_rank_on_its_local_card(monkeypatch):
    """On the cards each rank of a host mesh runs on ``cuda:LOCAL_RANK``
    (ranks numbered host by host, as ``torch.distributed.run`` numbers
    them), and a host with fewer cards than ranks refuses to start."""
    monkeypatch.setattr(tmesh, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for key, value in (("WORLD_SIZE", "4"), ("LOCAL_WORLD_SIZE", "2"),
                       ("RANK", "3"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(key, value)
    m = tmesh.make_host_mesh(model=2)
    assert m.shape == {"data": 2, "model": 2}
    assert m.devices == ("cuda:0", "cuda:1", "cuda:0", "cuda:1")
    assert m.local_device == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="4 ranks on this host, 2 cards"):
        tmesh.make_host_mesh(model=2)
