"""The port's example and tool scripts against their JAX originals, on
the CPU.

Each case loads the JAX original (``examples/*.py``, ``tools/*.py``) and
its ``*_torch.py`` counterpart by path, runs both ``main``s in this
process (the port's on ``--device cpu``) and requires equal stdout once
the wall-clock times, the rates and ratios made of them and the cache
path are masked (``MASKS``, by name); tolerance 0 on everything else,
compile keys and every cycle count included.  quickstart,
compile_vit_cim and explain (``tiny_cnn`` on ``isaac-baseline``, both
formats, with and without a fault model) run whole; explore_design_space
runs its campaign mode on ``tiny_cnn`` alone (the exhaustive and
adaptive sections on ``tiny_cnn`` too) and its sweep mode, one worker
each (two workers are ``test_torch_dse.py``'s).  The fleet example is
``test_torch_examples_fleet.py``'s.

serve_lm: both examples draw their own parameters (``PRNGKey(0)``
against a seeded ``torch.Generator``), so the case gives both the
reference's own ``init_params(cfg, PRNGKey(0))`` cast to float32 (the
port's through ``params_from_reference``) and a float32 config; the
served tokens must then be equal, request for request, and so must the
printed lines.  train_lm's original cannot run here (its ``Trainer``
stops at a ``ShardingTypeError`` under jax 0.9.0), so the port's is held
as ``test_torch_train.py`` holds the trainer: a 2-layer cut of its
config for 6 steps with a checkpoint every 3 must lower the loss, write
``metrics.jsonl`` and resume at step 6 when rerun with ``--steps 9``.
The golden tool's ``--check`` must reproduce the six committed fixtures
bit for bit and report one flipped element with a non-zero exit.
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import pathlib
import re
import shutil

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden" / "cim_mvm"

#: (pattern, replacement): every field the scripts print that is a
#: wall-clock time, a rate or ratio made of wall-clock times, or a path
MASKS = [
    (r'"compile_wall_s": [0-9.e-]+', '"compile_wall_s": <s>'),
    (r"compile_wall_s: [0-9.e-]+", "compile_wall_s: <s>"),
    (r"campaign finished in [0-9.]+s", "campaign finished in <s>"),
    (r"full compiles in [0-9.]+s", "full compiles in <s>"),
    (r"(?m)^cache: .*$", "cache: <dir>"),
    (r"points in [0-9.]+s", "points in <s>"),
    (r"\(warm cache\): [0-9.]+s -> [0-9.]+x (faster|SLOWER)",
     "(warm cache): <s> -> <x>"),
    (r"warm-up \(compile \+ lower \+ pack\): [0-9.]+s", "warm-up <s>"),
    (r"served (\d+) requests in [0-9.]+s", r"served \1 requests in <s>"),
    (r"(p50|p95) [0-9.]+ms", r"\1 <ms>"),
    (r"tokens in [0-9.]+s \([0-9.]+ tok/s", "tokens in <s> (<r> tok/s"),
]


def mask(text: str) -> str:
    for pattern, repl in MASKS:
        text = re.sub(pattern, repl, text)
    return text


def load(relpath: str):
    """Import the script at ``ROOT/relpath`` as a module of its own."""
    name = "script_" + relpath.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, ROOT / relpath)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(mod, *args):
    """``mod.main(*args)``'s return value and everything it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = mod.main(*args)
    return ret, buf.getvalue()


def assert_same_stdout(original: str, port: str) -> None:
    assert mask(port).splitlines() == mask(original).splitlines()


# ---------------------------------------------------------------- CIM path

def test_quickstart_matches_reference():
    _, want = run_main(load("examples/quickstart.py"))
    _, got = run_main(load("examples/quickstart_torch.py"), ["--device", "cpu"])
    assert "592 CIM reads, 4 DCOM ops -> matches reference: True" in got
    assert_same_stdout(want, got)


@pytest.mark.parametrize("fmt", ["markdown", "json"])
@pytest.mark.parametrize("faults", [[], ["--fault-prob", "0.01", "--seed",
                                         "3"]], ids=["clean", "faulted"])
def test_explain_matches_reference(fmt, faults):
    argv = ["--workload", "tiny_cnn", "--arch", "isaac-baseline",
            "--format", fmt] + faults
    _, want = run_main(load("tools/explain.py"), argv)
    _, got = run_main(load("tools/explain_torch.py"), argv)
    assert_same_stdout(want, got)
    if fmt == "json":
        meta = json.loads(got)["meta"]
        assert ("fault_retire_attempts" in meta) == bool(faults)


def test_compile_vit_cim_matches_reference():
    _, want = run_main(load("examples/compile_vit_cim.py"))
    _, got = run_main(load("examples/compile_vit_cim_torch.py"), [])
    assert got.count("speedup=") == 3
    assert_same_stdout(want, got)


@pytest.mark.parametrize("mode", ["campaign", "sweep"])
def test_explore_design_space_matches_reference(mode, tmp_path):
    argv = ["--mode", mode, "--workloads", "tiny_cnn", "--compare-workload",
            "tiny_cnn", "--workers", "1", "--fresh"]
    rc_j, want = run_main(load("examples/explore_design_space.py"),
                          argv + ["--cache-dir", str(tmp_path / "jax")])
    rc_t, got = run_main(load("examples/explore_design_space_torch.py"),
                         argv + ["--cache-dir", str(tmp_path / "torch")])
    assert rc_j == rc_t == 0
    assert f"cache: {tmp_path / 'torch'}" in got
    assert "cache entries on disk:" in got
    assert_same_stdout(want, got)


# ---------------------------------------------------------------- LM path

def test_serve_lm_tokens_match_reference(monkeypatch):
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import reduced as jreduced
    from repro.models import lm as jlm
    from repro.serving import BatchServer as JServer
    from repro_torch.configs import reduced as treduced
    from repro_torch.models import lm as tlm

    orig = load("examples/serve_lm.py")
    port = load("examples/serve_lm_torch.py")
    carried = {}

    def jinit(cfg, key):
        """The reference's own parameters (drawn at its spec dtypes from
        ``key``), cast to float32."""
        p = jlm.init_params(dataclasses.replace(cfg, dtype=jnp.bfloat16), key)
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
        carried["params"] = jax.tree.map(np.asarray, p)
        return p

    class Server(JServer):
        def serve(self, reqs):
            carried["done"] = super().serve(reqs)
            return carried["done"]

    monkeypatch.setattr(orig, "reduced", lambda c: dataclasses.replace(
        jreduced(c), dtype=jnp.float32))
    monkeypatch.setattr(orig, "lm", type("lm", (), {
        "init_params": staticmethod(jinit)}))
    monkeypatch.setattr(orig, "BatchServer", Server)
    _, want = run_main(orig)

    monkeypatch.setattr(port, "reduced", lambda c: dataclasses.replace(
        treduced(c), dtype=torch.float32))
    monkeypatch.setattr(port, "lm", type("lm", (), {
        "init_params": staticmethod(lambda cfg, gen, device:
                                    tlm.params_from_reference(
                                        carried["params"], cfg, device))}))
    (done, _), got = run_main(port, ["--device", "cpu"])
    want_done = carried["done"]
    assert len(done) == len(want_done) == 10
    for g, w in zip(done, want_done):
        assert (g.rid, len(g.prompt)) == (w.rid, len(w.prompt))
        assert len(g.output) == 12
        assert g.output == w.output, g.rid
    assert "tok/s on CPU)" in got
    assert_same_stdout(want, got)


def test_train_lm_loss_falls_and_resumes(monkeypatch, tmp_path):
    from repro_torch.train import TrainerConfig

    port = load("examples/train_lm_torch.py")
    full = port.build_config("qwen1.5-4b")
    assert (full.n_layers, full.d_model, full.vocab) == (8, 512, 32_768)
    monkeypatch.setattr(port, "build_config", lambda arch: dataclasses.replace(
        full, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512))
    monkeypatch.setattr(port, "TrainerConfig", lambda **kw: TrainerConfig(
        **{**kw, "save_every": 3, "log_every": 1}))
    argv = ["--device", "cpu", "--workdir", str(tmp_path)]
    first, out = run_main(port, argv + ["--steps", "6"])
    assert first["steps"] == 6 and first["nan_steps"] == 0
    assert "resumed" not in out
    recs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert (tmp_path / "ckpt").is_dir()

    second, out = run_main(port, argv + ["--steps", "9"])
    assert "at step 6" in out and second["steps"] == 9
    recs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "loss" in r] == list(range(1, 10))


# ------------------------------------------------------------- golden tool

def test_make_golden_check_reproduces_committed(tmp_path):
    tool = load("tools/make_golden_cim_mvm_torch.py")
    rc, out = run_main(tool, ["--device", "cpu", "--check",
                              "--out", str(tmp_path)])
    assert rc == 0, out
    assert "check: 6/6 fixtures bit-equal" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        sorted(p.name for p in GOLDEN.glob("*.npz"))
    for path in GOLDEN.glob("*.npz"):
        with np.load(path) as want, np.load(tmp_path / path.name) as got:
            assert sorted(want.files) == sorted(got.files)
            for k in want.files:
                assert want[k].dtype == got[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_make_golden_check_reports_a_flipped_element(tmp_path, monkeypatch):
    """A copy of the committed fixtures with one output element flipped
    stands in for ``tests/golden/cim_mvm``."""
    golden = tmp_path / "golden"
    shutil.copytree(GOLDEN, golden)
    with np.load(golden / "tiles_saturating.npz") as f:
        arrays = {k: f[k] for k in f.files}
    arrays["y"] = arrays["y"].copy()
    arrays["y"].flat[5] += 1
    np.savez_compressed(golden / "tiles_saturating.npz", **arrays)
    tool = load("tools/make_golden_cim_mvm_torch.py")
    monkeypatch.setattr(tool, "GOLDEN_DIR", golden)
    rc, out = run_main(tool, ["--device", "cpu", "--check", "--out",
                              str(tmp_path / "out")])
    assert rc != 0
    assert "check: 5/6 fixtures bit-equal" in out
    assert re.search(r"MISMATCH y to \S*tiles_saturating\.npz", out), out
