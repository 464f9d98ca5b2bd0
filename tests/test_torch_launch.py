"""The port's launch tier and roofline against the JAX package's, on the
CPU.

Partition specs of every architecture's parameters (train and serve
rules), optimizer state and caches equal the reference's on its 16x16
and 2x16x16 production meshes (the reference is given a
``jax.sharding.AbstractMesh``, so no devices are faked); the cells'
batch specs and shardings too.  ``model_params`` and ``model_flops``
equal the reference's exactly for every architecture and shape.  The
FLOPs counted on "meta" for a reduced prefill cell equal an analytic
count and the reference's HLO walk of the same computation exactly.  The
dry run completes every reduced cell on both plans as a DTensor program,
with its collective term.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.analysis import roofline as jroof
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import shapes_for as jshapes_for
from repro.launch import sharding as jshd
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch.analysis import roofline
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import SHAPES, ShapeSpec, shapes_for
from repro_torch.launch import dryrun, mesh as tmesh, sharding as shd, steps
from repro_torch.models import lm as tlm
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.perfopts import OPTIMIZED

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    sizes, names = MESHES[name]
    port = tmesh.make_production_mesh(multi_pod=name == "2x16x16")
    assert (port.axis_sizes, port.axis_names) == (sizes, names)
    return AbstractMesh(sizes, names), port


def _ref_specs(tree):
    return [tuple(s.spec) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))]


def _port_specs(tree):
    """Partition-spec leaves of a tree of them, in ``tree_leaves``
    order (a spec is a tuple whose entries are names, tuples of names
    or None)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_specs(tree[k])]
    if isinstance(tree, tuple) and not hasattr(tree, "_fields") and all(
            e is None or isinstance(e, str)
            or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
            for e in tree):
        return [tree]
    return [x for v in tree for x in _port_specs(v)]


# ------------------------------------------------------------ sharding

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_partition_specs_match_reference(name, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    jcfg, cfg = JARCHS[name], ARCHS[name]
    for kind in ("train", "serve"):
        want = jshd.tree_shardings(
            jlm.param_specs(jcfg), jlm.logical_axes(jcfg), jmesh,
            jshd.param_rules(jcfg, jmesh, kind))
        got = shd.tree_shardings(tlm.param_specs(cfg), tlm.logical_axes(cfg),
                                 mesh, shd.param_rules(cfg, mesh, kind))
        assert _port_specs(got) == _ref_specs(want), kind
        assert len(_port_specs(got)) == len(tree_leaves(tlm.param_specs(cfg)))
    enc = 64 if cfg.enc_dec else 0
    jc, jax_axes = jlm.cache_specs(jcfg, 128, 32768, enc)
    want = jshd.tree_shardings(jc, jax_axes, jmesh,
                               jshd.cache_rules(jcfg, jmesh, "serve"))
    got = shd.tree_shardings(tlm.cache_specs(cfg, 128, 32768, enc),
                             tlm.cache_axes(cfg, 128, 32768, enc), mesh,
                             shd.cache_rules(cfg, mesh, "serve"))
    assert _port_specs(got) == _ref_specs(want)


def test_spec_for_falls_back_to_replication():
    _, mesh = _meshes("16x16")
    rules = {"big": ("data",), "odd": ("data",), "both": ("data", "model"),
             None: None}
    assert shd.spec_for((64, 7), ("big", "odd"), mesh, rules) == ("data",)
    assert shd.spec_for((7,), ("odd",), mesh, rules) == ()
    assert shd.spec_for((512, 32), ("both", "big"), mesh, rules) == \
        (("data", "model"),)         # "data" is taken by the first dim
    _, pod = _meshes("2x16x16")
    assert shd.batch_sharding(pod, 3) == (("pod", "data"), None, None)
    assert shd.replicated(pod) == ()


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("name", ["qwen2-vl-2b", "seamless-m4t-large-v2",
                                  "mixtral-8x7b"])
def test_cell_batch_and_state_specs_match_reference(name, shape_name):
    jmesh, mesh = _meshes("2x16x16")
    jcfg, cfg = JARCHS[name], ARCHS[name]
    jshape, shape = JSHAPES[shape_name], SHAPES[shape_name]
    want = jsteps.batch_specs(jcfg, jshape)
    got = steps.batch_specs(cfg, shape)
    assert {k: (v.shape, str(v.dtype)) for k, v in want.items()} == \
        {k: (v.shape, str(v.dtype).replace("torch.", ""))
         for k, v in got.items()}
    wsh = jsteps.batch_shardings(jcfg, jshape, jmesh, want)
    gsh = steps.batch_shardings(cfg, shape, mesh, got)
    assert {k: tuple(v.spec) for k, v in wsh.items()} == gsh
    assert steps.default_microbatches(cfg, shape, mesh) == \
        jsteps.default_microbatches(jcfg, jshape, jmesh)
    cell = steps.build_cell(cfg, shape, mesh)
    assert cell.name == f"{name}:{shape_name}" and cell.mesh is mesh
    if shape.kind == "train":
        want_mu = jshd.tree_shardings(
            jlm.param_specs(jcfg), jlm.logical_axes(jcfg), jmesh,
            jshd.param_rules(jcfg, jmesh, "train"))
        assert _port_specs(cell.in_shardings[1].mu) == _ref_specs(want_mu)
        assert cell.in_shardings[1].count == ()
    else:
        assert len(tree_leaves(cell.out_shardings[1])) > 0


# ---------------------------------------------------------------- mesh

def test_meshes():
    mesh = tmesh.make_production_mesh()
    assert mesh.shape == {"data": 16, "model": 16} and mesh.size == 256
    assert mesh.name == "16x16" and mesh.devices == ()
    pod = tmesh.make_production_mesh(multi_pod=True)
    assert list(pod.shape) == ["pod", "data", "model"] and pod.size == 512
    host = tmesh.make_host_mesh(model=4, device="cpu")
    assert host.shape == {"data": 1, "model": 1} and host.devices == ("cpu",)
    with pytest.raises(ValueError):
        tmesh.Mesh(("data",), (2, 2))


# ------------------------------------------------------------ roofline

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_model_params_and_flops_match_reference(name):
    jcfg, cfg = JARCHS[name], ARCHS[name]
    assert roofline.model_params(cfg) == jroof.model_params(jcfg)
    assert [s.name for s in shapes_for(cfg)] == \
        [s.name for s in jshapes_for(jcfg)]
    for shape in shapes_for(cfg):
        assert roofline.model_flops(cfg, shape) == \
            jroof.model_flops(jcfg, JSHAPES[shape.name])


def test_terms_on_one_card_and_on_a_mesh():
    cfg = ARCHS["mixtral-8x7b"]
    shape = SHAPES["train_4k"]
    useful = roofline.model_flops(cfg, shape) / 256
    t = roofline.terms({"flops": useful * 3, "hbm_bytes": 1e11,
                        "collective_s": 100.0}, cfg, shape, 256)
    assert t["collective_s"] == 100.0 and "collective" not in t
    assert t["useful_flops_frac"] == pytest.approx(1 / 3)
    assert t["memory_s"] == pytest.approx(1e11 / 3.35e12)
    assert t["bottleneck"] == "collective"
    assert t["compute_s"] < 100.0
    assert t["roofline_frac"] == pytest.approx(useful / 989e12 / 100.0)
    one = roofline.terms({"flops": 989e12, "hbm_bytes": 0.0}, cfg, shape, 1)
    assert one["collective_s"] == 0.0 and one["compute_s"] == 1.0
    assert one["bottleneck"] == "compute"


def _analytic_prefill_flops(cfg, b, s):
    """Matmul FLOPs of a prefill of an attention + gated-MLP model at
    (b, s) in one 512-block: projections, QK^T and AV over the whole
    block, the MLP, and the last position's logits."""
    d, h, k, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.head_dim, cfg.d_ff)
    t = b * s
    per_layer = (2 * t * d * (h + 2 * k) * hd + 2 * 2 * b * h * s * s * hd
                 + 2 * t * h * hd * d + 3 * 2 * t * d * f)
    return cfg.n_layers * per_layer + 2 * b * d * cfg.vocab


def test_counted_prefill_flops_match_analytic_and_reference_walk():
    b, s = 2, 64
    cfg = dataclasses.replace(reduced(ARCHS["qwen1.5-4b"]),
                              dtype=torch.float32)
    cell = steps.build_cell(cfg, ShapeSpec("p", "prefill", s, b))
    flops, nbytes = roofline.count(cell.fn, *cell.materialize("meta"))
    assert flops == _analytic_prefill_flops(cfg, b, s)
    assert nbytes > sum(math.prod(t.shape) * 4
                        for t in tree_leaves(tlm.param_specs(cfg)))
    jcfg = dataclasses.replace(jreduced(JARCHS["qwen1.5-4b"]),
                               dtype=jnp.float32)
    compiled = jax.jit(lambda p, bt: jlm.prefill(p, jcfg, bt)).lower(
        jlm.param_specs(jcfg),
        {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}).compile()
    walked = jroof.parse_collectives(compiled.as_text(), 1)["walked_flops"]
    assert flops == walked, (flops, walked)


def test_counts_follow_the_levers_on_meta():
    """Triangular prefill counts one of four block pairs fewer;
    decode_opt's decode moves fewer bytes (no float32 cache copy)."""
    cfg = reduced(ARCHS["qwen1.5-4b"])
    shape = ShapeSpec("p", "prefill", 1024, 1)
    dense = roofline.count(*_meta(steps.build_cell(cfg, shape)))
    tri = roofline.count(*_meta(steps.build_cell(cfg, shape,
                                                 perf=OPTIMIZED)))
    pair = 2 * 2 * cfg.n_heads * 512 * 512 * cfg.head_dim
    assert dense[0] - tri[0] == pair * cfg.n_layers    # one of 4 pairs
    shape = ShapeSpec("d", "decode", 4096, 2)
    dense = roofline.count(*_meta(steps.build_cell(cfg, shape)))
    opt = roofline.count(*_meta(steps.build_cell(cfg, shape,
                                                 perf=OPTIMIZED)))
    # the same products, plus the current token's score beside the cache
    assert opt[0] - dense[0] == 2 * 2 * cfg.n_heads * cfg.head_dim \
        * cfg.n_layers
    assert opt[1] < dense[1]


def _meta(cell):
    return (cell.fn,) + cell.materialize("meta")


# ------------------------------------------------------------- cells

def test_decode_cell_runs_the_decode_step_on_cpu():
    cfg = dataclasses.replace(reduced(ARCHS["gemma2-2b"]),
                              dtype=torch.float32)
    cell = steps.build_cell(cfg, ShapeSpec("d", "decode", 16, 2),
                            perf=OPTIMIZED)
    params, cache, batch, pos = cell.materialize(
        "cpu", torch.Generator().manual_seed(0))
    assert pos == 15 and cache["unit"]["u0"]["k"].shape[2] == 16
    want = tlm.decode_step(params, cfg, tree_map(torch.clone, cache), batch,
                           pos)[0]
    logits, out = cell.fn(params, cache, batch, pos)
    assert out is cache and torch.isfinite(logits).all()
    assert float((logits - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_train_cell_takes_a_step_on_cpu():
    cfg = reduced(ARCHS["qwen1.5-4b"])
    cell = steps.build_cell(cfg, ShapeSpec("t", "train", 16, 2))
    params, opt, batch = cell.materialize("cpu", torch.Generator())
    before = params["embed"].clone()
    _, opt, metrics = cell.fn(params, opt, batch)
    assert int(opt.count) == 1 and torch.isfinite(metrics["loss"])
    assert not torch.equal(params["embed"], before)


# ------------------------------------------------------------- dry run

def test_dryrun_all_reduced_cells(tmp_path, capsys):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--all", "--reduced", "--mesh", "both", "--out",
                        str(out), "--workers", "4"]) == 0
    recs = json.loads(out.read_text())
    assert len(recs) == 2 * sum(len(shapes_for(c)) for c in ARCHS.values())
    assert all(r["status"] == "ok" for r in recs)
    assert {r["arch"] for r in recs} >= {"qwen2-vl-2b-reduced"}
    for r in recs:
        assert r["flops"] > 0 and r["hbm_bytes"] > 0 and r["fits_80gb"]
        assert r["n_chips"] in (256, 512)
        assert r["collective_s"] >= 0 and r["collective_count"] >= 0
        assert set(r["collectives"]) <= set(roofline.COLLECTIVES)
        assert r["collective_bytes"] == pytest.approx(
            sum(r["collectives"].values()))
    # a rerun finds every cell done
    assert dryrun.main(["--all", "--reduced", "--mesh", "both", "--out",
                        str(out)]) == 0
    assert capsys.readouterr().out.count("(cached)") == len(recs)


def test_dryrun_per_device_bytes_of_a_production_cell():
    cfg = ARCHS["qwen1.5-4b"]
    mesh = tmesh.make_production_mesh()
    rec = dryrun.run_cell(cfg, dataclasses.replace(SHAPES["decode_32k"],
                                                   global_batch=16), mesh)
    assert rec["status"] == "ok", rec.get("error")
    per = rec["bytes_per_device"]
    # serve rules: the embedding's vocab and the heads on "model" (16);
    # the cache's batch on "data" and sequence on "model"
    kv = 2 * cfg.n_layers * 16 * 32768 * cfg.n_kv_heads * cfg.head_dim * 2
    assert per["cache"] == kv // 256
    assert per["params"] < 8e9 / 16 + 1e6
    # per-device counts from the local ops: at most the whole step's
    # (counted on one device), at least its share of 256
    one = dryrun.run_cell(cfg, dataclasses.replace(
        SHAPES["decode_32k"], global_batch=16), steps.ONE_DEVICE)
    assert one["collective_count"] == 0 and one["collective_s"] == 0
    assert one["flops"] / 256 <= rec["flops"] <= one["flops"]
    assert rec["collective_count"] > 0 and rec["collective_s"] > 0
    assert rec["links"] == {"data": "infiniband", "model": "infiniband"}
    np.testing.assert_allclose(rec["memory_s"],
                               rec["hbm_bytes"] / roofline.HBM_BW)
    np.testing.assert_allclose(rec["collective_s"],
                               rec["collective_bytes"] / roofline.IB_BW)
