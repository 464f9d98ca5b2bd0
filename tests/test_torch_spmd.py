"""The launch tier's SPMD half: cells as DTensor programs on a
``DeviceMesh`` placed by the reference's partition specs, and the dry
run's per-device counts and collectives read from them, on the CPU.

``placements`` turns every spec form into DTensor placements whose
shards hold the elements JAX's ``NamedSharding`` gives each device of
the reference's 2x16x16 plan.  The ring-model wire bytes of single
collectives and of a two-layer tensor-parallel MLP on a 4x4 plan are
the analytic counts exactly.  The local shards of every architecture's
cells hold ``tree_shard_bytes`` on both production plans, and a cell's
per-device FLOPs lie between its global count over the mesh and its
global count.  On a world-size-1 gloo mesh the reduced qwen1.5-4b,
gemma2-2b and mixtral-8x7b cells as DTensor programs equal the plain
cells bit for bit, with the levers on and off.  The reference's dry run
of qwen1.5-4b's decode_32k and train_4k cells on 16x16 (in a process
of its own with 512 host devices) stands beside the port's records, and
``restore_resharded`` places the reference's checkpoint bit for bit.
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
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    _compute_local_shape_and_global_offset

from repro_torch.analysis import roofline
from repro_torch.checkpoint import restore_resharded
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.configs.base import SHAPES, ShapeSpec, shapes_for
from repro_torch.launch import dryrun, mesh as tmesh, sharding as shd, steps
from repro_torch.models.layers import tree_leaves
from repro_torch.models.perfopts import OPTIMIZED

ROOT = pathlib.Path(__file__).resolve().parent.parent
PLANS = {"16x16": tmesh.make_production_mesh(),
         "2x16x16": tmesh.make_production_mesh(multi_pod=True)}


def _reference(code: str, timeout: int = 300) -> dict:
    """Run ``code`` (which prints one JSON object last) with the JAX
    package on 512 host devices, in a process of its own."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=timeout)
    return json.loads(out.stdout.strip().splitlines()[-1])


# ------------------------------------------------------------ placements

@pytest.mark.parametrize("spec,want", [
    ((), (Replicate(), Replicate())),
    ((None,), (Replicate(), Replicate())),
    (("model",), (Shard(0), Replicate())),
    ((None, "model"), (Shard(1), Replicate())),
    (("data", "model"), (Shard(1), Shard(0))),
    (("model", "data"), (Shard(0), Shard(1))),
])
def test_placements_of_each_spec_form(spec, want):
    """One placement per mesh axis, in the mesh's axis order."""
    m = tmesh.Mesh(("model", "data"), (4, 2))
    assert shd.placements(spec, m) == want


def test_placements_of_an_axis_tuple_and_its_refusals():
    m = PLANS["2x16x16"]
    assert shd.placements((("pod", "data"), None, "model"), m) == \
        (Shard(0), Shard(0), Shard(2))
    # a trailing None is dropped by spec_for and changes nothing here
    assert shd.placements((("pod", "data"), None), m) == \
        shd.placements((("pod", "data"),), m)
    with pytest.raises(ValueError, match="order"):
        shd.placements((("data", "pod"),), m)
    with pytest.raises(ValueError, match="twice"):
        shd.placements(("model", "model"), m)
    assert shd.local_shape((64, 3, 32), (("pod", "data"), None, "model"),
                           m) == (2, 3, 2)


def test_placements_hold_jax_element_order_on_the_reference_plan():
    """Every device's shard under ``placements`` starts and ends where
    ``NamedSharding.devices_indices_map`` puts that device's shard."""
    shape, spec = (64, 3, 32), (("pod", "data"), None, "model")
    ref = _reference(
        "import json, jax\n"
        "from jax.sharding import NamedSharding, PartitionSpec as P\n"
        "from repro.launch.mesh import make_production_mesh\n"
        "mesh = make_production_mesh(multi_pod=True)\n"
        "ns = NamedSharding(mesh, P(('pod', 'data'), None, 'model'))\n"
        f"idx = ns.devices_indices_map({shape})\n"
        "out = {}\n"
        "for c, d in zip(__import__('numpy').ndindex(mesh.devices.shape),\n"
        "                mesh.devices.flat):\n"
        "    out[','.join(map(str, c))] = [[s.start or 0, s.stop or n]\n"
        f"        for s, n in zip(idx[d], {shape})]\n"
        "print(json.dumps(out))\n")
    m = PLANS["2x16x16"]
    place = shd.placements(spec, m)
    assert len(ref) == 512
    for coord, want in ref.items():
        c = [int(x) for x in coord.split(",")]
        size, off = _compute_local_shape_and_global_offset(
            shape, m.axis_sizes, c, place)
        assert [[o, o + n] for o, n in zip(off, size)] == want, coord


# ------------------------------------------------------------ collectives

def _dt(local_shape, dm, place, dtype=torch.float32):
    return DTensor.from_local(torch.empty(local_shape, dtype=dtype,
                                          device="meta"), dm, place,
                              run_check=False)


def test_ring_model_bytes_of_single_collectives():
    plan = tmesh.Mesh(("data", "model"), (4, 4))
    b, n = 64, 128                      # a (b, n) float32 tensor
    whole = b * n * 4
    with tmesh.plan_group():
        dm = plan.device_mesh()
        assert roofline.axis_links(dm) == {"data": "infiniband",
                                           "model": "nvlink"}
        cases = [   # (from, to, kind, wire bytes, link)
            ((Replicate(), Shard(0)), (Replicate(), Replicate()),
             "all-gather", whole * 3 / 4, roofline.NVLINK_BW),
            ((Replicate(), Partial()), (Replicate(), Replicate()),
             "all-reduce", 2 * whole * 3 / 4, roofline.NVLINK_BW),
            ((Replicate(), Partial()), (Replicate(), Shard(0)),
             "reduce-scatter", whole / 4 * 3, roofline.NVLINK_BW),
            ((Replicate(), Shard(0)), (Replicate(), Shard(1)),
             "all-to-all", whole / 4 * 3 / 4, roofline.NVLINK_BW),
            ((Shard(0), Replicate()), (Replicate(), Replicate()),
             "all-gather", whole * 3 / 4, roofline.IB_BW),
        ]
        for src, dst, kind, wire, bw in cases:
            local = shd.local_shape((b, n), _spec(src, plan), plan)
            t = _dt(local, dm, src)
            with roofline.OpCounter() as c:
                t.redistribute(dm, dst)
            assert dict(c.collectives) == {kind: wire}, (src, dst)
            assert c.collective_count == 1
            assert c.collective_s == wire / bw


def _spec(place, plan):
    """The partition spec of plain Shard/Replicate placements (Partial
    counts as Replicate: the local shard is whole)."""
    dims = {}
    for ax, p in zip(plan.axis_names, place):
        if isinstance(p, Shard):
            dims.setdefault(p.dim, []).append(ax)
    n = max(dims, default=-1) + 1
    return tuple((tuple(dims[d]) if len(dims[d]) > 1 else dims[d][0])
                 if d in dims else None for d in range(n))


def test_ring_model_bytes_of_a_tensor_parallel_mlp():
    """Column- then row-parallel on "model", batch on "data": the one
    all-reduce of the (B/4, D) partial result over 4 ranks."""
    plan = tmesh.Mesh(("data", "model"), (4, 4))
    b, d, f = 32, 64, 256
    with tmesh.plan_group():
        dm = plan.device_mesh()
        x = _dt((b // 4, d), dm, (Shard(0), Replicate()))
        w1 = _dt((d, f // 4), dm, (Replicate(), Shard(1)))
        w2 = _dt((f // 4, d), dm, (Replicate(), Shard(0)))
        with roofline.OpCounter() as c:
            y = torch.relu(x @ w1) @ w2
            y = y.redistribute(dm, (Shard(0), Replicate()))
        assert y.placements == (Shard(0), Replicate())
        want = 2 * (b // 4) * d * 4 * 3 / 4
        assert dict(c.collectives) == {"all-reduce": want}
        assert c.collective_count == 1
        # per-device matmul FLOPs: the local shards' products
        assert c.flops == 2 * (b // 4) * d * (f // 4) * 2


# ------------------------------------------------------- resident bytes

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_local_shards_hold_tree_shard_bytes(name):
    cfg = get_config(name)
    with tmesh.plan_group():
        for plan in PLANS.values():
            dm = plan.device_mesh()
            for shape in shapes_for(cfg):
                cell = steps.build_cell(cfg, shape, plan)
                args = cell.materialize("meta", mesh=dm)
                for a, spec_tree, dt in zip(cell.args, cell.in_shardings,
                                            args):
                    if isinstance(a, int):
                        continue
                    assert dryrun.local_bytes(dt) == \
                        shd.tree_shard_bytes(a, spec_tree, plan), \
                        (name, shape.name, plan.name)


def test_per_device_flops_lie_between_split_and_whole():
    cfg = dryrun._depth(get_config("qwen1.5-4b"), 1, 0)
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=1024)
    whole = roofline.count(*_meta(steps.build_cell(cfg, shape)))[0]
    plan = PLANS["16x16"]
    with tmesh.plan_group():
        cell = steps.build_cell(cfg, shape, plan)
        c = roofline.count_all(cell.fn, *cell.materialize(
            "meta", mesh=plan.device_mesh()))
    assert whole / plan.size <= c.flops <= whole
    assert c.collective_count > 0 and c.collective_s > 0


def _meta(cell):
    return (cell.fn,) + cell.materialize("meta")


# ------------------------------------------------- beside the reference

def test_dry_run_beside_the_reference_on_16x16():
    """The JAX package's ``run_cell`` of qwen1.5-4b's decode_32k and
    train_4k on 16x16 and the port's records of the same cells (train's
    global batch cut to 16, one microbatch, which issues the same kinds):
    GSPMD's kinds, collective-permute aside (DTensor issues none), are
    among DTensor's, which adds reduce-scatter.  Counts and bytes differ
    (PERF.md)."""
    ref = _reference(
        "import json\n"
        "from repro.launch import dryrun\n"
        "out = {}\n"
        "for shape in ('decode_32k', 'train_4k'):\n"
        "    r = dryrun.run_cell('qwen1.5-4b', shape, False, verbose=False)\n"
        "    out[shape] = [r['status'], r['collective_count'],\n"
        "                  sorted(r['collectives'])]\n"
        "print(json.dumps(out))\n")
    assert ref == {"decode_32k": ["ok", 482, ["all-gather", "all-reduce"]],
                   "train_4k": ["ok", 8163, ["all-gather", "all-reduce",
                                             "all-to-all",
                                             "collective-permute"]]}
    cfg = get_config("qwen1.5-4b")
    for name, b in (("decode_32k", 128), ("train_4k", 16)):
        rec = dryrun.run_cell(cfg, dataclasses.replace(
            SHAPES[name], global_batch=b), PLANS["16x16"])
        assert rec["status"] == "ok", rec.get("error")
        kinds = set(rec["collectives"])
        assert set(ref[name][2]) - {"collective-permute"} <= kinds, kinds
        assert kinds - set(ref[name][2]) <= {"reduce-scatter"}, kinds
        assert rec["collective_count"] > 0 and rec["collective_s"] > 0


# ----------------------------------------------- one-device DTensor cells

@pytest.fixture
def host_mesh():
    """A 1x1 CPU host mesh and its gloo group, destroyed afterwards."""
    m = tmesh.make_host_mesh(device="cpu")
    dm = m.device_mesh()
    try:
        yield m, dm
    finally:
        dist.destroy_process_group()


def _full(tree):
    return [t.full_tensor() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree)]


@pytest.mark.parametrize("name", ["qwen1.5-4b", "gemma2-2b",
                                  "mixtral-8x7b"])
@pytest.mark.parametrize("perf", [None, OPTIMIZED],
                         ids=["default", "optimized"])
def test_dtensor_cells_equal_plain_cells_on_one_device(name, perf,
                                                       host_mesh):
    m, dm = host_mesh
    cfg = dataclasses.replace(reduced(ARCHS[name]), dtype=torch.float32)
    for shape in (ShapeSpec("p", "prefill", 64, 2),
                  ShapeSpec("d", "decode", 32, 2),
                  ShapeSpec("t", "train", 32, 2)):
        cell = steps.build_cell(cfg, shape, m, perf=perf)
        plain = cell.materialize("cpu", torch.Generator().manual_seed(3))
        spmd = cell.materialize("cpu", torch.Generator().manual_seed(3),
                                mesh=dm)
        assert isinstance(tree_leaves(spmd[0])[0], DTensor)
        if shape.kind == "train":       # drawn second moments: made >= 0
            for args in (plain, spmd):
                for v in tree_leaves(args[1].nu):
                    v.abs_()
        want, got = cell.fn(*plain), cell.fn(*spmd)
        for w, g in zip(_full(want), _full(got)):
            assert not w.is_floating_point() or torch.isfinite(w).all()
            assert torch.equal(w, g), (name, shape.name)
        # the train step updated both sets of parameters alike
        for w, g in zip(_full(plain[:2]), _full(spmd[:2])):
            assert torch.equal(w, g), (name, shape.name)


def test_sharding_constraint_redistributes_a_dtensor(host_mesh):
    from repro_torch.models.layers import with_sharding_constraint
    m, dm = host_mesh
    x = torch.arange(24.).reshape(2, 3, 4)
    d = distribute_tensor(x, dm, (Replicate(), Replicate()))
    y = with_sharding_constraint(d, m, (None, "model"))
    assert y.placements == (Replicate(), Shard(1))
    assert torch.equal(y.full_tensor(), x)
    assert with_sharding_constraint(x, m, (None, "model")) is x


def test_restore_resharded_places_the_reference_checkpoint(tmp_path,
                                                           host_mesh):
    import jax.numpy as jnp
    from repro.checkpoint import checkpoint as jckpt
    m, dm = host_mesh
    rng = np.random.default_rng(0)
    ref = {"w": rng.standard_normal((4, 6)).astype(np.float32),
           "b": jnp.asarray(rng.standard_normal((6,)), jnp.bfloat16),
           "n": np.arange(5, dtype=np.int32)}
    path = jckpt.save_checkpoint(str(tmp_path), 3, ref, {"k": 1})
    like = {"w": torch.empty(4, 6), "b": torch.empty(6, dtype=torch.bfloat16),
            "n": torch.empty(5, dtype=torch.int32)}
    specs = {"w": (None, "model"), "b": ("data",), "n": ()}
    tree, extra = restore_resharded(path, like, specs, m, dm)
    assert extra == {"k": 1}
    assert tree["w"].placements == (Replicate(), Shard(1))
    assert torch.equal(tree["w"].full_tensor(), torch.from_numpy(ref["w"]))
    assert torch.equal(tree["n"].full_tensor(), torch.from_numpy(ref["n"]))
    bits = np.asarray(ref["b"]).view(np.int16)
    assert torch.equal(tree["b"].full_tensor().view(torch.int16),
                       torch.from_numpy(bits))
    with pytest.raises(ValueError, match="no devices"):
        restore_resharded(path, like, specs, PLANS["16x16"])
