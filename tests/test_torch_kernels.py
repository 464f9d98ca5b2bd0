"""The port's crossbar MVM against the JAX package's, on the CPU.

The plain PyTorch version (``repro_torch.kernels.cim_mvm.ref``) is held
to ``repro.kernels.cim_mvm.ref`` bit for bit (tolerance 0: the path is
integer) on seeded random shapes, the committed goldens replay through
the port's three entry points, and the route registry's auto and raise
cases are pinned, and the wgmma kernel's launch planner is checked on
every main-path shape (shared memory, k-step padding, each term covered
once, whole waves of blocks, the 16-byte rule that picks TMA or
``cp.async`` for each operand, the ring's depth and residency).  The CUDA kernel itself is held to the
plain version by the ``cuda``-marked tests, which run on a card only; a
card host without JAX collects this file too and runs just the port's
side.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import backend
from repro_torch.kernels.cim_mvm import (CimMvmParams, cim_mvm,
                                         cim_mvm_signed, cim_mvm_tiles, kernel)
from repro_torch.kernels.cim_mvm import ref as tref

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = sorted((ROOT / "tests" / "golden" / "cim_mvm").glob("*.npz"))
ENTRY = {"cim_mvm": cim_mvm, "cim_mvm_tiles": cim_mvm_tiles,
         "cim_mvm_signed": cim_mvm_signed}

#: (T, M, R, C) with R not a multiple of parallel_row in most cases
SHAPES = [(1, 5, 37, 9), (3, 4, 130, 17), (2, 7, 300, 20), (1, 2, 8, 1)]
PARAMS = [
    CimMvmParams(8, 8, 1, 2, 8, 8),        # ISAAC-like, exact
    CimMvmParams(8, 8, 1, 2, 8, 4),        # saturating ADC
    CimMvmParams(8, 8, 8, 8, 128, 4),      # 8-bit planes, saturating
    CimMvmParams(8, 8, 8, 2, 128, 8),      # PUMA-like
    CimMvmParams(8, 8, 1, 1, 1152, 8),     # jia-issc21, saturating
    CimMvmParams(8, 8, 3, 2, 16, 7),       # planes past the low byte
    CimMvmParams(8, 8, 1, 2, 100, 5),      # groups not a multiple of 32
    CimMvmParams(8, 8, 1, 2, 300, 6),      # likewise, longer than a chunk
    CimMvmParams(8, 8, 8, 2, 128, 1),      # PUMA: 1-bit ADC, adc_max 1
    CimMvmParams(8, 8, 1, 1, 32, 6),       # jain-jssc21: adc_max 63
]


try:
    import jax
    import jax.numpy as jnp
    from repro.kernels.cim_mvm import ref as jref
except ImportError:           # a card host without JAX
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="JAX is not installed")

if jax is not None:
    _STATIC = ("act_bits", "weight_bits", "dac_bits", "cell_bits",
               "parallel_row", "adc_bits")
    #: the JAX oracles, compiled once per shape, not dispatched op by op
    JAX_TILES = jax.jit(jref.cim_mvm_ref_tiles, static_argnames=_STATIC)
    JAX_MVM = jax.jit(jref.cim_mvm_ref, static_argnames=_STATIC)


def _pid(p: CimMvmParams) -> str:
    return "-".join(str(v) for v in dataclasses.astuple(p))


def _kw(p: CimMvmParams) -> dict:
    return dict(act_bits=p.act_bits, weight_bits=p.weight_bits,
                dac_bits=p.dac_bits, cell_bits=p.cell_bits,
                parallel_row=p.parallel_row, adc_bits=p.adc_bits)


def _operands(shape, p, seed):
    t, m, r, c = shape
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << p.act_bits, (t, m, r)).astype(np.int32)
    w = rng.integers(0, 1 << p.weight_bits, (t, r, c)).astype(np.int32)
    return x, w


def _load(path):
    z = np.load(path)
    p = CimMvmParams(*(int(v) for v in z["params"]))
    return str(z["kind"]), z["x"], z["w"], z["y"], p


# ------------------------------------------ plain version vs the JAX oracle

@needs_jax
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("p", PARAMS, ids=_pid)
def test_plain_tiles_matches_jax_ref(shape, p):
    x, w = _operands(shape, p, seed=sum(shape) * 31 + p.parallel_row)
    want = np.asarray(JAX_TILES(jnp.asarray(x), jnp.asarray(w), **_kw(p)))
    got = tref.cim_mvm_ref_tiles(torch.from_numpy(x), torch.from_numpy(w),
                                 **_kw(p))
    np.testing.assert_array_equal(got.numpy(), want)


@needs_jax
@pytest.mark.parametrize("p", PARAMS, ids=_pid)
def test_plain_mvm_and_entry_points_match_jax_ref(p):
    x, w = _operands((1, 6, 97, 11), p, seed=p.adc_bits)
    want = np.asarray(JAX_MVM(jnp.asarray(x[0]), jnp.asarray(w[0]), **_kw(p)))
    xt, wt = torch.from_numpy(x[0]), torch.from_numpy(w[0])
    np.testing.assert_array_equal(tref.cim_mvm_ref(xt, wt, **_kw(p)).numpy(),
                                  want)
    np.testing.assert_array_equal(cim_mvm(xt, wt, p).numpy(), want)
    np.testing.assert_array_equal(cim_mvm(xt[0], wt, p).numpy(), want[0])


@needs_jax
def test_bit_planes_adc_and_exact_bits_match_jax():
    x = np.random.default_rng(3).integers(0, 256, (4, 33)).astype(np.int32)
    for total, plane in ((8, 1), (8, 2), (8, 3), (8, 8), (4, 2)):
        np.testing.assert_array_equal(
            tref.bit_planes(torch.from_numpy(x), total, plane).numpy(),
            np.asarray(jref.bit_planes(jnp.asarray(x), total, plane)))
    v = np.arange(-5, 300, dtype=np.int32)
    for bits in (1, 4, 8):
        np.testing.assert_array_equal(
            tref.adc_saturate(torch.from_numpy(v), bits).numpy(),
            np.asarray(jref.adc_saturate(jnp.asarray(v), bits)))
    for args in ((8, 8, 1, 2, 8), (8, 8, 1, 1, 1152), (8, 8, 8, 2, 128)):
        assert tref.exact_adc_bits(*args) == jref.exact_adc_bits(*args)


def test_signed_matches_integer_matmul_under_wide_adc():
    p = CimMvmParams(8, 8, 1, 2, 8, 16)
    rng = np.random.default_rng(11)
    x = rng.integers(-128, 128, (9, 200)).astype(np.int32)
    w = rng.integers(-128, 128, (200, 33)).astype(np.int32)
    y = cim_mvm_signed(torch.from_numpy(x), torch.from_numpy(w), p)
    np.testing.assert_array_equal(y.numpy(),
                                  x.astype(np.int64) @ w.astype(np.int64))


# ---------------------------------------------------------- golden replay

def test_golden_fixtures_cover_every_entry_point():
    assert len(GOLDEN) == 6
    assert {_load(path)[0] for path in GOLDEN} == set(ENTRY)


@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_golden_replay(path):
    kind, x, w, y, p = _load(path)
    got = ENTRY[kind](torch.from_numpy(x), torch.from_numpy(w), p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), y)
    np.testing.assert_array_equal(
        ENTRY[kind](torch.from_numpy(x), torch.from_numpy(w), p,
                    mode="torch").numpy(), y)


# ------------------------------------------------------------- registry

def test_auto_route_follows_the_device():
    for name in backend.REGISTRY:
        assert backend.resolve(name, device="cpu").mode == "torch"
        assert backend.resolve(name, platform="cuda").mode == "compiled"
    with pytest.raises(backend.KernelUnsupportedError, match="no kernel"):
        backend.resolve("cim_mvm_tiles", platform="sm_80")
    assert backend.resolve("cim_mvm_tiles", "torch",
                           platform="sm_80").mode == "torch"


def test_unsupported_route_raises():
    with pytest.raises(backend.KernelUnsupportedError):
        backend.resolve("cim_mvm", "compiled", device="cpu")
    x = torch.zeros((2, 8), dtype=torch.int32)
    w = torch.zeros((8, 3), dtype=torch.int32)
    with pytest.raises(backend.KernelUnsupportedError):
        cim_mvm(x, w, CimMvmParams(), mode="compiled")
    with pytest.raises(KeyError):
        backend.resolve("nope")
    with pytest.raises(ValueError):
        backend.resolve("cim_mvm", mode="interpret")


def test_kernel_wrapper_rejects_cpu_tensors():
    x = torch.zeros((1, 2, 8), dtype=torch.uint8)
    w = torch.zeros((1, 8, 3), dtype=torch.uint8)
    before = dict(kernel.LAUNCHES)
    with pytest.raises(backend.KernelArgumentError, match="CUDA"):
        kernel.cim_mvm_tiles_cuda(x, w, CimMvmParams())
    with pytest.raises(backend.KernelArgumentError, match="CUDA"):
        kernel.cim_mvm_cuda(x[0], w[0], CimMvmParams())
    assert kernel.LAUNCHES == before


def test_resolution_precedence(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_KERNEL_MODE", "compiled")
    assert backend.resolve("cim_mvm", platform="cuda").mode == "compiled"
    with pytest.raises(backend.KernelUnsupportedError):
        backend.resolve("cim_mvm", device="cpu")        # env beats auto
    # per-call beats env
    assert backend.resolve("cim_mvm", "torch", platform="cuda").mode == "torch"


def test_jax_route_variable_is_ignored(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_KERNEL_MODE", raising=False)
    for value in ("compiled", "interpret", "xla"):
        monkeypatch.setenv("REPRO_KERNEL_MODE", value)
        assert backend.resolve("cim_mvm_tiles", device="cpu").mode == "torch"
        assert backend.resolve("cim_mvm_tiles",
                               platform="cuda").mode == "compiled"


@pytest.mark.parametrize("platform", ["cpu", "cuda", "sm_80"])
def test_supports_and_capability_matrix_follow_the_registry(platform,
                                                           monkeypatch):
    """``supports`` says what ``REGISTRY`` says, a forced mode resolves
    exactly where it is supported, and the matrix's ``auto_mode`` is
    the route ``resolve`` picks (``None`` where it refuses)."""
    monkeypatch.delenv("REPRO_TORCH_KERNEL_MODE", raising=False)
    matrix = backend.capability_matrix(platform)
    assert sorted(matrix) == sorted(backend.REGISTRY)
    for name, cap in backend.REGISTRY.items():
        for mode in backend.MODES:
            ok = backend.supports(name, mode, platform)
            assert ok == (mode in cap.modes_on(platform))
            if ok:
                assert backend.resolve(name, mode,
                                       platform=platform).mode == mode
            else:
                with pytest.raises(backend.KernelUnsupportedError):
                    backend.resolve(name, mode, platform=platform)
        assert matrix[name]["platforms"] == {
            "cpu": cap.modes_on("cpu"), "cuda": cap.modes_on("cuda")}
        try:
            auto = backend.resolve(name, platform=platform).mode
        except backend.KernelUnsupportedError:
            auto = None
        assert matrix[name]["auto_mode"] == auto == \
            {"cpu": "torch", "cuda": "compiled", "sm_80": None}[platform]


def test_supports_and_capability_matrix_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend.supports("cim_mvm", "torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend.capability_matrix()


def test_operand_dtype():
    assert kernel.operand_dtype(CimMvmParams(8, 8, 1, 1, 1152, 8)) \
        == torch.uint8
    assert kernel.operand_dtype(CimMvmParams(8, 8, 8, 2, 128, 8)) \
        == torch.uint8
    assert kernel.operand_dtype(CimMvmParams(8, 8, 3, 2, 16, 7)) \
        == torch.int32


# ------------------------------------------------------- launch planner

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def main_path():
    """chip_smoke's main path on the CPU: (params, one batch's dispatch
    shapes, the calibration's (1, M, R, C) shapes)."""
    _, _, params, tiles, mvm = _chip_smoke().main_path("cpu")
    return params, tiles, [(1, m, r, c) for m, r, c in mvm]


def _spans(plan: kernel.LaunchPlan):
    """(t, row tile, column tile, groups, phases) of every block, as
    ``wgmma_kernel`` in csrc/cim_mvm.cu decodes its block index."""
    gx, gy, gz = plan.grid
    for t in range(gz):
        for bx in range(gx):
            for by in range(gy):
                g0 = (by // plan.phase_splits) * plan.groups_per_block
                p0 = (by % plan.phase_splits) * plan.phases_per_block
                yield (t, bx // plan.c_tiles, bx % plan.c_tiles,
                       range(g0, min(plan.n_groups,
                                     g0 + plan.groups_per_block)),
                       range(p0, min(plan.n_p, p0 + plan.phases_per_block)))


def _check_plan(plan: kernel.LaunchPlan) -> None:
    """Shared memory fits; the groups tile R and each pads to whole
    k-steps (as the kernel's chunks pad it); the blocks cover each
    (crossbar tile, output tile, group, phase, slice) term exactly once;
    a wgmma plan's phase ranges are equal and its ring is the one its
    load paths give, resident exactly when a whole group fits it."""
    assert plan.smem_bytes <= kernel.SMEM_LIMIT == 232_448
    pr = plan.parallel_row
    lens = [min(pr, plan.r - g * pr) for g in range(plan.n_groups)]
    assert sum(lens) == plan.r and max(lens) == pr and min(lens) > 0
    for g, n in enumerate(lens):
        k = -(-n // kernel.K_STEP)
        assert (k - 1) * kernel.K_STEP < n <= k * kernel.K_STEP, (g, n, k)
    seen = np.zeros((plan.t, plan.m_tiles, plan.c_tiles, plan.n_groups,
                     plan.n_p, plan.n_s), np.int64)
    n_blocks = 0
    for t, mt, ct, groups, phases in _spans(plan):
        assert len(groups) and len(phases)
        seen[t, mt, ct, groups.start:groups.stop,
             phases.start:phases.stop] += 1
        n_blocks += 1
    assert n_blocks == plan.blocks
    assert (seen == 1).all()
    if plan.route == "wgmma":
        assert plan.n_p % plan.phases_per_block == 0
        assert (plan.stages, plan.smem_bytes) == kernel.ring_plan(
            plan.x_path, plan.w_path)
        assert plan.resident == (-(-pr // kernel.WG_KC) <= plan.stages)


@pytest.mark.parametrize("which", ["dispatch", "calibration"])
def test_launch_plan_on_main_path_shapes(main_path, which):
    params, tiles, mvm = main_path
    shapes = sorted(set(tiles if which == "dispatch" else mvm))
    assert len(shapes) >= 10
    for shape in shapes:
        plan = kernel.plan_launch(params, *shape)
        assert plan.route == "wgmma"
        _check_plan(plan)
        # jia's 1152-row groups stay resident on every path
        assert plan.resident, shape
        tiles_only = plan.t * plan.m_tiles * plan.c_tiles
        # a split never adds a wave of blocks to the unsplit launch
        waves = -(-plan.blocks // kernel.TARGET_BLOCKS)
        assert waves <= -(-tiles_only * plan.n_groups * plan.n_p
                          // kernel.TARGET_BLOCKS), shape
        if tiles_only < kernel.TARGET_BLOCKS // 2:
            assert plan.blocks > tiles_only, shape     # small: split
        if shape[1] in (4 * 49, 49) and shape[2] >= 2304:
            # layer 4's 3x3 convolutions (7x7 outputs): a wave of blocks
            # even with 8-16 output tiles
            assert plan.blocks >= kernel.SM_COUNT - 4, (shape, plan.grid)


def test_launch_plan_on_sweep_and_test_params():
    cases = [c for c in _chip_smoke()._sweep()] + [
        (*shape, p) for shape in SHAPES for p in PARAMS]
    for t, m, r, c, p in cases:
        plan = kernel.plan_launch(p, t, m, r, c)
        assert plan.route == ("cuda_core" if kernel.operand_dtype(p)
                              == torch.int32 else "wgmma")
        _check_plan(plan)


def test_launch_plan_split_policy():
    jia = CimMvmParams(8, 8, 1, 1, 1152, 8)
    # layer 4: 8 output tiles, 4 groups, phases in 4 ranges: one wave
    plan = kernel.plan_launch(jia, 1, 196, 4608, 128)
    assert plan.grid == (8, 16, 1) and plan.group_splits == 4
    assert plan.phases_per_block == 2
    # the LM block's 128 tiles fill the card: no split, one atomic add
    plan = kernel.plan_launch(jia, 1, 1024, 854, 512)
    assert plan.grid == (128, 1, 1)
    # groups split before phases: two 1152-row groups, all phases a block
    plan = kernel.plan_launch(jia, 1, 784, 2304, 256)
    assert plan.group_splits == 2 and plan.phase_splits == 1
    # 196 tiles are 1.5 waves: two phase ranges make three even ones
    plan = kernel.plan_launch(jia, 1, 12544, 576, 64)
    assert plan.grid == (196, 2, 1)
    # int32 operands: the CUDA-core kernel, never split
    plan = kernel.plan_launch(CimMvmParams(8, 8, 3, 2, 16, 7), 2, 9, 100, 13)
    assert plan.route == "cuda_core" and plan.grid == (1, 1, 2)
    assert plan.group_splits == plan.phase_splits == 1


@pytest.mark.parametrize("r,c,pr,x_aligned,w_aligned,want", [
    (4608, 128, 1152, True, True, ("tma", "tma")),
    (147, 64, 1152, True, True, ("cp.async", "tma")),       # R = 147
    (512, 488, 1152, True, True, ("tma", "cp.async")),      # C = 488
    (854, 512, 1152, True, True, ("cp.async", "tma")),      # the LM block
    (300, 64, 100, True, True, ("cp.async", "tma")),        # pr % 16 != 0
    (512, 128, 1152, False, True, ("cp.async", "tma")),     # x off the grid
    (512, 128, 1152, True, False, ("tma", "cp.async")),     # w off the grid
    (26, 32, 128, True, True, ("cp.async", "tma")),         # puma, R = 26
    (128, 8, 128, True, True, ("tma", "cp.async")),         # puma, C = 8
], ids=str)
def test_launch_plan_load_paths_follow_the_16_byte_rule(
        r, c, pr, x_aligned, w_aligned, want):
    assert kernel.load_paths(r, c, pr, x_aligned, w_aligned) == want
    p = CimMvmParams(8, 8, 1, 1, pr, 8)
    plan = kernel.plan_launch(p, 1, 64, r, c, x_aligned, w_aligned)
    assert (plan.x_path, plan.w_path) == want
    _check_plan(plan)


@pytest.mark.parametrize("paths", [("tma", "tma"), ("tma", "cp.async"),
                                   ("cp.async", "tma"),
                                   ("cp.async", "cp.async")], ids=str)
def test_ring_fills_shared_memory(paths):
    """As many stages as fit 232,448 bytes beside the plane buffers, at
    least the 9 chunks of a 1152-row group."""
    stages, smem = kernel.ring_plan(*paths)
    stage = kernel.SLOT_BYTES["x", paths[0]] + kernel.SLOT_BYTES["w", paths[1]]
    assert 9 <= stages <= kernel.MAX_STAGES
    assert smem <= kernel.SMEM_LIMIT < smem + stage
    assert kernel.RING_OFFSET >= 3 * 2 * kernel.PLANE_BYTES
    assert kernel.RING_OFFSET % kernel.SMEM_ALIGN == 0


@pytest.mark.parametrize("pr,resident", [(1152, True), (1408, True),
                                         (2048, False), (128, True)])
def test_launch_plan_streams_groups_longer_than_the_ring(pr, resident):
    plan = kernel.plan_launch(CimMvmParams(8, 8, 1, 1, pr, 8), 1, 64, 4096,
                              64)
    assert plan.stages == 11 and plan.resident == resident
    _check_plan(plan)


@pytest.mark.parametrize("n_phases,n_s,want", [
    (8, 8, (1, 8)), (4, 8, (2, 4)), (2, 8, (2, 4)), (1, 4, (2, 2)),
    (1, 1, (2, 1)), (6, 8, (1, 8)), (3, 2, (2, 1))])
def test_sweeps_keep_to_eight_live_pairs(n_phases, n_s, want):
    sb, sweeps = kernel.sweep_shape(n_phases, n_s)
    assert (sb, sweeps) == want
    assert n_phases * sb <= 2 * kernel.WG_PAIRS and sweeps * sb >= n_s


# ------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the crossbar-MVM kernel has no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("p", PARAMS, ids=_pid)
def test_cuda_kernel_matches_plain_version(card, p):
    before = kernel.LAUNCHES["cim_mvm_tiles"]
    shapes = SHAPES + [
        (1, 300, 1152, 128), (2, 70, 700, 65),
        (1, 4, 512, 488), (2, 5, 600, 37),   # M < 16, C % 8 != 0
        (1, 196, 4608, 128),                 # most atomic adds on jia
        (1, 4500, 600, 128),                 # an unsplit plan
        (2, 70, 256, 40), (1, 64, 224, 64),  # x by TMA, w by either path
    ]
    for shape in shapes:
        x, w = _operands(shape, p, seed=sum(shape))
        xt, wt = torch.from_numpy(x).to(card), torch.from_numpy(w).to(card)
        got = cim_mvm_tiles(xt, wt, p, mode="compiled")
        again = cim_mvm_tiles(xt, wt, p, mode="compiled")
        want = cim_mvm_tiles(xt, wt, p, mode="torch")
        torch.cuda.synchronize()
        assert torch.equal(got, want), (shape, p)
        assert torch.equal(got, again), (shape, p)     # order-independent
        assert torch.equal(cim_mvm(xt[0], wt[0], p),
                           cim_mvm(xt[0], wt[0], p, mode="torch"))
    assert kernel.LAUNCHES["cim_mvm_tiles"] == before + 2 * len(shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_cuda_golden_replay(card, path):
    kind, x, w, y, p = _load(path)
    got = ENTRY[kind](torch.from_numpy(x).to(card),
                      torch.from_numpy(w).to(card), p)
    np.testing.assert_array_equal(got.cpu().numpy(), y)
