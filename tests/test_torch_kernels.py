"""The port's crossbar MVM against the JAX package's, on the CPU.

The plain PyTorch version (``repro_torch.kernels.cim_mvm.ref``) is held
to ``repro.kernels.cim_mvm.ref`` bit for bit (tolerance 0: the path is
integer) on seeded random shapes, the committed goldens replay through
the port's three entry points, and the route registry's auto and raise
cases are pinned.  The CUDA kernel itself is held to the plain version
by the ``cuda``-marked tests, which run on a card only; a card host
without JAX collects this file too and runs just the port's side.
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import backend
from repro_torch.kernels.cim_mvm import (CimMvmParams, cim_mvm,
                                         cim_mvm_signed, cim_mvm_tiles, kernel)
from repro_torch.kernels.cim_mvm import ref as tref

GOLDEN = sorted((pathlib.Path(__file__).resolve().parent / "golden"
                 / "cim_mvm").glob("*.npz"))
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
    with pytest.raises(ValueError, match="CUDA"):
        kernel.cim_mvm_tiles_cuda(x, w, CimMvmParams())
    with pytest.raises(ValueError, match="CUDA"):
        kernel.cim_mvm_cuda(x[0], w[0], CimMvmParams())
    assert kernel.LAUNCHES == before


def test_resolution_precedence(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_KERNEL_MODE", "compiled")
    assert backend.resolve("cim_mvm", platform="cuda").mode == "compiled"
    with pytest.raises(backend.KernelUnsupportedError):
        backend.resolve("cim_mvm", device="cpu")        # env beats auto
    with backend.override("torch"):                     # blanket beats env
        assert backend.resolve("cim_mvm", device="cpu").mode == "torch"
        with backend.override("compiled", kernel="cim_mvm"):
            # named beats blanket; per-call beats everything
            assert backend.resolve("cim_mvm",
                                   platform="cuda").mode == "compiled"
            assert backend.resolve("cim_mvm_tiles",
                                   platform="cuda").mode == "torch"
            assert backend.resolve("cim_mvm", "torch",
                                   platform="cuda").mode == "torch"
    assert backend._OVERRIDES == {}


def test_jax_route_variable_is_ignored(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_KERNEL_MODE", raising=False)
    for value in ("compiled", "interpret", "xla"):
        monkeypatch.setenv("REPRO_KERNEL_MODE", value)
        assert backend.resolve("cim_mvm_tiles", device="cpu").mode == "torch"
        assert backend.resolve("cim_mvm_tiles",
                               platform="cuda").mode == "compiled"


def test_operand_dtype():
    assert kernel.operand_dtype(CimMvmParams(8, 8, 1, 1, 1152, 8)) \
        == torch.uint8
    assert kernel.operand_dtype(CimMvmParams(8, 8, 8, 2, 128, 8)) \
        == torch.uint8
    assert kernel.operand_dtype(CimMvmParams(8, 8, 3, 2, 16, 7)) \
        == torch.int32


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
    shapes = SHAPES + [(1, 300, 1152, 128), (2, 70, 700, 65)]
    for shape in shapes:
        x, w = _operands(shape, p, seed=sum(shape))
        xt, wt = torch.from_numpy(x).to(card), torch.from_numpy(w).to(card)
        got = cim_mvm_tiles(xt, wt, p, mode="compiled")
        want = cim_mvm_tiles(xt, wt, p, mode="torch")
        torch.cuda.synchronize()
        assert torch.equal(got, want), (shape, p)
        assert torch.equal(cim_mvm(xt[0], wt[0], p),
                           cim_mvm(xt[0], wt[0], p, mode="torch"))
    assert kernel.LAUNCHES["cim_mvm_tiles"] == before + len(shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_cuda_golden_replay(card, path):
    kind, x, w, y, p = _load(path)
    got = ENTRY[kind](torch.from_numpy(x).to(card),
                      torch.from_numpy(w).to(card), p)
    np.testing.assert_array_equal(got.cpu().numpy(), y)
