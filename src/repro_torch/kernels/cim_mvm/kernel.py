"""Build and bind the CUDA crossbar-MVM kernel (``csrc/cim_mvm.cu``).

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, from the sources in the checkout
(``build/`` at the repository root, keyed by the source's content hash),
and loaded with ``ctypes``.  Nothing is built or imported when this
module is imported: the CPU tests import it on machines without
``nvcc``.

Two wrappers launch the kernel, each with its own launch counter in
``LAUNCHES`` (incremented where the kernel is launched, once per call,
and nowhere else):

  * ``cim_mvm_tiles_cuda`` — (T,M,R) x (T,R,C) -> (T,M,C) int32,
  * ``cim_mvm_cuda``       — (M,R) x (R,C) -> (M,C) int32, the case T = 1.

Operands are unsigned integers: uint8 when every phase and slice sits in
the low 8 bits (``ceil(act_bits/dac_bits)*dac_bits <= 8`` and likewise
for the weights), else int32 (see ``operand_dtype``).  uint8 operands
run the warp-specialised ``wgmma`` instantiation, int32 ones the
CUDA-core one (see the source's header).  ``plan_launch`` decides, in
plain Python, how the ``wgmma`` kernel's work splits across blocks (by
output tile, by a range of row groups and by a range of bit phases, each
block adding its partial sums into the zeroed output with integer
atomics), which load path each operand takes (TMA where the 16-byte
rule allows, else 4-byte ``cp.async``), the depth of the shared-memory
ring and whether a row group stays resident in it.  A wrapper
checks device, dtype, shape and contiguity, raises
``KernelArgumentError`` on anything else, allocates the output and
launches on PyTorch's current stream.  It never falls back to the plain
version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Optional, Tuple

import torch

from ..backend import KernelArgumentError

_PKG = pathlib.Path(__file__).resolve().parents[2]          # src/repro_torch
SOURCE = _PKG / "csrc" / "cim_mvm.cu"
BUILD_DIR = _PKG.parents[1] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

#: launches per wrapper since the last ``reset_launch_counts``
LAUNCHES: Dict[str, int] = {"cim_mvm": 0, "cim_mvm_tiles": 0}

_LIB: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA crossbar-MVM kernel is "
                       "built from csrc/cim_mvm.cu at first use")


def build(verbose: bool = False) -> pathlib.Path:
    """Compile ``csrc/cim_mvm.cu`` unless the library for this source
    content already exists; returns the library path."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"cim_mvm-{tag[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, end="")
    os.replace(tmp, lib)
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.cim_mvm_tiles_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 23
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        enc = lib.cim_mvm_encode_us
        enc.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
        enc.restype = ctypes.c_double
        _LIB = lib
    return _LIB


def operand_dtype(params) -> torch.dtype:
    """uint8 when every extracted bit of x and w lies in the low byte
    (then uint8 storage changes no plane the plain version sees), else
    int32."""
    xb = math.ceil(params.act_bits / params.dac_bits) * params.dac_bits
    wb = math.ceil(params.weight_bits / params.cell_bits) * params.cell_bits
    return torch.uint8 if max(xb, wb) <= 8 else torch.int32


# -- launch planning ---------------------------------------------------------
# The tile constants of csrc/cim_mvm.cu; the launch refuses a plan whose
# constants differ from the compiled ones.

#: streaming multiprocessors of an H100 SXM
SM_COUNT = 132
#: blocks of one wave: the wgmma kernel holds one block per SM
TARGET_BLOCKS = SM_COUNT
#: shared memory one block may use on Hopper
SMEM_LIMIT = 232_448
#: wgmma route: output tile, staged k-chunk, wgmma depth
WG_BM, WG_BN, WG_KC, K_STEP = 64, 64, 128, 32
#: live (phase, slice) pairs of one consumer warpgroup; two warpgroups
WG_PAIRS = 4
#: the source's shared-memory layout: the 128-byte swizzle's alignment,
#: three sets of two K-major slice planes (8-column groups 1040 bytes
#: apart), the ring's barriers, and a ring slot's bytes per operand and
#: load path (a TMA box, or padded rows of cp.async words)
SMEM_ALIGN = 1024
PLANE_BYTES = (WG_BN // 8) * ((WG_KC // 16) * 128 + 16)
MAX_STAGES, PLANE_SETS = 16, 3
RING_OFFSET = -(-PLANE_SETS * 2 * PLANE_BYTES // SMEM_ALIGN) * SMEM_ALIGN
BARRIER_BYTES = 2 * MAX_STAGES * 8
SLOT_BYTES = {("x", "tma"): WG_BM * WG_KC,
              ("x", "cp.async"): WG_BM * (WG_KC + 16),
              ("w", "tma"): WG_KC * WG_BN,
              ("w", "cp.async"): WG_KC * (WG_BN + 16)}
#: CUDA-core route (int32 operands): output tile, shared-memory budget
CC_TILE, CC_SMEM_BUDGET = 64, 160 * 1024


def load_paths(r: int, c: int, parallel_row: int, x_aligned: bool = True,
               w_aligned: bool = True) -> Tuple[str, str]:
    """(x, w) load paths by the 16-byte rule: TMA needs a 16-byte-aligned
    base and a row pitch (R for x, C for w) that is a multiple of 16
    bytes; x's chunks start at multiples of ``parallel_row``, so it must
    be one too.  Otherwise 4-byte ``cp.async``."""
    x = "tma" if x_aligned and r % 16 == 0 and parallel_row % 16 == 0 \
        else "cp.async"
    w = "tma" if w_aligned and c % 16 == 0 else "cp.async"
    return x, w


def ring_plan(x_path: str, w_path: str) -> Tuple[int, int]:
    """(ring stages, dynamic shared-memory bytes) of the wgmma kernel
    for these load paths: as many stages as fit beside the plane
    buffers."""
    stage = SLOT_BYTES["x", x_path] + SLOT_BYTES["w", w_path]
    stages = min(MAX_STAGES, (SMEM_LIMIT - SMEM_ALIGN - RING_OFFSET
                              - BARRIER_BYTES) // stage)
    return stages, SMEM_ALIGN + RING_OFFSET + stages * stage + BARRIER_BYTES


def sweep_shape(n_phases: int, n_s: int) -> Tuple[int, int]:
    """(slices a sweep, sweeps a group) of a block owning ``n_phases``
    phases: a sweep runs all its phases against two slices while that
    keeps to 2 * WG_PAIRS live pairs, else against one."""
    sb = 2 if n_phases <= WG_PAIRS else 1
    return sb, math.ceil(n_s / sb)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one (T,M,R) x (T,R,C) launch maps onto blocks.

    Block ``(bx, by, t)`` owns output tile ``bx`` (row tile
    ``bx // c_tiles``, column tile ``bx % c_tiles``) of crossbar tile
    ``t``, the row groups of group range ``by // phase_splits`` and the
    phases of phase range ``by % phase_splits``, for every slice.
    """

    route: str                 # "wgmma" (uint8) or "cuda_core" (int32)
    t: int
    m: int
    r: int
    c: int
    n_p: int
    n_s: int
    parallel_row: int          # group length, <= r
    bm: int
    bn: int
    kc: int                    # k rows per staged chunk
    groups_per_block: int
    phases_per_block: int
    smem_bytes: int
    stages: int = 0            # ring depth (wgmma route)
    x_path: str = ""           # "tma" or "cp.async" (wgmma route)
    w_path: str = ""
    resident: bool = False     # a row group's chunks stay in the ring

    @property
    def n_groups(self) -> int:
        return math.ceil(self.r / self.parallel_row)

    @property
    def m_tiles(self) -> int:
        return math.ceil(self.m / self.bm)

    @property
    def c_tiles(self) -> int:
        return math.ceil(self.c / self.bn)

    @property
    def group_splits(self) -> int:
        return math.ceil(self.n_groups / self.groups_per_block)

    @property
    def phase_splits(self) -> int:
        return math.ceil(self.n_p / self.phases_per_block)

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.m_tiles * self.c_tiles,
                self.group_splits * self.phase_splits, self.t)

    @property
    def blocks(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz


def _split_cost(tiles: int, n_groups: int, n_p: int, n_s: int, gpb: int,
                ppb: int) -> Tuple[int, int, int]:
    """Rank of a split: the busiest SM's load in waves of one block per
    SM times a block's work (sweeps of its pairs plus one pair's worth
    of plane pass each), then the atomic adds per output, then fewer
    phase splits."""
    splits = math.ceil(n_groups / gpb) * math.ceil(n_p / ppb)
    sb, sweeps = sweep_shape(ppb, n_s)
    waves = math.ceil(tiles * splits / TARGET_BLOCKS)
    return (waves * gpb * sweeps * (ppb * sb + 1), splits,
            math.ceil(n_p / ppb))


@functools.lru_cache(maxsize=1024)
def plan_launch(params, t: int, m: int, r: int, c: int,
                x_aligned: bool = True,
                w_aligned: bool = True) -> LaunchPlan:
    """The launch of ``params`` at (T, M, R, C); ``x_aligned`` and
    ``w_aligned`` say whether the operands' base addresses are 16-byte
    aligned.

    uint8 operands take the wgmma kernel: output tiles of WG_BM x WG_BN,
    one block per SM.  The row groups and phases split into the ranges
    that minimise ``_split_cost``: whole waves of blocks on SM_COUNT SMs
    times one block's work, so a split that adds a partial wave, or
    phase splits that repeat the slice-plane pass, lose to fewer blocks.
    Phase ranges divide the phases evenly: every block runs the same
    number of live pairs, which the kernel takes as a template argument.
    int32 operands take the CUDA-core kernel, unsplit.
    """
    n_p = math.ceil(params.act_bits / params.dac_bits)
    n_s = math.ceil(params.weight_bits / params.cell_bits)
    pr = min(params.parallel_row, r)
    n_groups = math.ceil(r / pr)
    if operand_dtype(params) == torch.int32:
        kc = min(pr, CC_SMEM_BUDGET // (2 * CC_TILE * 4))
        return LaunchPlan("cuda_core", t, m, r, c, n_p, n_s, pr, CC_TILE,
                          CC_TILE, kc, n_groups, n_p, 2 * CC_TILE * kc * 4)
    tiles = t * math.ceil(m / WG_BM) * math.ceil(c / WG_BN)
    _, gpb, ppb = min(
        (_split_cost(tiles, n_groups, n_p, n_s, gpb_, ppb_), gpb_, ppb_)
        for gpb_ in range(1, n_groups + 1)
        for ppb_ in range(1, n_p + 1) if n_p % ppb_ == 0)
    x_path, w_path = load_paths(r, c, pr, x_aligned, w_aligned)
    stages, smem = ring_plan(x_path, w_path)
    return LaunchPlan("wgmma", t, m, r, c, n_p, n_s, pr, WG_BM, WG_BN,
                      WG_KC, gpb, ppb, smem, stages, x_path, w_path,
                      math.ceil(pr / WG_KC) <= stages)


def tensor_map_encode_us(x: torch.Tensor, reps: int = 1000) -> float:
    """Mean host microseconds of encoding the tensor map of a (T,M,R)
    uint8 ``x`` on the card, as each launch on the TMA path does."""
    t, m, r = x.shape
    us = _lib().cim_mvm_encode_us(x.data_ptr(), t, m, r, reps)
    if us < 0:
        raise RuntimeError("cuTensorMapEncodeTiled refused x's tensor map")
    return us


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, params,
            t: int, m: int, r: int, c: int) -> torch.Tensor:
    dtype = operand_dtype(params)
    for label, a in (("x_u", x), ("w_u", w)):
        if not a.is_cuda:
            raise KernelArgumentError(
                f"{name}: {label} is on {a.device}, the kernel runs on "
                "CUDA tensors only")
        if a.dtype != dtype:
            raise KernelArgumentError(
                f"{name}: {label} is {a.dtype}, the kernel takes {dtype} "
                "for these params")
        if not a.is_contiguous():
            raise KernelArgumentError(f"{name}: {label} must be contiguous")
    if x.device != w.device:
        raise KernelArgumentError(
            f"{name}: x_u on {x.device}, w_u on {w.device}")
    # zeroed: the wgmma kernel's blocks add their partial sums in
    out = torch.zeros((t, m, c), dtype=torch.int32, device=x.device)
    if out.numel() == 0:          # an empty grid is a launch error
        return out
    plan = plan_launch(params, t, m, r, c, x.data_ptr() % 16 == 0,
                       w.data_ptr() % 16 == 0)
    adc_max = min((1 << params.adc_bits) - 1, 2 ** 31 - 1)
    gx, gy, _ = plan.grid
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cim_mvm_tiles_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), t, m, r, c,
            plan.n_p, plan.n_s, params.dac_bits, params.cell_bits,
            plan.parallel_row, adc_max, x.element_size(), plan.bm, plan.bn,
            plan.kc, plan.groups_per_block, plan.phases_per_block, gx, gy,
            plan.smem_bytes, plan.stages, plan.x_path == "tma",
            plan.w_path == "tma", plan.resident, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{err}")
    LAUNCHES[name] += 1
    return out


def cim_mvm_tiles_cuda(x_u: torch.Tensor, w_u: torch.Tensor,
                       params) -> torch.Tensor:
    """(T,M,R) x (T,R,C) -> (T,M,C) int32 on the card."""
    if x_u.dim() != 3 or w_u.dim() != 3 or x_u.shape[0] != w_u.shape[0] \
            or x_u.shape[2] != w_u.shape[1]:
        raise KernelArgumentError(
            f"cim_mvm_tiles: shapes {tuple(x_u.shape)} x "
            f"{tuple(w_u.shape)} are not (T,M,R) x (T,R,C)")
    t, m, r = x_u.shape
    return _launch("cim_mvm_tiles", x_u, w_u, params, t, m, r, w_u.shape[2])


def cim_mvm_cuda(x_u: torch.Tensor, w_u: torch.Tensor,
                 params) -> torch.Tensor:
    """(M,R) x (R,C) -> (M,C) int32 on the card (the kernel at T = 1)."""
    if x_u.dim() != 2 or w_u.dim() != 2 or x_u.shape[1] != w_u.shape[0]:
        raise KernelArgumentError(
            f"cim_mvm: shapes {tuple(x_u.shape)} x "
            f"{tuple(w_u.shape)} are not (M,R) x (R,C)")
    m, r = x_u.shape
    return _launch("cim_mvm", x_u, w_u, params, 1, m, r, w_u.shape[1])[0]
