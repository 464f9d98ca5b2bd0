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
run the tensor-core instantiation, int32 ones the CUDA-core one (see the
source's header).  ``plan_launch`` decides, in plain Python, how the
tensor-core kernel's work splits across blocks: by output tile, by a
range of row groups and by a range of bit phases, each block adding its
partial sums into the zeroed output with integer atomics.  A wrapper
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
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 19
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
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
#: blocks the planner aims for when the output tiles alone are fewer
TARGET_BLOCKS = 2 * SM_COUNT
#: shared memory one block may use on Hopper
SMEM_LIMIT = 232_448
#: tensor-core route: output tile, staged k-chunk, ring depth, mma depth
MMA_BM, MMA_BN, MMA_KC, MMA_STAGES, K_STEP = 64, 32, 128, 3, 32
#: staged row pitches in bytes (x rows of a chunk, w rows of a chunk)
MMA_XSTR, MMA_WSTR = MMA_KC + 16, MMA_BN + 16
#: CUDA-core route (int32 operands): output tile, shared-memory budget
CC_TILE, CC_SMEM_BUDGET = 64, 160 * 1024


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one (T,M,R) x (T,R,C) launch maps onto blocks.

    Block ``(bx, by, t)`` owns output tile ``bx`` (row tile
    ``bx // c_tiles``, column tile ``bx % c_tiles``) of crossbar tile
    ``t``, the row groups of group range ``by // phase_splits`` and the
    phases of phase range ``by % phase_splits``, for every slice.
    """

    route: str                 # "mma" (uint8) or "cuda_core" (int32)
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


@functools.lru_cache(maxsize=1024)
def plan_launch(params, t: int, m: int, r: int, c: int) -> LaunchPlan:
    """The launch of ``params`` at (T, M, R, C).

    uint8 operands take the tensor-core kernel: output tiles of
    MMA_BM x MMA_BN.  Where the tiles give fewer than TARGET_BLOCKS
    blocks, the row groups and phases split into ranges, with the fewest
    ranges (atomic adds per output element) that reach the target, and
    phases before groups (phases are equal, the last group may be
    short); where even a full split cannot reach it, every block takes
    one group and one phase.  int32 operands take the CUDA-core kernel,
    unsplit.
    """
    n_p = math.ceil(params.act_bits / params.dac_bits)
    n_s = math.ceil(params.weight_bits / params.cell_bits)
    pr = min(params.parallel_row, r)
    n_groups = math.ceil(r / pr)
    if operand_dtype(params) == torch.int32:
        kc = min(pr, CC_SMEM_BUDGET // (2 * CC_TILE * 4))
        return LaunchPlan("cuda_core", t, m, r, c, n_p, n_s, pr, CC_TILE,
                          CC_TILE, kc, n_groups, n_p, 2 * CC_TILE * kc * 4)
    smem = MMA_STAGES * (MMA_BM * MMA_XSTR + MMA_KC * MMA_WSTR)
    tiles = t * math.ceil(m / MMA_BM) * math.ceil(c / MMA_BN)
    need = math.ceil(TARGET_BLOCKS / tiles)
    gpb, ppb = n_groups, n_p
    if n_groups * n_p <= need:
        gpb, ppb = 1, 1
    elif need > 1:
        _, _, gpb, ppb = min(
            (splits, gs, gpb_, ppb_)
            for gpb_ in range(1, n_groups + 1)
            for ppb_ in range(1, n_p + 1)
            for gs in (math.ceil(n_groups / gpb_),)
            for splits in (gs * math.ceil(n_p / ppb_),)
            if splits >= need)
    return LaunchPlan("mma", t, m, r, c, n_p, n_s, pr, MMA_BM, MMA_BN,
                      MMA_KC, gpb, ppb, smem)


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
    # zeroed: the tensor-core kernel's blocks add their partial sums in
    out = torch.zeros((t, m, c), dtype=torch.int32, device=x.device)
    if out.numel() == 0:          # an empty grid is a launch error
        return out
    plan = plan_launch(params, t, m, r, c)
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
            plan.smem_bytes, stream)
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
