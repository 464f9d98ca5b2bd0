"""Build and bind the CUDA crossbar-MVM kernel (``csrc/cim_mvm.cu``).

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, from the sources in the checkout
(``build/`` at the repository root, keyed by the source's content hash),
and loaded with ``ctypes``.  Nothing is built or imported when this
module is imported: the CPU tests import it on machines without
``nvcc``.

Two wrappers launch the one kernel, each with its own launch counter in
``LAUNCHES`` (incremented where the kernel is launched, and nowhere
else):

  * ``cim_mvm_tiles_cuda`` — (T,M,R) x (T,R,C) -> (T,M,C) int32,
  * ``cim_mvm_cuda``       — (M,R) x (R,C) -> (M,C) int32, the case T = 1.

Operands are unsigned integers: uint8 when every phase and slice sits in
the low 8 bits (``ceil(act_bits/dac_bits)*dac_bits <= 8`` and likewise
for the weights), else int32 (see ``operand_dtype``).  A wrapper checks
device, dtype, shape and contiguity, raises on anything else, allocates
the output and launches on PyTorch's current stream.  It never falls
back to the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Optional

import torch

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
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
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


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, params,
            t: int, m: int, r: int, c: int) -> torch.Tensor:
    dtype = operand_dtype(params)
    for label, a in (("x_u", x), ("w_u", w)):
        if not a.is_cuda:
            raise ValueError(f"{name}: {label} is on {a.device}, the "
                             "kernel runs on CUDA tensors only")
        if a.dtype != dtype:
            raise TypeError(f"{name}: {label} is {a.dtype}, the kernel "
                            f"takes {dtype} for these params")
        if not a.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if x.device != w.device:
        raise ValueError(f"{name}: x_u on {x.device}, w_u on {w.device}")
    out = torch.empty((t, m, c), dtype=torch.int32, device=x.device)
    if out.numel() == 0:          # an empty grid is a launch error
        return out
    n_p = math.ceil(params.act_bits / params.dac_bits)
    n_s = math.ceil(params.weight_bits / params.cell_bits)
    adc_max = min((1 << params.adc_bits) - 1, 2 ** 31 - 1)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cim_mvm_tiles_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), t, m, r, c,
            n_p, n_s, params.dac_bits, params.cell_bits,
            min(params.parallel_row, r), adc_max, x.element_size(), stream)
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
        raise ValueError(f"cim_mvm_tiles: shapes {tuple(x_u.shape)} x "
                         f"{tuple(w_u.shape)} are not (T,M,R) x (T,R,C)")
    t, m, r = x_u.shape
    return _launch("cim_mvm_tiles", x_u, w_u, params, t, m, r, w_u.shape[2])


def cim_mvm_cuda(x_u: torch.Tensor, w_u: torch.Tensor,
                 params) -> torch.Tensor:
    """(M,R) x (R,C) -> (M,C) int32 on the card (the kernel at T = 1)."""
    if x_u.dim() != 2 or w_u.dim() != 2 or x_u.shape[1] != w_u.shape[0]:
        raise ValueError(f"cim_mvm: shapes {tuple(x_u.shape)} x "
                         f"{tuple(w_u.shape)} are not (M,R) x (R,C)")
    m, r = x_u.shape
    return _launch("cim_mvm", x_u, w_u, params, 1, m, r, w_u.shape[1])[0]
