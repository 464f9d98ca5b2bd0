#!/usr/bin/env python3
"""Where the wgmma crossbar-MVM kernel's time goes, on a CUDA card.

Usage:  python3 tools/cim_mvm_ablation.py [--reps N]

Builds ``src/repro_torch/csrc/cim_mvm.cu`` as it is and three copies with
one part of the uint8 body taken out (their results are wrong; only their
times count):

  * ``no_plane_pass``  the consumers skip the slice-plane pass (the wgmmas
    read whatever the plane buffers hold);
  * ``no_extract``     the A registers take the raw x words instead of
    their phase planes (no shift and mask);
  * ``no_wgmma``       every wgmma is replaced by one integer add.

Each build runs in a process of its own (a variant that hangs or faults
cannot take the others with it) and times, with CUDA events, two of
``tools/cim_mvm_timing.py``'s shape sets: one batch-4 forward of
ResNet-18@224 on jia-issc21 (its 32 ``cim_mvm_tiles`` launches, as
``chip_smoke.py`` phase 2 times them) and the qwen1.5-4b block's 132
launches.  Prints ``ptxas``'s wgmma notes for each build.  Needs ``nvcc``
and a Hopper card; writes only under ``build/``.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

OUT = ROOT / "build" / "ablation"
#: shape sets of tools/cim_mvm_timing.py that each variant runs
SETS = ("resnet18_jia", "lmblock_jia")

PASS_BEGIN = "        // slice planes of this chunk, K-major; rows past kv are zero"
PASS_END = '        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");'
EXTRACT = ("for (int r = 0; r < 4; ++r) A[i][r] = (raw[r] >> xsh[i]) & "
           "xmask[i];")
WGMMAS = ("for (int i = 0; i < LIVE; ++i) wgmma_u8(acc[i], a0[i], d0[i]);",
          "for (int i = 0; i < LIVE; ++i) wgmma_u8(acc[i], a1[i], d1[i]);")


def _cut(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"cim_mvm_ablation: {old!r} is not in the source")
    return src.replace(old, new)


def _no_plane_pass(src: str) -> str:
    a, b = src.find(PASS_BEGIN), src.find(PASS_END)
    if a < 0 or b < a:
        raise SystemExit("cim_mvm_ablation: the plane pass is not found")
    return src[:a] + src[b:]


def _no_extract(src: str) -> str:
    return _cut(src, EXTRACT, "for (int r = 0; r < 4; ++r) A[i][r] = raw[r];")


def _no_wgmma(src: str) -> str:
    for old in WGMMAS:
        a, d = old.split("(acc[i], ")[1].split(", ")
        src = _cut(src, old, "for (int i = 0; i < LIVE; ++i) acc[i][0] += "
                   f"{a}[0] + static_cast<uint32_t>({d[:-2]});")
    return src


VARIANTS = {"as_is": lambda s: s, "no_plane_pass": _no_plane_pass,
            "no_extract": _no_extract, "no_wgmma": _no_wgmma}


def build(name: str) -> tuple:
    """(library path, ptxas's wgmma notes) of one variant."""
    from repro_torch.kernels.cim_mvm import kernel
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(VARIANTS[name](kernel.SOURCE.read_text()))
    lib = cu.with_suffix(".so")
    proc = subprocess.run([kernel._nvcc(), "-Xptxas=-v", *kernel.NVCC_FLAGS,
                           "-o", str(lib), str(cu)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    notes = sorted(set(re.findall(r"\((C75\d\d)\)", proc.stderr)))
    return lib, notes


def time_variant(name: str, reps: int) -> None:
    """Runs in its own process: bind the variant's library, time."""
    from repro_torch.kernels.cim_mvm import kernel
    from cim_mvm_timing import shape_sets, time_sets
    lib_path, notes = build(name)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.cim_mvm_tiles_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 23 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    kernel._LIB = lib
    sets = {k: v for k, v in shape_sets().items() if k in SETS}
    times = time_sets(kernel, sets, reps)
    print(f"[ablation] {name}: " + "; ".join(
        f"{k} ({v['launches']} launches) {v['ms']:.4f} ms"
        for k, v in times.items()) + f"; ptxas wgmma notes {notes or 'none'}",
        flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variant", choices=sorted(VARIANTS))
    args = ap.parse_args()
    if args.variant:
        time_variant(args.variant, args.reps)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("cim_mvm_ablation: torch sees no CUDA device", file=sys.stderr)
        return 2
    failed = 0
    for name in VARIANTS:
        try:
            rc = subprocess.run([sys.executable, __file__, "--variant", name,
                                 "--reps", str(args.reps)],
                                timeout=300).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc != 0:
            print(f"[ablation] {name}: failed ({rc})")
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
