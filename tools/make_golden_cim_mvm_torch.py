#!/usr/bin/env python
"""Regenerate the cim_mvm golden-vector fixtures with ``repro_torch``,
and check them against the committed ones.

Each fixture is one .npz holding the inputs, the crossbar params and the
expected int32 output of one kernel entry point.  Expectations come from
the port's plain PyTorch version (``ref.cim_mvm_ref``) and are
cross-checked against the entry point on ``--device`` before being
written: on a card that is the CUDA kernel, on ``--device cpu`` the
plain route through the entry point's own offset and routing code.
Inputs are crc32-seeded from the case name, as in
``tools/make_golden_cim_mvm.py`` (the JAX package's generator, which
writes the committed fixtures in ``tests/golden/cim_mvm/``).

This tool writes only into ``--out`` (default ``build/golden/cim_mvm``),
never into ``tests/golden/``.  With ``--check`` it then compares every
regenerated array with the committed fixture of the same name bit for
bit and exits non-zero on any difference.

Usage:  PYTHONPATH=src python tools/make_golden_cim_mvm_torch.py \
            [--device cpu] [--check]
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import zlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch                                                   # noqa: E402

from repro_torch.kernels.backend import resolve_device        # noqa: E402
from repro_torch.kernels.cim_mvm import CimMvmParams          # noqa: E402
from repro_torch.kernels.cim_mvm import ops                   # noqa: E402
from repro_torch.kernels.cim_mvm import ref                   # noqa: E402

OUT_DIR = ROOT / "build" / "golden" / "cim_mvm"
GOLDEN_DIR = ROOT / "tests" / "golden" / "cim_mvm"

#: (name, kind, params, shape) — shape is (M, R, C) for cim_mvm /
#: cim_mvm_signed and (T, M, R, C) for cim_mvm_tiles.  Params cover the
#: preset families plus a hard-saturating ADC.
CASES = [
    ("mvm_isaac", "cim_mvm", CimMvmParams(8, 8, 1, 2, 8, 8), (5, 40, 9)),
    ("mvm_puma", "cim_mvm", CimMvmParams(8, 8, 8, 2, 128, 8), (3, 130, 17)),
    ("mvm_saturating", "cim_mvm", CimMvmParams(8, 8, 8, 8, 128, 4),
     (4, 128, 8)),
    ("tiles_isaac", "cim_mvm_tiles", CimMvmParams(8, 8, 1, 2, 8, 8),
     (3, 6, 20, 12)),
    ("tiles_saturating", "cim_mvm_tiles", CimMvmParams(8, 8, 1, 2, 8, 4),
     (2, 4, 16, 8)),
    ("signed_wide_adc", "cim_mvm_signed", CimMvmParams(8, 8, 1, 2, 8, 16),
     (7, 50, 11)),
]

ENTRY = {"cim_mvm": ops.cim_mvm, "cim_mvm_tiles": ops.cim_mvm_tiles,
         "cim_mvm_signed": ops.cim_mvm_signed}


def _rng(name: str, tag: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(f"{name}\x00{tag}".encode()))


def _inputs(name: str, kind: str, params: CimMvmParams, shape):
    if kind == "cim_mvm_tiles":
        t, m, r, c = shape
        x = _rng(name, "x").integers(0, 1 << params.act_bits, (t, m, r))
        w = _rng(name, "w").integers(0, 1 << params.weight_bits, (t, r, c))
    elif kind == "cim_mvm_signed":
        m, r, c = shape
        half_a, half_w = 1 << (params.act_bits - 1), \
            1 << (params.weight_bits - 1)
        x = _rng(name, "x").integers(-half_a, half_a, (m, r))
        w = _rng(name, "w").integers(-half_w, half_w, (r, c))
    else:
        m, r, c = shape
        x = _rng(name, "x").integers(0, 1 << params.act_bits, (m, r))
        w = _rng(name, "w").integers(0, 1 << params.weight_bits, (r, c))
    return x.astype(np.int32), w.astype(np.int32)


def _expected(kind: str, x: np.ndarray, w: np.ndarray,
              params: CimMvmParams) -> np.ndarray:
    """The plain version's output on the CPU."""
    kw = dict(act_bits=params.act_bits, weight_bits=params.weight_bits,
              dac_bits=params.dac_bits, cell_bits=params.cell_bits,
              parallel_row=params.parallel_row, adc_bits=params.adc_bits)
    if kind == "cim_mvm_tiles":
        return ref.cim_mvm_ref_tiles(torch.from_numpy(x), torch.from_numpy(w),
                                     **kw).numpy()
    if kind == "cim_mvm_signed":
        ox, ow = 1 << (params.act_bits - 1), 1 << (params.weight_bits - 1)
        y_u = ref.cim_mvm_ref(torch.from_numpy(x + ox),
                              torch.from_numpy(w + ow), **kw) \
            .numpy().astype(np.int64)
        sx = (x.astype(np.int64) + ox).sum(axis=-1, keepdims=True)
        sw = (w.astype(np.int64) + ow).sum(axis=0, keepdims=True)
        return (y_u - ow * sx - ox * sw
                + x.shape[-1] * ox * ow).astype(np.int32)
    return ref.cim_mvm_ref(torch.from_numpy(x), torch.from_numpy(w),
                           **kw).numpy()


def _fixture(kind: str, x, w, y, params: CimMvmParams) -> dict:
    return dict(kind=np.array(kind), x=x, w=w, y=y,
                params=np.array([params.act_bits, params.weight_bits,
                                 params.dac_bits, params.cell_bits,
                                 params.parallel_row, params.adc_bits],
                                np.int32))


def _differences(arrays: dict, path: pathlib.Path) -> list:
    """The keys of ``arrays`` that differ from the fixture at ``path``
    in shape, dtype or any element (every key when it is missing)."""
    if not path.exists():
        return sorted(arrays)
    with np.load(path) as golden:
        keys = set(golden.files) | set(arrays)
        return sorted(k for k in keys
                      if k not in golden.files or k not in arrays
                      or golden[k].dtype != arrays[k].dtype
                      or not np.array_equal(golden[k], arrays[k]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the entry-point cross-check (default: "
                         "the card, where it runs the CUDA kernel)")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="directory the fixtures are written to")
    ap.add_argument("--check", action="store_true",
                    help="compare every fixture with the committed one in "
                         "tests/golden/cim_mvm bit for bit")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    bad = 0
    for name, kind, params, shape in CASES:
        x, w = _inputs(name, kind, params, shape)
        y = _expected(kind, x, w, params)
        # cross-check: the entry point on the device must agree before
        # the expectation is written
        y_dev = ENTRY[kind](torch.from_numpy(x).to(device),
                            torch.from_numpy(w).to(device), params)
        np.testing.assert_array_equal(y, y_dev.cpu().numpy())
        arrays = _fixture(kind, x, w, y, params)
        path = out_dir / f"{name}.npz"
        np.savez_compressed(path, **arrays)
        print(f"wrote {path} ({path.stat().st_size} bytes)")
        if args.check:
            diff = _differences(arrays, GOLDEN_DIR / path.name)
            bad += bool(diff)
            print(f"  {'MISMATCH ' + ', '.join(diff) if diff else 'equal'}"
                  f" to {GOLDEN_DIR / path.name}")
    if args.check:
        print(f"check: {len(CASES) - bad}/{len(CASES)} fixtures bit-equal "
              "to the committed ones")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
