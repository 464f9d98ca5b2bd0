#!/usr/bin/env python3
"""The control of a cell's output check: the reference, computed with
every operand on the grid of the nearest narrower integer (int4 for the
configurations' int8), put in the program's place for every image of the
cell's pool, and compared as a run compares the program.  The check has
to call it not correct on every seed.

Usage, from the root of a checkout (a CUDA card, or ``--device cpu``):

    python3 cimbench/control.py --workload NAME --seeds N [N ...]

Prints one JSON line per seed with the numbers compared and their limits,
and exits non-zero if any seed's control passes.  Imports nothing of the
program.
"""
import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
#: the integer grid below the configurations' int8
CONTROL_BITS = 4


def control(cell, seed: int, device) -> dict:
    """The numbers a run would compare, with the control's answers in
    place of the program's."""
    from cimbench import harness
    inp = harness.make_inputs(cell, seed, device)
    ref = harness.reference_outputs(cell, inp, device)
    got = harness.reference_outputs(cell, inp, device,
                                    keep_bits=CONTROL_BITS)
    idx = list(range(len(inp.pool)))
    done = [(idx, [SimpleNamespace(outputs={t: v[j] for t, v in got.items()})
                   for j in idx])]
    return harness.compare(cell, ref, done)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from cimbench import harness
    cell = harness.load_cell(args.workload)
    dev = torch.device(args.device)
    caught = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = control(cell, seed, dev)
        caught &= not harness.passed(checks)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_bits": CONTROL_BITS, "checks": checks,
                          "caught": not harness.passed(checks),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
