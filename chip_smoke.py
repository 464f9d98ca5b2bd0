#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one CUDA card (an H100).

Usage:  python3 chip_smoke.py        (from the repository root)

Drives ``repro_torch`` only — it imports neither JAX nor ``repro``:

1. **Build.**  Compiles ``src/repro_torch/csrc/cim_mvm.cu`` for sm_90a
   with nvcc (into ``build/``) and prints the build time and the card's
   ``nvidia-smi`` name and power limit.
2. **Kernels vs plain on the card.**  ``cim_mvm``, ``cim_mvm_tiles`` and
   ``cim_mvm_signed`` on the CUDA kernel must equal the plain PyTorch
   version on the same CUDA tensors bit for bit: the six committed
   goldens (``tests/golden/cim_mvm``), a seeded sweep (rows not a
   multiple of ``parallel_row``, groups not a multiple of the mma's 32
   rows, M < 16 and C % 8 != 0, saturating ADCs down to 1 bit, 8-bit
   planes, int32 operands, split and unsplit launch plans) and the main
   path's own shapes; every ``cim_mvm_tiles`` case runs twice and must
   give identical bits (the kernel's atomics are order-independent).
   Times the kernels, the plain version and a cuBLAS int8 yardstick
   (``torch._int_mm`` over the same plane work without the clamp) with
   CUDA events at the main path's shapes, and each dispatch shape
   alone.
3. **Main path.**  ``CimBatchService(resnet18(), get_arch("jia-issc21"),
   max_batch=4, device="cuda")`` — ResNet-18 at 224x224, 1000 classes,
   random weights from seed 0 — serves 8 requests.  Launch counts are
   reset just before and read just after; every ``cim_mvm_tiles``
   dispatch and the calibration's ``cim_mvm`` calls must have reached
   the kernel, and the outputs must equal a second service on the plain
   route (``mode="torch"``) given the same weights and shifts.  One
   more batch-4 dispatch runs under ``torch.profiler``: the device's
   busy share and the top device kernels and operators by time.
4. **Exact path.**  ResNet-18@224 on ``isaac-baseline`` (exact ADC: the
   split-plane float32 GEMM, no kernel) serves 4 requests on the card;
   the outputs must equal the port's on the CPU (a TF32 guard).
5. **Faults.**  ResNet-18@224 on ``puma`` (crossbar mode, 128x128
   crossbars, 1-bit ADC: every crossbar MVM saturates and runs the
   kernel; 29 segments, so the weights stream) under a seeded
   ``FaultMap`` with every fault class on.  (``jia-issc21`` is a core-mode
   chip whose reads span several crossbars, which a per-crossbar fault
   map cannot describe; ``FaultMap`` refuses it.)  (a) The faulted
   executor on the kernel equals the same executor on the plain route
   bit for bit, differs from the clean run, and times a faulted against
   a clean dispatch; (b) at 32x32 input the faulted op-by-op interpreter
   and the faulted executor, both on the kernel, equal the faulted
   executor on the plain route; (c) ``fault_aware_compile`` at 224 on a
   line-clustered map (stuck and dead bitlines, ADC offsets) and
   ``accuracy_under_faults`` with 4 inputs, unmitigated and remapped
   (remapped must be 1.0), and the remapped forward kernel vs plain;
   the calibration passes at 224 and 32 on the kernel equal the plain
   route's, tensor for tensor; prints retired lines, attempts and the
   host seconds spent materialising fault fields, compiling and
   dispatching.
6. **Fleet.**  A ``CimCluster`` of two ``jia-issc21`` chips serves
   ResNet-18@224 and ``tiny_cnn`` from a seeded synthetic trace of 48
   requests on the wall clock; one chip is killed midway while a request
   waits in its queue.  No accepted request may be lost, and every
   output must equal a standalone ``CimBatchService`` of its tenant on
   the plain route on each sub-arch the tenant was placed on (same
   weights and shifts); each tenant's calibration on the kernel must
   equal the plain route's, tensor for tensor;
   prints per-tenant p50/p99 latency, throughput before and after the
   kill and the evacuated requests.
7. **Design-space exploration.**  A successive-halving ``run_campaign``
   over ResNet-18@224 and ViT-base (d = 768, 197 tokens, 12 layers) on
   a 32-point ``jia-issc21`` space (cell precision 1 or 2 bits, 8 or 16
   cores, both bit bindings, pipeline and duplication on and off; the
   8-bit ADC over 1152 rows keeps every point saturating, so on the
   kernel), each workload's winning point verified on the card
   (``verify_best``, 2 inputs) from a fresh store; then the same
   campaign with 2 compile workers (a forkserver pool) must give the
   same winners, frontiers, metrics and verify errors.  Each winner is
   lowered again and dispatched on the kernel and on the plain route,
   bit-equal, and its calibration pass is held against the plain route
   tensor for tensor; ``evaluate_point`` of ResNet-18@224 on ``puma``
   under phase 5's line-clustered map gives the same ``fault_top1`` on
   both routes; ``explain_compile`` of ResNet-18@224 on ``jia-issc21``
   must cover every node.  Prints the winners, frontier sizes, full
   evaluations against exhaustive, and each verify's compile, lower and
   run seconds and ``max_abs_err``.

Launch counts are set to 0 just before each of phases 3, 5, 6 and 7
and read just after; each must have launched ``cim_mvm_tiles`` and
``cim_mvm``.  Prints one ``{"kernels": [...]}`` JSON line (``launches``
is phase 3's count, ``launches_by_path`` every phase's) and the
``nvidia-smi`` line before the last line, which is ``{"ok": true,
"device": {...}}``.  Any failure raises and exits non-zero without that
line; so does a machine without a CUDA device.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEV = "cuda"
HW = 224                      # ResNet-18's published input width
BATCH = 4
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor-core rate
FAULT_ARCH = "puma"           # the saturating crossbar-mode preset
FAULT_HW = 32                 # input width of the interpreter check
#: every fault class on (phase 5 a/b)
EVERY_FAULT = dict(seed=0, stuck_cell_rate=1e-3, stuck_col_rate=0.01,
                   dead_row_rate=1e-3, dead_col_rate=1e-3, drift_sigma=0.5,
                   adc_offset_sigma=1.0)
#: the line-clustered faults that retirement can clear (phase 5 c):
#: stuck cells and drift are spread over every line, and a retired row
#: would move the 1-bit ADC's row groups, so neither is remappable
LINE_FAULTS = dict(seed=0, stuck_col_rate=0.01, dead_col_rate=1e-3,
                   adc_offset_sigma=1.0)
FLEET_REQUESTS = 48
FLEET_TRACE_S = 6.0           # wall seconds the trace's arrivals span
VIT = {}                      # vit_base() at its published widths
#: phase 7's arch axes over jia-issc21 (core_number is a (rows, cols)
#: grid: 8 or 16 cores)
DSE_AXES = {"xb.cell_precision": [1, 2], "chip.core_number": [(2, 4), (4, 4)]}
VERIFY_BATCH = 2


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, after one
    warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(shapes, params, elem_bytes: int):
    """Least time for the kernel launches at ``shapes`` ((T, M, R, C)
    each): per launch the larger of its bytes over the memory rate and
    its plane operations over the int8 rate, summed; and which of the
    two bounds the total."""
    n_p = math.ceil(params.act_bits / params.dac_bits)
    n_s = math.ceil(params.weight_bits / params.cell_bits)
    total, by_bytes, by_ops = 0.0, 0.0, 0.0
    for t, m, r, c in shapes:
        b = ((t * m * r + t * r * c) * elem_bytes + t * m * c * 4) \
            / HBM_BYTES_PER_S
        o = 2 * t * m * c * r * n_p * n_s / INT8_OPS_PER_S
        total += max(b, o)
        by_bytes += b
        by_ops += o
    return total * 1e3, ("operations" if by_ops >= by_bytes else "bytes")


class Tally:
    """Mismatch bookkeeping of one kernel against its plain version."""

    def __init__(self):
        self.cases = 0
        self.mismatches = 0
        self.max_abs_err = 0

    def check(self, got, want, what: str) -> None:
        import torch
        self.cases += 1
        bad = int((got != want).sum())
        err = int((got.long() - want.long()).abs().max()) \
            if got.numel() else 0
        self.mismatches += bad
        self.max_abs_err = max(self.max_abs_err, err)
        if bad or got.shape != want.shape or got.dtype != torch.int32:
            raise AssertionError(f"{what}: {bad} mismatches, max |err| "
                                 f"{err}, shapes {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)}")


def phase_build():
    from repro_torch.kernels.cim_mvm import kernel
    t0 = time.perf_counter()
    lib = kernel.build(verbose=True)
    print(f"[build] {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")
    print(f"[build] card: {gpu_line()}")


def _sweep():
    """(T, M, R, C, params) cases of the seeded sweep."""
    from repro_torch.kernels.cim_mvm import CimMvmParams as P
    jia = P(8, 8, 1, 1, 1152, 8)
    return [
        (3, 37, 300, 70, P(8, 8, 1, 2, 8, 8)),       # R % pr != 0, ISAAC
        (2, 50, 130, 33, P(8, 8, 1, 2, 8, 4)),       # saturating ADC
        (1, 20, 260, 40, P(8, 8, 8, 8, 128, 4)),     # 8-bit planes
        (2, 9, 250, 17, P(8, 8, 8, 2, 128, 1)),      # PUMA, 1-bit ADC
        (2, 65, 100, 65, P(8, 8, 3, 2, 16, 7)),      # int32 operands
        (1, 33, 700, 20, P(8, 8, 3, 1, 512, 12)),    # group > smem chunk
        (1, 70, 1300, 130, P(8, 8, 1, 1, 1152, 8)),  # jia, ragged groups
        (1, 129, 1152, 256, jia),                     # jia, full crossbar
        (2, 40, 200, 72, P(8, 8, 1, 2, 16, 5)),      # 16-row groups
        (2, 37, 300, 70, P(8, 8, 1, 2, 100, 5)),     # 100-row groups
        (1, 50, 700, 40, P(8, 8, 1, 2, 300, 6)),     # 300-row groups
        (2, 5, 600, 37, jia),                        # M < 16, C % 8 != 0
        (1, 4500, 600, 128, jia),                    # unsplit plan
        (1, 33, 333, 48, P(8, 8, 8, 2, 128, 1)),     # PUMA, adc_max 1
        (2, 60, 200, 40, P(8, 8, 1, 1, 32, 6)),      # jain-jssc21, 63
    ]


def _operands(rng, t, m, r, c, p, dev):
    import torch
    x = rng.integers(0, 1 << p.act_bits, (t, m, r)).astype("int32")
    w = rng.integers(0, 1 << p.weight_bits, (t, r, c)).astype("int32")
    return torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)


def _plain_kwargs(params) -> dict:
    """``params`` as the plain version's keyword arguments."""
    return dict(act_bits=params.act_bits, weight_bits=params.weight_bits,
                dac_bits=params.dac_bits, cell_bits=params.cell_bits,
                parallel_row=params.parallel_row, adc_bits=params.adc_bits)


def time_forward(shapes, params, tiles: bool = True):
    """(kernel ms, plain ms, bound ms, bound_by) of the launches at
    ``shapes`` ((T, M, R, C) each), on seeded operands: one forward's
    ``cim_mvm_tiles`` launches, or with ``tiles=False`` one calibration
    pass's ``cim_mvm`` launches (T = 1)."""
    import numpy as np
    import torch
    from repro_torch.kernels.cim_mvm import kernel, ref
    dtype = kernel.operand_dtype(params)
    rng = np.random.default_rng(20261017)
    ops = [tuple(a.to(dtype).contiguous() for a in
                 _operands(rng, t, m, r, c, params, DEV))
           for t, m, r, c in shapes]
    kw = _plain_kwargs(params)

    def run_kernel():
        for x, w in ops:
            if tiles:
                kernel.cim_mvm_tiles_cuda(x, w, params)
            else:
                kernel.cim_mvm_cuda(x[0], w[0], params)

    def run_plain():
        for x, w in ops:
            ref.cim_mvm_ref_tiles(x, w, **kw)

    bms, bound_by = bound_ms(shapes, params,
                             torch.tensor([], dtype=dtype).element_size())
    return timed_ms(run_kernel), timed_ms(run_plain), bms, bound_by


def plane_gemm(shapes, params, dev):
    """A cuBLAS int8 yardstick: for each (T, M, R, C) launch, T products
    ``torch._int_mm`` of (P*M, R) 0/1 planes by (R, S*C) 0/1 planes, padded
    to its shape rules.  The same multiply-adds as the kernel's plane
    work, without the per-group clamp: no PyTorch call computes the
    saturating MVM, and the port never calls this one."""
    import torch
    n_p = math.ceil(params.act_bits / params.dac_bits)
    n_s = math.ceil(params.weight_bits / params.cell_bits)
    def up8(v):
        return -(-v // 8) * 8

    ops = []
    for t, m, r, c in shapes:
        a = torch.randint(0, 2, (max(up8(n_p * m), 24), up8(r)),
                          dtype=torch.int8, device=dev)
        b = torch.randint(0, 2, (up8(r), up8(n_s * c)), dtype=torch.int8,
                          device=dev)
        ops += [(a, b)] * t

    def run():
        for a, b in ops:
            torch._int_mm(a, b)
    return run


def phase_kernels(tiles_shapes, mvm_shapes, params):
    """Kernel vs plain version on the card; returns the per-kernel rows
    (without main-path launches) for the JSON line."""
    import numpy as np
    import torch
    from repro_torch.kernels.cim_mvm import (CimMvmParams, cim_mvm,
                                             cim_mvm_signed, cim_mvm_tiles,
                                             kernel, ref)
    entry = {"cim_mvm": cim_mvm, "cim_mvm_tiles": cim_mvm_tiles,
             "cim_mvm_signed": cim_mvm_signed}
    tally = {"cim_mvm": Tally(), "cim_mvm_tiles": Tally()}
    for path in sorted((ROOT / "tests" / "golden" / "cim_mvm")
                       .glob("*.npz")):
        z = np.load(path)
        kind = str(z["kind"])
        p = CimMvmParams(*(int(v) for v in z["params"]))
        x, w = (torch.from_numpy(z[k]).to(DEV) for k in ("x", "w"))
        got = entry[kind](x, w, p, mode="compiled")
        t = tally["cim_mvm_tiles" if kind == "cim_mvm_tiles" else "cim_mvm"]
        t.check(got, entry[kind](x, w, p, mode="torch"), path.stem)
        t.check(got, torch.from_numpy(z["y"]).to(DEV), f"{path.stem} golden")
    print(f"[kernels] goldens: {tally['cim_mvm'].cases} + "
          f"{tally['cim_mvm_tiles'].cases} checks bit-exact")

    rng = np.random.default_rng(20260417)
    cases = _sweep() + [(t, m, r, c, params)
                        for t, m, r, c in tiles_shapes]
    splits = {}
    for t, m, r, c, p in cases:
        x, w = _operands(rng, t, m, r, c, p, DEV)
        got = cim_mvm_tiles(x, w, p, mode="compiled")
        tally["cim_mvm_tiles"].check(
            got, cim_mvm_tiles(x, w, p, mode="torch"),
            f"tiles {(t, m, r, c)} {p}")
        tally["cim_mvm_tiles"].check(
            cim_mvm_tiles(x, w, p, mode="compiled"), got,
            f"tiles rerun {(t, m, r, c)} {p}")
        plan = kernel.plan_launch(p, t, m, r, c)
        splits[(t, m, r, c, p)] = (plan.group_splits * plan.phase_splits,
                                   plan.blocks)
        tally["cim_mvm"].check(cim_mvm(x[0], w[0], p, mode="compiled"),
                               cim_mvm(x[0], w[0], p, mode="torch"),
                               f"mvm {(m, r, c)} {p}")
        xs, ws = x[0] - (1 << (p.act_bits - 1)), w[0] - (1 << (p.weight_bits
                                                              - 1))
        tally["cim_mvm"].check(cim_mvm_signed(xs, ws, p, mode="compiled"),
                               cim_mvm_signed(xs, ws, p, mode="torch"),
                               f"signed {(m, r, c)} {p}")
    for m, r, c in mvm_shapes:
        x, w = _operands(rng, 1, m, r, c, params, DEV)
        tally["cim_mvm"].check(cim_mvm(x[0], w[0], params, mode="compiled"),
                               cim_mvm(x[0], w[0], params, mode="torch"),
                               f"calibration mvm {(m, r, c)}")
    torch.cuda.synchronize()
    print(f"[kernels] sweep: {len(cases)} tile cases (each run twice, "
          f"identical), {len(mvm_shapes)} calibration shapes, all "
          "bit-exact")
    most = max(splits, key=lambda k: splits[k][0])
    print(f"[kernels] launch plans: most atomic adds per output element "
          f"{splits[most][0]} at {most[:4]} ({splits[most][1]} blocks); "
          f"{sum(v[0] == 1 for v in splits.values())} cases unsplit")

    # times at the main path's shapes: one batch-4 forward's dispatches
    # (cim_mvm_tiles) and one calibration pass's MVMs (cim_mvm)
    dtype = kernel.operand_dtype(params)
    kw = _plain_kwargs(params)
    rows = {}
    for name, shapes in (("cim_mvm_tiles", tiles_shapes),
                         ("cim_mvm", [(1, m, r, c) for m, r, c in
                                      mvm_shapes])):
        ms, plain_ms, bms, bound_by = time_forward(
            shapes, params, tiles=name == "cim_mvm_tiles")
        gemm_ms = timed_ms(plane_gemm(shapes, params, DEV))
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/cim_mvm.cu",
            "replaces": ("src/repro/kernels/cim_mvm/kernel.py:132"
                         if name == "cim_mvm_tiles"
                         else "src/repro/kernels/cim_mvm/kernel.py:65"),
            "launches": None,
            "max_abs_err": tally[name].max_abs_err,
            "mismatches": tally[name].mismatches,
            "checks": tally[name].cases,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": bound_by, "library_ms": None,
            "plane_gemm_ms": gemm_ms,
            "shapes": len(shapes),
        }
        print(f"[kernels] {name}: {ms:.3f} ms kernel, {plain_ms:.3f} ms "
              f"plain, {gemm_ms:.3f} ms int8 plane GEMM, {bms:.4f} ms bound "
              f"({bound_by}) over {len(shapes)} main-path shapes")
    # where one forward's kernel time goes: each dispatch shape alone
    per = []
    for t, m, r, c in sorted(set(tiles_shapes)):
        x, w = (a.to(dtype).contiguous()
                for a in _operands(rng, t, m, r, c, params, DEV))
        n = tiles_shapes.count((t, m, r, c))
        one = timed_ms(lambda: kernel.cim_mvm_tiles_cuda(x, w, params))
        plain = timed_ms(lambda: ref.cim_mvm_ref_tiles(x, w, **kw))
        bms, _ = bound_ms([(t, m, r, c)], params, x.element_size())
        per.append((n * one, one, plain, bms, n, (t, m, r, c)))
    print("[kernels] cim_mvm_tiles per shape (total ms = ms x launches; "
          "one launch's plain ms and bound ms; shape T,M,R,C): " + "; ".join(
              f"{tot:.3f} = {one:.4f} x{n} (plain {plain:.3f}, bound "
              f"{bms:.4f}) {s}"
              for tot, one, plain, bms, n, s in sorted(per, reverse=True)))
    slower = [s for _, one, plain, _, _, s in per if one >= plain]
    assert not slower, f"kernel not faster than the plain version at {slower}"
    return rows


def _mvm_shapes(graph):
    """(M, R, C) of the calibration pass's MVMs: one per CIM node at
    batch 1."""
    from repro_torch.core.graph import weight_matrix_shape
    out = []
    for node in graph.cim_nodes:
        r, c = weight_matrix_shape(node)
        shape = graph.shapes[node.outputs[0]]
        m = shape[1] * shape[2] if node.op_type == "Conv" else \
            (1 if len(shape) == 1 else shape[0])
        out.append((m, r, c))
    return out


def main_path(device):
    """The main path's graph (ResNet-18 at HW), arch (jia-issc21), kernel
    params, one batch's dispatch shapes (T, M, R, C) and the calibration
    pass's MVM shapes (M, R, C)."""
    from repro_torch.cimsim.executor import lower
    from repro_torch.core import compiler
    from repro_torch.core.abstraction import get_arch
    from repro_torch.kernels.cim_mvm import cim_mvm_params
    from repro_torch.workloads import resnet18
    graph, jia = resnet18(in_hw=HW), get_arch("jia-issc21")
    params = cim_mvm_params(jia)
    res = compiler.compile_graph(graph, jia)
    tiles_shapes = lower(res.plan, res.program, params=params, device=device,
                         cache=False).dispatch_shapes(BATCH)
    return graph, jia, params, tiles_shapes, _mvm_shapes(graph)


def _device_us(event, total: bool = False) -> float:
    """An event's device microseconds, its own or with its children's."""
    return float(event.device_time_total if total
                 else event.self_device_time_total)


def profile_call(fn, label: str):
    """``fn()`` (one dispatch, which synchronises) once bare and once
    under ``torch.profiler``: wall seconds, the device's busy share (the
    sum of its kernel and copy times over the wall time, the profiled
    one's and the bare one's; one stream, so they do not overlap) and
    the top device kernels and operators by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    bare = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = prof.key_averages()
    dev = sorted((e for e in stats if e.device_type == DeviceType.CUDA),
                 key=_device_us, reverse=True)
    ops = sorted((e for e in stats if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::") and _device_us(e, True)),
                 key=lambda e: _device_us(e, True), reverse=True)
    assert dev, "the profiler recorded no device activity"
    busy_s = sum(_device_us(e) for e in dev) / 1e6
    out = {"wall_s": wall, "unprofiled_wall_s": bare,
           "device_busy_s": busy_s, "busy_share": busy_s / wall,
           "unprofiled_busy_share": busy_s / bare,
           "kernels": [(e.key[:70], e.count, _device_us(e) / 1e3)
                       for e in dev[:8]],
           "operators": [(e.key, e.count, _device_us(e, True) / 1e3)
                         for e in ops[:8]]}
    print(f"[profile] {label}: wall {wall:.4f} s "
          f"profiled, {bare:.4f} s unprofiled; device busy "
          f"{busy_s * 1e3:.3f} ms ({100 * out['busy_share']:.1f} % of the "
          f"profiled wall, {100 * out['unprofiled_busy_share']:.1f} % of the "
          f"unprofiled); {sum(e.count for e in dev)} device kernels and "
          "copies")
    print("[profile] top device kernels (launches, ms): " + "; ".join(
        f"{k} ({n}, {ms:.3f})" for k, n, ms in out["kernels"]))
    print("[profile] top operators by device time incl. children "
          "(calls, ms): " + "; ".join(
              f"{k} ({n}, {ms:.3f})" for k, n, ms in out["operators"]))
    return out


def phase_main(graph, arch):
    """The main path; returns (launch counts, timings)."""
    import numpy as np
    import torch
    from repro_torch.cimsim.functional import make_input
    from repro_torch.kernels.cim_mvm import kernel
    from repro_torch.obs import metrics
    from repro_torch.serving import CimBatchService, CimRequest

    reg = metrics.enable(metrics.MetricsRegistry())
    torch.cuda.reset_peak_memory_stats()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    svc = CimBatchService(graph, arch, max_batch=BATCH, device=DEV)
    init_s = time.perf_counter() - t0
    reqs = [CimRequest(rid=i, inputs=make_input(graph, i)) for i in range(8)]
    t1 = time.perf_counter()
    svc.serve(reqs)
    serve_s = time.perf_counter() - t1
    torch.cuda.synchronize()
    launches = dict(kernel.LAUNCHES)
    metrics.disable()

    stats = svc.executor_stats
    compile_s = reg.histogram("compile_wall_s", cached=False).sum
    lower_s = reg.histogram("executor_lower_s").sum
    pack_s = reg.histogram("executor_pack_s").sum
    disp = reg.histogram("executor_dispatch_s", route="compiled")
    timings = {"init_s": init_s, "compile_s": compile_s, "lower_s": lower_s,
               "pack_s": pack_s,
               "calibration_s": init_s - compile_s - lower_s - pack_s,
               "serve_s": serve_s, "dispatches": disp.count,
               "dispatch_s": disp.sum / max(disp.count, 1),
               "batch_s": [r.latency_s for r in reqs[::BATCH]],
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"[main] {graph.name}@{HW} on {arch.name}: {stats}")
    print(f"[main] launches {launches}; compile {compile_s:.3f} s, "
          f"calibration {timings['calibration_s']:.3f} s, lower "
          f"{lower_s:.3f} s, pack {pack_s:.3f} s; per-batch dispatch "
          + ", ".join(f"{s:.4f}" for s in timings["batch_s"])
          + f" s; peak {timings['peak_mem_gib']:.2f} GiB")
    assert svc.use_executor, "service fell back to the interpreter"
    assert stats.kernel_mode == "compiled", stats.kernel_mode
    # every run_batch (the warm-up pass and the 2 timed batches)
    assert launches["cim_mvm_tiles"] >= stats.dispatches * disp.count >= \
        stats.dispatches * 2, (launches, stats.dispatches, disp.count)
    assert launches["cim_mvm"] > 0, "calibration never reached the kernel"
    for r in reqs:
        y = r.outputs["fc.out"]
        assert y.shape == (1000,) and y.dtype == np.int32, (y.shape, y.dtype)
        assert -128 <= int(y.min()) and int(y.max()) <= 127
    preqs = [CimRequest(rid=100 + i, inputs=make_input(graph, i))
             for i in range(BATCH)]
    timings["profile"] = profile_call(lambda: svc.dispatch(preqs),
                                      f"one batch-{BATCH} dispatch")

    plain = CimBatchService(graph, arch, max_batch=BATCH, device=DEV,
                            mode="torch", weights=svc.weights,
                            shifts=svc.shifts)
    assert plain.executor_stats.kernel_mode == "torch"
    reqs2 = [CimRequest(rid=i, inputs=make_input(graph, i))
             for i in range(8)]
    plain.serve(reqs2)
    for a, b in zip(reqs, reqs2):
        np.testing.assert_array_equal(a.outputs["fc.out"], b.outputs["fc.out"])
    timings["plain_batch_s"] = [r.latency_s for r in reqs2[::BATCH]]
    print("[main] 8 outputs bit-equal to the plain route; plain per-batch "
          + ", ".join(f"{s:.4f}" for s in timings["plain_batch_s"]) + " s")
    return launches, timings


def phase_exact(graph, arch):
    import numpy as np
    from repro_torch.cimsim.functional import make_input
    from repro_torch.kernels.cim_mvm import kernel
    from repro_torch.serving import CimBatchService, CimRequest
    cpu = CimBatchService(graph, arch, max_batch=BATCH, device="cpu")
    kernel.reset_launch_counts()
    gpu = CimBatchService(graph, arch, max_batch=BATCH, device=DEV,
                          weights=cpu.weights, shifts=cpu.shifts)
    assert gpu.executor_stats.matmul_nodes == gpu.executor_stats.cim_nodes
    out = {}
    for name, svc in (("cpu", cpu), ("gpu", gpu)):
        reqs = [CimRequest(rid=i, inputs=make_input(graph, i))
                for i in range(BATCH)]
        svc.serve(reqs)
        out[name] = reqs
    assert sum(kernel.LAUNCHES.values()) == 0, kernel.LAUNCHES
    for a, b in zip(out["cpu"], out["gpu"]):
        np.testing.assert_array_equal(a.outputs["fc.out"], b.outputs["fc.out"])
    print(f"[exact] {graph.name}@{HW} on {arch.name}: {BATCH} outputs "
          f"bit-equal card vs CPU; card batch {out['gpu'][0].latency_s:.4f} "
          f"s, CPU batch {out['cpu'][0].latency_s:.4f} s")


def check_calibration(graph, weights, x, params, shifts) -> int:
    """Hold a calibration pass on the kernel against the same pass with
    every crossbar MVM on the plain route, on the card: the shifts must
    equal ``shifts`` and every tensor of the two passes must be
    bit-equal.  Returns the number of tensors compared."""
    import numpy as np
    import torch
    from repro_torch.cimsim.functional import (reference_forward,
                                               reference_mvm, weights_numpy)
    from repro_torch.kernels.cim_mvm import cim_mvm_signed

    def plain_mvm(x_rows, w):
        return cim_mvm_signed(
            torch.as_tensor(x_rows.astype(np.int32), device=DEV),
            torch.as_tensor(w.astype(np.int32), device=DEV), params,
            mode="torch").cpu().numpy()

    w = weights_numpy(weights)
    got, got_shifts = reference_forward(graph, w, x,
                                        mvm=reference_mvm(params, DEV))
    want, want_shifts = reference_forward(graph, w, x, mvm=plain_mvm)
    assert got_shifts == want_shifts == shifts, (got_shifts, want_shifts)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    return len(want)


def _run_timed(exe, batched, packed, shifts):
    """(outputs, wall seconds) of one executor pass; copying the outputs
    to the host synchronises."""
    t0 = time.perf_counter()
    out = exe.run_batch(batched, packed=packed, shifts=shifts)
    return out, time.perf_counter() - t0


def phase_faults():
    """Phase 5; returns the launch counts of its run and the faulted
    forward's kernel times."""
    import numpy as np
    from repro_torch.cimsim.executor import lower
    from repro_torch.cimsim.faults import (FaultMap, FaultModel,
                                           accuracy_under_faults,
                                           fault_aware_compile, plan_spans)
    from repro_torch.cimsim.functional import (FunctionalSimulator,
                                               calibrate_shifts, make_input,
                                               make_weights)
    from repro_torch.core import compiler
    from repro_torch.core.abstraction import get_arch
    from repro_torch.kernels.cim_mvm import cim_mvm_params, kernel
    from repro_torch.workloads import resnet18

    t_phase = time.perf_counter()
    kernel.reset_launch_counts()
    arch = get_arch(FAULT_ARCH)
    params = cim_mvm_params(arch)
    model = FaultModel(**EVERY_FAULT)
    graph = resnet18(in_hw=HW)
    out = graph.outputs[0]
    weights = make_weights(graph, 0)
    inputs = [make_input(graph, i) for i in range(BATCH)]
    batched = {k: np.stack([x[k] for x in inputs]) for k in graph.inputs}
    shifts = calibrate_shifts(graph, weights, inputs[0], params, device=DEV)
    res = compiler.compile_graph(graph, arch)

    # (a) the faulted forward: kernel vs plain route, faulted vs clean
    fm = FaultMap(model, arch)
    t0 = time.perf_counter()
    spans = plan_spans(res.plan, res.program)
    for name, node_spans in spans.items():
        for span in node_spans:
            fm.span_deficit(name, span)          # materialises the field
    materialise_s = time.perf_counter() - t0
    n_spans = sum(len(v) for v in spans.values())
    exes = {(route, tag): lower(res.plan, res.program, params=params,
                                mode=route, device=DEV, cache=False,
                                faults=fm if tag == "faulted" else None)
            for route in ("compiled", "torch")
            for tag in ("faulted", "clean")}
    stats = exes[("compiled", "faulted")].stats
    assert stats.streamed and stats.matmul_nodes == 0, stats
    packed = {k: e.pack(weights) for k, e in exes.items()}
    outs = {k: _run_timed(e, batched, packed[k], shifts)[0]
            for k, e in exes.items()}
    np.testing.assert_array_equal(outs[("compiled", "faulted")][out],
                                  outs[("torch", "faulted")][out])
    np.testing.assert_array_equal(outs[("compiled", "clean")][out],
                                  outs[("torch", "clean")][out])
    y = outs[("compiled", "faulted")][out]
    assert y.shape == (BATCH, 1000) and -128 <= y.min() and y.max() <= 127
    changed = int((y != outs[("compiled", "clean")][out]).any(axis=1).sum())
    assert changed >= 1, "the fault map left every output untouched"
    times = {"clean": [], "faulted": []}
    for tag in ("clean", "faulted", "faulted", "clean") * 4:
        key = ("compiled", tag)
        times[tag].append(_run_timed(exes[key], batched, packed[key],
                                     shifts)[1])
    plain = {tag: _run_timed(exes[("torch", tag)], batched,
                             packed[("torch", tag)], shifts)[1]
             for tag in ("clean", "faulted")}
    print(f"[faults] {graph.name}@{HW} on {arch.name}: {stats}")
    print(f"[faults] (a) {n_spans} spans; fault fields materialised in "
          f"{materialise_s:.3f} s; {BATCH} faulted outputs bit-equal "
          f"kernel vs plain, {changed} of {BATCH} differ from the clean "
          "run; dispatch s on the kernel, clean "
          + ", ".join(f"{t:.4f}" for t in times["clean"]) + "; faulted "
          + ", ".join(f"{t:.4f}" for t in times["faulted"])
          + f" (medians {np.median(times['clean']):.4f} and "
          f"{np.median(times['faulted']):.4f}); plain route clean "
          f"{plain['clean']:.4f}, faulted {plain['faulted']:.4f}")

    # (b) interpreter == executor under the same map, at FAULT_HW
    small = resnet18(in_hw=FAULT_HW)
    w_small = make_weights(small, 0)
    x_small = make_input(small, 0)
    s_small = calibrate_shifts(small, w_small, x_small, params, device=DEV)
    res_x = compiler.compile_graph(small, arch, expand=True)
    t0 = time.perf_counter()
    sim = FunctionalSimulator(res_x.plan, res_x.program, w_small, s_small,
                              params=params, device=DEV,
                              faults=FaultMap(model, arch))
    interp = sim.run(x_small)
    interp_s = time.perf_counter() - t0
    res_s = compiler.compile_graph(small, arch)
    fm_s = FaultMap(model, arch)
    small_out = {route: lower(res_s.plan, res_s.program, params=params,
                              mode=route, device=DEV, cache=False,
                              faults=fm_s).run(x_small, w_small,
                                               s_small)[out]
                 for route in ("compiled", "torch")}
    np.testing.assert_array_equal(interp[out], small_out["torch"])
    np.testing.assert_array_equal(small_out["compiled"], small_out["torch"])
    print(f"[faults] (b) {small.name}@{FAULT_HW}: the faulted interpreter "
          f"on the kernel ({sim.stats.cim_reads} crossbar reads, "
          f"{interp_s:.3f} s) and the faulted executor on the kernel both "
          "equal the faulted executor on the plain route")

    # (c) fault-aware compile and top-1 under faults
    lines = FaultModel(**LINE_FAULTS)
    t0 = time.perf_counter()
    fc = fault_aware_compile(graph, arch, lines)
    compile_s = time.perf_counter() - t0
    acc = {}
    for remap in (False, True):
        t0 = time.perf_counter()
        acc[remap] = accuracy_under_faults(graph, arch, lines,
                                           n_inputs=BATCH, remap=remap,
                                           device=DEV)
        acc[f"{remap}_s"] = time.perf_counter() - t0
    print(f"[faults] (c) fault_aware_compile: {fc.retired_rows} rows and "
          f"{fc.retired_cols} bitlines retired in {fc.attempts} attempts, "
          f"{compile_s:.3f} s; top-1 agreement over {BATCH} inputs: "
          f"unmitigated {acc[False]} ({acc['False_s']:.3f} s), remapped "
          f"{acc[True]} ({acc['True_s']:.3f} s)")
    assert acc[True] == 1.0, acc
    remapped = {route: lower(fc.result.plan, fc.result.program,
                             params=params, mode=route, device=DEV,
                             cache=False, faults=fc.faults)
                .run_batch(batched, weights=weights, shifts=shifts)[out]
                for route in ("compiled", "torch")}
    np.testing.assert_array_equal(remapped["compiled"], remapped["torch"])
    launches = dict(kernel.LAUNCHES)
    # calibration passes on the kernel against the plain route (after
    # the phase's launches were read)
    n_cal = check_calibration(graph, weights, inputs[0], params, shifts) \
        + check_calibration(small, w_small, x_small, params, s_small)
    print(f"[faults] (c) the remapped forward is bit-equal kernel vs plain;"
          f" calibration at {HW} and {FAULT_HW}: {n_cal} tensors bit-equal "
          "kernel vs plain")
    # the faulted forward's launches timed alone with CUDA events (not
    # counted: the phase's launches were read above)
    ms, plain_ms, bms, bound_by = time_forward(
        exes[("compiled", "faulted")].dispatch_shapes(BATCH), params)
    print(f"[faults] cim_mvm_tiles on {arch.name}, {stats.dispatches} "
          f"launches a forward: {ms:.3f} ms kernel, {plain_ms:.3f} ms "
          f"plain, {bms:.4f} ms bound ({bound_by})")
    print(f"[faults] host seconds: materialising fault fields "
          f"{materialise_s:.3f}, fault-aware compile {compile_s:.3f}, "
          f"faulted dispatch {min(times['faulted']):.4f} (clean "
          f"{min(times['clean']):.4f}); launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    assert launches["cim_mvm_tiles"] >= 2 * stats.dispatches, launches
    assert launches["cim_mvm"] > 0, launches
    return launches, {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                      "bound_by": bound_by, "shapes": stats.dispatches}


def phase_fleet(graph):
    """Phase 6; returns the launch counts of its run."""
    import numpy as np
    from repro_torch.cimsim.functional import make_input
    from repro_torch.core.abstraction import get_arch
    from repro_torch.kernels.cim_mvm import kernel
    from repro_torch.serving import (ChipFault, CimBatchService,
                                     CimCluster, CimRequest, FaultSchedule,
                                     TenantSpec, TraceRecorder,
                                     TrafficModel, synthetic_trace)
    from repro_torch.serving.common import percentile
    from repro_torch.workloads import tiny_cnn

    t_phase = time.perf_counter()
    jia = get_arch("jia-issc21")
    chips = {c: jia.subarch(jia.chip.n_cores, c) for c in ("jia-a", "jia-b")}
    graphs = {"resnet18": graph, "tiny_cnn": tiny_cnn()}
    trace = synthetic_trace(
        graphs, FLEET_REQUESTS, FLEET_TRACE_S,
        shares={"resnet18": 1.0, "tiny_cnn": 1.0},
        model=TrafficModel(diurnal_amp=0.0, bursts_per_day=0.0), seed=0)
    # the kill fires 5 ms after the first tiny_cnn arrival past midway:
    # that request waits max_wait_s (20 ms) on jia-b, and the next step
    # or admission applies due faults before it releases a batch, so it
    # is always evacuated
    mid = next(r for r in trace[len(trace) // 2:] if r.model == "tiny_cnn")
    kill_at = mid.arrival_s + 0.005
    kernel.reset_launch_counts()
    tr = TraceRecorder()
    cluster = CimCluster(
        [TenantSpec(n, g) for n, g in graphs.items()], chips, seed=0,
        max_wait_s=0.02, trace=tr, device=DEV,
        faults=FaultSchedule([ChipFault(at_s=kill_at, chip="jia-b")]))
    plans = [cluster.plan]
    for fleet in cluster.fleets.values():        # warm every bucket shape
        for name, engine in fleet.pool.items():
            x = [CimRequest(rid=-1, inputs=make_input(graphs[name], 0))]
            for b in cluster.buckets:
                engine.serve_padded(x, b)
    setup_s = time.perf_counter() - t_phase

    done_at = []                                  # (clock s, completed)
    t0 = time.monotonic()

    def clock():
        return time.monotonic() - t0

    def step():
        n = len(cluster.step(now=clock()))
        if n:
            done_at.append((clock(), n))
        return n

    # open loop: a request is stamped with its trace arrival, so its
    # latency includes any time the host was too busy to admit it
    for r in trace:
        while clock() < r.arrival_s:
            if not step():
                time.sleep(2e-4)
        cluster.submit_request(r, now=r.arrival_s)
        if cluster.plan is not plans[-1]:
            plans.append(cluster.plan)
    while cluster.pending:
        step()
    end = clock()
    launches = dict(kernel.LAUNCHES)
    assert cluster.chip_kills == 1 and cluster.failed == {"jia-b"}, \
        cluster.summary()
    lost = [r.rid for r in trace if r.outputs is None]
    assert not lost, f"accepted requests lost: {lost}"
    assert launches["cim_mvm_tiles"] > 0 and launches["cim_mvm"] > 0, \
        launches
    evacuated = sum(e["args"]["evacuated"] for e in tr.events
                    if e.get("name") == "chip_kill")
    assert evacuated >= 1, "the kill found no queued request to evacuate"

    # each served output against standalone services of its tenant on
    # every sub-arch the tenant was placed on, same weights and shifts,
    # on the plain route; each tenant's calibration (the cluster's seed
    # 0) on the kernel against the plain route
    checked = n_cal = 0
    for name, g in graphs.items():
        mine = [r for r in trace if r.model == name]
        engine = next(f.pool[name] for f in cluster.fleets.values()
                      if name in f.pool)
        views = {}
        for plan in plans:
            for tplan in plan.chips.values():
                if name in tplan.tenants:
                    sub = tplan.subarch(name)
                    views[json.dumps(sub.to_dict(), sort_keys=True,
                                     default=str)] = sub
        n_cal += check_calibration(g, engine.weights, make_input(g, 0),
                                   engine.params, engine.shifts)
        for sub in views.values():
            ref = CimBatchService(g, sub, max_batch=max(cluster.buckets),
                                  weights=engine.weights,
                                  shifts=engine.shifts, device=DEV,
                                  mode="torch")
            assert ref.executor_stats.kernel_mode == "torch"
            refs = [CimRequest(rid=r.rid, inputs=r.inputs) for r in mine]
            ref.serve(refs)
            for a, b in zip(mine, refs):
                for t in g.outputs:
                    np.testing.assert_array_equal(a.outputs[t],
                                                  b.outputs[t])
                    checked += 1
    before = sum(n for t, n in done_at if t < kill_at)
    after = sum(n for t, n in done_at if t >= kill_at)
    lat = {name: [r.latency_s for r in trace if r.model == name]
           for name in graphs}
    print(f"[fleet] plan before the kill: {plans[0].routes}; after: "
          f"{cluster.plan.routes}")
    print(f"[fleet] {len(trace)} requests over {end:.3f} s (set-up "
          f"{setup_s:.3f} s), none lost; jia-b killed at {kill_at:.3f} s, "
          f"{evacuated} queued requests evacuated; {checked} outputs "
          "bit-equal to standalone services on the plain route on every "
          f"sub-arch of their tenant; calibration {n_cal} tensors bit-equal "
          "kernel vs plain")
    print("[fleet] latency per tenant (p50 / p99 s): " + "; ".join(
        f"{n}: {percentile(v, 50):.4f} / {percentile(v, 99):.4f} "
        f"({len(v)} requests)" for n, v in lat.items()))
    print(f"[fleet] throughput: {before / kill_at:.2f} requests/s before "
          f"the kill, {after / max(end - kill_at, 1e-9):.2f} after; "
          f"launches {launches}; phase {time.perf_counter() - t_phase:.1f}"
          " s")
    return launches


def _campaign_view(camp):
    """A campaign's winners, frontiers, full-fidelity metrics and verify
    errors, comparable across runs."""
    return {name: (w.best.point.label(),
                   [r.point.label() for r in w.frontier],
                   [(r.point.label(), r.metrics, r.error)
                    for r in w.results],
                   w.full_evals, w.verify.max_abs_err)
            for name, w in camp.workloads.items()}


def phase_dse(graph):
    """Phase 7; returns the launch counts of its run."""
    import tempfile
    import numpy as np
    from repro_torch.cimsim.executor import clear_lower_cache, lower
    from repro_torch.cimsim.faults import FaultModel
    from repro_torch.cimsim.functional import (calibrate_shifts, make_input,
                                               make_weights)
    from repro_torch.core import compiler
    from repro_torch.core.abstraction import get_arch
    from repro_torch.dse import (CompileCache, DesignPoint, DesignSpace,
                                 evaluate_point, run_campaign)
    from repro_torch.kernels.cim_mvm import cim_mvm_params, kernel
    from repro_torch.obs import explain_compile
    from repro_torch.workloads import vit_base

    t_phase = time.perf_counter()
    jia = get_arch("jia-issc21")
    space = DesignSpace(jia, arch_axes=DSE_AXES)
    graphs = {"resnet18": graph, "vit": vit_base(**VIT)}
    clear_lower_cache()          # phase 5 lowered the same puma forward
    kernel.reset_launch_counts()
    camps, views = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for workers in (1, 2):
            before = kernel.LAUNCHES["cim_mvm_tiles"]
            t0 = time.perf_counter()
            camp = run_campaign(
                graphs, space, verify_best=True, verify_batch=VERIFY_BATCH,
                device=DEV, workers=workers,
                cache=CompileCache(pathlib.Path(tmp) / f"w{workers}"))
            wall = time.perf_counter() - t0
            grew = kernel.LAUNCHES["cim_mvm_tiles"] - before
            assert grew > 0, "verify_best never reached the kernel"
            camps[workers], views[workers] = camp, _campaign_view(camp)
            for name, w in camp.workloads.items():
                v = w.verify
                assert v.error is None, v.error
                print(f"[dse] workers {workers}: {name} best "
                      f"'{w.best.point.label()}', frontier "
                      f"{len(w.frontier)}, {w.full_evals} full evaluations "
                      f"of {camp.n_points} (exhaustive); verify compile "
                      f"{v.compile_s:.3f} s, lower {v.lower_s:.3f} s, run "
                      f"{v.run_s:.3f} s, max_abs_err {v.max_abs_err}")
            print(f"[dse] workers {workers}: campaign {wall:.3f} s, "
                  f"{grew} cim_mvm_tiles launches in verify_best")
    assert views[1] == views[2], "workers 1 and 2 disagree"

    # the fault metric of the DSE tier on the kernel, and provenance
    puma = get_arch(FAULT_ARCH)
    point = DesignPoint(level=puma.mode.value, binding="B->XBC",
                        use_pipeline=True, use_duplication=True)
    lines = FaultModel(**LINE_FAULTS)
    top1 = {}
    t0 = time.perf_counter()
    top1["compiled"] = evaluate_point(graph, puma, point,
                                      fault_model=lines,
                                      device=DEV)[0]["fault_top1"]
    top1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = explain_compile(graph, jia)
    explain_s = time.perf_counter() - t0
    assert report.coverage == 1.0, report.coverage
    launches = dict(kernel.LAUNCHES)
    assert launches["cim_mvm_tiles"] > 0 and launches["cim_mvm"] > 0, \
        launches

    # held against the plain route (after the phase's launches were read)
    t0 = time.perf_counter()
    top1["torch"] = evaluate_point(graph, puma, point, fault_model=lines,
                                   device=DEV, mode="torch")[0]["fault_top1"]
    top1_plain_s = time.perf_counter() - t0
    assert top1["compiled"] == top1["torch"], top1
    n_out = n_cal = 0
    for name, w in camps[1].workloads.items():
        g, pt = graphs[name], w.best.point
        arch = pt.arch_for(jia)
        params = cim_mvm_params(arch)
        res = compiler.compile_graph(g, arch, **pt.compile_kwargs())
        weights = make_weights(g, 0)
        inputs = [make_input(g, i) for i in range(VERIFY_BATCH)]
        batched = {k: np.stack([x[k] for x in inputs]) for k in g.inputs}
        shifts = calibrate_shifts(g, weights, inputs[0], params, device=DEV)
        outs = {}
        for route in ("compiled", "torch"):
            exe = lower(res.plan, res.program, params=params, mode=route,
                        device=DEV, cache=False)
            assert exe.stats.kernel_mode == route, exe.stats
            packed = exe.pack(weights)
            outs[route] = exe.run_batch(batched, packed=packed,
                                        shifts=shifts)
            if route == "compiled":
                print(f"[dse] {name} winner: {exe.stats}")
                profile_call(lambda: exe.run_batch(batched, packed=packed,
                                                   shifts=shifts),
                             f"{name} winner, one batch-{VERIFY_BATCH} "
                             "dispatch")
        for t in g.outputs:
            np.testing.assert_array_equal(outs["compiled"][t],
                                          outs["torch"][t], err_msg=t)
            n_out += 1
        n_cal += check_calibration(g, weights, inputs[0], params, shifts)
    print(f"[dse] winners re-dispatched: {n_out} outputs bit-equal kernel "
          f"vs plain; calibration {n_cal} tensors bit-equal kernel vs "
          "plain")
    print(f"[dse] evaluate_point {graph.name}@{HW} on {puma.name} under "
          f"the line-clustered map: fault_top1 {top1['compiled']} on the "
          f"kernel ({top1_s:.3f} s), {top1['torch']} on the plain route "
          f"({top1_plain_s:.3f} s)")
    print(f"[dse] explain {graph.name}@{HW} on {jia.name}: coverage "
          f"{report.coverage}, {len(report.rows)} rows, "
          f"{report.meta['segments']} segments ({explain_s:.3f} s); "
          f"launches {launches}; phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.abstraction import get_arch
    from repro_torch.workloads import resnet18

    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase_build()

    graph, jia, params, tiles_shapes, mvm_shapes = main_path(DEV)
    rows = phase_kernels(tiles_shapes, mvm_shapes, params)

    launches, _ = phase_main(graph, jia)
    for name, row in rows.items():
        row["launches"] = launches[name]
        assert row["launches"] > 0, f"{name} never launched on the main path"

    t0 = time.perf_counter()
    phase_exact(resnet18(in_hw=HW), get_arch("isaac-baseline"))
    print(f"[exact] phase {time.perf_counter() - t0:.1f} s")
    fault_launches, puma_forward = phase_faults()
    by_path = {"main": launches, "faults": fault_launches,
               "fleet": phase_fleet(graph), "dse": phase_dse(graph)}
    for name, row in rows.items():
        row["launches_by_path"] = {p: n[name] for p, n in by_path.items()}
    rows["cim_mvm_tiles"]["puma_faulted_forward"] = puma_forward

    print(json.dumps({"kernels": [rows["cim_mvm_tiles"], rows["cim_mvm"]]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
