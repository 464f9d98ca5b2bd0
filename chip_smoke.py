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

Prints one ``{"kernels": [...]}`` JSON line and the ``nvidia-smi`` line
before the last line, which is ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero without that line; so does a machine
without a CUDA device.
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
    kw = dict(act_bits=params.act_bits, weight_bits=params.weight_bits,
              dac_bits=params.dac_bits, cell_bits=params.cell_bits,
              parallel_row=params.parallel_row, adc_bits=params.adc_bits)
    rows = {}
    for name, shapes in (("cim_mvm_tiles", tiles_shapes),
                         ("cim_mvm", [(1, m, r, c) for m, r, c in
                                      mvm_shapes])):
        ops = [tuple(a.to(dtype).contiguous() for a in
                     _operands(rng, t, m, r, c, params, DEV))
               for t, m, r, c in shapes]
        if name == "cim_mvm_tiles":
            def run_kernel():
                for x, w in ops:
                    kernel.cim_mvm_tiles_cuda(x, w, params)
        else:
            def run_kernel():
                for x, w in ops:
                    kernel.cim_mvm_cuda(x[0], w[0], params)

        def run_plain():
            for x, w in ops:
                ref.cim_mvm_ref_tiles(x, w, **kw)

        ms = timed_ms(run_kernel)
        plain_ms = timed_ms(run_plain)
        gemm_ms = timed_ms(plane_gemm(shapes, params, DEV))
        bms, bound_by = bound_ms(shapes, params, torch.tensor(
            [], dtype=dtype).element_size())
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


def profile_dispatch(svc, graph):
    """One more batch dispatch of ``svc`` under ``torch.profiler``: wall
    seconds, the device's busy share (the sum of its kernel and copy
    times over the wall time, the profiled one's and that of the same
    dispatch unprofiled just before; one stream, so they do not overlap)
    and the top device kernels and operators by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.cimsim.functional import make_input
    from repro_torch.serving import CimRequest
    reqs = [CimRequest(rid=100 + i, inputs=make_input(graph, i))
            for i in range(BATCH)]
    bare = svc.dispatch(reqs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.dispatch(reqs)
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
    print(f"[profile] one batch-{BATCH} dispatch: wall {wall:.4f} s "
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
    timings["profile"] = profile_dispatch(svc, graph)

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

    phase_exact(resnet18(in_hw=HW), get_arch("isaac-baseline"))

    print(json.dumps({"kernels": [rows["cim_mvm_tiles"], rows["cim_mvm"]]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
