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
   multiple of ``parallel_row``, groups not a multiple of the wgmma's 32
   rows and a short last group, M < 64 and C below the 64-column tile,
   saturating ADCs down to 1 bit, DAC and cell widths of 1, 2, 4 and 8
   bits, 6 phases, int32 operands, split and unsplit launch plans, row
   groups resident in the ring and streamed through it) and the main
   path's own shapes, with each case's load paths printed (x and w by
   TMA or by 4-byte ``cp.async``); operands whose base addresses sit off
   the 16-byte grid take ``cp.async``; every ``cim_mvm_tiles`` case runs
   twice and must give identical bits (the kernel's atomics are
   order-independent), and all four x / w path pairs and a streamed
   group must have been launched.  Prints the host cost of encoding one
   TMA tensor map.  Times the kernels, the plain version and a cuBLAS
   int8 yardstick (``torch._int_mm`` over the same plane work without the
   clamp) with CUDA events at the main path's shapes, and each dispatch
   shape alone; phases 5 and 8 time the faulted puma forward and the LM
   block's launches the same way.
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
8. **LM substrate** (``[lm]`` lines), qwen1.5-4b at its published widths
   (40 layers, d = 2560, 20 heads of 128, d_ff 6912, vocab 151936, QKV
   bias), random weights drawn on the card from a seed.  (a) float32:
   the reference's prefill/decode consistency test at B = 2, S = 64
   (prefill vs forward within 2e-2 of the largest logit, decode within
   5e-2, greedy tokens equal).  (b) bf16: ``BatchServer`` with 4 slots
   and ``max_len`` 256 serves 8 seeded requests of 32-128 prompt tokens
   and 32 new tokens each; every request gets its tokens and every
   logit is finite; prints set-up seconds, each batch's prefill against
   its bound, decode ms per step against the bound by bytes, tokens/s,
   peak memory, and one decode step under ``torch.profiler``.  (c) The
   reduced qwen1.5-4b and gemma2-2b in float32 on the card and on the
   CPU from the same parameters: logits within 1e-4, greedy and served
   tokens equal.  (d) ``lmblock:qwen1.5-4b`` (seq 512) compiled onto
   ``jia-issc21`` and verified with ``compile_and_verify`` on the kernel
   and on the plain route: the same ``max_abs_err`` (at d = 2560 the
   reference's own, nonzero), bit-equal executor outputs and
   calibration passes; the forward's kernel launches timed.

9. **LM training** (``[train]`` lines), TF32 off.  (a) Reduced
   qwen1.5-4b, gemma2-2b and mixtral-8x7b in float32 from one seed on
   the card and on the CPU: the loss, every gradient leaf, and the
   params and moments after one clipped AdamW update fed the CPU's
   gradients, within 1e-5 of each leaf's largest magnitude; two
   microbatches against one on the card within the same bound (not on
   mixtral: an MoE layer's expert capacity scales with the tokens of a
   call).  (b) qwen1.5-4b at full width in bf16 trains 10 steps on
   ``TokenStream(vocab, 2, 4096, seed=0)`` through the ``Trainer`` that
   ``launch/train.py`` builds (B = 2, S = 4096, ``mb=1``, remat, lr
   1e-3, no checkpoint): each step's loss and seconds, the median step,
   tokens/s against ``lm_train_bound_ms``, the optimizer's own
   milliseconds, peak memory, set-up seconds and one more step under
   ``torch.profiler`` on a depth-cut copy (its first 4 of 40 layers,
   fresh weights, the same batch: a full-depth step's trace took
   minutes to read); every loss finite and the mean of the last three
   below the first.  (c) Reduced qwen1.5-4b in bf16: 4 steps with
   checkpoints every 2, then a new trainer on the same workdir resumes
   at step 4 on the card to step 6; its losses at steps 5-6 equal an
   uninterrupted run's within 1e-3 relative.

10. **Levers and launch cells** (``[launch]`` lines), TF32 off,
   qwen1.5-4b at full width in bf16.  (a) Phase 8's 8 requests served
   again under ``use_perf_opts(OPTIMIZED)``: decode ms a step against
   the bound and tokens/s, the profiled decode step's ``aten::copy_``
   calls, device ops and busy share beside phase 8's default run; the
   profiled step's logits against phase 8's within 5e-2 of the largest
   (the reference test's limit) and the share of greedy tokens served
   alike (printed, not asserted: bf16 rounding differs).  (b) A B = 2,
   S = 4096 prefill with ``triangular_attention`` (36 of 64 block pairs
   a layer) against the dense loop: last logits within 2e-2 of the
   largest, both times.  (c) ``remat_policy="dots"``: reduced
   qwen1.5-4b float32 gradients against full remat on the card within
   1e-5 of each leaf's largest, then 3 full-width training steps at
   B = 2, S = 4096 with step seconds and peak memory beside phase 9's.
   (d) ``launch.steps.build_cell`` of decode_32k at its published
   S = 32768 with B cut from 128 to 1 (params 7.12 GB, cache 13.4 GB):
   8 steps default and 8 under ``OPTIMIZED`` from the same arguments,
   against the bound by bytes.  (e) ``launch.dryrun`` of qwen1.5-4b on
   "meta" over its three shapes on the 16x16 mesh plan, printed per
   cell, and decode_32k on 16x16 again under ``OPTIMIZED`` beside the
   default (``decode_opt``'s products on each device's own cache shard:
   no ``bmm`` run replicated, at most twice the default's collective
   bytes); then (d)'s cell counted on one device, its ``memory_s``
   beside the measured step.  (f) The prefill and decode_32k cells as
   DTensor programs on a 1x1 CUDA mesh against the plain cells, bit for
   bit, default and ``OPTIMIZED``.

11. **Examples and tools** (``[examples]`` lines): each of the port's
   scripts beside the JAX package's (``examples/*_torch.py``,
   ``tools/*_torch.py``) has its ``main`` run in this process at the
   original's own sizes on the card.  (a) ``quickstart_torch``: 592
   crossbar reads of ``tiny_cnn`` on ``isaac-baseline`` through the
   kernel, ``matches reference: True``, its stdout equal to the same
   script's on ``--device cpu``; (b) ``serve_cim_fleet_torch``:
   ResNet-18@16 and a 2-layer ViT co-resident, 12 requests, every output
   bit-exact against a standalone ``CimBatchService`` inside the script
   (``isaac-baseline``'s ADC never clips, so its executor runs each node
   as one exact GEMM and launches no kernel); requests/s; (c)
   ``compile_vit_cim_torch`` and (d) ``explore_design_space_torch`` at
   their defaults (a fresh cache in a temporary directory), their
   seconds; (e) ``serve_lm_torch``: tokens/s and peak memory; (f)
   ``train_lm_torch``: the ~100M "lm-100m" model, 200 steps at B = 8,
   S = 256: steps/s, the first and last logged loss (the last must be
   lower), then a rerun to 220 steps on the same workdir that must
   resume at step 200; (g) ``explain_torch`` of ResNet-18 on
   ``jia-issc21`` as JSON, which must parse; (h)
   ``make_golden_cim_mvm_torch --check``: all six committed goldens
   reproduced through the kernel bit for bit.

12. **The trainer on a mesh** (``[mesh]`` lines), TF32 off.  (a)
   ``Trainer(..., mesh=make_host_mesh())`` on a 1x1 NCCL ``DeviceMesh``:
   qwen1.5-4b at full width in bf16, cut to its first 4 of 40 layers
   (as phase 9's profiled step), B = 2, S = 4096, full remat, 3 steps
   against the one-device ``Trainer`` on the same cut and seed; losses,
   params and moments bit-equal; step seconds of both, the mesh run's
   peak memory and the ops it ran replicated.  (b) Elastic restart: a
   one-device run stopped at step 2 by its checkpoint, relaunched on the
   mesh through ``restore_resharded``, ends bit-equal to the
   uninterrupted 3 steps.  (c) ``python -m torch.distributed.run
   --standalone --nproc-per-node <cards> -m repro_torch.launch.train
   --mesh host --arch qwen1.5-4b --reduced --steps 4`` as a child
   process group: exit 0, one ``final:`` line, one ``metrics.jsonl``.

Launch counts are set to 0 just before each of phases 3, 5, 6, 7,
8 (d), 9, 10 and 12 and each script of phase 11, and read just after;
each of 3-8 must have launched ``cim_mvm_tiles`` and ``cim_mvm``, phases
9, 10 and 12 neither (the LM substrate has no TPU kernel), and in phase 11
(a) and (h) must have launched the kernel.  Prints one ``{"kernels": [...]}`` JSON line (``launches``
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

from repro_torch.analysis.roofline import (  # noqa: E402  (H100 SXM rates)
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS as BF16_FLOPS_PER_S)

DEV = "cuda"
HW = 224                      # ResNet-18's published input width
BATCH = 4
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
LM_ARCH = "qwen1.5-4b"        # the serving example's model, full width
#: a CPU rehearsal sets this to run phase 8 on ``reduced()`` configs
LM_REDUCED = False
LM_CONSISTENCY = (2, 64)      # (B, S) of phase 8 (a)
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_NEW = 4, 256, 8, 32
LM_PROMPT = (32, 128)         # prompt lengths, inclusive
LM_CPU_ARCHS = ("qwen1.5-4b", "gemma2-2b")    # phase 8 (c), reduced
#: phase 9: the reference's train_4k sequence length, its global batch of
#: 256 cut to 2 for one card and the script's time
TRAIN_SHAPE = (2, 4096)
TRAIN_STEPS = 10
TRAIN_LR = 1e-3               # the training CLI's default
TRAIN_CPU_ARCHS = ("qwen1.5-4b", "gemma2-2b", "mixtral-8x7b")  # 9 (a)
#: the layers of the depth-cut copy whose training step phase 9 profiles
#: (reading a full-depth step's trace took minutes)
TRAIN_PROFILE_LAYERS = 4
#: phase 10: (b) triangular prefill at (B, S); (c) "dots" training steps
#: at TRAIN_SHAPE; (d) the decode_32k cell at its published S with B cut
#: from 128 to LAUNCH_DECODE_B, LAUNCH_DECODE_STEPS steps a variant
LAUNCH_PREFILL = (2, 4096)
LAUNCH_DOTS_STEPS = 3
LAUNCH_DECODE_B, LAUNCH_DECODE_STEPS = 1, 8
LAUNCH_DRYRUN_ARCH = "qwen1.5-4b"
DRYRUN_WORKERS = 6            # phase 10 (e): the cells' processes
LAUNCH_SPMD_PREFILL = (2, 4096)   # phase 10 (f): (B, S) of the prefill
EXAMPLES_TRAIN_STEPS = 200    # examples/train_lm_torch.py's default
#: phase 12: the mesh trainer on a depth cut at TRAIN_SHAPE (as phase
#: 9's profiled step: a DTensor step at full depth would take minutes),
#: its steps, and the launcher's steps across the cards present
MESH_TRAIN_LAYERS = 4
MESH_TRAIN_STEPS = 3
MESH_LAUNCH_STEPS = 4


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
        # the wgmma kernel's load paths (x / w: TMA where base and row
        # pitch are multiples of 16 bytes, else 4-byte cp.async), ring
        # modes and live-pair counts
        (2, 70, 256, 40, jia),                       # x TMA, w cp.async
        (1, 100, 384, 96, P(8, 8, 2, 2, 128, 5)),    # both TMA, P = S = 4
        (2, 40, 250, 48, P(8, 8, 4, 4, 100, 9)),     # cp / TMA, short group
        (1, 64, 224, 64, P(8, 8, 1, 2, 96, 6)),      # TMA, pr % 32 != 0
        (1, 70, 300, 50, P(6, 8, 1, 1, 256, 7)),     # 6 phases: 3 live
        (1, 64, 2048, 64, P(8, 8, 1, 1, 2048, 8)),   # streamed, TMA
        (1, 40, 2050, 40, P(8, 8, 1, 1, 2048, 9)),   # streamed, cp.async
        (6, 2816, 3456, 64, jia),                    # 3 groups a block
        (4, 4224, 2300, 64, jia),                    # 2, cp.async, short
    ]


#: (T, M, R, C, byte offset of x, of w): uint8 operands at base addresses
#: off the 16-byte grid, which the rule sends to cp.async
OFFSET_CASES = [(1, 130, 512, 128, 1, 2), (2, 33, 256, 64, 4, 0),
                (1, 64, 128, 64, 0, 8)]


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


def _pid(p) -> str:
    return "P" + "/".join(str(v) for v in (p.act_bits, p.weight_bits,
                                          p.dac_bits, p.cell_bits,
                                          p.parallel_row, p.adc_bits))


def _plan_key(plan) -> str:
    """x / w load paths and ring mode of a wgmma launch plan."""
    if plan.route != "wgmma":
        return plan.route
    return (f"{plan.x_path}/{plan.w_path} "
            f"{'resident' if plan.resident else 'streamed'}")


def _plan_text(plan) -> str:
    if plan.route != "wgmma":
        return f"{plan.route}, grid {plan.grid}"
    return (f"{_plan_key(plan)} ({plan.stages} stages), "
            f"{plan.phases_per_block} of {plan.n_p} phases and "
            f"{plan.groups_per_block} of {plan.n_groups} groups a block, "
            f"grid {plan.grid}")


def _shifted(a, offset: int):
    """A contiguous copy of ``a`` whose data starts ``offset`` bytes past a
    256-byte-aligned allocation."""
    import torch
    buf = torch.empty(a.numel() + 256, dtype=a.dtype, device=a.device)
    out = buf[offset:offset + a.numel()].view(a.shape)
    out.copy_(a)
    assert out.is_contiguous() and out.data_ptr() % 16 == offset % 16
    return out


def forward_row(shapes, params) -> dict:
    """Kernel, plain and plane-GEMM milliseconds of one forward's
    ``cim_mvm_tiles`` launches at ``shapes``, with their bound."""
    ms, plain_ms, bms, bound_by = time_forward(shapes, params)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": bound_by,
            "plane_gemm_ms": timed_ms(plane_gemm(shapes, params, DEV)),
            "shapes": len(shapes)}


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
    ``torch._int_mm`` of (P*M, R) 0/1 planes by (R, S*C) 0/1 planes, each
    size padded to a multiple of 32.  The same multiply-adds as the
    kernel's plane work, without the per-group clamp: no PyTorch call
    computes the saturating MVM, and the port never calls this one."""
    import torch
    n_p = math.ceil(params.act_bits / params.dac_bits)
    n_s = math.ceil(params.weight_bits / params.cell_bits)

    def up32(v):
        return -(-v // 32) * 32

    ops = []
    for t, m, r, c in shapes:
        # cuBLASLt refuses some int8 products whose sizes are multiples of
        # 8 only (puma's 196 x 26 x 32 slices among them): pad to 32
        a = torch.randint(0, 2, (up32(n_p * m), up32(r)), dtype=torch.int8,
                          device=dev)
        b = torch.randint(0, 2, (up32(r), up32(n_s * c)), dtype=torch.int8,
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
    sweep = _sweep()
    cases = sweep + [(t, m, r, c, params) for t, m, r, c in tiles_shapes]
    splits, paths, most_groups = {}, {}, 0
    for n, (t, m, r, c, p) in enumerate(cases):
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
        paths[_plan_key(plan)] = paths.get(_plan_key(plan), 0) + 1
        most_groups = max(most_groups, plan.groups_per_block)
        if n < len(sweep):
            print(f"[kernels] case {(t, m, r, c)} {_pid(p)}: "
                  f"{_plan_text(plan)}")
        tally["cim_mvm"].check(cim_mvm(x[0], w[0], p, mode="compiled"),
                               cim_mvm(x[0], w[0], p, mode="torch"),
                               f"mvm {(m, r, c)} {p}")
        xs, ws = x[0] - (1 << (p.act_bits - 1)), w[0] - (1 << (p.weight_bits
                                                              - 1))
        tally["cim_mvm"].check(cim_mvm_signed(xs, ws, p, mode="compiled"),
                               cim_mvm_signed(xs, ws, p, mode="torch"),
                               f"signed {(m, r, c)} {p}")
    jia = CimMvmParams(8, 8, 1, 1, 1152, 8)
    for t, m, r, c, xo, wo in OFFSET_CASES:
        x, w = (a.to(torch.uint8) for a in _operands(rng, t, m, r, c, jia,
                                                     DEV))
        x, w = _shifted(x, xo), _shifted(w, wo)
        plan = kernel.plan_launch(jia, t, m, r, c, x.data_ptr() % 16 == 0,
                                  w.data_ptr() % 16 == 0)
        got = kernel.cim_mvm_tiles_cuda(x, w, jia)
        tally["cim_mvm_tiles"].check(
            got, ref.cim_mvm_ref_tiles(x, w, **_plain_kwargs(jia)),
            f"offset tiles {(t, m, r, c, xo, wo)}")
        tally["cim_mvm_tiles"].check(kernel.cim_mvm_tiles_cuda(x, w, jia),
                                     got, f"offset rerun {(t, m, r, c)}")
        paths[_plan_key(plan)] = paths.get(_plan_key(plan), 0) + 1
        print(f"[kernels] case {(t, m, r, c)} x at +{xo}, w at +{wo} bytes: "
              f"{_plan_text(plan)}")
    for m, r, c in mvm_shapes:
        x, w = _operands(rng, 1, m, r, c, params, DEV)
        tally["cim_mvm"].check(cim_mvm(x[0], w[0], params, mode="compiled"),
                               cim_mvm(x[0], w[0], params, mode="torch"),
                               f"calibration mvm {(m, r, c)}")
    torch.cuda.synchronize()
    print(f"[kernels] sweep: {len(cases) + len(OFFSET_CASES)} tile cases "
          f"(each run twice, identical), {len(mvm_shapes)} calibration "
          "shapes, all bit-exact")
    print("[kernels] wgmma launches by x / w load path and ring mode: "
          + ", ".join(f"{k} {v}" for k, v in sorted(paths.items())))
    for xp in ("tma", "cp.async"):
        for wp in ("tma", "cp.async"):
            assert any(k.startswith(f"{xp}/{wp} ") for k in paths), \
                (xp, wp, paths)
    assert any(k.endswith("streamed") for k in paths), paths
    assert most_groups > 1, "no plan put several row groups in one block"
    xm = torch.zeros((1, 196, 4608), dtype=torch.uint8, device=DEV)
    encode_us = kernel.tensor_map_encode_us(xm)
    print(f"[kernels] host cost of one tensor map: {encode_us:.3f} us "
          "(cuTensorMapEncodeTiled; a launch on the TMA path encodes one "
          "or two)")
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
            "tensor_map_encode_us": encode_us,
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
    aten = [e for e in stats if e.device_type == DeviceType.CPU
            and e.key.startswith("aten::")]
    ops = sorted((e for e in aten if _device_us(e, True)),
                 key=lambda e: _device_us(e, True), reverse=True)
    host = sorted(aten, key=lambda e: e.self_cpu_time_total, reverse=True)
    assert dev, "the profiler recorded no device activity"
    busy_s = sum(_device_us(e) for e in dev) / 1e6
    out = {"wall_s": wall, "unprofiled_wall_s": bare,
           "device_ops": sum(e.count for e in dev),
           "copy_calls": sum(e.count for e in stats
                             if e.key == "aten::copy_"),
           "device_busy_s": busy_s, "busy_share": busy_s / wall,
           "unprofiled_busy_share": busy_s / bare,
           "kernels": [(e.key[:70], e.count, _device_us(e) / 1e3)
                       for e in dev[:8]],
           "operators": [(e.key, e.count, _device_us(e, True) / 1e3)
                         for e in ops[:8]],
           "host_operators": [(e.key, e.count, e.self_cpu_time_total / 1e3)
                              for e in host[:8]]}
    print(f"[profile] {label}: wall {wall:.4f} s "
          f"profiled, {bare:.4f} s unprofiled; device busy "
          f"{busy_s * 1e3:.3f} ms ({100 * out['busy_share']:.1f} % of the "
          f"profiled wall, {100 * out['unprofiled_busy_share']:.1f} % of the "
          f"unprofiled); {out['device_ops']} device kernels and copies; "
          f"{out['copy_calls']} aten::copy_ calls")
    print("[profile] top device kernels (launches, ms): " + "; ".join(
        f"{k} ({n}, {ms:.3f})" for k, n, ms in out["kernels"]))
    print("[profile] top operators by device time incl. children "
          "(calls, ms): " + "; ".join(
              f"{k} ({n}, {ms:.3f})" for k, n, ms in out["operators"]))
    print("[profile] top operators by own host time, profiled (calls, ms): "
          + "; ".join(f"{k} ({n}, {ms:.3f})"
                      for k, n, ms in out["host_operators"]))
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
    fwd = forward_row(exes[("compiled", "faulted")].dispatch_shapes(BATCH),
                      params)
    print(f"[faults] cim_mvm_tiles on {arch.name}, {stats.dispatches} "
          f"launches a forward: {fwd['ms']:.3f} ms kernel, "
          f"{fwd['plain_ms']:.3f} ms plain, {fwd['plane_gemm_ms']:.3f} ms "
          f"int8 plane GEMM, {fwd['bound_ms']:.4f} ms bound "
          f"({fwd['bound_by']})")
    print(f"[faults] host seconds: materialising fault fields "
          f"{materialise_s:.3f}, fault-aware compile {compile_s:.3f}, "
          f"faulted dispatch {min(times['faulted']):.4f} (clean "
          f"{min(times['clean']):.4f}); launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    assert launches["cim_mvm_tiles"] >= 2 * stats.dispatches, launches
    assert launches["cim_mvm"] > 0, launches
    return launches, fwd


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


def _lm_base():
    from repro_torch.configs import get_config, reduced
    cfg = get_config(LM_ARCH)
    return reduced(cfg) if LM_REDUCED else cfg


def _tree_bytes(tree) -> int:
    from repro_torch.models.layers import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def lm_prefill_bound_ms(cfg, param_bytes: int, b: int, s: int):
    """Least time of a (b, s) prefill: the larger of the parameter bytes
    over the memory rate and the matmul operations (projections and
    MLP of every token, causal attention, the last position's logits)
    over the bf16 rate; and which of the two bounds it."""
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_token = (d * (h + 2 * k) * hd + h * hd * d
                 + 3 * d * cfg.d_ff) * cfg.n_layers
    attn = 2 * h * hd * s * (s + 1) // 2 * cfg.n_layers    # QK^T and AV
    ops = 2 * (per_token * b * s + attn * b + d * cfg.vocab * b)
    t_bytes = param_bytes / HBM_BYTES_PER_S
    t_ops = ops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def lm_decode_bound_ms(cfg, param_bytes: int, b: int, length: float,
                       elem_bytes: int) -> float:
    """Least time of one decode step, by bytes: every parameter read
    once plus the valid K/V entries of ``b`` sequences of ``length``."""
    kv = 2 * b * length * cfg.n_kv_heads * cfg.head_dim * cfg.n_layers \
        * elem_bytes
    return (param_bytes + kv) / HBM_BYTES_PER_S * 1e3


class _WatchLm:
    """Times each ``lm.prefill`` / ``lm.decode_step`` call the server
    makes (to the device's completion) and keeps a device-side flag of
    whether every logit was finite; restores both functions on exit."""

    def __init__(self):
        self.calls = []                 # (kind, seconds, length)
        self.finite = []                # 0-d bool tensors on the card

    def __enter__(self):
        import torch
        from repro_torch.models import lm
        self.saved = lm.prefill, lm.decode_step

        def watch(kind, fn):
            def run(*args, **kw):
                t0 = time.perf_counter()
                logits, cache = fn(*args, **kw)
                torch.cuda.synchronize()
                length = args[2]["tokens"].shape[1] if kind == "prefill" \
                    else int(args[4]) + 1
                self.calls.append((kind, time.perf_counter() - t0, length))
                self.finite.append(torch.isfinite(logits).all())
                return logits, cache
            return run
        lm.prefill = watch("prefill", self.saved[0])
        lm.decode_step = watch("decode", self.saved[1])
        return self

    def __exit__(self, *exc):
        from repro_torch.models import lm
        lm.prefill, lm.decode_step = self.saved

    def seconds(self, kind: str):
        return [t for k, t, _ in self.calls if k == kind]

    def lengths(self, kind: str):
        return [n for k, _, n in self.calls if k == kind]


def _rel(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-9))


def _lm_consistency():
    """Phase 8 (a): forward, prefill and one decode step of the full-width
    model in float32 on the card, with the reference test's limits."""
    import dataclasses
    import torch
    from repro_torch.models import lm
    cfg = dataclasses.replace(_lm_base(), dtype=torch.float32)
    b, s = LM_CONSISTENCY
    gen = torch.Generator(device=DEV).manual_seed(0)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen, device=DEV)
    with torch.no_grad():
        t0 = time.perf_counter()
        x = lm.forward(params, cfg, {"tokens": toks})
        ref = lm.logits_fn(params, cfg, x[:, s - 1:s + 1])
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        lp, cache = lm.prefill(params, cfg, {"tokens": toks[:, :s]})
        ld, _ = lm.decode_step(params, cfg, cache,
                               {"tokens": toks[:, s:s + 1]}, s)
    e_p, e_d = _rel(lp[:, 0], ref[:, 0]), _rel(ld[:, 0], ref[:, 1])
    same = bool((ld[:, 0].argmax(-1) == ref[:, 1].argmax(-1)).all())
    print(f"[lm] (a) {cfg.name} float32, {cfg.param_count() / 1e9:.3f} B "
          f"parameters, {_tree_bytes(params) / 1e9:.2f} GB drawn on the card "
          f"in {init_s:.3f} s; B={b} S={s}: forward {fwd_s:.3f} s; prefill "
          f"vs forward rel {e_p:.2e} (limit 2e-2), decode vs forward rel "
          f"{e_d:.2e} (limit 5e-2), greedy tokens equal: {same}")
    assert e_p < 2e-2 and e_d < 5e-2 and same, (e_p, e_d, same)
    assert torch.isfinite(ref).all()


def _lm_serving(opts=None, tag: str = "[lm] (b)"):
    """Phase 8 (b), and 10 (a) under ``opts``: ``BatchServer`` in bf16 at
    full width; returns the numbers for the summary, the served tokens
    and the profiled decode step's logits (on the CPU)."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    from repro_torch.models.perfopts import PerfOpts, use_perf_opts
    from repro_torch.serving import BatchServer, Request
    opts = opts or PerfOpts()
    cfg = _lm_base()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(1),
                            device=DEV)
    server = BatchServer(cfg, params, batch_slots=LM_SLOTS,
                         max_len=LM_MAX_LEN, device=DEV)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pbytes = _tree_bytes(params)
    rng = np.random.default_rng(0)
    reqs = [Request(i, prompt=rng.integers(
                0, cfg.vocab, int(rng.integers(LM_PROMPT[0],
                                               LM_PROMPT[1] + 1))
            ).astype(np.int32), max_new_tokens=LM_NEW)
            for i in range(LM_REQUESTS)]
    with _WatchLm() as watch, use_perf_opts(opts):
        t0 = time.perf_counter()
        server.serve(reqs)
        serve_s = time.perf_counter() - t0
    assert bool(torch.stack(watch.finite).all()), "a logit was not finite"
    for r in reqs:
        assert r.output is not None and len(r.output) == LM_NEW, \
            (r.rid, r.output)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pre, dec = watch.seconds("prefill"), watch.seconds("decode")
    plens = watch.lengths("prefill")
    mean_len = float(np.mean(watch.lengths("decode")))
    bounds = [lm_prefill_bound_ms(cfg, pbytes, LM_SLOTS, n) for n in plens]
    dbound = lm_decode_bound_ms(cfg, pbytes, LM_SLOTS, mean_len,
                                params["embed"].element_size())
    tokens = sum(len(r.output) for r in reqs)
    dec_ms = 1e3 * float(np.mean(dec))
    print(f"{tag} {cfg.name} bf16, {pbytes / 1e9:.2f} GB of parameters; "
          f"BatchServer({LM_SLOTS} slots, max_len {LM_MAX_LEN}) set-up "
          f"{setup_s:.3f} s; {len(reqs)} requests, prompts "
          f"{min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)} tokens, {LM_NEW} new each, "
          f"all served, every logit finite")
    print(f"{tag} prefill s per batch: " + ", ".join(
        f"{t:.4f} (S={n}, bound {bms:.3f} ms by {by})"
        for t, n, (bms, by) in zip(pre, plens, bounds)))
    print(f"{tag} decode: {len(dec)} steps, {dec_ms:.3f} ms per step "
          f"(median {1e3 * float(np.median(dec)):.3f}, min "
          f"{1e3 * min(dec):.3f}, max {1e3 * max(dec):.3f}) against a "
          f"{dbound:.3f} ms bound by bytes at mean length {mean_len:.1f}; "
          f"{tokens} tokens in {serve_s:.3f} s = {tokens / serve_s:.1f} "
          f"tokens/s; peak {peak:.2f} GiB")
    # one decode step under the profiler, batch LM_SLOTS at the longest
    # prompt length
    n = LM_PROMPT[1]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (LM_SLOTS, n + 1))
                            ).to(DEV)
    last = {}

    def step():        # rewrites slot n with the same entries each time
        last["logits"] = lm.decode_step(params, cfg, cache,
                                        {"tokens": toks[:, n:]}, n)[0]
    with torch.no_grad(), use_perf_opts(opts):
        _, cache = lm.prefill(params, cfg, {"tokens": toks[:, :n]},
                              cache_len=LM_MAX_LEN)
        prof = profile_call(step, f"one batch-{LM_SLOTS} decode step at "
                            f"length {n + 1}")
    pbound = lm_decode_bound_ms(cfg, pbytes, LM_SLOTS, n + 1,
                                params["embed"].element_size())
    print(f"{tag} profiled decode step: {prof['device_ops']} device "
          f"kernels and copies ({prof['copy_calls']} aten::copy_), device "
          f"busy {100 * prof['unprofiled_busy_share']:.1f} % of an "
          f"unprofiled step; bound {pbound:.3f} ms by bytes")
    return {"setup_s": setup_s, "prefill_s": pre, "decode_ms": dec_ms,
            "tokens_per_s": tokens / serve_s, "peak_gib": peak,
            "decode_bound_ms": dbound, "copies": prof["copy_calls"],
            "device_ops": prof["device_ops"],
            "busy_share": prof["unprofiled_busy_share"],
            "outputs": [list(r.output) for r in reqs],
            "last_logits": last["logits"].float().cpu()}


def _lm_card_vs_cpu():
    """Phase 8 (c): reduced configs in float32, the same parameters on
    the card and on the CPU."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm
    from repro_torch.models.layers import tree_map
    from repro_torch.serving import BatchServer, Request
    for name in LM_CPU_ARCHS:
        cfg = dataclasses.replace(reduced(get_config(name)),
                                  dtype=torch.float32)
        cpu = lm.init_params(cfg, torch.Generator().manual_seed(2),
                             device="cpu")
        gpu = tree_map(lambda t: t.to(DEV), cpu)
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab, (2, 26)))
        out = {}
        with torch.no_grad():
            for dev, p in (("cpu", cpu), (DEV, gpu)):
                t = toks.to(dev)
                got = [lm.logits_fn(p, cfg, lm.forward(p, cfg,
                                                       {"tokens": t}))]
                lp, cache = lm.prefill(p, cfg, {"tokens": t[:, :24]},
                                       cache_len=28)
                got.append(lp)
                for pos in (24, 25):
                    ld, cache = lm.decode_step(p, cfg, cache,
                                               {"tokens": t[:, pos:pos + 1]},
                                               pos)
                    got.append(ld)
                reqs = [Request(i, prompt=toks[i % 2, :8 + 3 * i].numpy()
                                .astype(np.int32), max_new_tokens=6)
                        for i in range(4)]
                BatchServer(cfg, p, batch_slots=4, max_len=32,
                            device=dev).serve(reqs)
                out[dev] = (got, [r.output for r in reqs])
        errs = [_rel(g.cpu(), c) for g, c in zip(out[DEV][0], out["cpu"][0])]
        same = all(bool((g.cpu().argmax(-1) == c.argmax(-1)).all())
                   for g, c in zip(out[DEV][0], out["cpu"][0]))
        print(f"[lm] (c) {cfg.name} float32: forward, prefill and 2 decode "
              f"steps card vs CPU max rel {max(errs):.2e} (limit 1e-4); "
              f"greedy tokens equal: {same}; BatchServer tokens equal: "
              f"{out[DEV][1] == out['cpu'][1]}")
        assert max(errs) < 1e-4 and same, (errs, same)
        assert out[DEV][1] == out["cpu"][1], out


def _lm_block():
    """Phase 8 (d): ``lmblock:qwen1.5-4b`` on jia-issc21 through the
    kernel, held against the plain route; returns (launch counts, the
    forward's kernel times)."""
    import numpy as np
    from repro_torch.cimsim.executor import lower
    from repro_torch.cimsim.functional import (calibrate_shifts,
                                               compile_and_verify,
                                               make_input, make_weights)
    from repro_torch.core import compiler
    from repro_torch.core.abstraction import get_arch
    from repro_torch.kernels.cim_mvm import cim_mvm_params, kernel
    from repro_torch.workloads import get_workload
    jia = get_arch("jia-issc21")
    params = cim_mvm_params(jia)
    graph = get_workload(f"lmblock:{LM_ARCH}")
    weights = make_weights(graph, 0)
    inputs = [make_input(graph, i) for i in range(VERIFY_BATCH)]
    batched = {k: np.stack([x[k] for x in inputs]) for k in graph.inputs}
    reps, verify_s, exes, outs, run_s = {}, {}, {}, {}, {}
    kernel.reset_launch_counts()
    for route in ("compiled", "torch"):
        t0 = time.perf_counter()
        reps[route] = compile_and_verify(graph, jia, batch=VERIFY_BATCH,
                                         device=DEV, mode=route)
        verify_s[route] = time.perf_counter() - t0
        if route == "compiled":
            shifts = calibrate_shifts(graph, weights, inputs[0], params,
                                      device=DEV)
            res = compiler.compile_graph(graph, jia)
        exe = exes[route] = lower(res.plan, res.program, params=params,
                                  mode=route, device=DEV, cache=False)
        assert exe.stats.kernel_mode == route, exe.stats
        packed = exe.pack(weights)
        t0 = time.perf_counter()
        outs[route] = exe.run_batch(batched, packed=packed, shifts=shifts)
        run_s[route] = time.perf_counter() - t0
        if route == "compiled":
            launches = dict(kernel.LAUNCHES)
    rep, stats = reps["compiled"], exes["compiled"].stats
    # the reference's own verify error: it groups each weight matrix's
    # rows by parallel_row (1152) over the whole matrix, the compiled
    # flow by the 852-854-row chunks of d = 2560, and an 8-bit ADC
    # saturates differently on the two (0 at d = 2304 or with an exact
    # ADC; tests/test_torch_dse.py holds both packages equal on a
    # 2560-wide cut).  The kernel must report what the plain route does.
    assert rep.error is None and reps["torch"].error is None, reps
    assert rep.max_abs_err == reps["torch"].max_abs_err, reps
    for t in graph.outputs:
        np.testing.assert_array_equal(outs["compiled"][t], outs["torch"][t],
                                      err_msg=t)
    n_cal = check_calibration(graph, weights, inputs[0], params, shifts)
    fwd = forward_row(exes["compiled"].dispatch_shapes(VERIFY_BATCH), params)
    print(f"[lm] (d) {graph.name} (seq {graph.shapes['x'][0]}) on "
          f"{jia.name}: {stats}; compile_and_verify on the kernel "
          f"{verify_s['compiled']:.3f} s (compile {rep.compile_s:.3f}, "
          f"lower {rep.lower_s:.3f}, run {rep.run_s:.3f}), on the plain "
          f"route {verify_s['torch']:.3f} s; max_abs_err against the "
          f"reference forward {rep.max_abs_err} on the kernel, "
          f"{reps['torch'].max_abs_err} plain")
    print(f"[lm] (d) batch-{VERIFY_BATCH} dispatch {run_s['compiled']:.4f} s "
          f"on the kernel, {run_s['torch']:.4f} s plain, outputs bit-equal; "
          f"calibration {n_cal} tensors bit-equal kernel vs plain; "
          f"cim_mvm_tiles {fwd['ms']:.3f} ms kernel, {fwd['plain_ms']:.3f} "
          f"ms plain, {fwd['plane_gemm_ms']:.3f} ms int8 plane GEMM, "
          f"{fwd['bound_ms']:.4f} ms bound ({fwd['bound_by']}) over "
          f"{stats.dispatches} launches; launches {launches}")
    assert launches["cim_mvm_tiles"] >= 2 * stats.dispatches, launches
    assert launches["cim_mvm"] > 0, launches
    return launches, dict(fwd, verify_max_abs_err=rep.max_abs_err)


def phase_lm():
    """Phase 8; returns (launch counts of (d), the lm block forward's
    kernel times, the serving numbers of (b))."""
    import torch
    t_phase = time.perf_counter()
    # float32 checks mean float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[lm] card: {gpu_line()}")
    _lm_consistency()
    torch.cuda.empty_cache()
    serving = _lm_serving()
    torch.cuda.empty_cache()
    _lm_card_vs_cpu()
    launches, block = _lm_block()
    print(f"[lm] phase {time.perf_counter() - t_phase:.1f} s")
    return launches, block, serving


def lm_train_bound_ms(cfg, b: int, s: int):
    """Least time of one training step at (b, s) with the unit remat'd:
    the matmul operations of forward, backward and the recompute (8 per
    weight and token: 2 forward, 2 recomputed, 4 backward; the tied
    embedding's logits included, as ``lm_loss`` recomputes them too, and
    causal attention's QK^T and AV) over the bf16 rate, plus the
    optimizer's bytes over the memory rate (bf16 params read and
    written, bf16 grads read, float32 mu and nu read and written: 22
    bytes a parameter).  Returns (total, matmul part, optimizer part)
    in ms."""
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_token = (d * (h + 2 * k) * hd + h * hd * d
                 + 3 * d * cfg.d_ff) * cfg.n_layers + d * cfg.vocab
    attn = 2 * h * hd * s * (s + 1) // 2 * cfg.n_layers    # MACs, causal
    t_ops = 8 * (per_token * b * s + attn * b) / BF16_FLOPS_PER_S
    t_opt = 22 * cfg.param_count() / HBM_BYTES_PER_S
    return (t_ops + t_opt) * 1e3, t_ops * 1e3, t_opt * 1e3


def _train_card_vs_cpu():
    """Phase 9 (a): reduced configs in float32 from the same parameters
    on the card and on the CPU: loss, every gradient leaf, and params
    and moments after one clipped AdamW update fed the same gradients;
    then two microbatches against one on the card."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import TokenStream
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import adamw
    worst = 0.0
    for name in TRAIN_CPU_ARCHS:
        cfg = dataclasses.replace(reduced(get_config(name)),
                                  dtype=torch.float32)
        cpu = lm.init_params(cfg, torch.Generator().manual_seed(4),
                             device="cpu")
        gpu = tree_map(lambda t: t.to(DEV), cpu)
        batch = TokenStream(cfg.vocab, 2, 32, seed=5).next_batch()
        lc, gc = steps.loss_and_grads(cpu, cfg, steps.to_device(batch, "cpu"))
        lg, gg = steps.loss_and_grads(gpu, cfg, steps.to_device(batch, DEV))
        e_loss = abs(float(lg) - float(lc)) / abs(float(lc))
        e_grad = max(_rel(a.cpu(), b) for a, b in zip(tree_leaves(gg),
                                                      tree_leaves(gc)))
        e_mb = 0.0
        if not cfg.n_experts:
            # an MoE layer's expert capacity scales with the tokens of a
            # call, so microbatches drop other tokens (the reference's too)
            l2, g2 = steps.loss_and_grads(gpu, cfg,
                                          steps.to_device(batch, DEV), 2)
            e_mb = max([abs(float(l2) - float(lg)) / abs(float(lg))]
                       + [_rel(a, b) for a, b in zip(tree_leaves(g2),
                                                     tree_leaves(gg))])
            del g2
        same = tree_map(lambda t: t.to(DEV), gc)          # the CPU's grads
        del gg
        oc, nc = steps.apply_update(cpu, adamw.adamw_init(cpu), gc,
                                    TRAIN_LR)
        og, ng = steps.apply_update(gpu, adamw.adamw_init(gpu), same,
                                    TRAIN_LR)
        e_upd = max(_rel(a.cpu(), b) for a, b in zip(
            tree_leaves((gpu, og)), tree_leaves((cpu, oc))))
        n = len(tree_leaves(cpu))
        print(f"[train] (a) {cfg.name} float32, B=2 S=32: loss "
              f"{float(lc):.6f} on the CPU, card vs CPU rel {e_loss:.2e}; "
              f"{n} gradient leaves max rel {e_grad:.2e}; grad norm "
              f"{float(ng):.6f} vs {float(nc):.6f}; params and moments "
              f"after one clipped AdamW update max rel {e_upd:.2e}; "
              + (f"mb=2 vs mb=1 on the card max rel {e_mb:.2e}"
                 if not cfg.n_experts else "no mb=2 check (MoE capacity)")
              + " (limit 1e-5 of each leaf's largest magnitude)")
        errs = (e_loss, e_grad, e_upd, e_mb)
        assert max(errs) <= 1e-5, (name, errs)
        worst = max(worst, *errs)
    return worst


class _WatchUpdate:
    """CUDA-event milliseconds of each ``steps.apply_update`` call (clip
    and AdamW) the trainer makes; restores the function on exit."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        import torch
        from repro_torch.launch import steps
        self.saved = steps.apply_update

        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.saved(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out
        steps.apply_update = run
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import steps
        steps.apply_update = self.saved

    def ms(self):
        import torch
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def _records(workdir) -> list:
    path = pathlib.Path(workdir) / "metrics.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def _train_cli(workdir, *args):
    """The trainer and stream ``launch/train.py`` builds, logging every
    step."""
    from repro_torch.launch import train as train_cli
    trainer, stream = train_cli.build(train_cli.parse_args(
        ["--arch", LM_ARCH, "--device", DEV, "--workdir", str(workdir)]
        + list(args)))
    trainer.tcfg.log_every = 1
    return trainer, stream


def _train_full():
    """Phase 9 (b): qwen1.5-4b at full width in bf16, trained through
    the CLI's ``Trainer``; returns the numbers for the summary."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.launch import steps
    from repro_torch.models.layers import tree_leaves
    b, s = TRAIN_SHAPE
    with tempfile.TemporaryDirectory() as wd:
        torch.cuda.reset_peak_memory_stats()
        trainer, stream = _train_cli(
            wd, "--batch", str(b), "--seq-len", str(s), "--steps",
            str(TRAIN_STEPS), "--save-every", str(TRAIN_STEPS + 1),
            "--lr", str(TRAIN_LR), *(["--reduced"] if LM_REDUCED else []))
        cfg = trainer.cfg
        setup = []
        restore = trainer.restore_or_init

        def timed_restore(seed):
            t0 = time.perf_counter()
            out = restore(seed)
            torch.cuda.synchronize()
            setup.append(time.perf_counter() - t0)
            return out
        trainer.restore_or_init = timed_restore
        with _WatchUpdate() as watch:
            res = trainer.train(seed=0)
        del trainer.restore_or_init            # no cycle keeps the state
        opt_ms = watch.ms()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        recs = [r for r in _records(wd) if "ema" in r]
    losses = [r["loss"] for r in recs]
    step_s = [r["step_s"] for r in recs]
    med = float(np.median(step_s[1:]))
    pbytes = sum(t.numel() * t.element_size()
                 for t in tree_leaves(trainer.params))
    obytes = sum(t.numel() * t.element_size()
                 for t in tree_leaves(trainer.opt_state))
    bound, b_ops, b_opt = lm_train_bound_ms(cfg, b, s)
    print(f"[train] (b) {cfg.name} bf16, {cfg.param_count() / 1e9:.3f} B "
          f"parameters ({pbytes / 1e9:.2f} GB) + AdamW state "
          f"({obytes / 1e9:.2f} GB); B={b} S={s}, mb=1, remat, lr "
          f"{TRAIN_LR}; set-up (params drawn on the card, moments) "
          f"{setup[0]:.3f} s; {res['steps']} steps in {res['wall_s']:.3f} s")
    for r in recs:
        print(f"[train] (b) step {r['step']}: loss {r['loss']:.6f}, grad "
              f"norm {r['grad_norm']:.6f}, {r['step_s']:.4f} s")
    print(f"[train] (b) median step (steps 2-{len(recs)}) {med:.4f} s, "
          f"{b * s / med:.1f} tokens/s; bound {bound:.3f} ms ({b_ops:.3f} "
          f"matmul + {b_opt:.3f} optimizer) = {100 * bound / 1e3 / med:.2f} "
          f"% of the step; optimizer (clip + AdamW) {np.median(opt_ms):.3f} "
          f"ms median on the card (min {min(opt_ms):.3f}, max "
          f"{max(opt_ms):.3f}) against {b_opt:.3f} ms by bytes; peak "
          f"{peak:.2f} GiB")
    assert all(math.isfinite(x) for x in losses), losses
    assert np.mean(losses[-3:]) < losses[0], losses
    assert res["nan_steps"] == 0 and res["steps"] == TRAIN_STEPS, res

    batch = steps.to_device(stream.next_batch(), DEV)
    del trainer
    torch.cuda.empty_cache()
    prof = _profile_cut_step(cfg, batch)
    return {"setup_s": setup[0], "losses": losses, "step_s": step_s,
            "median_step_s": med, "tokens_per_s": b * s / med,
            "bound_ms": bound, "optimizer_ms": opt_ms, "peak_gib": peak,
            "profile": {k: prof[k] for k in ("device_ops", "device_busy_s",
                                             "unprofiled_busy_share")}}


def _profile_cut_step(cfg, batch, tag: str = "[train] (b)"):
    """One training step of a depth-cut copy of ``cfg`` (its first
    TRAIN_PROFILE_LAYERS layers, fresh weights from a seed) under the
    profiler, at the same batch."""
    import dataclasses
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    cut = dataclasses.replace(cfg, n_layers=TRAIN_PROFILE_LAYERS)
    params = lm.init_params(cut, torch.Generator(device=DEV).manual_seed(0),
                            device=DEV)
    opt = adamw.adamw_init(params)
    b, s = batch["tokens"].shape
    t0 = time.perf_counter()
    prof = profile_call(
        lambda: steps.train_step(params, opt, batch, cut, lr=TRAIN_LR,
                                 microbatches=1),
        f"one B={b} S={s} training step, {TRAIN_PROFILE_LAYERS} of "
        f"{cfg.n_layers} layers")
    prof_s = time.perf_counter() - t0
    print(f"{tag} profiled step of a depth-cut copy "
          f"({TRAIN_PROFILE_LAYERS} of {cfg.n_layers} layers; cut so that "
          f"reading the trace takes seconds): {prof['device_ops']} device "
          f"kernels and copies, device busy {prof['device_busy_s']:.3f} s = "
          f"{100 * prof['unprofiled_busy_share']:.1f} % of an unprofiled "
          f"step ({prof['unprofiled_wall_s']:.4f} s); the profile took "
          f"{prof_s:.1f} s, of which reading the trace "
          f"{prof_s - prof['wall_s'] - prof['unprofiled_wall_s']:.1f} s")
    return prof


def _train_resume():
    """Phase 9 (c): reduced qwen1.5-4b in bf16, 4 steps then a new
    trainer on the same workdir to 6, against 6 uninterrupted steps."""
    import tempfile
    import torch
    args = ("--reduced", "--batch", "4", "--seq-len", "64", "--save-every",
            "2")
    with tempfile.TemporaryDirectory() as wd:
        whole, _ = _train_cli(pathlib.Path(wd) / "a", *args, "--steps", "6")
        whole.train()
        first, _ = _train_cli(pathlib.Path(wd) / "b", *args, "--steps", "4")
        first.train()
        again, stream = _train_cli(pathlib.Path(wd) / "b", *args,
                                   "--steps", "6")
        again.train()
        want = {r["step"]: r["loss"] for r in _records(pathlib.Path(wd) / "a")
                if "ema" in r}
        got = [r for r in _records(pathlib.Path(wd) / "b") if "ema" in r]
    resumed = {r["step"]: r["loss"] for r in got[4:]}
    errs = {k: abs(v - want[k]) / abs(want[k]) for k, v in resumed.items()}
    on_card = again.params["embed"].device.type
    print(f"[train] (c) {whole.cfg.name} bf16, B=4 S=64, checkpoints every 2 "
          f"steps: 4 steps, then a new trainer resumed from step 4 on "
          f"{on_card} with the stream at step {stream.state.step}; losses "
          f"at steps 5-6 " + ", ".join(f"{resumed[k]:.6f}" for k in
                                        sorted(resumed))
          + " vs uninterrupted " + ", ".join(f"{want[k]:.6f}" for k in
                                              sorted(resumed))
          + f", max rel {max(errs.values()):.2e} (limit 1e-3)")
    assert sorted(resumed) == [5, 6] and [r["step"] for r in got[:4]] == \
        [1, 2, 3, 4], got
    assert stream.state.step == 6 and on_card == torch.device(DEV).type
    assert max(errs.values()) <= 1e-3, errs
    return max(errs.values())


def phase_train():
    """Phase 9; returns the kernel launch counts of the training path
    (none: the reference trains through plain XLA ops) and (b)'s
    numbers."""
    import torch
    from repro_torch.kernels.cim_mvm import kernel
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[train] card: {gpu_line()}")
    kernel.reset_launch_counts()
    took, res = {}, {}
    for part, fn in (("a", _train_card_vs_cpu), ("b", _train_full),
                     ("c", _train_resume)):
        t0 = time.perf_counter()
        res[part] = fn()
        torch.cuda.empty_cache()
        took[part] = time.perf_counter() - t0
    print("[train] seconds: " + ", ".join(f"({k}) {v:.1f}"
                                          for k, v in took.items()))
    launches = dict(kernel.LAUNCHES)
    print(f"[train] kernel launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    assert sum(launches.values()) == 0, launches
    return launches, res["b"]


def _launch_serving(default):
    """Phase 10 (a): phase 8's serving run again under ``OPTIMIZED``,
    beside phase 8's numbers (``default``)."""
    from repro_torch.models.perfopts import OPTIMIZED
    opt = _lm_serving(OPTIMIZED, tag="[launch] (a) OPTIMIZED:")
    err = _rel(opt["last_logits"], default["last_logits"])
    pairs = [(a, b) for x, y in zip(opt["outputs"], default["outputs"])
             for a, b in zip(x, y)]
    agree = sum(a == b for a, b in pairs) / len(pairs)
    print(f"[launch] (a) decode ms per step {opt['decode_ms']:.3f} OPTIMIZED "
          f"vs {default['decode_ms']:.3f} default (bound "
          f"{opt['decode_bound_ms']:.3f} ms); tokens/s "
          f"{opt['tokens_per_s']:.1f} vs {default['tokens_per_s']:.1f}; "
          f"profiled step aten::copy_ {opt['copies']} vs "
          f"{default['copies']}, device ops {opt['device_ops']} vs "
          f"{default['device_ops']}, device busy "
          f"{100 * opt['busy_share']:.1f} % vs "
          f"{100 * default['busy_share']:.1f} % of an unprofiled step; peak "
          f"{opt['peak_gib']:.2f} vs {default['peak_gib']:.2f} GiB")
    print(f"[launch] (a) last decode step's logits, lever on vs off: max "
          f"|delta| / max |logit| {err:.3e} (limit 5e-2); greedy tokens "
          f"served equal in {100 * agree:.1f} % of {len(pairs)} (bf16 "
          "rounding differs; not asserted)")
    assert err <= 5e-2, err
    return opt


def _launch_prefill():
    """Phase 10 (b): a B x S prefill with the triangular lever against
    the dense block loop, bf16, full width."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.perfopts import PerfOpts, use_perf_opts
    from repro_torch.models.layers import _visible_pairs, AttnSpec
    cfg = _lm_base()
    b, s = LAUNCH_PREFILL
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(1),
                            device=DEV)
    toks = torch.randint(0, cfg.vocab, (b, s), device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(6))
    out, secs = {}, {"dense": [], "triangular": []}
    with torch.no_grad():
        for name in ("dense", "triangular") * 2:     # the first pair warms
            with use_perf_opts(PerfOpts(triangular_attention=name !=
                                        "dense")):
                t0 = time.perf_counter()
                out[name] = lm.prefill(params, cfg, {"tokens": toks})[0]
                torch.cuda.synchronize()
                secs[name].append(time.perf_counter() - t0)
    nb = -(-s // AttnSpec().q_block)
    pairs = len(_visible_pairs(nb, nb, AttnSpec().q_block,
                               AttnSpec().kv_block, AttnSpec()))
    err = _rel(out["triangular"], out["dense"])
    bms, by = lm_prefill_bound_ms(cfg, _tree_bytes(params), b, s)
    print(f"[launch] (b) {cfg.name} bf16 prefill B={b} S={s}: dense "
          f"{secs['dense'][1]:.4f} s ({nb * nb} block pairs a layer), "
          f"triangular {secs['triangular'][1]:.4f} s ({pairs} pairs; first "
          f"calls {secs['dense'][0]:.4f} / {secs['triangular'][0]:.4f} s); "
          f"bound {bms:.3f} ms by {by}; last logits triangular vs dense "
          f"rel {err:.3e} (limit 2e-2), bit-equal: "
          f"{bool(torch.equal(out['triangular'], out['dense']))}")
    assert err <= 2e-2, err
    return secs


def _launch_dots(full_remat):
    """Phase 10 (c): ``remat_policy="dots"`` — reduced gradients against
    full remat on the card, then full-width bf16 training steps beside
    phase 9's full-remat numbers (``full_remat``)."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import TokenStream
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.perfopts import PerfOpts, use_perf_opts
    dots = PerfOpts(remat_policy="dots")
    cfg = dataclasses.replace(reduced(get_config(LM_ARCH)),
                              dtype=torch.float32)
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(4),
                            device=DEV)
    batch = steps.to_device(TokenStream(cfg.vocab, 2, 32, seed=5)
                            .next_batch(), DEV)
    lf, gf = steps.loss_and_grads(params, cfg, batch)
    with use_perf_opts(dots):
        ld, gd = steps.loss_and_grads(params, cfg, batch)
    e_grad = max(_rel(a, b) for a, b in zip(tree_leaves(gd),
                                            tree_leaves(gf)))
    e_loss = abs(float(ld) - float(lf)) / abs(float(lf))
    print(f"[launch] (c) {cfg.name} float32: \"dots\" vs full remat on the "
          f"card, loss rel {e_loss:.2e}, gradients max rel {e_grad:.2e} "
          "(limit 1e-5 of each leaf's largest)")
    assert max(e_loss, e_grad) <= 1e-5, (e_loss, e_grad)
    del params, gf, gd
    b, s = TRAIN_SHAPE
    with tempfile.TemporaryDirectory() as wd, use_perf_opts(dots):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer, _ = _train_cli(
            wd, "--batch", str(b), "--seq-len", str(s), "--steps",
            str(LAUNCH_DOTS_STEPS), "--save-every",
            str(LAUNCH_DOTS_STEPS + 1), "--lr", str(TRAIN_LR),
            *(["--reduced"] if LM_REDUCED else []))
        trainer.train(seed=0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        recs = [r for r in _records(wd) if "ema" in r]
        del trainer
    step_s = [r["step_s"] for r in recs]
    med = float(np.median(step_s[1:]))
    # the same depth-cut step phase 9 profiles, under "dots"
    stream = TokenStream(_lm_base().vocab, b, s, seed=0)
    with use_perf_opts(dots):
        prof = _profile_cut_step(_lm_base(), steps.to_device(
            stream.next_batch(), DEV), tag="[launch] (c) \"dots\":")
    print(f"[launch] (c) {_lm_base().name} bf16 B={b} S={s}, remat \"dots\", "
          f"{len(recs)} steps: " + ", ".join(f"{x:.4f}" for x in step_s)
          + f" s (median of steps 2-{len(recs)} {med:.4f} s, "
          f"{b * s / med:.1f} tokens/s), losses "
          + ", ".join(f"{r['loss']:.4f}" for r in recs)
          + f"; peak {peak:.2f} GiB; phase 9 full remat: median "
          f"{full_remat['median_step_s']:.4f} s, peak "
          f"{full_remat['peak_gib']:.2f} GiB")
    assert all(math.isfinite(r["loss"]) for r in recs), recs
    return {"median_step_s": med, "peak_gib": peak, "profile": prof}


def _launch_decode_cell():
    """Phase 10 (d): the decode_32k cell at its published S with B cut,
    default and ``OPTIMIZED``, from one set of arguments on the card."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import steps
    from repro_torch.models.perfopts import OPTIMIZED
    cfg = _lm_base()
    pub = SHAPES["decode_32k"]
    shape = dataclasses.replace(pub, global_batch=LAUNCH_DECODE_B)
    cells = {"default": steps.build_cell(cfg, shape),
             "OPTIMIZED": steps.build_cell(cfg, shape, perf=OPTIMIZED)}
    params, cache, batch, last = cells["default"].materialize(
        DEV, torch.Generator(device=DEV).manual_seed(7))
    pbytes, cbytes = _tree_bytes(params), _tree_bytes(cache)
    bound = lm_decode_bound_ms(cfg, pbytes, shape.global_batch,
                               shape.seq_len, 2)
    ms, busy = {}, {}
    with torch.no_grad():
        for name, cell in cells.items():
            cell.fn(params, cache, batch, last)            # warm-up
            torch.cuda.synchronize()
            ms[name] = []
            for i in range(LAUNCH_DECODE_STEPS):
                t0 = time.perf_counter()
                logits, _ = cell.fn(params, cache, batch,
                                    last - LAUNCH_DECODE_STEPS + 1 + i)
                torch.cuda.synchronize()
                ms[name].append(1e3 * (time.perf_counter() - t0))
            assert torch.isfinite(logits).all()
            busy[name] = 1e3 * profile_call(
                lambda: cell.fn(params, cache, batch, last),
                f"{cell.name} {name}, one step")["device_busy_s"]
    print(f"[launch] (d) {cells['default'].name} at its published S = "
          f"{shape.seq_len} with B cut from {pub.global_batch} to "
          f"{shape.global_batch} (one card): params {pbytes / 1e9:.2f} GB, "
          f"cache {cbytes / 1e9:.2f} GB; bound {bound:.3f} ms by bytes; "
          + "; ".join(f"{k} {LAUNCH_DECODE_STEPS} steps median "
                      f"{np.median(v):.3f} ms (min {min(v):.3f}, max "
                      f"{max(v):.3f}), device busy {busy[k]:.3f} ms of a "
                      "profiled step" for k, v in ms.items()))
    return shape, {k: float(np.median(v)) for k, v in ms.items()}, bound


#: the JAX package's dry run of qwen1.5-4b (``repro.launch.dryrun.run_cell``
#: under jax 0.9.0, XLA's CPU compile for 512 host devices): collectives
#: and wire bytes per device by kind, counts from a compile, no times
REF_DRYRUN = {
    ("decode_32k", "16x16"): (482, {"all-reduce": 18681600.0,
                                    "all-gather": 13774080.0}),
    ("train_4k", "16x16"): (8163, {"all-gather": 583920870144.0,
                                   "collective-permute": 2097152.0,
                                   "all-reduce": 1588250542501.0,
                                   "all-to-all": 1006632960.0}),
    ("prefill_32k", "16x16"): (604, {"all-gather": 95969574720.0,
                                     "all-to-all": 1258291200.0,
                                     "collective-permute": 1677742080.0,
                                     "all-reduce": 50331686400.0}),
    ("decode_32k", "2x16x16"): (482, {"all-reduce": 9340800.0,
                                      "all-gather": 6887040.0}),
    ("train_4k", "2x16x16"): (8055, {"collective-permute": 55745536.0,
                                     "all-gather": 594397862912.0,
                                     "all-reduce": 1587421880869.0,
                                     "all-to-all": 1509949440.0}),
    ("prefill_32k", "2x16x16"): (604, {"all-gather": 53187104160.0,
                                       "all-to-all": 629145600.0,
                                       "collective-permute": 838871040.0,
                                       "all-reduce": 25165843200.0}),
}

#: phase 10 (e)'s child: the dry run of both plans (its cells in
#: ``DRYRUN_WORKERS`` processes), then (d)'s cell on one device
_DRYRUN_CHILD = """
import dataclasses, json, sys
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import ONE_DEVICE
arch, out, workers, small, b = sys.argv[1:6]
rc = dryrun.main(["--arch", arch, "--mesh", "both", "--out", out,
                  "--workers", workers] + (["--reduced"] if small == "1"
                                           else []))
cfg = get_config(arch)
cfg = reduced(cfg) if small == "1" else cfg
shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=int(b))
recs = [dryrun.run_cell(cfg, shape, ONE_DEVICE, optimized=opt)
        for opt in (False, True)]
plan = SHAPES["decode_32k"]
if small == "1":                # the cut dryrun.main's --reduced makes
    plan = dataclasses.replace(
        plan, seq_len=min(plan.seq_len, dryrun.REDUCED_SEQ),
        global_batch=min(plan.global_batch, dryrun.REDUCED_BATCH))
opt = dryrun.run_cell(cfg, plan, make_production_mesh(), optimized=True)
print(json.dumps({"rc": rc, "one_device": recs, "optimized_16x16": opt}))
"""


def _launch_dryrun(shape, decode_ms):
    """Phase 10 (e): the SPMD dry run of one architecture's cells on the
    16x16 and 2x16x16 plans (DTensor programs on meta over a fake process
    group, in a child process: this process's group is NCCL's), beside
    the JAX package's counts; then (d)'s cell on one device beside its
    measured step."""
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as wd:
        out = pathlib.Path(wd) / "dryrun.json"
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", _DRYRUN_CHILD, LAUNCH_DRYRUN_ARCH,
             str(out), str(DRYRUN_WORKERS), "1" if LM_REDUCED else "0",
             str(shape.global_batch)], capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            timeout=900)
        took = time.perf_counter() - t0
        if child.returncode:
            print(child.stdout[-4000:] + child.stderr[-4000:])
        assert child.returncode == 0, child.returncode
        res = json.loads(child.stdout.strip().splitlines()[-1])
        recs = json.loads(out.read_text())
    print(f"[launch] (e) SPMD dry run of {LAUNCH_DRYRUN_ARCH}: {len(recs)} "
          f"cells on the 16x16 and 2x16x16 plans (DTensor programs on meta, "
          f"{DRYRUN_WORKERS} processes), exit {res['rc']} in {took:.1f} s")
    assert res["rc"] == 0 and len(recs) == 6
    for rec in sorted(recs, key=lambda r: (r["mesh"], r["shape"])):
        assert rec["status"] == "ok", rec
        ref = REF_DRYRUN.get((rec["shape"], rec["mesh"]))
        kinds = ", ".join(f"{k} {v / 1e9:.6g}" for k, v in
                          sorted(rec["collectives"].items()))
        line = (f"[launch] (e) {rec['arch']}:{rec['shape']} on {rec['mesh']} "
                f"({rec['total_s']} s): {rec['collective_count']} "
                f"collectives, {rec['collective_bytes'] / 1e9:.6g} GB on the "
                f"wire per device ({kinds} GB), collective_s "
                f"{rec['collective_s']:.6g} s over {rec['links']}; compute_s "
                f"{rec['compute_s']:.6g} s, memory_s {rec['memory_s']:.6g} "
                f"s, {rec['bottleneck']}-bound; replicated ops "
                f"{rec['replicated_ops'] or 'none'}")
        if ref and not LM_REDUCED:
            line += (f"; the JAX package's CPU compile: {ref[0]} "
                     f"collectives, " + ", ".join(
                         f"{k} {v / 1e9:.6g}" for k, v in
                         sorted(ref[1].items())) + " GB")
        print(line)
    opt = res["optimized_16x16"]
    assert opt["status"] == "ok", opt
    base = next(r for r in recs if r["mesh"] == "16x16"
                and r["shape"] == "decode_32k")
    kinds = ", ".join(f"{k} {v / 1e9:.6g}" for k, v in
                      sorted(opt["collectives"].items()))
    print(f"[launch] (e) {opt['arch']}:decode_32k on 16x16 under OPTIMIZED "
          f"(decode_opt's per-sequence products on each device's own "
          f"cache shard; {opt['total_s']} s): {opt['collective_count']} "
          f"collectives, {opt['collective_bytes'] / 1e9:.6g} GB on the wire "
          f"per device ({kinds} GB), beside the default's "
          f"{base['collective_count']} and "
          f"{base['collective_bytes'] / 1e9:.6g} GB; memory_s "
          f"{opt['memory_s']:.6g} s against {base['memory_s']:.6g} s; "
          f"replicated ops {opt['replicated_ops'] or 'none'}")
    assert "bmm" not in opt["replicated_ops"], opt["replicated_ops"]
    assert opt["collective_bytes"] <= 2 * base["collective_bytes"], \
        (opt["collectives"], base["collectives"])
    for name, rec in zip(("default", "OPTIMIZED"), res["one_device"]):
        assert rec["status"] == "ok", rec
        print(f"[launch] (e) {rec['arch']}:{rec['shape']} B="
              f"{shape.global_batch} on one device, {name}: counted "
              f"{rec['hbm_bytes'] / 1e9:.3f} GB and {rec['flops']:.4g} "
              f"flops, memory_s {1e3 * rec['memory_s']:.3f} ms, compute_s "
              f"{1e3 * rec['compute_s']:.4f} ms; measured step (d) "
              f"{decode_ms[name]:.3f} ms = "
              f"{decode_ms[name] / (1e3 * rec['memory_s']):.2f}x memory_s")


def _spmd_pair(cell, plain_args, spmd_args, steps_at=None):
    """``cell.fn`` on plain and on DTensor arguments: (plain ms, DTensor
    ms, DTensor ms of its first call), each call to the card's
    completion, the logits bit-equal at every call."""
    import torch
    from repro_torch.models.layers import tree_leaves
    calls = steps_at or [None, None]
    ms = {"plain": [], "spmd": []}
    for i, at in enumerate(calls):
        for kind, args in (("plain", plain_args), ("spmd", spmd_args)):
            if at is not None:
                args = args[:-1] + (at,)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = cell.fn(*args)
            torch.cuda.synchronize()
            ms[kind].append(1e3 * (time.perf_counter() - t0))
            if kind == "plain":
                want = out
        got = [t.full_tensor() for t in tree_leaves(out)]
        for w, g in zip(tree_leaves(want), got):
            assert torch.equal(w, g), (cell.name, i)
        assert torch.isfinite(got[0]).all()
    return ms


def _launch_spmd():
    """Phase 10 (f): qwen1.5-4b's prefill and decode cells as DTensor
    programs on a 1x1 CUDA ``DeviceMesh`` (NCCL at world size 1) beside
    the plain cells on the same arguments, default and ``OPTIMIZED``."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import SHAPES, ShapeSpec
    from repro_torch.launch import sharding as shd, steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.perfopts import OPTIMIZED
    from torch.distributed.tensor import distribute_tensor
    cfg = _lm_base()
    mesh = make_host_mesh(device=DEV)
    assert mesh.size == 1, mesh
    dm = mesh.device_mesh()
    try:
        b, s = LAUNCH_SPMD_PREFILL
        pre = ShapeSpec("prefill_4k", "prefill", s, b)
        dec = dataclasses.replace(SHAPES["decode_32k"],
                                  global_batch=LAUNCH_DECODE_B)
        cell = steps.build_cell(cfg, dec, mesh)
        plain = cell.materialize(DEV, torch.Generator(device=DEV)
                                 .manual_seed(11))
        spmd = cell.materialize(DEV, torch.Generator(device=DEV)
                                .manual_seed(11), mesh=dm)
        tokens = torch.randint(0, cfg.vocab, (b, s), device=DEV,
                               generator=torch.Generator(device=DEV)
                               .manual_seed(12), dtype=torch.int32)
        last = dec.seq_len - 1
        with torch.no_grad():
            for name, perf in (("default", None), ("OPTIMIZED", OPTIMIZED)):
                pc = steps.build_cell(cfg, pre, mesh, perf=perf)
                placed = distribute_tensor(tokens, dm, shd.placements(
                    pc.in_shardings[1]["tokens"], mesh))
                p_ms = _spmd_pair(pc, (plain[0], {"tokens": tokens}),
                                  (spmd[0], {"tokens": placed}))
                del pc
                torch.cuda.empty_cache()
                dc = steps.build_cell(cfg, dec, mesh, perf=perf)
                at = [last] + [last - LAUNCH_DECODE_STEPS + 1 + i
                               for i in range(LAUNCH_DECODE_STEPS)]
                d_ms = _spmd_pair(dc, plain, spmd, steps_at=at)
                print(f"[launch] (f) {cfg.name} on a 1x1 CUDA DeviceMesh "
                      f"(NCCL, world size 1), {name}: prefill B={b} S={s} "
                      f"DTensor {p_ms['spmd'][1]:.1f} ms (first call "
                      f"{p_ms['spmd'][0]:.1f} ms) vs plain "
                      f"{p_ms['plain'][1]:.1f} ms; {dec.name} (S = "
                      f"{dec.seq_len}, B = {dec.global_batch}) "
                      f"{LAUNCH_DECODE_STEPS} steps after a warm-up: DTensor "
                      f"median {np.median(d_ms['spmd'][1:]):.1f} ms vs plain "
                      f"{np.median(d_ms['plain'][1:]):.1f} ms a step; "
                      f"logits and caches bit-equal at every call; replicated "
                      f"ops {dc.replicated_ops or 'none'}")
        print(f"[launch] (f) card: {gpu_line()}")
    finally:
        dist.destroy_process_group()


def phase_launch(serving, full_remat):
    """Phase 10; returns the kernel launch counts of its paths (none:
    the LM levers and the launch cells reach no TPU-kernel counterpart)."""
    import torch
    from repro_torch.kernels.cim_mvm import kernel
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[launch] card: {gpu_line()}")
    kernel.reset_launch_counts()
    took = {}
    t0 = time.perf_counter()
    _launch_serving(serving)
    took["a"] = time.perf_counter() - t0
    for part, fn in (("b", _launch_prefill),
                     ("c", lambda: _launch_dots(full_remat))):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        fn()
        took[part] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shape, decode_ms, _ = _launch_decode_cell()
    took["d"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _launch_dryrun(shape, decode_ms)
    took["e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _launch_spmd()
    took["f"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print("[launch] seconds: " + ", ".join(f"({k}) {v:.1f}"
                                           for k, v in took.items()))
    launches = dict(kernel.LAUNCHES)
    print(f"[launch] kernel launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    assert sum(launches.values()) == 0, launches
    return launches


# --------------------------------------------------------------------------
# Phase 11: the example and tool scripts (``examples/*_torch.py``,
# ``tools/*_torch.py``), each ``main`` run in this process at its own
# sizes.

def _script(relpath: str):
    """Import the script at ``ROOT/relpath`` as a module of its own."""
    import importlib.util
    name = "script_" + pathlib.Path(relpath).stem
    spec = importlib.util.spec_from_file_location(name, ROOT / relpath)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(mod, argv, launches: dict = None, tag: str = ""):
    """``mod.main(argv)`` with its stdout captured; returns its value,
    the stdout and the seconds.  The kernel's launch counts are set to 0
    just before and, where ``launches`` is given, stored there under
    ``tag`` just after."""
    import contextlib
    import io
    import torch
    from repro_torch.kernels.cim_mvm import kernel
    buf = io.StringIO()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ret = mod.main(list(argv))
    if DEV != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if launches is not None:
        launches[tag] = dict(kernel.LAUNCHES)
    return ret, buf.getvalue(), seconds


def _examples_cim(launches: dict, took: dict):
    """(a) quickstart, (b) the fleet, (c) the ViT compile, (d) the DSE
    demo, (g) explain, (h) the goldens."""
    import tempfile
    from repro_torch.kernels.cim_mvm import cim_mvm_params
    qs = _script("examples/quickstart_torch.py")
    _, out, took["a"] = _run_script(qs, ["--device", DEV], launches, "a")
    assert "matches reference: True" in out, out[-300:]
    assert sum(launches["a"].values()) > 0, launches["a"]
    # the same walk-through on the CPU's plain version prints the same
    # lines: the script prints no wall-clock time, so nothing is masked
    _, cpu_out, cpu_s = _run_script(qs, ["--device", "cpu"])
    assert cpu_out == out, "quickstart: card and CPU runs print differently"
    print(f"[examples] (a) quickstart_torch: {out.splitlines()[-1].strip()}"
          f" in {took['a']:.3f} s; kernel launches {launches['a']}; stdout "
          f"equal to --device cpu's ({len(out.splitlines())} lines, "
          f"{cpu_s:.3f} s)")

    fleet = _script("examples/serve_cim_fleet_torch.py")
    served = {}

    class TimedFleet(fleet.CimFleet):
        def serve(self, *a, **kw):
            if DEV != "cpu":
                import torch
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().serve(*a, **kw)
            served["s"], served["n"] = time.perf_counter() - t0, len(out)
            return out
    fleet.CimFleet = TimedFleet
    done, out, took["b"] = _run_script(fleet, ["--device", DEV], launches,
                                       "b")
    assert out.count("fleet outputs bit-exact") == 2, out[-500:]
    assert len(done) == served["n"] == 12, served
    exact = cim_mvm_params(fleet.get_arch("isaac-baseline")).exact
    assert exact or launches["b"]["cim_mvm_tiles"] > 0, launches["b"]
    print(f"[examples] (b) serve_cim_fleet_torch: 12 requests served in "
          f"{served['s']:.4f} s ({served['n'] / served['s']:.2f} requests/s),"
          f" bit-exact vs standalone CimBatchService in-script; whole script"
          f" {took['b']:.3f} s; kernel launches {launches['b']} (ADC exact "
          f"on isaac-baseline: {exact}, so each node is one exact GEMM)")

    _, out, took["c"] = _run_script(
        _script("examples/compile_vit_cim_torch.py"), [], launches, "c")
    assert out.count("speedup=") == 3, out
    print(f"[examples] (c) compile_vit_cim_torch: 3 presets in "
          f"{took['c']:.3f} s")
    for line in out.splitlines()[2:]:
        print(f"[examples] (c)   {line}")

    with tempfile.TemporaryDirectory() as tmp:
        rc, out, took["d"] = _run_script(
            _script("examples/explore_design_space_torch.py"),
            ["--fresh", "--cache-dir", tmp], launches, "d")
    assert rc == 0 and "halving returns the same best point: OK" in out
    print(f"[examples] (d) explore_design_space_torch (defaults, fresh "
          f"cache): {took['d']:.3f} s, {len(out.splitlines())} lines")
    for line in out.splitlines():
        if "finished in" in line or "full compiles in" in line:
            print(f"[examples] (d)   {line.strip()}")

    rc, out, took["g"] = _run_script(
        _script("tools/explain_torch.py"),
        ["--workload", "resnet18", "--arch", "jia-issc21", "--format",
         "json"], launches, "g")
    report = json.loads(out)
    assert rc == 0 and len(report["rows"]) == report["meta"]["nodes"]
    print(f"[examples] (g) explain_torch resnet18 on jia-issc21: JSON of "
          f"{len(report['rows'])} rows, compile "
          f"{report['meta']['compile_wall_s']} s; {took['g']:.3f} s")

    with tempfile.TemporaryDirectory() as tmp:
        rc, out, took["h"] = _run_script(
            _script("tools/make_golden_cim_mvm_torch.py"),
            ["--device", DEV, "--check", "--out", tmp], launches, "h")
    assert rc == 0 and "check: 6/6 fixtures bit-equal" in out, out
    assert all(n > 0 for n in launches["h"].values()), launches["h"]
    print(f"[examples] (h) make_golden_cim_mvm_torch --check: 6/6 fixtures "
          f"bit-equal to tests/golden through the kernel; kernel launches "
          f"{launches['h']}; {took['h']:.3f} s")


def _examples_lm(launches: dict, took: dict):
    """(e) the LM server example, (f) the training example and its
    resume."""
    import statistics
    import tempfile
    import torch
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    (done, dt), out, took["e"] = _run_script(
        _script("examples/serve_lm_torch.py"), ["--device", DEV], launches,
        "e")
    tokens = sum(len(r.output) for r in done)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert len(done) == 10 and tokens == 120, (len(done), tokens)
    print(f"[examples] (e) serve_lm_torch: {len(done)} requests, {tokens} "
          f"tokens in {dt:.4f} s ({tokens / dt:.2f} tokens/s), peak "
          f"{peak - held:.4f} GiB above the {held:.4f} GiB allocated "
          f"before; whole script {took['e']:.3f} s")
    torch.cuda.empty_cache()

    train = _script("examples/train_lm_torch.py")
    with tempfile.TemporaryDirectory() as wd:
        argv = ["--device", DEV, "--workdir", wd]
        res, out, took["f"] = _run_script(
            train, argv + ["--steps", str(EXAMPLES_TRAIN_STEPS)], launches,
            "f")
        recs = [r for r in _records(wd) if "loss" in r]
        losses = [r["loss"] for r in recs]
        assert res["steps"] == EXAMPLES_TRAIN_STEPS and \
            res["nan_steps"] == 0, res
        assert all(math.isfinite(x) for x in losses), losses
        assert losses[-1] < losses[0], losses
        more = EXAMPLES_TRAIN_STEPS + 20
        res2, out2, took["f2"] = _run_script(
            train, argv + ["--steps", str(more)], launches, "f2")
        assert f"at step {EXAMPLES_TRAIN_STEPS}" in out2, out2
        assert res2["steps"] == more, res2
        recs2 = [r for r in _records(wd) if "loss" in r]
    cfg = train.build_config("qwen1.5-4b")
    print(f"[examples] (f) train_lm_torch ({cfg.name}, "
          f"{cfg.param_count() / 1e6:.1f} M parameters, B=8, S=256): "
          f"{res['steps']} steps in {res['wall_s']:.3f} s "
          f"({res['steps'] / res['wall_s']:.3f} steps/s; median logged "
          f"step {statistics.median(r['step_s'] for r in recs):.4f} s, "
          f"checkpoints every 50 included in the total); logged loss "
          f"{losses[0]:.6f} at step {recs[0]['step']} -> {losses[-1]:.6f} at "
          f"step {recs[-1]['step']}; whole script {took['f']:.3f} s")
    print(f"[examples] (f) rerun with --steps {more}: resumed at step "
          f"{EXAMPLES_TRAIN_STEPS}, {res2['steps'] - EXAMPLES_TRAIN_STEPS} "
          f"steps in {res2['wall_s']:.3f} s, loss {recs2[-1]['loss']:.6f} at "
          f"step {recs2[-1]['step']}; whole script {took['f2']:.3f} s")


def phase_examples():
    """Phase 11; returns the kernel launches of the scripts' runs on the
    card, summed (the CPU comparison run of (a) is not among them)."""
    import torch
    t_phase = time.perf_counter()
    print(f"[examples] card: {gpu_line()}")
    launches, took = {}, {}
    _examples_cim(launches, took)
    torch.cuda.empty_cache()
    _examples_lm(launches, took)
    torch.cuda.empty_cache()
    for tag in ("c", "d", "e", "f", "f2", "g"):
        assert sum(launches[tag].values()) == 0, (tag, launches[tag])
    total = {k: sum(n[k] for n in launches.values())
             for k in launches["a"]}
    print("[examples] seconds: " + ", ".join(f"({k}) {v:.1f}"
                                             for k, v in took.items()))
    print(f"[examples] kernel launches {total}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return total


# --------------------------------------------------------------------------
# Phase 12: the Trainer on a DeviceMesh, its elastic restart, and the
# training launcher across the cards present.

def _cut_trainer(workdir, cfg, mesh=None, steps: int = MESH_TRAIN_STEPS,
                 save_every: int = 100):
    """A ``Trainer`` of ``cfg`` on ``TokenStream(vocab, B, S, seed=0)``
    at TRAIN_SHAPE, logging every step: on the card, or on ``mesh``."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import TokenStream, make_batch_iterator
    from repro_torch.train import Trainer, TrainerConfig
    b, s = TRAIN_SHAPE
    stream = TokenStream(cfg.vocab, b, s, seed=0)
    tcfg = TrainerConfig(workdir=str(workdir), num_steps=steps,
                         save_every=save_every, log_every=1, lr=TRAIN_LR)
    kw = {"mesh": mesh} if mesh is not None else {"device": DEV}
    return Trainer(cfg, ShapeSpec("train_cut", "train", s, b), tcfg,
                   make_batch_iterator(stream), data_state=stream.state,
                   **kw)


def _state(trainer) -> list:
    """The trainer's params and moments, whole."""
    from repro_torch.models.layers import tree_leaves
    return [t.full_tensor() if hasattr(t, "full_tensor") else t
            for t in tree_leaves((trainer.params, trainer.opt_state))]


def _losses(workdir) -> dict:
    return {r["step"]: r["loss"] for r in _records(workdir) if "ema" in r}


def _mesh_vs_one(wd):
    """Phase 12 (a) and (b): the mesh trainer on a 1x1 NCCL mesh against
    the one-device trainer, then a one-device run stopped at step 2 by
    its checkpoint and relaunched on the mesh; returns the mesh's
    numbers."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    cfg = dataclasses.replace(_lm_base(), n_layers=MESH_TRAIN_LAYERS)
    b, s = TRAIN_SHAPE
    mesh = make_host_mesh(device=DEV)
    assert mesh.size == 1, mesh
    out = {}
    for kind, m in (("plain", None), ("mesh", mesh)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = _cut_trainer(wd / kind, cfg, m)
        t0 = time.perf_counter()
        res = trainer.train(seed=0)
        took = time.perf_counter() - t0
        recs = [r for r in _records(wd / kind) if "ema" in r]
        out[kind] = {"state": _state(trainer), "step_s": [
            r["step_s"] for r in recs], "wall_s": took,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "losses": _losses(wd / kind), "res": res}
        if m is not None:
            out[kind]["replicated_ops"] = dict(trainer.replicated_ops)
        del trainer
    plain, spmd = out["plain"], out["mesh"]
    same = all(torch.equal(a, b_) for a, b_ in zip(plain["state"],
                                                   spmd["state"]))
    print(f"[mesh] (a) {cfg.name} at full width, {MESH_TRAIN_LAYERS} of "
          f"{_lm_base().n_layers} layers, {cfg.dtype}, B={b} S={s}, full "
          f"remat, lr {TRAIN_LR}: {MESH_TRAIN_STEPS} steps through "
          f"Trainer(..., mesh=1x1 NCCL DeviceMesh) against the one-device "
          f"Trainer from the same seed")
    for kind in ("plain", "mesh"):
        o = out[kind]
        print(f"[mesh] (a) {kind}: losses " + ", ".join(
            f"{o['losses'][k]:.6f}" for k in sorted(o["losses"]))
            + "; step s " + ", ".join(f"{x:.4f}" for x in o["step_s"])
            + f" (median of steps 2-{len(o['step_s'])} "
            f"{np.median(o['step_s'][1:]):.4f} s); peak "
            f"{o['peak_gib']:.2f} GiB")
    print(f"[mesh] (a) losses equal: {plain['losses'] == spmd['losses']}; "
          f"params and moments bit-equal: {same} "
          f"({len(spmd['state'])} leaves); replicated ops "
          f"{spmd['replicated_ops'] or 'none'}")
    assert all(math.isfinite(x) for x in plain["losses"].values())
    assert plain["losses"] == spmd["losses"], (plain["losses"],
                                               spmd["losses"])
    assert sorted(spmd["losses"]) == list(range(1, MESH_TRAIN_STEPS + 1))
    assert same
    want = plain["state"]
    del out
    torch.cuda.empty_cache()

    # (b) a one-device run checkpointed at step 2 and stopped, then a
    # relaunch on the mesh, which re-shards the checkpoint onto it
    first = _cut_trainer(wd / "cut", cfg, steps=2, save_every=2)
    first.train(seed=0)
    del first
    torch.cuda.empty_cache()
    again = _cut_trainer(wd / "cut", cfg, mesh)
    t0 = time.perf_counter()
    again.train(seed=0)
    took = time.perf_counter() - t0
    got = _state(again)
    same = all(torch.equal(a, b_) for a, b_ in zip(want, got))
    losses = _losses(wd / "cut")
    print(f"[mesh] (b) {cfg.name} cut: 2 steps on one device, "
          f"checkpointed at step 2, then Trainer(..., mesh=1x1) resumed "
          f"through restore_resharded ({took:.1f} s): step 3 loss "
          f"{losses[3]:.6f} vs uninterrupted {plain['losses'][3]:.6f}; "
          f"params and moments bit-equal to the uninterrupted 3 steps: "
          f"{same}")
    assert sorted(losses) == [1, 2, 3] and losses == plain["losses"], losses
    assert same
    return {"plain_step_s": float(np.median(plain["step_s"][1:])),
            "mesh_step_s": float(np.median(spmd["step_s"][1:])),
            "mesh_peak_gib": spmd["peak_gib"],
            "replicated_ops": spmd["replicated_ops"]}


def _run_group(cmd, timeout: int):
    """``cmd`` in a session of its own, its whole process group killed if
    it outlives ``timeout``; returns (exit code, stdout, stderr)."""
    import os
    import signal
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True,
                            env=dict(os.environ,
                                     PYTHONPATH=str(ROOT / "src")))
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"{cmd} outlived {timeout} s:\n{err[-4000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    return proc.returncode, out, err


def _mesh_launcher(wd):
    """Phase 12 (c): the training launcher on a host mesh of the cards
    present, one process each, under ``torch.distributed.run``."""
    import torch
    n = torch.cuda.device_count()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), "-m", "repro_torch.launch.train",
           "--mesh", "host", "--arch", LM_ARCH, "--reduced", "--steps",
           str(MESH_LAUNCH_STEPS), "--workdir", str(wd / "cli")]
    if DEV != "cuda":
        cmd += ["--device", DEV]
    t0 = time.perf_counter()
    rc, out, err = _run_group(cmd, timeout=600)
    took = time.perf_counter() - t0
    finals = [ln for ln in out.splitlines() if ln.startswith("final:")]
    metrics = sorted((wd / "cli").rglob("metrics.jsonl"))
    recs = _records(wd / "cli") if metrics else []
    print(f"[mesh] (c) python -m torch.distributed.run --nproc-per-node {n} "
          f"-m repro_torch.launch.train --mesh host --arch {LM_ARCH} "
          f"--reduced --steps {MESH_LAUNCH_STEPS}: exit {rc} in {took:.1f} "
          f"s; {len(finals)} final line(s) {finals}; metrics files "
          f"{[str(p.relative_to(wd)) for p in metrics]}, {len(recs)} "
          f"records")
    if rc:
        print(out[-4000:] + err[-4000:])
    assert rc == 0 and len(finals) == 1, rc
    assert metrics == [wd / "cli" / "metrics.jsonl"], metrics
    assert recs and recs[-1]["event"] == "done" and \
        recs[-1]["steps"] == MESH_LAUNCH_STEPS, recs
    return took


def phase_mesh_train():
    """Phase 12; returns the kernel launch counts of its path (none: the
    LM trainer reaches no TPU-kernel counterpart)."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.cim_mvm import kernel
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[mesh] card: {gpu_line()}")
    kernel.reset_launch_counts()
    took = {}
    with tempfile.TemporaryDirectory() as wd:
        wd = pathlib.Path(wd)
        t0 = time.perf_counter()
        try:
            res = _mesh_vs_one(wd)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        took["a+b"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        took["c"] = _mesh_launcher(wd)
    print(f"[mesh] median step: mesh {res['mesh_step_s']:.4f} s, plain "
          f"{res['plain_step_s']:.4f} s "
          f"({res['mesh_step_s'] / res['plain_step_s']:.2f}x); mesh peak "
          f"{res['mesh_peak_gib']:.2f} GiB; card: {gpu_line()}")
    print("[mesh] seconds: " + ", ".join(f"({k}) {v:.1f}"
                                         for k, v in took.items()))
    launches = dict(kernel.LAUNCHES)
    print(f"[mesh] kernel launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    assert sum(launches.values()) == 0, launches
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
    by_path["lm"], lm_forward, serving = phase_lm()
    torch.cuda.empty_cache()
    by_path["train"], full_remat = phase_train()
    torch.cuda.empty_cache()
    by_path["launch"] = phase_launch(serving, full_remat)
    torch.cuda.empty_cache()
    by_path["examples"] = phase_examples()
    torch.cuda.empty_cache()
    by_path["mesh_train"] = phase_mesh_train()
    for name, row in rows.items():
        row["launches_by_path"] = {p: n[name] for p, n in by_path.items()}
    rows["cim_mvm_tiles"]["puma_faulted_forward"] = puma_forward
    rows["cim_mvm_tiles"]["lm_block_forward"] = lm_forward

    print(json.dumps({"kernels": [rows["cim_mvm_tiles"], rows["cim_mvm"]]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
