"""One benchmark cell of the CIM serving path of ``repro_torch``.

``run_cell`` builds the cell named in ``BENCHMARK.json`` from its data
files, serves its traffic for the measured window, and holds every
answer of the window against ``cimbench.reference``.  Everything that
belongs to one configuration, traffic mix or per-layer metric is a file
of its own, found by name:

* ``BENCHMARK.json``'s ``configs[].file``: the configuration's sizes and
  crossbar, with ``family`` naming its plain model ``models/<family>.py``,
  which says everything model-specific: ``layers(cfg)``, the plain layer
  list ``reference`` runs (a fully connected layer may state ``rows``,
  its MVM rows an image, 1 by default); ``input_shape(cfg)``, one
  input's shape; ``build_kwargs(cfg)``, the keyword arguments of the
  served graph's builder ``get_workload(cfg["workload"], ...)``; and
  ``OPS``, op name to a plain-torch ``fn(xs, layer)``, for the ops
  ``reference`` lacks.  A layer of any op that states
  ``"requant": true`` has its accumulator requantised by a shift
  calibrated as a convolution's is.  A family module imports torch and
  the standard library only;
* ``traffic/<traffic>.json``: the batch of the closed loop of one client;
* ``metrics/<name>.py``: a ``read(readings)`` that returns the per-layer
  metric or ``None`` where it finds nothing to read.

The program is imported only here and in ``run.py``; the reference and
the counts import nothing of it.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import reference, trace

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
#: fixed directories inside the checkout for what the program caches
COMPILE_CACHE = ROOT / "build" / "cimbench" / "compile"
#: names that may not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: distinct images in the pool, in batches of the cell's size
POOL_BATCHES = 4
#: dispatches in the device trace, and in the host and kernel trace
TRACED_DISPATCHES = 20
KERNEL_DISPATCHES = 3
#: images a block of the reference runs at once
REFERENCE_BLOCK = 16


class BenchError(RuntimeError):
    """A cell that cannot be run as ``BENCHMARK.json`` describes it."""


# -- the cell's data ----------------------------------------------------------

@dataclasses.dataclass
class Cell:
    workload: Dict
    config: Dict
    traffic: Dict
    bench: Dict

    @property
    def xb(self) -> reference.Crossbar:
        return reference.Crossbar.from_config(self.config)

    @property
    def model(self):
        return importlib.import_module(
            f"cimbench.models.{self.config['family']}")

    @property
    def layers(self) -> List[Dict]:
        return self.model.layers(self.config)

    @property
    def ops(self) -> Dict[str, Callable]:
        """The family's operators for ops the reference lacks."""
        return getattr(self.model, "OPS", {})

    @property
    def outputs(self) -> List[str]:
        """The served tensors every answer is held to, by name."""
        return list(self.config["outputs"])

    @property
    def in_shape(self) -> Tuple[int, ...]:
        return tuple(self.model.input_shape(self.config))


def load_cell(name: str) -> Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json")
                         .read_text())
    return Cell(wl, config, traffic, bench)


def per_layer_readers(cell: Cell) -> Dict[str, Callable]:
    """``read`` of every per-layer metric this cell reports."""
    out = {}
    for m in cell.bench["per_layer"]:
        if cell.workload["name"] not in m.get("workloads",
                                              [cell.workload["name"]]):
            continue
        path = HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            f"cimbench.metrics.{m['name']}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[m["name"]] = mod.read
    return out


# -- inputs from the seed -----------------------------------------------------

@dataclasses.dataclass
class Inputs:
    weights: Dict[str, torch.Tensor]      # (R, C) int32 on the device
    calib: np.ndarray                     # one image, int32
    pool: np.ndarray                      # (pool, *in_shape) int32
    order: np.random.Generator            # draws each batch's images


def make_inputs(cell: Cell, seed: int, device) -> Inputs:
    """Weights, the calibration image and the pool of distinct images,
    all from ``seed``: weights on the device in one call, images in one
    more."""
    xb = cell.xb
    s = int(seed) % (1 << 63)
    gen = torch.Generator(device=device)
    gen.manual_seed(s)
    shapes = reference.weight_shapes(cell.layers)
    sizes = [r * c for _, (r, c) in shapes]
    wlim = 1 << (xb.weight_bits - 1)
    flat = torch.randint(-wlim, wlim, (sum(sizes),), generator=gen,
                         device=device, dtype=torch.int32)
    weights = {name: part.view(r, c) for (name, (r, c)), part
               in zip(shapes, torch.split(flat, sizes))}
    n_pool = cell.traffic["batch"] * POOL_BATCHES
    alim = 1 << (xb.act_bits - 1)
    imgs = torch.randint(-alim, alim, (n_pool + 1, *cell.in_shape),
                         generator=gen, device=device, dtype=torch.int32)
    imgs = imgs.cpu().numpy()
    return Inputs(weights, imgs[0], imgs[1:], np.random.default_rng(s))


def batches(inp: Inputs, batch: int):
    """Endless full batches of pool indices: each pass over the pool in
    an order drawn from the seed."""
    n = inp.pool.shape[0]
    while True:
        perm = inp.order.permutation(n)
        for i in range(0, n - batch + 1, batch):
            yield perm[i:i + batch]


# -- the program ----------------------------------------------------------------

def program_graph(cell: Cell):
    """The served graph, checked against the configuration's own layer
    list (names and weight shapes) and its crossbar, returning the
    configuration's ``outputs``."""
    from repro_torch.core.abstraction import get_arch
    from repro_torch.core.graph import weight_matrix_shape
    from repro_torch.kernels.cim_mvm import cim_mvm_params
    from repro_torch.workloads import get_workload
    cfg = cell.config
    graph = get_workload(cfg["workload"], **cell.model.build_kwargs(cfg))
    arch = get_arch(cfg["arch"])
    got = [(n.name, tuple(weight_matrix_shape(n))) for n in graph.cim_nodes]
    if list(graph.inputs.values()) != [cell.in_shape] or \
            got != reference.weight_shapes(cell.layers):
        raise BenchError("the served graph's crossbar layers differ from "
                         f"the configuration's: {got}")
    named = {layer["output"] for layer in cell.layers}
    if any(t not in graph.shapes or t not in named for t in cell.outputs):
        raise BenchError(f"outputs {cell.outputs}: not all are tensors of "
                         "both the served graph and the plain model")
    if cell.outputs != graph.outputs:
        graph = dataclasses.replace(graph, outputs=cell.outputs)
    params = cim_mvm_params(arch)
    stated = cell.xb
    size = (cfg["crossbar"]["rows"], cfg["crossbar"]["cols"])
    if tuple(arch.xb.xb_size) != size or any(
            getattr(params, f) != getattr(stated, f)
            for f in ("act_bits", "weight_bits", "dac_bits", "cell_bits",
                      "parallel_row", "adc_bits")):
        raise BenchError(f"{arch.name} computes with {params} on "
                         f"{arch.xb.xb_size} crossbars, the configuration "
                         f"states {stated} on {size}")
    return graph, arch, params


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read."""

    cell: Cell
    batch: int
    window_s: float
    dispatch_s: List[float]
    setup_calibrate_s: float
    device_name: str = ""
    #: executor_dispatch_s over the window: (seconds, observations)
    executor_dispatch: Optional[Tuple[float, int]] = None
    #: the device trace (CUDA activity only) of ``TRACED_DISPATCHES``
    events: Sequence[Dict] = ()
    trace_window: Optional[Tuple[float, float]] = None
    traced_dispatches: int = 0
    #: the host and device trace of a few dispatches, the kernel's
    #: launches annotated, and the (T, M, R, C) of each launch in it
    kernel_events: Sequence[Dict] = ()
    cim_launches: List[Tuple[int, int, int, int]] = \
        dataclasses.field(default_factory=list)

    @property
    def dispatches(self) -> int:
        return len(self.dispatch_s)

    @property
    def device_ops(self) -> List[Dict]:
        if self.trace_window is None:
            return []
        return trace.device_ops(self.events, self.trace_window)


def _histogram(reg, name: str) -> Tuple[float, int]:
    total, n = 0.0, 0
    for series, h in reg.snapshot()["histograms"].items():
        if series.split("{")[0] == name:
            total += h["sum"]
            n += h["count"]
    return total, n


class _Traced:
    """The crossbar-MVM kernel's launches annotated for the profiler, and
    their shapes recorded, while active."""

    def __init__(self):
        from repro_torch.kernels.cim_mvm import kernel
        self.kernel = kernel
        self.orig = kernel._launch
        self.shapes: List[Tuple[int, int, int, int]] = []

    def __enter__(self):
        orig, shapes = self.orig, self.shapes

        def launch(name, x, w, params, t, m, r, c):
            shapes.append((t, m, r, c))
            with torch.profiler.record_function(trace.CIM_MVM):
                return orig(name, x, w, params, t, m, r, c)

        self.kernel._launch = launch
        return self

    def __exit__(self, *exc):
        self.kernel._launch = self.orig


def _events(export) -> List[Dict]:
    """The complete events of the trace ``export(path)`` writes."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        export(path)
        with open(path) as f:
            return trace.complete(json.load(f)["traceEvents"])
    finally:
        os.unlink(path)


def _device_trace(svc, reqs, draw, k: int) -> Tuple[List[Dict], List]:
    """``k`` dispatches traced with CUDA activity only, after one that
    starts the profiler up; returns the events and the (indices,
    requests) of the ``k``."""
    from torch.profiler import ProfilerActivity, profile, schedule
    done, out = [], []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=k, repeat=1),
                 on_trace_ready=lambda p: out.append(
                     _events(p.export_chrome_trace))) as prof:
        for i in range(1 + k):
            idx = next(draw)
            batch = reqs(idx)
            svc.dispatch(batch)
            if i:
                done.append((idx, batch))
            prof.step()
    return (out[0] if out else []), done


def _kernel_trace(svc, reqs, draw, k: int
                  ) -> Tuple[List[Dict], List[Tuple[int, int, int, int]],
                             List]:
    """``k`` dispatches traced on the host and the device with the
    kernel's launches annotated, after one that starts the profiler up;
    returns the events, the kernel launches of the ``k`` and their
    (indices, requests)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    done = []
    with _Traced() as traced, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        svc.dispatch(reqs(next(draw)))
        traced.shapes.clear()
        for _ in range(k):
            idx = next(draw)
            batch = reqs(idx)
            with record_function(trace.DISPATCH):
                svc.dispatch(batch)
            done.append((idx, batch))
        shapes = list(traced.shapes)
    return _events(prof.export_chrome_trace), shapes, done


# -- correctness ------------------------------------------------------------------

def reference_outputs(cell: Cell, inp: Inputs, device, *,
                      keep_bits: Optional[int] = None
                      ) -> Dict[str, np.ndarray]:
    """The reference's outputs for every image of the pool, by name;
    ``keep_bits`` below the configuration's precision gives the
    control's."""
    out = reference.run(cell.layers, inp.weights,
                        torch.as_tensor(inp.calib),
                        torch.as_tensor(inp.pool), cell.xb, device=device,
                        block=REFERENCE_BLOCK, outputs=cell.outputs,
                        keep_bits=keep_bits, ops=cell.ops)
    return {name: v.numpy() for name, v in out.items()}


def compare(cell: Cell, ref: Dict[str, np.ndarray],
            done: Sequence) -> Dict[str, Dict]:
    """Every answer of ``done`` ((pool indices, requests) per dispatch),
    each of its outputs, against ``ref``'s rows for its image: the
    numbers compared, each with its limit."""
    max_diff, wrong, missing, n = 0, 0, 0, 0
    for idx, batch in done:
        for j, r in zip(idx, batch):
            n += 1
            got = r.outputs or {}
            if any(got.get(t) is None or np.shape(got[t]) != v[j].shape
                   for t, v in ref.items()):
                missing += 1
                continue
            d = max(int(np.abs(np.asarray(got[t], np.int64) - v[j]).max())
                    for t, v in ref.items())
            max_diff = max(max_diff, d)
            wrong += int(d > 0)
    return {"unanswered": {"value": missing if n else 1, "limit": 0},
            "wrong_answers": {"value": wrong, "limit": 0},
            "max_abs_diff": {"value": max_diff, "limit": 0}}


def passed(checks: Dict[str, Dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


# -- one run ------------------------------------------------------------------

def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, *,
             t_start: float, device="cuda") -> Dict:
    """One run of ``cell``: set-up, the measured window, with ``traced``
    the per-layer readings and a profiled tail, then the check.
    ``t_start`` is the process's start on ``time.perf_counter``."""
    from repro_torch.cimsim.executor import clear_lower_cache
    from repro_torch.cimsim.functional import calibrate_shifts
    from repro_torch.dse.cache import CompileCache
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serving import CimBatchService, CimRequest

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    b = cell.traffic["batch"]
    parts = {"start": time.perf_counter() - t_start}
    t = time.perf_counter()
    graph, arch, params = program_graph(cell)
    inp = make_inputs(cell, seed, dev)
    in_name = next(iter(graph.inputs))
    parts["inputs"] = time.perf_counter() - t

    def reqs(idx):
        return [CimRequest(rid=int(j), inputs={in_name: inp.pool[j]})
                for j in idx]

    t = time.perf_counter()
    shifts = calibrate_shifts(graph, inp.weights, {in_name: inp.calib},
                              params, device=dev)
    parts["calibrate"] = time.perf_counter() - t
    t = time.perf_counter()
    svc = CimBatchService(graph, arch, max_batch=b, weights=inp.weights,
                          shifts=shifts, device=dev,
                          cache=CompileCache(COMPILE_CACHE))
    parts["service"] = time.perf_counter() - t
    t = time.perf_counter()
    draw = batches(inp, b)
    svc.dispatch(reqs(next(draw)))        # warms this batch shape
    if cuda:
        torch.cuda.synchronize(dev)
    parts["warm"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    reg = obs_metrics.enable(obs_metrics.MetricsRegistry()) if traced \
        else None
    done, dispatch_s = [], []
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        idx = next(draw)
        batch = reqs(idx)
        a = time.perf_counter()
        svc.dispatch(batch)
        z = time.perf_counter()
        dispatch_s.append(z - a)
        done.append((idx, batch))
        if z >= t_end:
            break
    window_s = z - t0
    if traced:
        obs_metrics.disable()
    readings = Readings(cell, b, window_s, dispatch_s, parts["calibrate"],
                        torch.cuda.get_device_name(dev) if cuda else "")
    if traced:
        readings.executor_dispatch = _histogram(reg, "executor_dispatch_s")
        if cuda:
            events, tail = _device_trace(svc, reqs, draw,
                                         TRACED_DISPATCHES)
            readings.events = events
            readings.trace_window = trace.window(events)
            readings.traced_dispatches = len(tail)
            done += tail
            events, shapes, tail = _kernel_trace(svc, reqs, draw,
                                                 KERNEL_DISPATCHES)
            readings.kernel_events = events
            readings.cim_launches = shapes
            done += tail
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    del svc
    clear_lower_cache()
    if cuda:
        torch.cuda.empty_cache()
    checks = compare(cell, reference_outputs(cell, inp, dev), done)

    result = {"correct": passed(checks),
              "attempted": len(done) * b, "failed": 0}
    if traced:
        metrics = {}
        units = {m["name"]: m["unit"] for m in cell.bench["per_layer"]}
        for mname, read in per_layer_readers(cell).items():
            v = read(readings)
            if v is not None:
                metrics[mname] = {"value": v, "unit": units[mname]}
    else:
        metrics = {
            "setup_s": {"value": setup_s, "unit": "s"},
            "infer_per_s": {"value": len(dispatch_s) * b / window_s,
                            "unit": "inferences/s"},
        }
        stated = {m["name"] for m in cell.bench["end_to_end"]
                  if cell.workload["name"] in m.get(
                      "workloads", [cell.workload["name"]])}
        metrics = {k: v for k, v in metrics.items() if k in stated}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if cuda else dev.type,
                        "kind": readings.device_name, "count": 1,
                        "memory_peak_bytes": int(peak)}
    if traced and readings.trace_window is not None:
        lo, hi = readings.trace_window
        ops = readings.device_ops
        result["device"]["busy_s"] = trace.busy_us(ops, (lo, hi)) / 1e6
        result["device"]["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = {
            "device_ops": trace.top_ops(ops),
            "idle_gaps": trace.idle_gaps(readings.events, ops, (lo, hi))}
    # set-up seconds by step (imports and CUDA start-up in "start")
    result["setup_parts"] = parts
    result["checks"] = checks
    return result


def p95(values: Sequence[float]) -> float:
    """The 95th percentile of ``values``, linear between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values), 95))


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is one that may not be."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})
