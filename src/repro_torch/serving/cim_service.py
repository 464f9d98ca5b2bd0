"""Batched CIM inference service over a trace-lowered executor.

The serving-side consumer of cimsim.executor: compile a workload for a
CIM chip once, lower the meta-operator flow once onto a device, then
serve request traffic by stacking queued inputs on the executor's batch
axis — one batched pass per batch instead of one interpreter walk per
request.  ``use_executor=False`` keeps the op-by-op interpreter as a
reference/fallback path (same outputs, orders of magnitude slower),
which is also how the service is tested.

The service runs on ``device`` (default ``"cuda"``: on the card every
crossbar MVM, the calibration pass's included, runs the CUDA kernel).
A genuine ``LoweringError`` (a flow the executor cannot lower
bit-exactly) falls back to the interpreter, which runs the kernel too;
route, build and launch errors propagate.

Request/stats shapes live in ``serving.common`` (shared with the
multi-tenant fleet); ``serve_padded`` is the fleet batcher's entry
point — it pads a partial batch up to a bucket size by repeating the
last row, so every ragged queue drain of a bucket runs one batch shape.

Units and clocks: ``dispatch``/``serve_padded`` return **seconds of
``time.perf_counter()``** around the timed pass (which ends when the
outputs reach the host and are handed to the requests); the compiled
plan's latency/energy estimates are **compiler cycles/pJ** and never mix
into serve times.

Tracing: with a recorder installed (``obs.trace.install``) every pass of
``dispatch`` is a ``service.dispatch`` span (``args``: ``batch``,
``padded_to``, ``warm`` on a shape's first pass) holding
``service.stack`` (stacking and padding the rows; ``staged``:
``"allocated"`` or ``"reused"``), the executor's spans
(``LoweredExecutable.run_batch``) and ``service.answers`` (each row
handed to its request), all on the graph's row of the executor track
and carrying the service's sequence number of the pass as
``dispatch``.  Without one a dispatch pays one ``is None`` check.

Input staging: the executor path stacks each batch into a host buffer
of its padded shape, one per graph input, allocated on the shape's
first (warm) pass and rewritten in place on every later one, so a
steady-state dispatch allocates nothing.  On a CUDA device the buffers
are pinned, and the executor copies them to the card without a bounce
through a pageable staging area; it records the buffers' event after
that copy, and the next pass of the shape waits on it before writing.
Rows are cast to int32 as ``np.asarray(row, np.int32)`` casts them.
Each pass counts ``cim_service_staging_total{outcome=...}`` in an
enabled ``obs.metrics`` registry.

Thread-safety: ``stats``, the warm-shape set and the staging buffers are
plain mutable state — one service instance per serving thread.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import compiler
from ..core.abstraction import CIMArch
from ..core.graph import Graph
from ..kernels.backend import resolve_device
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..kernels.cim_mvm import CimMvmParams, cim_mvm_params
from .common import CimRequest, ServiceStats  # noqa: F401  (re-export)


@dataclasses.dataclass
class _Staging:
    """One padded batch shape's host input buffers (int32, pinned on a
    CUDA device) and the event recorded after their last copy to the
    device (``None`` on the CPU)."""

    tensors: Dict[str, torch.Tensor]
    copied: Optional["torch.cuda.Event"]


class CimBatchService:
    """Fixed-workload inference service with batched execution.

    Weights default to the deterministic test weights and shifts to one
    reference calibration pass (the §4.1 verification setup); embedders
    can pass their own ``weights``/``shifts`` (numpy arrays or tensors,
    e.g. from ``cimsim.functional.weights_from_reference``).

    ``mode`` forces the executor's crossbar-MVM route (``"compiled"`` or
    ``"torch"``); by default the registry picks it for ``device``.
    ``cache`` (a compile cache with ``get``/``put``, see
    ``core.compiler``) warm-loads the compiled plan instead of
    recompiling; the fleet's engine pool hands every tenant the same
    one.  ``compile_kwargs`` carries compiler knob overrides (binding /
    use_pipeline / use_duplication); ``level`` stays a convenience alias
    for the common single-knob case.
    """

    def __init__(self, graph: Graph, arch: CIMArch, *, level=None,
                 seed: int = 0, max_batch: int = 8,
                 params: Optional[CimMvmParams] = None,
                 weights: Optional[Dict] = None,
                 shifts: Optional[Dict[str, int]] = None,
                 use_executor: bool = True,
                 mode: Optional[str] = None,
                 device="cuda",
                 cache=None,
                 compile_kwargs: Optional[Dict] = None):
        from ..cimsim.functional import (calibrate_shifts, make_input,
                                         make_weights)
        self.device = resolve_device(device)
        self.graph = graph
        self.arch = arch
        self.max_batch = max_batch
        self.use_executor = use_executor
        self.params = params or cim_mvm_params(arch)
        self.weights = weights if weights is not None \
            else make_weights(graph, seed)
        self.shifts = shifts if shifts is not None else calibrate_shifts(
            graph, self.weights, make_input(graph, seed), self.params,
            device=self.device)
        self.stats = ServiceStats()
        self._warmed: set = set()        # batch sizes already served once
        self._staging: Dict[int, _Staging] = {}   # padded batch -> buffers
        self._traced = 0                 # traced passes: their span ids
        kwargs = dict(compile_kwargs or {})
        kwargs.setdefault("level", level)
        if use_executor:
            from ..cimsim.executor import LoweringError, lower
            res = compiler.compile_graph(graph, arch, cache=cache, **kwargs)
            try:
                self._exe = lower(res.plan, res.program, params=self.params,
                                  mode=mode, device=self.device)
                self._packed = self._exe.pack(self.weights)
            except LoweringError:
                # flow has no bit-exact fast lowering: serve op by op
                self.use_executor = use_executor = False
        if not use_executor:
            from ..cimsim.functional import FunctionalSimulator
            res = compiler.compile_graph(graph, arch, cache=cache,
                                         expand=True, **kwargs)
            self._sim = FunctionalSimulator(res.plan, res.program,
                                            self.weights, self.shifts,
                                            params=self.params,
                                            device=self.device)

    @property
    def executor_stats(self):
        """The lowered executable's ``ExecutorStats`` (segments, streamed
        weight updates, resolved kernel route), or ``None`` when the
        service degraded to the op-by-op interpreter."""
        return self._exe.stats if self.use_executor else None

    def serve(self, requests: List[CimRequest]) -> List[CimRequest]:
        """Serve ``requests`` in arrival order, ``max_batch`` at a time.

        Each batch is one executor pass.  The first pass of a new batch
        shape runs once untimed (first-use costs: kernel build, lazy
        allocations), so ``latency_s`` / ``ServiceStats`` report
        steady-state serving cost.
        """
        done: List[CimRequest] = []
        for i in range(0, len(requests), self.max_batch):
            batch = requests[i:i + self.max_batch]
            dt = self.dispatch(batch)
            for r in batch:
                r.latency_s = dt
            self.stats.record([dt] * len(batch), dt)
            done.extend(batch)
        return done

    def serve_padded(self, batch: List[CimRequest],
                     bucket: Optional[int] = None) -> float:
        """One bucket-shaped dispatch for ``len(batch) <= bucket``
        requests; returns the wall time.  The fleet batcher's entry
        point.  Fills ``outputs`` but leaves latency/stats accounting to
        the caller (the fleet adds queue wait before recording)."""
        return self.dispatch(batch, pad_to=bucket)

    def dispatch(self, batch: List[CimRequest],
                 pad_to: Optional[int] = None) -> float:
        """Serve one batch (warm-once per shape), return the wall time.
        ``pad_to`` pads the batch to that many rows by repeating the
        last one (the interpreter serves requests one by one and ignores
        it)."""
        if not batch:
            return 0.0
        shape = pad_to if (pad_to and self.use_executor) else len(batch)
        tr = obs_trace.get_trace()
        if self.use_executor and shape not in self._warmed:
            self._pass(tr, batch, pad_to, shape, warm=True)
            self._warmed.add(shape)
        t0 = time.perf_counter()
        self._pass(tr, batch, pad_to, shape)
        return time.perf_counter() - t0

    def _pass(self, tr, batch: List[CimRequest], pad_to: Optional[int],
              shape: int, warm: bool = False) -> None:
        """One pass of ``dispatch``; with a recorder ``tr``, inside its
        ``service.dispatch`` span."""
        if tr is None:
            self._serve_batch(batch, pad_to=pad_to)
            return
        self._traced += 1
        spans = obs_trace.Spans(tr, obs_trace.EXECUTOR_TRACK,
                                self.graph.name, dispatch=self._traced)
        t0 = obs_trace.now_s()
        self._serve_batch(batch, pad_to=pad_to, spans=spans)
        spans.span("service.dispatch", t0, cat="service", batch=len(batch),
                   padded_to=shape, **({"warm": True} if warm else {}))

    def _serve_batch(self, batch: List[CimRequest],
                     pad_to: Optional[int] = None, spans=None) -> None:
        if not self.use_executor:
            for r in batch:
                out = self._sim.run({k: np.asarray(v)
                                     for k, v in r.inputs.items()})
                r.outputs = {t: np.asarray(out[t]) for t in self.graph.outputs}
            return
        if spans is not None:
            t0 = obs_trace.now_s()
        st, outcome = self._stage(batch, max(pad_to or 0, len(batch)))
        obs_metrics.count("cim_service_staging_total", outcome=outcome)
        if spans is not None:
            spans.span("service.stack", t0, cat="service", staged=outcome)
        outs = self._exe.run_batch(st.tensors, packed=self._packed,
                                   shifts=self.shifts, spans=spans,
                                   inputs_copied=st.copied)
        if spans is not None:
            t0 = obs_trace.now_s()
        for i, r in enumerate(batch):
            r.outputs = {t: outs[t][i] for t in self.graph.outputs}
        if spans is not None:
            spans.span("service.answers", t0, cat="service")

    def _stage(self, batch: List[CimRequest], n: int):
        """Write ``batch``'s rows, padded to ``n`` by repeating the last,
        into the staging buffers of that shape; returns the buffers and
        whether they were ``"allocated"`` for it or ``"reused"``."""
        st = self._staging.get(n)
        if st is None:
            outcome = "allocated"
            pin = self.device.type == "cuda"
            st = self._staging[n] = _Staging(
                {name: torch.empty((n, *shape), dtype=torch.int32,
                                   pin_memory=pin)
                 for name, shape in self.graph.inputs.items()},
                torch.cuda.Event() if pin else None)
        else:
            outcome = "reused"
            if st.copied is not None:
                st.copied.synchronize()   # the last copy out has finished
        for name, buf in st.tensors.items():
            rows = [r.inputs[name] for r in batch]
            rows += [rows[-1]] * (n - len(rows))  # pad-to-bucket: repeat last
            np.stack(rows, out=buf.numpy(), casting="unsafe")
        return st, outcome
