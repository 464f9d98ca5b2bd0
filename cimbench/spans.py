"""The program's own spans of a CIM dispatch, laid on the device trace.

With a ``TraceRecorder`` installed (``repro_torch.obs.trace.install``),
``CimBatchService.dispatch`` and the executor under it emit one span at
each layer boundary of a pass, all on one thread row, each carrying the
pass's ``dispatch`` id in ``args``:

    service.dispatch            (batch, padded_to; warm on a first pass)
      service.stack             the rows stacked and padded
      dispatch:<graph>          the executor's pass (batch, route, ...)
        executor.inputs         host arrays to the device (bytes)
        executor.forward        issuing the graph
          <op_type>             one per graph node (node, cim)
            cim_mvm             one per kernel launch (t, m, r, c, route)
            executor.host_dcom  a float op's host round trip (bytes)
        executor.outputs        the served tensors to numpy (bytes)
      service.answers           each row handed to its request

The recorder's saved trace carries the Unix time of its clock's zero
(``otherData["clock"]["ts0_unix_ns"]``); ``program_spans`` moves the
spans onto a ``torch.profiler`` trace's timeline with it, so each idle
gap of the device can be charged to the span open across it
(``idle_by_span``) rather than to the runtime call open where it began
(``trace.idle_gaps``).

``span_trace`` runs the phase: dispatches with a fresh recorder
installed, under a profiler with CUDA activity only (none on the CPU).
``readings`` reduces it to per-layer numbers.  A program that emits
none of these spans gives readings of ``None``.  The harness does not
call them yet.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

from cimbench import trace

SERVICE = "service.dispatch"
EXECUTOR = "dispatch:"            # prefix: ``dispatch:<graph>``
INPUTS = "executor.inputs"
FORWARD = "executor.forward"
OUTPUTS = "executor.outputs"
CIM_MVM = "cim_mvm"
HOST_DCOM = "executor.host_dcom"
#: the name ``idle_by_span`` gives time in no program span
OUTSIDE = "outside"


# -- spans on the profiler's timeline ----------------------------------------

def program_spans(recorded: Dict, base_ns: Optional[int]) -> List[Dict]:
    """The complete events of a recorder's saved trace (``to_dict()``),
    with ``ts`` moved onto the timeline of a profiler trace whose
    ``baseTimeNanoseconds`` is ``base_ns``; as recorded where ``base_ns``
    is ``None``, and none where the trace has no clock anchor."""
    events = [e for e in recorded.get("traceEvents", ())
              if e.get("ph") == "X"]
    if base_ns is None:
        return [dict(e) for e in events]
    clock = recorded.get("otherData", {}).get("clock")
    if clock is None:
        return []
    # the two large integers first, so no float rounds them
    shift = (int(clock["ts0_unix_ns"]) - int(base_ns)) / 1e3
    return [dict(e, ts=float(e["ts"]) + shift) for e in events]


def _innermost(spans: Sequence[Dict], win: Tuple[float, float]
               ) -> List[Tuple[float, float, str]]:
    """``win`` cut into (start, end, name) pieces, each named by the
    innermost of ``spans`` (which nest, as one thread's do) open there,
    or ``OUTSIDE``."""
    lo, hi = win
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []          # (end, name), outermost first
    t = lo

    def upto(x: float) -> None:
        nonlocal t
        x = min(max(x, lo), hi)
        if x > t:
            out.append((t, x, stack[-1][1] if stack else OUTSIDE))
            t = x

    for s, e, name in sorted(((*trace._span(sp), sp["name"])
                              for sp in spans),
                             key=lambda v: (v[0], -v[1])):
        while stack and stack[-1][0] <= s:
            upto(stack[-1][0])
            stack.pop()
        upto(s)
        stack.append((e, name))
    while stack:
        upto(stack[-1][0])
        stack.pop()
    upto(hi)
    return out


def idle_by_span(spans: Sequence[Dict], ops: Sequence[Dict],
                 win: Tuple[float, float]) -> Dict[str, float]:
    """Seconds of the device's idle time inside ``win``, by the program
    span open across it: each gap between device operations is split by
    time over the spans it crosses, the innermost span taking each
    stretch, and time in no span counts as ``OUTSIDE``.  The values sum
    to the window's idle time."""
    gaps, t = [], win[0]
    for s, e in trace.merged([trace._span(o) for o in ops], win):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < win[1]:
        gaps.append((t, win[1]))
    total: Dict[str, float] = {}
    pieces = _innermost(spans, win)
    i = 0
    for s, e in gaps:
        while i < len(pieces) and pieces[i][1] <= s:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < e:
            ps, pe, name = pieces[j]
            d = min(e, pe) - max(s, ps)
            if d > 0:
                total[name] = total.get(name, 0.0) + d / 1e6
            j += 1
    return total


# -- the phase ------------------------------------------------------------------

@dataclasses.dataclass
class SpanPhase:
    """One phase of traced dispatches."""

    #: the program's spans, on the profiler's timeline (microseconds),
    #: or as recorded where no profiler ran
    spans: List[Dict]
    #: the profiler's complete events (CUDA activity only); none on
    #: the CPU
    events: List[Dict]
    #: (pool indices, requests) of each dispatch, for the check
    done: List


def _export(prof) -> Dict:
    """The whole trace ``prof`` exports, ``baseTimeNanoseconds`` kept."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def span_trace(svc, reqs, draw, k: int, cuda: bool) -> SpanPhase:
    """``k`` dispatches with a fresh recorder installed; on a card under
    a profiler with CUDA activity only, after one dispatch that starts
    it up (as ``harness._device_trace`` traces), with the recorder
    installed from the first of the ``k``."""
    from repro_torch.obs import trace as obs_trace
    done: List = []
    if not cuda:
        rec = obs_trace.install()
        try:
            for _ in range(k):
                idx = next(draw)
                batch = reqs(idx)
                svc.dispatch(batch)
                done.append((idx, batch))
        finally:
            obs_trace.uninstall()
        return SpanPhase(program_spans(rec.to_dict(), None), [], done)
    from torch.profiler import ProfilerActivity, profile, schedule
    out: List[Dict] = []
    try:
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=k, repeat=1),
                     on_trace_ready=lambda p: out.append(_export(p))
                     ) as prof:
            for i in range(1 + k):
                if i == 1:
                    rec = obs_trace.install()
                idx = next(draw)
                batch = reqs(idx)
                svc.dispatch(batch)
                if i:
                    done.append((idx, batch))
                prof.step()
    finally:
        obs_trace.uninstall()
    data = out[0] if out else {"traceEvents": []}
    return SpanPhase(program_spans(rec.to_dict(),
                                   data.get("baseTimeNanoseconds")),
                     trace.complete(data["traceEvents"]), done)


# -- readings -------------------------------------------------------------------

def _kind(name: str) -> str:
    """The share of ``readings`` an idle stretch under span ``name``
    counts towards."""
    if name in (INPUTS, OUTPUTS):
        return "copying"
    if name == OUTSIDE or name.startswith(("service.", EXECUTOR)):
        return "service"
    return "issuing"          # executor.forward and every span under it


def _timed(phase: SpanPhase):
    """The phase's ``service.dispatch`` spans of timed passes by id, the
    spans of those passes, and their window: first start to last end."""
    svc = {s["args"]["dispatch"]: s for s in phase.spans
           if s["name"] == SERVICE and not s["args"].get("warm")}
    mine = [s for s in phase.spans
            if s.get("args", {}).get("dispatch") in svc]
    win = None
    if svc:
        win = (min(float(s["ts"]) for s in svc.values()),
               max(trace._span(s)[1] for s in svc.values()))
    return svc, mine, win


def readings(phase: SpanPhase) -> Dict[str, Optional[float]]:
    """The per-layer numbers of a span phase, ``None`` where it has
    nothing to read (no spans; no device trace for the idle shares):

    * ``service_self_ms``: ``service.dispatch`` less its executor pass;
    * ``executor_input_ms``, ``executor_issue_ms``,
      ``executor_output_wait_ms``: ``executor.inputs``, ``.forward``,
      ``.outputs``; each per dispatch;
    * ``idle_issuing_pct``, ``idle_copying_pct``, ``idle_service_pct``:
      shares of the phase's window (first ``service.dispatch`` start to
      last end) with the device idle inside ``executor.forward`` or a
      span under it; inside ``executor.inputs`` or ``.outputs``; and
      anywhere else (``service.*`` and the executor pass's own time
      between its children, or no span).  They sum to ``idle_pct``;
    * ``runtime_in_dispatch_pct``: the share of the trace's CUDA runtime
      calls that start inside a ``service.dispatch`` span, the check of
      the two clocks' alignment;
    * counts per dispatch from span ``args``: ``launches``,
      ``host_round_trips``, ``input_bytes``, ``output_bytes``.
    """
    names = ("service_self_ms", "executor_input_ms", "executor_issue_ms",
             "executor_output_wait_ms", "idle_issuing_pct",
             "idle_copying_pct", "idle_service_pct", "idle_pct",
             "runtime_in_dispatch_pct", "launches", "host_round_trips",
             "input_bytes", "output_bytes")
    out: Dict[str, Optional[float]] = dict.fromkeys(names)
    svc, mine, win = _timed(phase)
    if not svc:
        return out
    n = len(svc)

    def total(name: str, field: str = "dur") -> float:
        return sum(float(s["dur"]) if field == "dur" else s["args"][field]
                   for s in mine if s["name"] == name)

    exe = {s["args"]["dispatch"]: float(s["dur"]) for s in mine
           if s["name"].startswith(EXECUTOR)}
    if set(exe) == set(svc):
        out["service_self_ms"] = sum(
            float(s["dur"]) - exe[i] for i, s in svc.items()) / n / 1e3
    for key, name in (("executor_input_ms", INPUTS),
                      ("executor_issue_ms", FORWARD),
                      ("executor_output_wait_ms", OUTPUTS)):
        if any(s["name"] == name for s in mine):
            out[key] = total(name) / n / 1e3
    out["launches"] = sum(s["name"] == CIM_MVM for s in mine) / n
    out["host_round_trips"] = sum(s["name"] == HOST_DCOM for s in mine) / n
    if out["executor_input_ms"] is not None:
        out["input_bytes"] = total(INPUTS, "bytes") / n
        out["output_bytes"] = total(OUTPUTS, "bytes") / n
    width = win[1] - win[0]
    if not phase.events or width <= 0:
        return out
    ops = trace.device_ops(phase.events, win)
    idle = idle_by_span(mine, ops, win)
    for kind in ("issuing", "copying", "service"):
        out[f"idle_{kind}_pct"] = 100.0 * sum(
            v for k, v in idle.items() if _kind(k) == kind) * 1e6 / width
    out["idle_pct"] = 100.0 * (1.0 - trace.busy_us(ops, win) / width)
    calls = [float(e["ts"]) for e in phase.events
             if e.get("cat") == "cuda_runtime"]
    inside = [trace._span(s) for s in svc.values()]
    if calls:
        out["runtime_in_dispatch_pct"] = 100.0 * sum(
            any(a <= t <= b for a, b in inside) for t in calls) / len(calls)
    return out
