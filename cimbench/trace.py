"""Reduction of a ``torch.profiler`` trace to the benchmark's readings.

Works on the events of a Chrome trace as ``export_chrome_trace`` writes
them (a list of dicts with ``ph``, ``cat``, ``name``, ``ts`` and ``dur``
in microseconds, ``tid``, ``args``).  Device operations are kernels,
copies and fills.  Two kinds of trace are read:

* a device trace (CUDA activity only, so the host runs at its own pace):
  its window is the span of its device operations and the host's CUDA
  calls, which a profiler schedule limits to the dispatches traced;
* a host and device trace: its window is the span of the harness's
  ``DISPATCH`` annotations, and a device operation belongs to a harness
  span when the host call that launched it (the runtime or driver event
  with the same ``correlation``) ran inside that span.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

DISPATCH = "cimbench.dispatch"
CIM_MVM = "cimbench.cim_mvm"

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


def _span(e: Dict) -> Tuple[float, float]:
    ts = float(e["ts"])
    return ts, ts + float(e.get("dur", 0.0))


def complete(events: Sequence[Dict]) -> List[Dict]:
    return [e for e in events if e.get("ph") == "X" and "ts" in e]


def annotations(events: Sequence[Dict], name: str) -> List[Dict]:
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") == name]


def window(events: Sequence[Dict]) -> Optional[Tuple[float, float]]:
    """(start, end) in microseconds of the dispatches traced: of the
    ``DISPATCH`` annotations where there are any, else of the device
    operations and the host's CUDA calls."""
    spans = [_span(e) for e in annotations(events, DISPATCH)] or \
        [_span(e) for e in events
         if e.get("cat") in DEVICE_CATS + LAUNCH_CATS]
    if not spans:
        return None
    return min(s for s, _ in spans), max(e for _, e in spans)


def device_ops(events: Sequence[Dict], win: Tuple[float, float]
               ) -> List[Dict]:
    """Kernels, copies and fills that start inside ``win``."""
    lo, hi = win
    return [e for e in events if e.get("cat") in DEVICE_CATS
            and lo <= float(e["ts"]) < hi]


def merged(spans: Sequence[Tuple[float, float]],
           win: Tuple[float, float]) -> List[Tuple[float, float]]:
    """``spans`` clipped to ``win`` and merged where they overlap."""
    lo, hi = win
    out: List[Tuple[float, float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in spans):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_us(ops: Sequence[Dict], win: Tuple[float, float]) -> float:
    """Microseconds of ``win`` in which some device operation ran."""
    return sum(e - s for s, e in merged([_span(o) for o in ops], win))


def launched_in(events: Sequence[Dict], ops: Sequence[Dict],
                span_name: str) -> List[Dict]:
    """The device operations of ``ops`` whose launching host call ran
    inside a ``span_name`` annotation on the same thread."""
    spans: Dict = {}
    for a in annotations(events, span_name):
        spans.setdefault(a.get("tid"), []).append(_span(a))
    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e
    out = []
    for o in ops:
        host = launch.get(o.get("args", {}).get("correlation"))
        if host is None:
            continue
        t = float(host["ts"])
        if any(s <= t <= e for s, e in spans.get(host.get("tid"), ())):
            out.append(o)
    return out


def top_ops(ops: Sequence[Dict], n: int = 10) -> List[List]:
    """[name, seconds] of the ``n`` device operations that took most
    time, summed by name."""
    total: Dict[str, float] = {}
    for o in ops:
        total[o["name"]] = total.get(o["name"], 0.0) + float(o["dur"]) / 1e6
    return [[k[:96], v] for k, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events: Sequence[Dict], ops: Sequence[Dict],
              win: Tuple[float, float], n: int = 10) -> List[List]:
    """[name, seconds] of the device's idle time inside ``win``, summed
    by what the host was doing when each gap began: the innermost host
    event open at that moment, or ``host`` where the trace holds none
    (the program's own Python and numpy, in a device trace)."""
    busy = merged([_span(o) for o in ops], win)
    gaps, t = [], win[0]
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < win[1]:
        gaps.append((t, win[1]))
    host = sorted(((*_span(e), e["name"]) for e in events
                   if e.get("cat") in HOST_CATS),
                  key=lambda h: (h[0], -h[1]))
    total: Dict[str, float] = {}
    # one sweep: ``open_`` holds the host events open at the current
    # moment, outermost first (the dispatching thread's events nest)
    open_: List[Tuple[float, float, str]] = []
    i = 0
    for s, e in gaps:
        while i < len(host) and host[i][0] <= s:
            while open_ and open_[-1][1] <= host[i][0]:
                open_.pop()
            open_.append(host[i])
            i += 1
        while open_ and open_[-1][1] <= s:
            open_.pop()
        name = open_[-1][2] if open_ else "host"
        total[name] = total.get(name, 0.0) + (e - s) / 1e6
    return [[k[:96], v] for k, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:n]]
