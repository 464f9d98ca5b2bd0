"""Chrome-trace recording for every tier — one Perfetto timeline.

``TraceRecorder`` collects Chrome Trace Event Format events (the JSON
consumed by ``chrome://tracing`` and https://ui.perfetto.dev).  It grew
up in the serving tier (fleet batcher waits, engine dispatches,
migrations), and is now the stack-wide sink: the compiler, the trace-lowered
executor and the DSE drivers emit onto the same recorder under
**reserved track names**, so a DSE campaign, its compiles and the
fleet run they feed land in one timeline with distinct process rows.

Mapping onto the trace model:

  * **process (pid)** = one *track*: a CIM chip for serving events, or
    one of the reserved tracks ``compiler`` / ``executor`` / ``dse``
    for the other tiers (``register_chip`` assigns pids and emits the
    ``process_name`` metadata either way);
  * **thread (tid)**  = one tenant on that chip — or, on the reserved
    tracks, one workload — plus tid 0 for track-level control events;
  * **complete events (``ph: "X"``)** = spans: queue waits, engine
    dispatches, compiles, executor dispatches, DSE rung batches;
  * **instant events (``ph: "i"``)** = points: admission rejections,
    re-plan triggers, searcher rounds;
  * **counter events (``ph: "C"``)** = sampled series (utilization,
    queue depth) — ``args`` values must be numbers;
  * **flow events (``ph: "s"/"t"/"f"``)** = cross-track arrows sharing
    an ``id``: a compile's flow start binds to the executor dispatch
    that first runs the artifact.

Units and clocks: the recorder's timeline is whatever clock the caller
drives — the serving tier passes its service clock (wall time in
production, synthetic in tests); the compiler/executor/DSE hooks and
the CIM service's dispatch spans use the process clock started by
:func:`install` (``now_s``, ``time.perf_counter`` since then).  Under a
wall clock all tiers coincide; under a synthetic service clock the
serving rows show the model's own accounting next to the host-side
rows.  Event ``ts``/``dur`` are emitted in **microseconds** as the
format requires.

One clock with ``torch.profiler``: :func:`install` reads
``time.perf_counter`` and ``time.time_ns`` together, stores the Unix
time on the recorder (``anchor``), and the saved trace carries it under
``otherData["clock"]``.  ``ts0_unix_ns`` is the Unix time of ``ts`` 0 of
the process clock, so a span's Unix time is ``ts0_unix_ns + ts * 1000``
and its place on a Kineto trace's timeline is that less the trace's
``baseTimeNanoseconds``, over 1000 (a ``torch.profiler`` export, CPU or
CUDA activity, counts its ``ts`` from that base on the Unix clock).

Thread-safety: a recorder is plain mutable state owned by one thread;
share one recorder across the tiers of one run, not across concurrent
runs.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

#: event phases this layer emits (subset of the trace format):
#: complete, instant, counter, metadata, flow start/step/end
_PHASES = ("X", "i", "C", "M", "s", "t", "f")

#: the flow-event subset (requires an ``id`` binding the arrow's ends)
_FLOW_PHASES = ("s", "t", "f")

#: fields every emitted event carries (the format's required core)
_REQUIRED = ("name", "ph", "ts", "pid", "tid")

#: reserved track (pseudo-chip) names the non-serving tiers emit under
COMPILER_TRACK = "compiler"
EXECUTOR_TRACK = "executor"
DSE_TRACK = "dse"


def _us(t_s: float) -> float:
    """Clock seconds -> trace microseconds (float is allowed)."""
    return round(t_s * 1e6, 3)


class TraceRecorder:
    """Accumulates Chrome-trace events for one run.

    All ``*_s`` arguments are clock seconds (see module docstring);
    ``args`` values must be JSON-serializable.  Not thread-safe — one
    recorder per driving thread.
    """

    def __init__(self):
        self.events: List[dict] = []
        #: ``{"ts0_unix_ns": ...}``, set by :func:`install`: the Unix
        #: time of ``ts`` 0 of the process clock
        self.anchor: Optional[Dict[str, int]] = None
        self._pids: Dict[str, int] = {}          # track name -> pid
        self._tids: Dict[tuple, int] = {}        # (pid, tenant) -> tid

    # -- registry --------------------------------------------------------
    def register_chip(self, chip: str) -> int:
        """Assign (or return) the pid for track ``chip``; emits
        process_name metadata on first registration."""
        if chip not in self._pids:
            pid = len(self._pids) + 1
            self._pids[chip] = pid
            label = chip if chip in (COMPILER_TRACK, EXECUTOR_TRACK,
                                     DSE_TRACK) else f"chip:{chip}"
            self.events.append({"name": "process_name", "ph": "M",
                                "ts": 0, "pid": pid, "tid": 0,
                                "args": {"name": label}})
        return self._pids[chip]

    def register_tenant(self, chip: str, tenant: str) -> int:
        """Assign (or return) the tid for ``tenant`` on ``chip``; emits
        thread_name metadata on first registration (tid 0 is reserved
        for track-level control events)."""
        pid = self.register_chip(chip)
        key = (pid, tenant)
        if key not in self._tids:
            tid = 1 + sum(1 for (p, _) in self._tids if p == pid)
            self._tids[key] = tid
            self.events.append({"name": "thread_name", "ph": "M",
                                "ts": 0, "pid": pid, "tid": tid,
                                "args": {"name": f"tenant:{tenant}"}})
        return self._tids[key]

    # -- emitters --------------------------------------------------------
    def complete(self, chip: str, tenant: str, name: str, cat: str,
                 ts_s: float, dur_s: float, **args) -> None:
        """One span (``ph: "X"``): starts at ``ts_s``, lasts ``dur_s``
        (clock seconds; negative durations are clamped to 0)."""
        self._complete(self.register_chip(chip),
                       self.register_tenant(chip, tenant), name, cat, ts_s,
                       dur_s, args)

    def _complete(self, pid: int, tid: int, name: str, cat: str,
                  ts_s: float, dur_s: float, args: dict) -> None:
        """``complete`` on a registered row (``Spans`` keeps its ids)."""
        self.events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": _us(ts_s), "dur": _us(max(0.0, dur_s)),
            "pid": pid, "tid": tid, "args": args})

    def instant(self, chip: str, name: str, cat: str, ts_s: float,
                tenant: Optional[str] = None, **args) -> None:
        """One point event (``ph: "i"``, thread scope); track-level when
        ``tenant`` is None (tid 0)."""
        tid = (self.register_tenant(chip, tenant) if tenant is not None
               else (self.register_chip(chip), 0)[1])
        self.events.append({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": _us(ts_s), "pid": self.register_chip(chip),
            "tid": tid, "args": args})

    def counter(self, chip: str, name: str, ts_s: float,
                values: Dict[str, float]) -> None:
        """One counter sample (``ph: "C"``): ``values`` maps series name
        to a number (e.g. ``{"utilization": 0.73}``)."""
        self.events.append({
            "name": name, "cat": "counter", "ph": "C",
            "ts": _us(ts_s), "pid": self.register_chip(chip),
            "tid": 0, "args": dict(values)})

    def flow(self, phase: str, chip: str, tenant: str, name: str,
             cat: str, ts_s: float, flow_id: int, **args) -> None:
        """One flow event (``ph: "s"/"t"/"f"``) — the cross-track arrow
        primitive.  All ends sharing ``flow_id`` are drawn as one flow;
        the end event binds to its enclosing slice (``bp: "e"``)."""
        if phase not in _FLOW_PHASES:
            raise ValueError(f"flow phase must be one of {_FLOW_PHASES}, "
                             f"got {phase!r}")
        ev = {"name": name, "cat": cat, "ph": phase,
              "ts": _us(ts_s), "pid": self.register_chip(chip),
              "tid": self.register_tenant(chip, tenant),
              "id": int(flow_id), "args": args}
        if phase == "f":
            ev["bp"] = "e"
        self.events.append(ev)

    def flow_start(self, chip: str, tenant: str, name: str, cat: str,
                   ts_s: float, flow_id: int, **args) -> None:
        self.flow("s", chip, tenant, name, cat, ts_s, flow_id, **args)

    def flow_end(self, chip: str, tenant: str, name: str, cat: str,
                 ts_s: float, flow_id: int, **args) -> None:
        self.flow("f", chip, tenant, name, cat, ts_s, flow_id, **args)

    # -- output ----------------------------------------------------------
    def to_dict(self) -> dict:
        """The JSON-object trace (``traceEvents`` array form) — the shape
        both ``chrome://tracing`` and Perfetto load directly."""
        out = {"traceEvents": list(self.events), "displayTimeUnit": "ms"}
        if self.anchor is not None:
            out["otherData"] = {"clock": dict(self.anchor)}
        return out

    def save(self, path: Union[str, Path]) -> Path:
        """Write the trace as JSON **atomically** (write-temp-then-rename,
        same directory so the rename never crosses filesystems): a
        killed benchmark leaves either the previous trace or the new
        one, never a truncated file Perfetto rejects.  Returns the
        path; load it in https://ui.perfetto.dev ("Open trace file") or
        chrome://tracing."""
        path = Path(path)
        data = (json.dumps(self.to_dict()) + "\n").encode("utf-8")
        fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                                   prefix=path.name + ".", suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    def __len__(self) -> int:
        return len(self.events)


class Spans:
    """The spans of one dispatch, on one thread row of ``recorder``.

    Timed on the process clock (``now_s``); every span carries ``ids``
    (e.g. ``dispatch=7``) in its ``args``.  Built only while a recorder
    is installed, so an untraced dispatch makes none.
    """

    __slots__ = ("recorder", "pid", "tid", "ids")

    def __init__(self, recorder: TraceRecorder, chip: str, tenant: str,
                 **ids):
        self.recorder = recorder
        self.pid = recorder.register_chip(chip)
        self.tid = recorder.register_tenant(chip, tenant)
        self.ids = ids

    def span(self, name: str, t0: float, /, cat: str = "executor",
             **args) -> float:
        """One span ``name`` from ``t0`` (``now_s`` seconds) to now;
        returns now, the next span's start."""
        t = now_s()
        self.recorder._complete(self.pid, self.tid, name, cat, t0, t - t0,
                                {**self.ids, **args})
        return t


def validate_chrome_trace(trace: dict) -> None:
    """Validate ``trace`` against the Chrome Trace Event Format subset
    this layer emits; raises ``ValueError`` with the first violation.

    Checks the JSON-object form (``traceEvents`` array), per-event
    required fields, known phases, numeric non-negative timestamps,
    ``dur`` on complete events, counter ``args`` being non-empty
    number-valued objects, flow events carrying an ``id``, and ``args``
    being JSON objects — the properties Perfetto's importer actually
    relies on.
    """
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be a JSON object with 'traceEvents'")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be an array")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        for field in _REQUIRED:
            if field not in ev:
                raise ValueError(f"event {i}: missing field {field!r}")
        if ev["ph"] not in _PHASES:
            raise ValueError(f"event {i}: unknown phase {ev['ph']!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise ValueError(f"event {i}: bad ts {ev['ts']!r}")
        for field in ("pid", "tid"):
            if not isinstance(ev[field], int):
                raise ValueError(f"event {i}: {field} must be an int")
        if ev["ph"] == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"event {i}: complete event needs dur >= 0")
        if ev["ph"] == "C":
            args = ev.get("args")
            if not args or not isinstance(args, dict):
                raise ValueError(f"event {i}: counter event needs args "
                                 f"values")
            for k, v in args.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise ValueError(
                        f"event {i}: counter series {k!r} must be a "
                        f"number, got {v!r}")
        if ev["ph"] in _FLOW_PHASES:
            if not isinstance(ev.get("id"), (int, str)):
                raise ValueError(f"event {i}: flow event needs an 'id'")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"event {i}: args must be an object")
    # one timeline: metadata aside, events must carry registered pids
    pids = {ev["pid"] for ev in events if ev["ph"] == "M"}
    for i, ev in enumerate(events):
        if ev["ph"] != "M" and pids and ev["pid"] not in pids:
            raise ValueError(f"event {i}: pid {ev['pid']} never registered")


def load_trace(path: Union[str, Path]) -> dict:
    """Read a trace JSON file and validate it; returns the trace dict."""
    trace = json.loads(Path(path).read_text(encoding="utf-8"))
    validate_chrome_trace(trace)
    return trace


# ---------------------------------------------------------------------------
# Process-wide recorder (the compiler/executor/DSE hook sink)
# ---------------------------------------------------------------------------

_TRACE: Optional[TraceRecorder] = None
_T0: float = 0.0


def install(recorder: Optional[TraceRecorder] = None) -> TraceRecorder:
    """Install ``recorder`` (or a fresh one) as the process-wide sink
    the compiler/executor/DSE hooks emit to, and start the process
    clock ``now_s`` runs on; returns the installed recorder.  Pass the
    same recorder to a fleet/cluster's ``trace=`` to merge serving
    events into the identical timeline."""
    global _TRACE, _T0
    _TRACE = recorder if recorder is not None else TraceRecorder()
    # one reading of each clock, back to back: perf_counter is the
    # spans' clock, the Unix time the profiler's
    _T0 = time.perf_counter()
    _TRACE.anchor = {"ts0_unix_ns": time.time_ns()}
    return _TRACE


def uninstall() -> Optional[TraceRecorder]:
    """Remove the process-wide recorder (tracing off); returns it."""
    global _TRACE
    prev, _TRACE = _TRACE, None
    return prev


def get_trace() -> Optional[TraceRecorder]:
    """The installed recorder, or ``None`` when tracing is disabled —
    hot paths gate all emission on this single check."""
    return _TRACE


def now_s() -> float:
    """Seconds on the process clock started by :func:`install`."""
    return time.perf_counter() - _T0
