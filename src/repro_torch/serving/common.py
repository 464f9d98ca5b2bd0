"""Shared serving primitives: request shapes and latency accounting.

One set of dataclasses serves both frontends — the LM batch server
(``serving.server``) and the CIM fleet (``serving.cim_service`` /
``serving.fleet``) — so request identity, deadlines and latency
bookkeeping cannot drift between them:

  * ``BaseRequest`` — identity + timing fields every service shares;
  * ``CimRequest`` — one CIM inference (unbatched graph inputs/outputs);
  * ``LmRequest``  — one LM generation (prompt -> token list);
  * ``ServiceStats`` — per-service accounting with an explicit
    cumulative/windowed split: all-time counters next to windowed
    p50/p95 tail latency over recent requests.

Timing model: ``arrival_s`` / ``deadline_s`` live on one caller-chosen
clock (wall time by default; tests may inject a synthetic ``now``).
``latency_s`` is filled by the serving layer — queue wait plus batch
execution for fleet-routed requests, execution only for direct
``serve()`` calls.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class BaseRequest:
    """Base request: identity plus the timing fields every service shares.

    The timing fields are keyword-only so subclass payloads keep their
    historical positional slot right after ``rid`` (``CimRequest(3,
    inputs)`` / ``LmRequest(1, prompt)`` still bind the payload, never a
    clock field).
    """

    rid: int
    # submission time (service clock)
    arrival_s: float = dataclasses.field(default=0.0, kw_only=True)
    # absolute deadline, same clock
    deadline_s: Optional[float] = dataclasses.field(default=None,
                                                    kw_only=True)
    # filled by the service
    latency_s: float = dataclasses.field(default=0.0, kw_only=True)
    # set once the miss has been counted into some ServiceStats — a
    # request that is evicted past-deadline during migration and later
    # completes (or is evicted twice) must be counted exactly once
    miss_recorded: bool = dataclasses.field(default=False, kw_only=True)

    def missed_deadline(self, completion_s: float) -> bool:
        return self.deadline_s is not None and completion_s > self.deadline_s


@dataclasses.dataclass
class CimRequest(BaseRequest):
    """One CIM inference request (unbatched graph inputs)."""

    inputs: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    model: Optional[str] = None          # tenant id (fleet routing key)
    # filled by the service:
    outputs: Optional[Dict[str, np.ndarray]] = None


@dataclasses.dataclass
class LmRequest(BaseRequest):
    """One LM generation request (prompt in, greedy tokens out)."""

    prompt: Optional[np.ndarray] = None  # (prompt_len,) int32
    max_new_tokens: int = 16
    eos: Optional[int] = None
    # filled by the server:
    output: Optional[List[int]] = None


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (0 for an empty list) — small-sample
    friendly: p95 of 10 requests is the 10th value, not an interpolation
    between observations that never happened."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = max(1, int(np.ceil(q / 100.0 * len(ordered))))
    return ordered[rank - 1]


#: per-service cap on retained latencies: tails are computed over the
#: most recent window so long-running fleets stay O(1) in memory and the
#: percentiles track current behavior, not all-time history
LATENCY_WINDOW = 4096


@dataclasses.dataclass
class ServiceStats:
    """Throughput counters + tail-latency accounting for one service.

    The bundle holds two kinds of state, and the split is part of the
    contract:

      * **cumulative** (all-time, monotone): ``requests``, ``batches``,
        ``serve_s`` and ``deadline_misses`` count everything the service
        ever did — dashboards diff them across scrapes;
      * **windowed** (recent, bounded): ``window_latencies_s`` and
        ``window_missed`` retain only the most recent ``LATENCY_WINDOW``
        requests, so ``p50_latency_s`` / ``p95_latency_s`` /
        ``window_deadline_misses`` describe *current* traffic and a
        long-running fleet stays O(1) in memory.

    Units and clocks: latencies and ``serve_s`` are **seconds on the
    service clock** the caller drives (wall time by default, synthetic
    in tests/benchmarks) — never compiler cycles.  Thread-safety: plain
    mutable state owned by one service on one thread; ``merge`` returns
    a new bundle and mutates neither operand.
    """

    requests: int = 0                    # cumulative served requests
    batches: int = 0                     # cumulative dispatched batches
    serve_s: float = 0.0                 # cumulative busy seconds
    deadline_misses: int = 0             # cumulative missed deadlines
    #: sliding window of recent per-request latencies (seconds)
    window_latencies_s: List[float] = dataclasses.field(default_factory=list)
    #: window of recent per-request miss flags.  Served requests append
    #: in lockstep with ``window_latencies_s``; misses discovered
    #: outside a batch (``record_misses`` — e.g. eviction during
    #: migration) append here only, so the two windows may differ in
    #: length while ``window_deadline_misses`` stays complete.
    window_missed: List[bool] = dataclasses.field(default_factory=list)

    def record(self, latencies_s: List[float], batch_s: float,
               misses: int = 0,
               missed: Optional[List[bool]] = None) -> None:
        """Account one served batch: per-request latencies (seconds) +
        batch busy seconds.  ``missed`` optionally flags which of the
        batch's requests missed their deadline (defaults to the first
        ``misses`` positions, which preserves the windowed count)."""
        self.requests += len(latencies_s)
        self.batches += 1
        self.serve_s += batch_s
        self.deadline_misses += misses
        if missed is None:
            missed = [i < misses for i in range(len(latencies_s))]
        self.window_latencies_s.extend(latencies_s)
        self.window_missed.extend(missed)
        del self.window_latencies_s[:-LATENCY_WINDOW]
        del self.window_missed[:-LATENCY_WINDOW]

    def record_misses(self, n: int) -> None:
        """Account ``n`` deadline misses discovered outside a served
        batch — requests evicted past-deadline during migration or
        chip failover never reach ``record``, and silently dropping
        their misses undercounts both the cumulative and the windowed
        counters.  No latency is recorded (none was measured)."""
        if n <= 0:
            return
        self.deadline_misses += n
        self.window_missed.extend([True] * n)
        del self.window_missed[:-LATENCY_WINDOW]

    @property
    def requests_per_s(self) -> float:
        """Cumulative throughput: all-time requests over busy seconds."""
        return self.requests / self.serve_s if self.serve_s > 0 else 0.0

    @property
    def p50_latency_s(self) -> float:
        """Median latency over the recent window (seconds)."""
        return percentile(self.window_latencies_s, 50.0)

    @property
    def p95_latency_s(self) -> float:
        """Tail latency over the recent window (seconds)."""
        return percentile(self.window_latencies_s, 95.0)

    @property
    def window_deadline_misses(self) -> int:
        """Missed deadlines among the window's requests (recent, not
        all-time — compare with cumulative ``deadline_misses``)."""
        return sum(self.window_missed)

    def merge(self, other: "ServiceStats") -> "ServiceStats":
        """Combine two bundles (fleet aggregate view): cumulative
        counters add; the merged window keeps the most recent
        ``LATENCY_WINDOW`` entries of the concatenation."""
        return ServiceStats(
            requests=self.requests + other.requests,
            batches=self.batches + other.batches,
            serve_s=self.serve_s + other.serve_s,
            deadline_misses=self.deadline_misses + other.deadline_misses,
            window_latencies_s=(self.window_latencies_s
                                + other.window_latencies_s)[-LATENCY_WINDOW:],
            window_missed=(self.window_missed
                           + other.window_missed)[-LATENCY_WINDOW:])
