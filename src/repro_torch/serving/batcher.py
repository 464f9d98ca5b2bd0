"""Deadline-aware dynamic batching with bucketed batch sizes.

One ``DynamicBatcher`` fronts one tenant's engine.  Requests accumulate
in an earliest-deadline-first queue; a batch is released when any of
three conditions holds:

  * **full bucket** — the queue can fill the largest bucket, so waiting
    longer cannot improve packing;
  * **age** — the oldest request has waited ``max_wait_s``, the classic
    dynamic-batching knob bounding added latency under light traffic;
  * **deadline pressure** — the earliest absolute deadline minus the
    estimated service time of the would-be batch says dispatching any
    later would miss it.

Batch sizes are *bucketed* (default powers of two up to the engine's
``max_batch``): a drained batch of 3 is padded up to the 4-bucket by the
engine (``CimBatchService.serve_padded``), so only ``len(buckets)``
batch shapes ever run per tenant — ragged queue lengths reuse a warm
batch shape instead of paying first-use costs for each.

The batcher is clock-agnostic: every decision takes an explicit ``now``
so fleets can run on wall time while tests drive a synthetic clock.
All times (``now``, ``max_wait_s``, ``est_batch_s``, deadlines) are
**seconds on that one caller-chosen clock** — never compiler cycles.
Thread-safety: plain mutable queue state, not locked; one batcher is
owned by one fleet thread.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Union

from .common import CimRequest

#: default bucket ladder (powers of two; the engine's max_batch caps it)
DEFAULT_BUCKETS = (1, 2, 4, 8)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (the largest bucket for oversized n)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


@dataclasses.dataclass
class Batch:
    """One released batch: the requests plus the executable bucket."""

    requests: List[CimRequest]
    bucket: int
    reason: str                      # "full" | "age" | "deadline" | "flush"

    def __len__(self) -> int:
        return len(self.requests)


class DynamicBatcher:
    """EDF queue + bucketed release policy for one tenant."""

    def __init__(self, *, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_s: float = 0.002,
                 est_batch_s: Union[float, None,
                                    Callable[[int], Optional[float]]] = 0.0):
        """``est_batch_s`` estimates the service time of a batch of the
        given bucket size (constant or callable).  ``None`` (or a
        callable returning ``None``) means *unknown* — deadlined work is
        then released immediately rather than gambling on a wait."""
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(f"buckets must be sorted unique, got {buckets}")
        self.buckets = tuple(int(b) for b in buckets)
        self.max_wait_s = max_wait_s
        self._est = (est_batch_s if callable(est_batch_s)
                     else (lambda n, c=est_batch_s: c))
        self.queue: List[CimRequest] = []

    def __len__(self) -> int:
        return len(self.queue)

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def submit(self, req: CimRequest) -> None:
        self.queue.append(req)

    def _edf_order(self) -> List[CimRequest]:
        """Earliest deadline first; deadline-free requests by arrival."""
        return sorted(self.queue,
                      key=lambda r: (r.deadline_s if r.deadline_s is not None
                                     else float("inf"), r.arrival_s, r.rid))

    def release_reason(self, now: float) -> Optional[str]:
        """Why a batch should be released at ``now`` (None: keep waiting)."""
        if not self.queue:
            return None
        if len(self.queue) >= self.max_bucket:
            return "full"
        if now - min(r.arrival_s for r in self.queue) >= self.max_wait_s:
            return "age"
        deadlines = [r.deadline_s for r in self.queue
                     if r.deadline_s is not None]
        if deadlines:
            est = self._est(bucket_for(len(self.queue), self.buckets))
            # unknown service time: waiting on a deadline is a gamble we
            # cannot price, so dispatch deadlined work right away
            if est is None or min(deadlines) - now <= est:
                return "deadline"
        return None

    def next_batch(self, now: float, force: bool = False) -> Optional[Batch]:
        """Pop one batch if the release policy (or ``force``) says go.

        Pops up to ``max_bucket`` requests in EDF order and assigns the
        smallest covering bucket; remaining requests stay queued for the
        next call (an over-full queue drains ``max_bucket`` at a time).
        """
        reason = self.release_reason(now)
        if reason is None:
            if not force or not self.queue:
                return None
            reason = "flush"
        ordered = self._edf_order()
        take = ordered[:self.max_bucket]
        taken_ids = {id(r) for r in take}
        self.queue = [r for r in self.queue if id(r) not in taken_ids]
        return Batch(requests=take, bucket=bucket_for(len(take),
                                                      self.buckets),
                     reason=reason)

    def drain(self, now: float) -> List[Batch]:
        """Flush the whole queue as bucketed batches (end of trace /
        shutdown).  An empty queue yields no batches."""
        out = []
        while self.queue:
            out.append(self.next_batch(now, force=True))
        return out
