"""Synthetic million-user traffic: diurnal + bursty arrival processes.

Real serving traffic is not a constant-rate trickle: request rates
follow a daily sine (the diurnal cycle of a geographic user base) with
short multiplicative bursts riding on top (launches, retries, thundering
herds).  This module generates deterministic request traces with that
shape so fleet benchmarks and re-planning tests exercise the traffic
the planner will actually face.

``TrafficModel`` describes the population-scale process (users x
per-user rate, diurnal amplitude, burst statistics); ``synthetic_trace``
samples a bounded number of requests from it — the *shape* of a
million-user day compressed into however many requests the benchmark
can afford — by inverse-CDF sampling of the non-homogeneous intensity.

Tenant mix drift is first-class: ``shares`` may be a callable
``t_s -> {tenant: share}``, so a trace can start on the planner's
assumed mix and drift to a different one mid-stream — exactly the
input the cluster's re-planner must detect and chase.

Units and clocks: all times are service-clock **seconds** (``arrival_s``
stamps land on the same caller-chosen clock the fleet runs on);
``TrafficModel.rps`` is requests per second for the *modeled*
population, independent of how many requests are actually sampled.
Determinism: everything is driven by ``numpy.random.default_rng(seed)``
— same seed, same trace.  Thread-safety: pure functions over local rng
state; safe to call from anywhere.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from .common import CimRequest

#: tenant mix: fixed shares, or a function of service-clock seconds
SharesLike = Union[Dict[str, float], Callable[[float], Dict[str, float]]]


@dataclasses.dataclass(frozen=True)
class TrafficModel:
    """Population-scale arrival process: diurnal sine + random bursts.

    The modeled mean rate is ``users * req_per_user_day / day_s``
    requests/second, modulated by a diurnal factor in
    ``[1 - diurnal_amp, 1 + diurnal_amp]`` and multiplied by
    ``burst_mult`` inside burst windows (on average
    ``bursts_per_day`` windows of ``burst_s`` seconds each day).
    """

    users: float = 1_000_000.0          # population size
    req_per_user_day: float = 50.0      # requests per user per day
    day_s: float = 86_400.0             # diurnal period, seconds
    diurnal_amp: float = 0.6            # peak/trough modulation (0..1)
    peak_hour: float = 20.0             # local hour of the diurnal peak
    bursts_per_day: float = 8.0         # expected burst windows per day
    burst_s: float = 600.0              # burst window length, seconds
    burst_mult: float = 3.0             # rate multiplier inside a burst

    def __post_init__(self):
        if not 0.0 <= self.diurnal_amp < 1.0:
            raise ValueError("diurnal_amp must be in [0, 1)")
        if self.burst_mult < 1.0:
            raise ValueError("burst_mult must be >= 1")

    @property
    def mean_rps(self) -> float:
        """Modeled mean request rate (requests/second, whole population)."""
        return self.users * self.req_per_user_day / self.day_s

    def diurnal(self, t_s: float) -> float:
        """Diurnal modulation factor at service-clock second ``t_s``."""
        phase = 2.0 * math.pi * (t_s / self.day_s - self.peak_hour / 24.0)
        return 1.0 + self.diurnal_amp * math.cos(phase)

    def rps(self, t_s: float, burst: bool = False) -> float:
        """Modeled offered load at ``t_s`` (requests/second)."""
        rate = self.mean_rps * self.diurnal(t_s)
        return rate * self.burst_mult if burst else rate


def burst_windows(model: TrafficModel, duration_s: float,
                  rng: np.random.Generator) -> List[tuple]:
    """Sample burst windows over ``[0, duration_s)`` as ``(start_s,
    end_s)`` tuples (Poisson count, uniform starts; deterministic in
    ``rng``)."""
    expect = model.bursts_per_day * duration_s / model.day_s
    n = int(rng.poisson(expect))
    starts = np.sort(rng.uniform(0.0, duration_s, size=n))
    return [(float(s), float(min(s + model.burst_s, duration_s)))
            for s in starts]


def intensity_grid(model: TrafficModel, duration_s: float,
                   rng: np.random.Generator,
                   resolution: int = 2048) -> tuple:
    """(times_s, rps) — the modeled rate profile sampled on a uniform
    grid, bursts included.  The benchmark uses this both to sample
    arrivals and to report the population-scale offered load."""
    t = np.linspace(0.0, duration_s, resolution, endpoint=False)
    rate = np.array([model.rps(ti) for ti in t])
    for lo, hi in burst_windows(model, duration_s, rng):
        rate[(t >= lo) & (t < hi)] *= model.burst_mult
    return t, rate


def _shares_at(shares: SharesLike, t_s: float) -> Dict[str, float]:
    s = shares(t_s) if callable(shares) else shares
    total = sum(s.values())
    if total <= 0:
        raise ValueError(f"tenant shares must sum > 0, got {s}")
    return {k: v / total for k, v in s.items()}


def synthetic_trace(graphs: Dict[str, object], n_requests: int,
                    duration_s: float, *, shares: SharesLike,
                    model: Optional[TrafficModel] = None, seed: int = 0,
                    deadline_s: Optional[float] = None,
                    rid_base: int = 0) -> List[CimRequest]:
    """Sample ``n_requests`` arrivals shaped like a diurnal+bursty day.

    ``graphs`` maps tenant name -> workload graph (inputs are generated
    deterministically per request id via ``cimsim.make_input``);
    ``shares`` fixes the tenant mix (or lets it drift when callable).
    Arrival times are inverse-CDF samples of the model's intensity over
    ``[0, duration_s)`` — the *shape* of the modeled load at whatever
    sample size the caller affords.  ``deadline_s`` (seconds of slack)
    stamps per-request absolute deadlines on the same clock.

    Returns requests sorted by ``arrival_s`` with ``rid`` assigned in
    arrival order starting at ``rid_base``.
    """
    from ..cimsim.functional import make_input
    if n_requests <= 0:
        return []
    model = model or TrafficModel()
    rng = np.random.default_rng(seed)
    t, rate = intensity_grid(model, duration_s, rng)
    cdf = np.cumsum(rate)
    cdf = cdf / cdf[-1]
    # stratified quantiles keep the empirical histogram close to the
    # intensity even for small n; jitter keeps arrivals distinct
    q = (np.arange(n_requests) + rng.uniform(0.2, 0.8, n_requests)) \
        / n_requests
    arrivals = np.interp(q, cdf, t)
    out: List[CimRequest] = []
    names = sorted(graphs)
    for i, arr in enumerate(arrivals):
        share = _shares_at(shares, float(arr))
        probs = np.array([share.get(n, 0.0) for n in names])
        pick = names[int(rng.choice(len(names), p=probs / probs.sum()))]
        rid = rid_base + i
        out.append(CimRequest(
            rid=rid, model=pick, inputs=make_input(graphs[pick], rid),
            arrival_s=float(arr),
            deadline_s=(float(arr) + deadline_s
                        if deadline_s is not None else None)))
    return out
