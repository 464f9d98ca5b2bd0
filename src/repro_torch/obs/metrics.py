"""Process-wide metrics registry — the stack's one place for counters.

Every tier of the stack keeps numbers today: ``CompileCache.stats()``,
the executor's ``ExecutorStats``, the serving ``ServiceStats``, the DSE
searchers' round logs.  They are all *pull* bundles with their own
shapes, so "how many compiles did this campaign pay, how many cache
hits did the fleet get, how many kernel dispatches ran" is N different
accessors.  ``MetricsRegistry`` is the *push* side that unifies them:

  * three instrument kinds — :class:`Counter` (monotone),
    :class:`Gauge` (set-to-current), :class:`Histogram` (bucketed
    observations with sum/count) — each identified by a metric name
    plus a sorted label set, Prometheus-style;
  * **deterministic snapshots**: ``snapshot()`` / ``flat()`` sort by
    (name, labels) so two runs with the same event sequence serialize
    byte-identically — committed benchmark JSON can diff them;
  * two expositions: ``to_prometheus()`` (the text format scrapers
    ingest) and ``to_json()`` (stable, sorted keys);
  * ``absorb()`` pulls any of today's scattered stats dicts
    (``CompileCache.stats()``, ``dataclasses.asdict(ExecutorStats)``,
    a ``ServiceStats`` summary) into gauges under one prefix, so
    legacy bundles surface through the same exposition.

Enablement contract: telemetry is **off by default** — ``active()``
returns ``None`` and every instrumented hot path (executor dispatch,
cache lookups, compile driver) reduces to one ``is None`` check, so
disabled runs are bit-identical and effectively free.  ``enable()``
installs a process-wide registry (optionally your own instance);
``disable()`` removes it and returns it for inspection.  The module
helpers ``count`` / ``set_gauge`` / ``observe`` are the no-op-when-
disabled entry points call sites use.

Thread-safety: like the serving stats bundles, a registry is plain
mutable state owned by one driving thread; counters are not atomic
across threads.  Process pools (DSE sweep workers) do not share the
parent's registry — absorb their returned stats instead.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple, Union

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "enable", "disable", "active",
    "count", "set_gauge", "observe",
]

#: default histogram bucket upper bounds (seconds-flavoured: the stack's
#: histograms time dispatches and packs; callers pass their own bounds
#: for anything else)
DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)

LabelValue = Union[str, int, float, bool]


def _label_key(labels: Mapping[str, LabelValue]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _series_name(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


@dataclasses.dataclass
class Counter:
    """Monotone event count for one labeled series."""

    name: str
    labels: Tuple[Tuple[str, str], ...] = ()
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({n})")
        self.value += n


@dataclasses.dataclass
class Gauge:
    """Set-to-current value for one labeled series."""

    name: str
    labels: Tuple[Tuple[str, str], ...] = ()
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


@dataclasses.dataclass
class Histogram:
    """Bucketed observations (cumulative buckets + sum + count)."""

    name: str
    labels: Tuple[Tuple[str, str], ...] = ()
    bounds: Tuple[float, ...] = DEFAULT_BUCKETS
    counts: List[int] = dataclasses.field(default_factory=list)
    sum: float = 0.0
    count: int = 0

    def __post_init__(self):
        self.bounds = tuple(sorted(float(b) for b in self.bounds))
        if not self.counts:
            self.counts = [0] * (len(self.bounds) + 1)   # + the +Inf bucket

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> Dict[str, int]:
        """``{le: cumulative count}`` including the ``+Inf`` bucket —
        the Prometheus histogram shape."""
        out: Dict[str, int] = {}
        running = 0
        for b, c in zip(self.bounds, self.counts):
            running += c
            out[repr(b)] = running
        out["+Inf"] = self.count
        return out


class MetricsRegistry:
    """Deterministic counter/gauge/histogram store for one process."""

    def __init__(self):
        self._counters: Dict[Tuple, Counter] = {}
        self._gauges: Dict[Tuple, Gauge] = {}
        self._histograms: Dict[Tuple, Histogram] = {}

    # -- instruments -----------------------------------------------------
    def counter(self, name: str, **labels: LabelValue) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter(name, key[1])
        return c

    def gauge(self, name: str, **labels: LabelValue) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge(name, key[1])
        return g

    def histogram(self, name: str,
                  bounds: Iterable[float] = DEFAULT_BUCKETS,
                  **labels: LabelValue) -> Histogram:
        key = (name, _label_key(labels))
        h = self._histograms.get(key)
        if h is None:
            h = self._histograms[key] = Histogram(name, key[1],
                                                  tuple(bounds))
        return h

    # -- absorption of legacy stat bundles -------------------------------
    def absorb(self, prefix: str, stats: Mapping[str, Any],
               **labels: LabelValue) -> None:
        """Mirror the numeric entries of a legacy stats mapping
        (``CompileCache.stats()``, ``dataclasses.asdict`` of
        ``ExecutorStats``/``ServiceStats``) as ``<prefix>_<key>``
        gauges, so pull-style bundles ride the same exposition.
        Non-numeric values are skipped; booleans become 0/1."""
        for k in sorted(stats):
            v = stats[k]
            if isinstance(v, bool):
                v = int(v)
            if isinstance(v, (int, float)):
                self.gauge(f"{prefix}_{k}", **labels).set(float(v))

    # -- snapshots --------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Deterministic nested snapshot (sorted by name, then labels)."""
        def series(d):
            return {_series_name(m.name, m.labels): m.value
                    for _, m in sorted(d.items())}
        hists = {}
        for _, h in sorted(self._histograms.items()):
            hists[_series_name(h.name, h.labels)] = {
                "buckets": h.cumulative(), "sum": h.sum, "count": h.count}
        return {"counters": series(self._counters),
                "gauges": series(self._gauges),
                "histograms": hists}

    def flat(self, prefix: Union[str, Tuple[str, ...], None] = None
             ) -> Dict[str, float]:
        """Counters and gauges as one sorted ``{series: value}`` map,
        optionally filtered to metric-name ``prefix`` (str or tuple)."""
        out: Dict[str, float] = {}
        for store in (self._counters, self._gauges):
            for _, m in sorted(store.items()):
                if prefix is not None and not m.name.startswith(prefix):
                    continue
                out[_series_name(m.name, m.labels)] = m.value
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, indent=indent)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (``# TYPE`` per metric family)."""
        lines: List[str] = []

        def fmt(v: float) -> str:
            return str(int(v)) if float(v) == int(v) else repr(float(v))

        for kind, store in (("counter", self._counters),
                            ("gauge", self._gauges)):
            seen: set = set()
            for _, m in sorted(store.items()):
                if m.name not in seen:
                    seen.add(m.name)
                    lines.append(f"# TYPE {m.name} {kind}")
                lines.append(f"{_series_name(m.name, m.labels)} "
                             f"{fmt(m.value)}")
        seen = set()
        for _, h in sorted(self._histograms.items()):
            if h.name not in seen:
                seen.add(h.name)
                lines.append(f"# TYPE {h.name} histogram")
            for le, c in h.cumulative().items():
                labels = h.labels + (("le", le),)
                lines.append(f"{_series_name(h.name + '_bucket', labels)} "
                             f"{c}")
            lines.append(f"{_series_name(h.name + '_sum', h.labels)} "
                         f"{fmt(h.sum)}")
            lines.append(f"{_series_name(h.name + '_count', h.labels)} "
                         f"{h.count}")
        return "\n".join(lines) + "\n"

    def __len__(self) -> int:
        return (len(self._counters) + len(self._gauges)
                + len(self._histograms))


# ---------------------------------------------------------------------------
# Process-wide enablement
# ---------------------------------------------------------------------------

_REGISTRY: Optional[MetricsRegistry] = None


def enable(registry: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Install ``registry`` (or a fresh one) process-wide; returns it."""
    global _REGISTRY
    _REGISTRY = registry if registry is not None else MetricsRegistry()
    return _REGISTRY


def disable() -> Optional[MetricsRegistry]:
    """Remove the installed registry (telemetry off); returns it."""
    global _REGISTRY
    prev, _REGISTRY = _REGISTRY, None
    return prev


def active() -> Optional[MetricsRegistry]:
    """The installed registry, or ``None`` when telemetry is disabled —
    hot paths gate all accounting on this single check."""
    return _REGISTRY


def count(name: str, n: float = 1.0, **labels: LabelValue) -> None:
    """Increment a counter on the installed registry (no-op if none)."""
    if _REGISTRY is not None:
        _REGISTRY.counter(name, **labels).inc(n)


def set_gauge(name: str, v: float, **labels: LabelValue) -> None:
    """Set a gauge on the installed registry (no-op if none)."""
    if _REGISTRY is not None:
        _REGISTRY.gauge(name, **labels).set(v)


def observe(name: str, v: float, **labels: LabelValue) -> None:
    """Observe into a histogram on the installed registry (no-op)."""
    if _REGISTRY is not None:
        _REGISTRY.histogram(name, **labels).observe(v)
