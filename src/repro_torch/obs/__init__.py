"""Stack-wide observability: metrics registry, Chrome trace, provenance.

  * :mod:`repro_torch.obs.metrics` — the process-wide ``MetricsRegistry``
    (counters/gauges/histograms, Prometheus + stable-JSON exposition).
    ``metrics.enable()`` turns accounting on; disabled, every
    instrumented path is one ``is None`` check.
  * :mod:`repro_torch.obs.trace` — the Chrome-trace ``TraceRecorder``.
    ``trace.install()`` makes it the process-wide sink the compiler and
    executor emit spans to, each on its own Perfetto process row.
  * :mod:`repro_torch.obs.explain` — per-node compile provenance
    (``ExplainReport`` / ``explain_compile``), fed by the
    :mod:`repro_torch.obs.hooks` events the compiler tiers emit.
"""
from . import hooks, metrics, trace                              # noqa: F401
from .metrics import MetricsRegistry                             # noqa: F401
from .trace import (TraceRecorder, load_trace,                   # noqa: F401
                    validate_chrome_trace)

__all__ = [
    "hooks", "metrics", "trace",
    "MetricsRegistry", "TraceRecorder",
    "load_trace", "validate_chrome_trace",
    "ExplainReport", "explain_compile",
]


def __getattr__(name):
    # ``explain`` imports the compiler (which imports this package), so
    # it loads lazily to keep the package import acyclic and light.
    if name in ("ExplainReport", "explain_compile", "explain"):
        import importlib
        explain = importlib.import_module(".explain", __name__)
        if name == "explain":
            return explain
        return getattr(explain, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
