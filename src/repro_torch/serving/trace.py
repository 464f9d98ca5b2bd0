"""Compatibility shim — the Chrome-trace recorder lives in
:mod:`repro_torch.obs.trace`, the stack-wide sink (compiler, executor
and fleet spans share one timeline).  Importing ``TraceRecorder`` /
``validate_chrome_trace`` / ``load_trace`` from here keeps working; new
code should import from ``repro_torch.obs.trace``.
"""
from ..obs.trace import (TraceRecorder, load_trace,       # noqa: F401
                         validate_chrome_trace)

__all__ = ["TraceRecorder", "validate_chrome_trace", "load_trace"]
