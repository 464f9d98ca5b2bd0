"""Share of the profiled window in which no kernel, copy or fill ran on
the device."""
from cimbench import trace


def read(r):
    if r.trace_window is None:
        return None
    lo, hi = r.trace_window
    if hi <= lo:
        return None
    return 100.0 * (1.0 - trace.busy_us(r.device_ops, (lo, hi)) / (hi - lo))
