"""Kernels, copies and fills the device ran per dispatch, in the
profiled dispatches."""


def read(r):
    if not r.traced_dispatches:
        return None
    return len(r.device_ops) / r.traced_dispatches
