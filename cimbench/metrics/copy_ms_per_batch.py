"""Device milliseconds of copies (host to device, device to host and on
the device) per dispatch, in the profiled dispatches: the inputs, the
served outputs and every host round trip of a float op."""


def read(r):
    if not r.traced_dispatches:
        return None
    us = sum(float(e["dur"]) for e in r.device_ops
             if e.get("cat") == "gpu_memcpy")
    return us / 1e3 / r.traced_dispatches
