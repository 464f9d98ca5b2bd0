"""The crossbar-MVM kernel's share of its roofline: the least time of
the launches traced (``counts.launch_bound_s`` from their (T, M, R, C)
and the crossbar's phases and slices) over the device time of the
operations those launches put on the device, which the profiler ties to
them through the host call that launched each."""
from cimbench import counts, trace


def read(r):
    win = trace.window(r.kernel_events)
    if not r.cim_launches or win is None:
        return None
    ops = trace.launched_in(r.kernel_events,
                            trace.device_ops(r.kernel_events, win),
                            trace.CIM_MVM)
    device_s = sum(float(o["dur"]) for o in ops) / 1e6
    bound_s = counts.launch_bound_s(r.cim_launches, r.cell.xb,
                                    counts.peaks(r.device_name))
    return counts.percent(bound_s, device_s)
