"""The whole dispatch's share of the card's int8 peak: the operations
the configuration's MVMs need (``counts.mvm_ops_per_image``) for every
inference of the measured window, over the window's seconds times the
peak."""
from cimbench import counts


def read(r):
    if not r.device_name or not r.window_s:
        return None
    ops = counts.mvm_ops_per_image(r.cell.layers, r.cell.in_shape,
                                   r.cell.xb) * r.batch * r.dispatches
    peak = counts.peaks(r.device_name)["int8_ops_per_s"]
    return counts.percent(ops, r.window_s * peak)
