"""Kernel 1's share of its roofline in the traced call, in %: the least
time of every `scatter_add_` call (counts/scatter_add.py, from the call's
own ids, at the card's published peaks) over the device time of the
kernels launched inside the calls' ranges, its in-call sort included."""
from benchmark import peaks
from benchmark.counts import scatter_add


def read(ctx):
    device_s = ctx.summary["scatter_device_s"]
    if not ctx.scatter_calls or device_s <= 0:
        return None
    least = 0.0
    bound = {}
    for ids, rows, width, elem in ctx.scatter_calls:
        t, by = peaks.least_seconds(*scatter_add.call_counts(ids, rows,
                                                             width, elem))
        least += t
        bound[by] = bound.get(by, 0) + 1
    ctx.detail["scatter_add_bound_by"] = bound
    ctx.detail["scatter_add_device_s"] = device_s
    ctx.detail["scatter_add_least_s"] = least
    return 100.0 * least / device_s
