"""The whole step's share of the cards' peak, in %: the least time of one
batch, the larger of its operations at 67 TFLOP/s and its bytes at
3.35 TB/s on each of the cell's cards (counted by the configuration's
counts/<reference>.py over the batches that set-up followed: the whole
batch, over every worker), over the wall time per batch of the trace
run's untraced call (the host clock: the profiler slows a host-bound
call, so the traced call's own time would understate the share)."""
import importlib

from benchmark import peaks


def read(ctx):
    if not ctx.batches or not ctx.steps:
        return None
    counts = importlib.import_module("benchmark.counts."
                                     + ctx.cfg["reference"])
    ops, nbytes = counts.per_batch(ctx.cfg, ctx.steps)
    least, by = peaks.least_seconds(nbytes, ops, ctx.chips)
    ctx.detail["step_bound_by"] = by
    ctx.detail["step_ops"] = ops
    ctx.detail["step_bytes"] = nbytes
    return 100.0 * least / ctx.plain_batch_s
