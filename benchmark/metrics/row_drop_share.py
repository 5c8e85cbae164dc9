"""Row requests of the walks engine dropped past their owner's capacity,
in %: the program's `row_drops` counter over its `row_requests` counter
(every walk position and pool slot a worker asks its owner for, a
worker-batch). None where the program counts no requests."""
from benchmark import spans


def read(ctx):
    return spans.counter_share(ctx, "row_drops", "row_requests")
