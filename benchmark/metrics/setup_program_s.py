"""Seconds of the run's set-up spent in the program's set-up stages (the
graph's finalize, the solver's build, the samplers' builds, the kernels'
and the native library's compiles), over the process: each stage's time
less the stages nested inside it, so no second is counted twice."""
from benchmark import spans


def read(ctx):
    totals = spans.setup_totals(ctx)
    if totals is None:
        return None
    return sum(t["self_seconds"] for t in totals.values())
