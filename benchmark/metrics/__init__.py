"""Per-layer metrics, one reader per file named as the metric is named in
BENCHMARK.json: `read(ctx)` takes the traced run's context (harness.Trace)
and returns the value, or None where the run has nothing to read."""
