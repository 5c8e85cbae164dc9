"""What the program's own spans and counters read in a `--trace 1` run
(graphvite_tpu_torch/utils/tracing.py). The traced call is the run's only
profiled call, so the program's newest recording session is that call's;
its set-up stages are totals over the process. A program without the
facility reads nothing: every function here then returns None."""


def _tracing():
    try:
        from graphvite_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def session(ctx):
    """The traced call's session ({"spans", "counters", ...}), or None;
    puts its spans per batch into `ctx.detail["spans"]`: count, host,
    self and device ms per batch of the traced call."""
    tracing = _tracing()
    s = tracing.last_session() if tracing is not None else None
    if not s or not s["spans"]:
        return None
    n = max(ctx.batches, 1)
    ctx.detail["spans"] = {
        name: {"count": v["count"],
               "host_ms_per_batch": 1e3 * v["host_s"] / n,
               "self_ms_per_batch": 1e3 * v["self_s"] / n,
               "device_ms_per_batch": 1e3 * v["device_s"] / n}
        for name, v in s["spans"].items()}
    ctx.detail["span_counters"] = s["counters"]
    ctx.detail["spans_dropped"] = s["dropped"]
    return s


def share(ctx, parts, whole, key):
    """100 x the sum of `key` ("host_s" or "device_s") over the spans
    named `parts` over that of span `whole` (names without the program's
    prefix), or None where the whole or every part is absent."""
    s = session(ctx)
    if s is None:
        return None
    prefix = _tracing().PREFIX
    spans = s["spans"]
    found = [spans[prefix + p][key] for p in parts if prefix + p in spans]
    total = spans.get(prefix + whole, {}).get(key, 0.0)
    if not found or total <= 0:
        return None
    return 100.0 * sum(found) / total


def counter_share(ctx, part, whole):
    """100 x counter `part` over counter `whole`, or None."""
    s = session(ctx)
    if s is None:
        return None
    prefix = _tracing().PREFIX
    num = s["counters"].get(prefix + part)
    den = s["counters"].get(prefix + whole)
    if num is None or not den:
        return None
    return 100.0 * num / den


def setup_totals(ctx):
    """The program's set-up stages over the process ({stage: {"count",
    "seconds", "self_seconds"}}), also put into `ctx.detail`, or None."""
    tracing = _tracing()
    totals = tracing.setup_totals() if tracing is not None else None
    if not totals:
        return None
    ctx.detail["setup_stages"] = totals
    return totals
