"""Common constants and small helpers (the port's copy of
graphvite_tpu/utils/common.py, without JAX)."""
from __future__ import annotations

import contextlib
import logging
import os
import time

import numpy as np

from graphvite_tpu_torch.utils import tracing

# Sentinel meaning "deduce this hyperparameter automatically" (the
# reference's kAuto = 0, so YAML configs with `auto` behave identically).
auto = 0

EPSILON = 1e-15

KiB = 1 << 10
MiB = 1 << 20
GiB = 1 << 30

logger = logging.getLogger("graphvite_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(levelname).1s %(message)s",
                                      datefmt="%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("GRAPHVITE_LOG_LEVEL", "INFO"))


def parse_bytes(value):
    """Parse a byte count: int/float bytes or a "4G"/"512M"/"12GiB" string."""
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip().upper().replace("IB", "").rstrip("B")
    for suffix, mult in (("K", KiB), ("M", MiB), ("G", GiB), ("T", GiB * 1024)):
        if s.endswith(suffix):
            return float(s[:-1]) * mult
    return float(s)


def hbm_budget_bytes(limit=auto, device=None):
    """Device memory budget in bytes for the overflow warning.

    Priority: GRAPHVITE_HBM_BYTES env override > an explicit `limit`
    (the solver's gpu_memory_limit; bytes or "4G"-style) > the CUDA
    device's total memory (torch.cuda.mem_get_info) > 12 GB for a
    device that reports none (the CPU)."""
    env = os.environ.get("GRAPHVITE_HBM_BYTES")
    if env is not None:
        return parse_bytes(env)
    if limit not in (auto, None):
        return parse_bytes(limit)
    import torch

    if device is not None and torch.device(device).type == "cuda":
        return float(torch.cuda.mem_get_info(torch.device(device))[1])
    return 12e9


def sigmoid(x):
    """Numerically safe sigmoid of a numpy array, in float64 (the
    reference's util/math.h:30-33): 1 / (1 + e^-x) for x >= 0, e^x / (1 +
    e^x) below, so neither branch overflows."""
    out = np.empty_like(x, dtype=np.float64)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


class Monitor:
    """Wall-clock stage timer (the reference's Monitor); each stage is
    also a span of its name (utils/tracing.py) in a recording session."""

    def __init__(self):
        self.records = {}

    @contextlib.contextmanager
    def stage(self, name):
        start = time.perf_counter()
        try:
            with tracing.span(name):
                yield
        finally:
            elapsed = time.perf_counter() - start
            total, count = self.records.get(name, (0.0, 0))
            self.records[name] = (total + elapsed, count + 1)
            logger.info("%s: %.3f s", name, elapsed)

    def summary(self):
        return {k: {"total_s": t, "calls": c} for k, (t, c) in self.records.items()}


@contextlib.contextmanager
def device_profile(trace_dir):
    """Profile the enclosed block with torch.profiler (the CPU, and CUDA
    where a card is present) inside a recording session of the program's
    spans (utils/tracing.py), and write a Chrome trace into `trace_dir`
    (view it in chrome://tracing or Perfetto), where the `graphvite::`
    ranges sit over the kernels. Yields the profiler."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        with tracing.recording():
            yield prof
    finally:
        prof.stop()
        path = os.path.join(trace_dir, "trace_%d_%d.json"
                            % (os.getpid(), time.time_ns()))
        prof.export_chrome_trace(path)
        logger.info("device trace written to %s", path)


def recursive_map(obj, fn):
    """Apply fn to every leaf of a nested dict/list structure (ref util.py)."""
    if isinstance(obj, dict):
        return {k: recursive_map(v, fn) for k, v in obj.items()}
    if isinstance(obj, list):
        return [recursive_map(v, fn) for v in obj]
    return fn(obj)


def assert_in(name, value, candidates):
    if value not in candidates:
        raise ValueError("Unknown %s `%s`; expected one of %s" % (name, value, sorted(candidates)))
