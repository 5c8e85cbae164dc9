"""One run of one cell: set-up, the measured window (or the traced call),
the check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by name: the configuration's file (BENCHMARK.json
`configs[].file`), its job module `apps/<application>.py` and its reference
`reference/<reference>.py` with its counts `counts/<reference>.py`, the
traffic file `traffic/<traffic>.json`, and one reader
`metrics/<metric>.py` per per-layer metric.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import time

import torch

from benchmark import isolation, trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_files(manifest, workload, root=ROOT):
    """(cell, configuration, traffic) of a workload name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError("no workload %r in BENCHMARK.json" % workload)
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     cell["traffic"] + ".json"))
    return cell, cfg, traffic


def metric_reader(name):
    """metrics/<name>.py, loaded from its path (names may hold dots)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit(chips=1):
    """Cards 0 .. chips-1's names and power limits as nvidia-smi reads
    them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return "; ".join(out.stdout.strip().splitlines()[:chips])


class Trace:
    """What the per-layer readers read of a traced call: the trace's
    summary (trace.summarize), the batches it trained, the scatter calls'
    ids and widths, the steps set-up followed, and the wall time per
    batch of the untraced call before it (`plain_batch_s`)."""

    def __init__(self, cfg, summary, batches, scatter_calls, steps,
                 plain_batch_s, chips=1):
        self.cfg, self.summary, self.batches = cfg, summary, batches
        self.scatter_calls, self.steps = scatter_calls, steps
        self.plain_batch_s = plain_batch_s
        self.chips = chips       # the cards the cell uses
        self.detail = {}


def check(job, cfg, dtype=torch.float32):
    """The numbers compared, each beside its limit: ({name: (value,
    limit)}, {name: value} of what the reference read and no limit
    holds)."""
    if job.device.type == "cuda":
        # the reference's float32 products stay float32 on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    gaps, sampler = job.check(dtype)
    values = dict(sampler, **gaps)
    values["reference_imports_program"] = len(
        isolation.reference_imports_program())
    limits = cfg["limits"]
    return ({name: (values[name], limits[name]) for name in limits},
            {k: v for k, v in values.items() if k not in limits})


def run(workload, seed, seconds, trace_on, device="cuda", root=ROOT,
        t_start=None):
    """One run; returns the result dict (its `checks` key last). On the
    card it uses cards cuda:0 .. chips-1 of the cell's entry, and reads
    each one's memory peak."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    cell, cfg, traffic = cell_files(manifest, workload, root)
    app = importlib.import_module("benchmark.apps." + cfg["application"])
    on_card = torch.device(device).type == "cuda"
    chips = int(cell["chips"])
    cards = [torch.device("cuda", i) for i in range(chips)] if on_card else []
    job = app.Job(cfg, traffic, seed, device)
    job.set_up()
    for card in cards:
        torch.cuda.synchronize(card)
        torch.cuda.reset_peak_memory_stats(card)
    setup_s = time.perf_counter() - t_start

    batches = 0
    summary = None
    detail = {}
    if trace_on:
        t0 = time.perf_counter()
        plain = job.call()
        plain_batch_s = (time.perf_counter() - t0) / plain
        scatter = trace.Scatter()
        with scatter.installed():
            batches, events = trace.profile(lambda: job.call(record=False),
                                            cards)
        summary = trace.summarize(events, chips)
        del events
    else:
        t0 = time.perf_counter()
        calls_s = []
        while True:
            batches += job.call()
            elapsed = time.perf_counter() - t0
            calls_s.append(elapsed - sum(calls_s))
            if elapsed >= seconds:
                break
        detail["calls_s"] = calls_s
    peaks = [torch.cuda.max_memory_allocated(card) for card in cards]
    # the window's matmul precision, before the check sets its own
    tf32 = on_card and torch.backends.cuda.matmul.allow_tf32
    samples = batches * job.samples_per_batch()

    metrics = {}
    if trace_on:
        ctx = Trace(cfg, summary, batches, scatter.calls, job.steps,
                    plain_batch_s, chips)
        # a reader that finds nothing to read in this cell returns None
        for m in manifest["per_layer"]:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        detail.update(ctx.detail, kernels=summary["kernels"],
                      scatter_ranges=summary["scatter_ranges"],
                      scatter_kernels=summary["scatter_kernels"],
                      plain_batch_s=plain_batch_s,
                      traced_batch_s=summary["window_s"] / batches)
        scatter.calls.clear()
    else:
        e2e = {"samples_per_s": samples / elapsed, "setup_s": setup_s}
        for m in manifest["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    job.release()

    checks, unbounded = check(job, cfg)
    correct = all(v <= lim for v, lim in checks.values())
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": chips, "memory_peak_bytes": max(peaks, default=0),
           "card": power_limit(chips) if on_card else None,
           "tf32_matmul": tf32}
    out = {"correct": correct, "attempted": batches, "failed": 0,
           "metrics": metrics, "device": dev}
    if trace_on:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["detail"] = dict(detail, samples=samples, memory_peaks_bytes=peaks,
                         not_compared=unbounded)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out
