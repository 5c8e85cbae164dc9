"""Random-row-access bench: how fast one call gathers, updates or
scatter-adds N random rows of a [V, D] table, the row-access kernels
(ops/row_access.py) and the port's scatter-add (kernel 1, ops/scatter.py)
beside the PyTorch calls that compute the same functions.

    python -m graphvite_tpu_torch.tools.row_access_bench
        [--device cuda|cpu] [experiment ...]

The counterpart of the reference's tools/pallas_bench.py, experiment for
experiment:

  torch_gather           index_select of N rows          (xla_gather)
  cuda_gather            row_access.gather_rows          (pallas_gather)
  torch_scatter          index_add_ of N updates         (xla_scatter)
  cuda_rmw               row_access.rmw_rows_, unique    (pallas_rmw)
  cuda_sweep             sort + row_access.sweep_add_sorted_ (pallas_sweep)
  kernel1_sorted         scatter_add_sorted_, float32 and bfloat16 tables,
                         on sorted random ids and on the cumsum-of-gaps
                         presorted ids     (pallas_sweep_mxu,
                                            sweep_mxu_presorted)
  sweep_verify           scatter_add_sorted_ against index_add_
  kernel1_unsorted       scatter_add_, float32, and bfloat16 with the
                         deltas rounded to bfloat16 first (sweep_unsorted)
  sweep_unsorted_verify  scatter_add_ against index_add_ on N - 137 ids

The reference's tile and chunk variants collapse to one run per table
type: the port's kernels have no such knobs. The shape comes from PB_V,
PB_D and PB_N (defaults 1,000,000, 128 and 325,520: the context-update
count at the solver's effective batch). Each timed call is a chain of EP =
10 calls that draw their ids on the device; 2 chains warm up, 5 are
timed on the host clock around a synchronize. Prints one JSON line per
run: experiment, ms per call, ns per row, bound_ms (the bytes the call
must move over the H100's 3.35e12 B/s) and the device; on the card also
the line of `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`. Unlike the reference's, which prints an error
and goes on, any failure (a build, a launch, a verify past its limit)
ends the run with a non-zero exit. The default device is the card; on
the CPU every call runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from graphvite_tpu_torch.ops import row_access, scatter

EP = 10                  # calls per timed chain
HBM_BYTES_PER_S = 3.35e12   # the H100 SXM's published memory rate


def shape():
    """(V, D, N) from PB_V, PB_D and PB_N."""
    env = os.environ.get
    return (int(env("PB_V", 1_000_000)), int(env("PB_D", 128)),
            int(env("PB_N", 325_520)))


def gather_bytes(n, d):
    """N rows read and written, and the ids."""
    return 2 * n * d * 4 + 4 * n


def rmw_bytes(n, d):
    """N rows read and written, N update rows read, and the ids."""
    return 3 * n * d * 4 + 4 * n


def scatter_bytes(n, unique_rows, d, table_itemsize=4):
    """The U distinct rows read and written, N float32 update rows read,
    and the ids."""
    return 2 * unique_rows * d * table_itemsize + n * d * 4 + 4 * n


def bound_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


class Bench:
    """One run's device, shape, generator and output."""

    def __init__(self, device, out=sys.stdout):
        self.device = torch.device(device)
        self.V, self.D, self.N = shape()
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(3)
        self.out = out
        self.card = None
        if self.device.type == "cuda":
            self.card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60, check=True).stdout.strip().splitlines()[0]

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def ids(self, n=None):
        return torch.randint(0, self.V, (n or self.N,), generator=self.gen,
                             device=self.device, dtype=torch.int32)

    def unique_rows(self, ids):
        return int(torch.unique(ids).numel())

    def chain_time(self, fn, state, n_warm=2, n_time=5):
        """Seconds of one chain of EP calls: fn(state, salt) runs a
        chain and returns the state."""
        for i in range(n_warm):
            state = fn(state, i)
        self.sync()
        t0 = time.perf_counter()
        for i in range(n_time):
            state = fn(state, i + 7)
        self.sync()
        return (time.perf_counter() - t0) / n_time, state

    def emit(self, rec):
        rec["device"] = str(self.device)
        if self.card is not None:
            rec["card"] = self.card
        print(json.dumps(rec), file=self.out, flush=True)

    def report(self, name, dt_chain, nbytes, n_rows=None):
        ms = dt_chain / EP * 1e3
        self.emit({"experiment": name, "ms": ms,
                   "ns_per_row": ms * 1e6 / (n_rows or self.N),
                   "bound_ms": bound_ms(nbytes)})

    def table(self, dtype=torch.float32, zeros=False):
        if zeros:
            return torch.zeros((self.V, self.D), dtype=dtype,
                               device=self.device)
        return torch.randn((self.V, self.D), generator=self.gen,
                           device=self.device).to(dtype)

    def small_updates(self, n=None):
        return torch.full((n or self.N, self.D), 1e-6, dtype=torch.float32,
                          device=self.device)


# -- gathers ------------------------------------------------------------------

def _gather(b, name, fn):
    table = b.table()

    def run(acc, salt):
        for _ in range(EP):
            acc = acc + fn(table, b.ids())[:, 0].sum()
        return acc

    dt, _ = b.chain_time(run, torch.zeros((), device=b.device))
    b.report(name, dt, gather_bytes(b.N, b.D))


def e_torch_gather(b):
    _gather(b, "torch_gather", lambda t, ids: t.index_select(0, ids))


def e_cuda_gather(b):
    _gather(b, "cuda_gather", row_access.gather_rows)


# -- scatters -----------------------------------------------------------------

def e_torch_scatter(b):
    g = b.small_updates()
    u = b.unique_rows(b.ids())

    def run(t, salt):
        for _ in range(EP):
            t.index_add_(0, b.ids(), g)
        return t

    dt, _ = b.chain_time(run, b.table(zeros=True))
    b.report("torch_scatter", dt, scatter_bytes(b.N, u, b.D))


def e_cuda_rmw(b):
    # unique by construction: id j = 3 j + jitter (jitter < 3), mod V
    g = b.small_updates()
    base = torch.arange(b.N, device=b.device, dtype=torch.int32) * 3

    def run(t, salt):
        for _ in range(EP):
            jitter = torch.randint(0, 3, (b.N,), generator=b.gen,
                                   device=b.device, dtype=torch.int32)
            row_access.rmw_rows_(t, (base + jitter) % b.V, g)
        return t

    dt, _ = b.chain_time(run, b.table(zeros=True))
    b.report("cuda_rmw", dt, rmw_bytes(b.N, b.D))


def e_cuda_sweep(b):
    g = b.small_updates()
    u = b.unique_rows(b.ids())

    def run(t, salt):
        for _ in range(EP):
            sid, order = torch.sort(b.ids())
            row_access.sweep_add_sorted_(t, sid, g[order])
        return t

    dt, _ = b.chain_time(run, b.table(zeros=True))
    b.report("cuda_sweep", dt, scatter_bytes(b.N, u, b.D))


def presorted_ids(b):
    """Sorted by construction (a cumsum of gaps): the sorted-edge-stream
    case, no sort in the measured path."""
    gaps = torch.randint(0, 2 * b.V // b.N + 1, (b.N,), generator=b.gen,
                         device=b.device, dtype=torch.int32)
    return torch.clamp(torch.cumsum(gaps, 0), max=b.V - 1).to(torch.int32)


def e_kernel1_sorted(b):
    g = b.small_updates()
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[-1]
        for name, draw in (("kernel1_sorted", lambda: torch.sort(b.ids())[0]),
                           ("kernel1_presorted", lambda: presorted_ids(b))):
            u = b.unique_rows(draw())

            def run(t, salt, draw=draw):
                for _ in range(EP):
                    scatter.scatter_add_sorted_(t, draw(), g)
                return t

            dt, _ = b.chain_time(run, b.table(dtype, zeros=True))
            b.report("%s_%s" % (name, tname), dt,
                     scatter_bytes(b.N, u, b.D, dtype.itemsize))


def e_kernel1_unsorted(b):
    g = b.small_updates()
    u = b.unique_rows(b.ids())
    for dtype, name in ((torch.float32, "kernel1_unsorted_float32"),
                        (torch.bfloat16,
                         "kernel1_unsorted_bfloat16_bf16delta")):
        # bf16 tables: the deltas rounded to bf16 before the sum, as the
        # reference's permute_dtype
        delta = g if dtype == torch.float32 else g.bfloat16().float()

        def run(t, salt, delta=delta):
            for _ in range(EP):
                scatter.scatter_add_(t, b.ids(), delta)
            return t

        dt, _ = b.chain_time(run, b.table(dtype, zeros=True))
        b.report(name, dt, scatter_bytes(b.N, u, b.D, dtype.itemsize))


# -- verifies -----------------------------------------------------------------

def _verify(b, name, n, ids, fn):
    rng = np.random.default_rng(3 if "unsorted" in name else 0)
    upd = torch.as_tensor(rng.normal(size=(n, b.D)).astype(np.float32)
                          * 1e-3, device=b.device)
    table = torch.as_tensor(rng.normal(size=(b.V, b.D)).astype(np.float32),
                            device=b.device)
    ids = torch.as_tensor(ids, device=b.device)
    want = table.clone().index_add_(0, ids.long(), upd)
    got = fn(table.clone(), ids, upd)
    err = float((got - want).abs().max())
    ok = err < 1e-3
    b.emit({"experiment": name, "max_abs_err": err, "ok": ok})
    if not ok:
        raise AssertionError("%s: max abs err %g" % (name, err))


def e_sweep_verify(b):
    rng = np.random.default_rng(0)
    n = (b.N // 512) * 512
    ids = np.sort((rng.random(n) ** 2.5 * b.V).astype(np.int32))
    _verify(b, "sweep_verify", n, ids, scatter.scatter_add_sorted_)


def e_sweep_unsorted_verify(b):
    rng = np.random.default_rng(3)
    n = b.N - 137
    ids = (rng.random(n) ** 2.5 * b.V).astype(np.int32)
    _verify(b, "sweep_unsorted_verify", n, ids, scatter.scatter_add_)


EXPERIMENTS = {
    "torch_gather": e_torch_gather,
    "cuda_gather": e_cuda_gather,
    "torch_scatter": e_torch_scatter,
    "cuda_rmw": e_cuda_rmw,
    "cuda_sweep": e_cuda_sweep,
    "kernel1_sorted": e_kernel1_sorted,
    "sweep_verify": e_sweep_verify,
    "kernel1_unsorted": e_kernel1_unsorted,
    "sweep_unsorted_verify": e_sweep_unsorted_verify,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("experiments", nargs="*", metavar="experiment",
                    help="of %s (default: all)" % ", ".join(EXPERIMENTS))
    args = ap.parse_args(argv)
    unknown = [e for e in args.experiments if e not in EXPERIMENTS]
    if unknown:
        ap.error("unknown experiments: %s" % ", ".join(unknown))
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device; pass --device cpu for the plain versions")
    b = Bench(args.device)
    with torch.no_grad():
        for name in args.experiments or list(EXPERIMENTS):
            t0 = time.perf_counter()
            EXPERIMENTS[name](b)
            sys.stderr.write("%s done in %.1f s\n"
                             % (name, time.perf_counter() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
