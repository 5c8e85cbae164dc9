"""The traced stretch of a `--trace 1` run: torch.profiler over one call of
the window, read from the profiler's raw (kineto) events.

`Scatter` wraps every call of the program's kernel-1 entry
(`scatter_add_`) in a `benchmark::scatter_add_` range and keeps the
call's ids and widths, for the traced run only. `summarize` reduces the
events to what the per-layer metrics read: the window's length, each card's
union of device activity inside it, the device kernels, the device time of the
kernels launched inside the scatter ranges, the operations that took most
device time, and the idle gaps by the host operation that ended them.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
import sys

import torch

WINDOW = "benchmark::window"
SCATTER = "benchmark::scatter_add_"
# device activities that are not kernels, by their names' first word
COPIES = ("Memcpy", "Memset")


class Scatter:
    """Wraps the program's `scatter_add_` where the program's modules call
    it (every module that imported the name), inside `installed()`."""

    def __init__(self):
        self.calls = []      # (ids, table rows, width, element size)

    def wrap(self, fn):
        def scatter_add_(table, ids, upd):
            with torch.profiler.record_function(SCATTER):
                out = fn(table, ids, upd)
            self.calls.append((ids, table.shape[0], table.shape[1],
                               table.element_size()))
            return out
        return scatter_add_

    def installed(self):
        from graphvite_tpu_torch.ops import scatter

        return scatter_replaced(self.wrap(scatter.scatter_add_))


@contextlib.contextmanager
def swapped(objects, name, value):
    """`value` as attribute `name` of each of `objects` inside the block."""
    olds = [getattr(o, name) for o in objects]
    for o in objects:
        setattr(o, name, value)
    try:
        yield
    finally:
        for o, old in zip(objects, olds):
            setattr(o, name, old)


def _importers(module, name):
    """The program's other modules that imported `name` from `module`."""
    orig = getattr(module, name)
    return [m for key, m in list(sys.modules.items())
            if key.startswith("graphvite_tpu_torch.") and m is not module
            and getattr(m, name, None) is orig]


def replaced(point, value):
    """`value` in place of the program's attribute `point`, a (module
    name, attribute) pair: in that module and in every module of the
    program that imported the name."""
    module = importlib.import_module(point[0])
    return swapped([module] + _importers(module, point[1]), point[1], value)


def scatter_replaced(fn):
    """`fn` in place of the program's `scatter_add_` wherever the program's
    modules call it: every module that imported the name (ops/scatter.py's
    own entries keep theirs)."""
    from graphvite_tpu_torch.ops import scatter

    return swapped(_importers(scatter, "scatter_add_"), "scatter_add_", fn)


def profile(fn, cards):
    """Run fn() under torch.profiler inside a WINDOW range, then
    synchronise every card of `cards`; return its result and the
    profiler's raw events."""
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = fn()
        for card in cards:
            torch.cuda.synchronize(card)
    return out, prof.profiler.kineto_results.events()


def _union(intervals):
    """Merged [start, end) intervals, sorted; each keeps the index of the
    event that opened it."""
    merged = []
    for s, e, i in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e, i])
    return merged


def card_unions(spans, cards):
    """Each card's device activity, from `spans`, (card, start, end,
    index) tuples: ({card: its merged [start, end, index] intervals} for
    cards 0 .. cards-1, busy), busy being the mean over those cards of
    each card's union, in the spans' unit. Activity on a card that the
    cell does not use is an error."""
    by_card = {card: [] for card in range(cards)}
    for card, s, e, i in spans:
        if card not in by_card:
            raise ValueError("device activity on card %r; the cell uses "
                             "cards 0 .. %d" % (card, cards - 1))
        by_card[card].append((s, e, i))
    unions = {card: _union(v) for card, v in by_card.items()}
    busy = sum(e - s for u in unions.values() for s, e, _ in u) / cards
    return unions, busy


def _runtime(name):
    """CUDA API calls (cudaLaunchKernel, cuLaunchKernel,
    cudaMemcpyAsync, ...): the host side of a device activity."""
    return name.startswith("cu")


def summarize(events, cards=1, top=10):
    """The traced window's numbers (seconds unless named otherwise) on a
    cell of `cards` cards: `busy_s` is the mean over the cards of each
    card's busy time, and the idle gaps are summed over the cards.

    A device kernel belongs to a scatter range when the runtime call that
    launched it (the CPU event of the same CUPTI correlation id) started
    inside the range, or when the operation it is linked to did: kernels
    launched through ctypes are linked to no operation. Device-side copies
    of the host's ranges (user annotations) are not device activity."""
    from torch.autograd import DeviceType

    cpu, dev = [], []
    for ev in events:
        if ev.device_type() == DeviceType.CPU:
            cpu.append(ev)
        elif ev.device_type() == DeviceType.CUDA and ev.duration_ns() > 0:
            dev.append(ev)
    host_names = {ev.name() for ev in cpu}
    dev = [ev for ev in dev if ev.name() not in host_names]
    win = [e for e in cpu if e.name() == WINDOW]
    if len(win) != 1:
        raise RuntimeError("the trace holds %d window ranges" % len(win))
    w0 = win[0].start_ns()
    w1 = w0 + win[0].duration_ns()
    ops = {e.correlation_id(): e.name() for e in cpu
           if not _runtime(e.name()) and e.linked_correlation_id() == 0
           and e.correlation_id() != 0}
    launches = {e.correlation_id(): e for e in cpu if _runtime(e.name())}
    # the scatter ranges by thread, and the operations and runtime calls
    # that started inside one
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                     e.start_thread_id()) for e in cpu
                    if e.name() == SCATTER)
    by_thread = {}
    for s, e, t in ranges:
        starts, ends = by_thread.setdefault(t, ([], []))
        starts.append(s)
        ends.append(e)

    def in_range(ev):
        found = by_thread.get(ev.start_thread_id())
        if not found:
            return False
        starts, ends = found
        j = bisect.bisect_right(starts, ev.start_ns()) - 1
        return j >= 0 and ev.start_ns() <= ends[j]

    inside_ops = {e.correlation_id() for e in cpu
                  if not _runtime(e.name()) and in_range(e)}
    inside_launches = {c for c, e in launches.items() if in_range(e)}
    spans, by_name = [], {}
    kernels = scatter_kernels = 0
    scatter_s = 0.0
    for i, ev in enumerate(dev):
        s = max(ev.start_ns(), w0)
        e = min(ev.start_ns() + ev.duration_ns(), w1)
        if e <= s:
            continue
        spans.append((ev.device_index(), s, e, i))
        sec = (e - s) * 1e-9
        by_name[ev.name()] = by_name.get(ev.name(), 0.0) + sec
        if not ev.name().startswith(COPIES):
            kernels += 1
            if (ev.correlation_id() in inside_launches
                    or ev.linked_correlation_id() in inside_ops):
                scatter_kernels += 1
                scatter_s += sec
    unions, busy = card_unions(spans, cards)
    busy *= 1e-9

    def host_op(ev):
        """What the host was doing when it launched `ev`."""
        op = ops.get(ev.linked_correlation_id())
        if op is None:
            launch = launches.get(ev.correlation_id())
            if launch is not None and in_range(launch):
                return SCATTER
            return launch.name() if launch is not None else "(no host op)"
        return op

    gaps = {}
    tail = "(after the last device op)"
    for merged in unions.values():
        prev = w0
        for s, e, i in merged:
            if s > prev:
                op = host_op(dev[i])
                gaps[op] = gaps.get(op, 0.0) + (s - prev) * 1e-9
            prev = e
        if w1 > prev:
            gaps[tail] = gaps.get(tail, 0.0) + (w1 - prev) * 1e-9
    order = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy,
            "kernels": kernels, "scatter_ranges": len(ranges),
            "scatter_kernels": scatter_kernels,
            "scatter_device_s": scatter_s,
            "device_ops": [[n[:160], s] for n, s in order],
            "idle_gaps": [[n[:160], s] for n, s in idle]}
