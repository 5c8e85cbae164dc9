"""Spans and counters inside graphvite_tpu_torch.

A span is a context manager around one piece of the program's work: its
name, its start and end on the profiler's clock, the id of the span it
runs inside, and, inside a batch, the batch index (the spans of one batch
share it). A counter is a named sum. Both are kept in memory, in a
recording session:

* a session starts at the first span opened while a `torch.profiler`
  session is active, and ends with that span (or with the profiler), or
  it runs inside `recording()`; `utils.common.device_profile` opens one;
* with no session a span site costs a branch and a read of the profiler's
  on/off flag: it reads no clock, opens no profiler range and allocates
  nothing;
* while a profiler is active each span is also a profiler range of the
  same name (a user-scope record function, as `record_function` makes,
  through its C++ fast path), and its stored start and end come from the
  clock that the profiler stamps its events with (Unix-epoch
  nanoseconds), read next to the range's own stamps: stored spans line
  up with a device trace to a few microseconds;
* a span of a training call on a CUDA device records a CUDA event at its
  start and at its end on the current stream; its device seconds are the
  time between the two, read by `resolve()` once the device has finished
  them (the solvers call it after the synchronize that ends a call, so no
  synchronize is added per batch). Elsewhere device seconds equal host
  seconds;
* spans draw no random numbers and reorder no device work.

`last_session()` gives the newest session's totals per span name (count,
host seconds, self seconds, device seconds), its counters and its raw
spans (at most MAX_SPANS; the rest are counted as dropped).

Set-up stages (functions decorated with `setup_stage(name)`: the graph's
finalize, the solver's build, the samplers' builds, the kernels' and the
native library's compiles) are the exception: a handful per process,
always timed on the host clock, into per-name totals (`setup_totals()`),
and spans like any other inside a session.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
import time

import torch

PREFIX = "graphvite::"
# spans of a training call, from the entry down
TRAIN = PREFIX + "train"
PREPARE = PREFIX + "prepare"
EPISODE = PREFIX + "episode"
SAMPLE = PREFIX + "sample"
STEP = PREFIX + "step"
NEGATIVES = PREFIX + "negatives"
UPDATE = PREFIX + "update"
FINISH = PREFIX + "finish"
ALIAS_BUILD = PREFIX + "alias.build"
# set-up stages, always timed
GRAPH_FINALIZE = PREFIX + "graph.finalize"
SOLVER_BUILD = PREFIX + "solver.build"
SAMPLER_BUILD = PREFIX + "sampler.build"
KERNELS_BUILD = PREFIX + "kernels.build"
NATIVE_BUILD = PREFIX + "native.build"
# counters
PAIR_SLOTS = PREFIX + "pair_slots"
VALID_PAIRS = PREFIX + "valid_pairs"
# the walks engine's row requests to their owners, and those dropped past
# an owner's capacity
ROW_REQUESTS = PREFIX + "row_requests"
ROW_DROPS = PREFIX + "row_drops"

MAX_SPANS = 200_000

_profiler_enabled = torch._C._autograd._profiler_enabled

_session = None     # the recording session, or None
_last = None        # the newest session
_setup = {}         # set-up stage -> [count, seconds, self seconds]
_setup_local = threading.local()


def _clock():
    """The profiler's clock: its events carry Unix-epoch nanoseconds."""
    return time.time_ns()


class _Off:
    """What a span site gets with no session: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key, value):
        pass


OFF = _Off()


class Span:
    """One span: open while its `with` block runs, then a raw record."""
    __slots__ = ("session", "name", "id", "parent", "batch", "device",
                 "start_ns", "end_ns", "device_s", "attrs", "is_stage",
                 "_parent", "_child_ns", "_range", "_events")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.session._close(self)
        return False

    def set(self, key, value):
        """An attribute of the span (kept in its raw record)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value


class Session:
    """The spans and counters recorded between a session's start and
    end. `auto`: started by a span under a profiler, and ended with that
    span (a profiler's start is not observable, so one session never
    spans two profilers)."""

    def __init__(self, auto=False):
        self.auto = auto
        self.stats = {}        # name -> [count, host ns, self ns, device s]
        self.counters = {}
        self.spans = []        # raw records, at most MAX_SPANS
        self.dropped = 0
        self._local = threading.local()
        self._ids = 0
        self._pending = []         # closed spans with unread device markers
        self._pending_counts = {}  # counter -> [device scalars]
        self._free_events = []

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _event(self):
        if self._free_events:
            return self._free_events.pop()
        return torch.cuda.Event(enable_timing=True)

    def open(self, name, batch=None, device=None, is_stage=False):
        stack = self._stack()
        parent = stack[-1] if stack else None
        if parent is not None:
            if batch is None:
                batch = parent.batch
            if device is None:
                device = parent.device
        sp = Span()
        sp.session, sp.name, sp.batch, sp.device = self, name, batch, device
        sp.id = self._ids
        self._ids += 1
        sp._parent = parent
        sp.parent = None if parent is None else parent.id
        sp.attrs = None
        sp.is_stage = is_stage
        sp._child_ns = 0
        sp.device_s = None
        sp._range = sp._events = None
        if _profiler_enabled():
            sp._range = torch._C._profiler._RecordFunctionFast(name)
            sp._range.__enter__()
        sp.start_ns = _clock()
        if device is not None and device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            sp._events = (self._event(), self._event(), stream)
            sp._events[0].record(stream)
        stack.append(sp)
        return sp

    def _close(self, sp):
        stack = self._stack()
        if sp not in stack:
            return
        # stages left open inside the span end with it
        while stack[-1] is not sp:
            self._finish(stack.pop())
        self._finish(stack.pop())
        if self.auto and not stack:
            _end(self)

    def _finish(self, sp):
        if sp._events is not None:
            sp._events[1].record(sp._events[2])
        sp.end_ns = _clock()
        if sp._range is not None:
            sp._range.__exit__(None, None, None)
            sp._range = None
        dur = sp.end_ns - sp.start_ns
        if sp._parent is not None:
            sp._parent._child_ns += dur
            sp._parent = None
        st = self.stats.get(sp.name)
        if st is None:
            st = self.stats[sp.name] = [0, 0, 0, 0.0]
        st[0] += 1
        st[1] += dur
        st[2] += dur - sp._child_ns
        if sp._events is None:
            sp.device_s = dur * 1e-9
            st[3] += sp.device_s
        else:
            self._pending.append(sp)
        if len(self.spans) < MAX_SPANS:
            self.spans.append(sp)
        else:
            self.dropped += 1

    def stage(self, name):
        stack = self._stack()
        if stack and stack[-1].is_stage:
            self._finish(stack.pop())
        # a stage needs a span to end it
        if name is not None and stack:
            self.open(name, is_stage=True)

    def count(self, name, value):
        if torch.is_tensor(value):
            self._pending_counts.setdefault(name, []).append(value)
        else:
            self.counters[name] = self.counters.get(name, 0) + value

    def resolve(self, sync=False):
        """Read the device markers and device counters recorded so far.
        Without `sync` the caller has already waited for the device."""
        if sync and (self._pending or self._pending_counts) \
                and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        for sp in self._pending:
            ev0, ev1, _ = sp._events
            sp.device_s = ev0.elapsed_time(ev1) * 1e-3
            self.stats[sp.name][3] += sp.device_s
            sp._events = None
            self._free_events += (ev0, ev1)
        self._pending = []
        for name, values in self._pending_counts.items():
            total = 0
            by_kind = {}
            for v in values:
                by_kind.setdefault((v.dtype, v.device), []).append(v)
            for group in by_kind.values():
                nums = torch.stack(group).tolist()
                total += (math.fsum(nums) if group[0].is_floating_point()
                          else sum(nums))
            self.counters[name] = self.counters.get(name, 0) + total
        self._pending_counts = {}

    def summary(self):
        return {"spans": {name: {"count": st[0], "host_s": st[1] * 1e-9,
                                 "self_s": st[2] * 1e-9,
                                 "device_s": st[3]}
                          for name, st in self.stats.items()},
                "counters": dict(self.counters),
                "raw": list(self.spans), "dropped": self.dropped}


def _end(session):
    global _session
    if _session is session:
        _session = None


def _active():
    """The session a span site records into, or None."""
    global _session, _last
    s = _session
    if s is None:
        if not _profiler_enabled():
            return None
        s = _session = _last = Session(auto=True)
    elif s.auto and not _profiler_enabled():
        _session = None
        return None
    return s


def span(name, batch=None, device=None):
    """A span of `name` (a context manager). `batch`: the batch index,
    taken from the enclosing span when None; `device`: the torch device
    whose current stream carries the span's device markers, likewise
    inherited (None: host time only)."""
    s = _active()
    if s is None:
        return OFF
    return s.open(name, batch, device)


def stage(name):
    """End the open stage of the innermost span, and open stage `name`
    (None: none) as its child; a span's end ends its open stage. Stages
    are the phases of a call that no single block encloses."""
    s = _session
    if s is not None:
        s.stage(name)


def count(name, value):
    """Add `value` (a number, or a device scalar summed at `resolve()`) to
    counter `name`."""
    s = _session
    if s is not None:
        s.count(name, value)


def resolve():
    """Read the recording session's device markers and counters; call
    once the device has finished the work recorded so far."""
    s = _session
    if s is not None:
        s.resolve()


@contextlib.contextmanager
def recording():
    """A recording session around the block (yields it)."""
    global _session, _last
    prev = _session
    s = _session = _last = Session()
    try:
        yield s
    finally:
        _session = prev
        s.resolve(sync=True)


def last_session():
    """The newest session's {"spans": {name: {count, host_s, self_s,
    device_s}}, "counters": {name: value}, "raw": [Span], "dropped": n},
    or None when no session has run."""
    s = _last
    if s is None:
        return None
    s.resolve(sync=True)
    return s.summary()


class _Setup:
    """A set-up stage: host-clock totals always, a span in a session."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = getattr(_setup_local, "stack", None)
        if stack is None:
            stack = _setup_local.stack = []
        self.stack = stack
        self.inner = span(self.name)
        self.nested = 0.0
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.stack.pop()
        if self.stack:
            self.stack[-1].nested += dt
        tot = _setup.setdefault(self.name, [0, 0.0, 0.0])
        tot[0] += 1
        tot[1] += dt
        tot[2] += dt - self.nested
        self.inner.__exit__(*exc)
        return False


def setup_stage(name):
    """Decorator: the function runs as set-up stage `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def staged(*args, **kwargs):
            with _Setup(name):
                return fn(*args, **kwargs)
        return staged
    return wrap


def setup_totals():
    """{stage: {"count", "seconds", "self_seconds"}} over the process;
    self seconds leave out the set-up stages nested inside."""
    return {name: {"count": c, "seconds": s, "self_seconds": own}
            for name, (c, s, own) in _setup.items()}
