"""Spans and counters of the capture pipeline's step.

    with trace.span("channelize"):
        ...
    trace.count("launch.xlat_bank")

A span records where the step spends its time: its name, its host start
and end, the span it opened inside and the root span of its request (a
block through ``pipeline.step``, or through ``split2.step``). Spans are on
while ``enable()`` is in force or while ``torch.profiler`` records, so an
operator who profiles the site sees each span in the profiler's trace as
a host event, on the device trace's clock; spans are never profiler
annotations, which the profiler would also draw on the device's timeline
as if they were device work. One request in ``DEVICE_EVERY`` of each
root name whose step runs on the card is also timed on the device: each of
its spans records a pair of timing CUDA events on the step's stream (an
event between two kernels costs the device a few microseconds, so timing
every request would move the device's idle share it is meant to explain).
Each request's end reads the device times of the spans the device has
passed and keeps their events for later spans. Off, ``span`` costs one
check and returns a shared no-op.

Records stay in memory, the newest ``RECORDS``; ``summary()`` reduces
them to times by span name, ``requests(root)`` to the device times of each
request timed on the device. Counters (``count``) are always on: the
launches of each hand kernel (``launch.<kernel>``) and the host seconds
of set-up (``setup.*_s``: the kernel library's load, filter design,
first-seen constants and plans). Steps may run on several threads: each
keeps its own span stack, and the state they share is locked.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque

import torch
from torch._C._profiler import _RecordFunctionFast

RECORDS = 1 << 16          # span records kept, the newest
DEVICE_EVERY = 8           # requests of a root name a device-timed one

_on = False
_records: deque = deque(maxlen=RECORDS)
_cut = -1                  # roots up to this id lost spans to the bound
_pending: deque = deque()  # spans whose events the device may not have passed
_free: dict = {}           # device index -> timing events to record again
_seen: dict = {}           # root name -> requests since the last reset
_counters: dict = {}
_ids = itertools.count()
_local = threading.local()  # this thread's span stack and ``timed`` names
_lock = threading.Lock()    # _pending, _free, _seen, _counters: shared
_profiling = torch.autograd._profiler_enabled


class _Off:
    """The span while tracing is off: enters and exits doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _event(stream) -> torch.cuda.Event:
    """A timing event recorded on ``stream``: an idle one of its device's
    again where there is one (creating one costs the host more than a
    span's other work)."""
    with _lock:
        free = _free.get(stream.device_index)
        ev = free.pop() if free else None
    if ev is None:
        ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def _resolve(wait: bool) -> None:
    """Read the device time of the pending spans the device has passed,
    in the order their end events were recorded (all of them with
    ``wait``), and keep their events for reuse."""
    with _lock:
        while _pending:
            r = _pending[0]
            start, end = r.events
            if wait:
                end.synchronize()
            elif not end.query():
                return
            _pending.popleft()
            r.device_s = start.elapsed_time(end) * 1e-3
            r.events = None
            _free.setdefault(r.stream.device_index, []).extend((start, end))


class _Span:
    __slots__ = ("name", "id", "parent", "root", "root_name", "t0", "t1",
                 "child_ns", "cuda", "stream", "events", "device_s", "rf")

    def __init__(self, name: str, cuda: bool, profiling: bool):
        self.name = name
        self.cuda = cuda
        self.rf = _RecordFunctionFast(name) if profiling else None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            top = stack[-1]
            self.parent, self.root, self.root_name = top.id, top.root, \
                top.root_name
            self.cuda, self.stream = top.cuda, top.stream
        else:
            self.parent, self.root, self.root_name = None, self.id, self.name
            if self.cuda:
                with _lock:
                    k = _seen.get(self.name, 0)
                    _seen[self.name] = k + 1
                self.cuda = k % DEVICE_EVERY == 0
            self.stream = torch.cuda.current_stream() if self.cuda else None
        self.child_ns = 0
        self.events = self.device_s = None
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__enter__()
        if self.cuda:
            self.events = (_event(self.stream), None)
        return self

    def __exit__(self, *exc):
        global _cut
        if self.events is not None:
            self.events = (self.events[0], _event(self.stream))
            with _lock:
                _pending.append(self)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.t1 = time.perf_counter_ns()
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += self.t1 - self.t0
        if len(_records) == RECORDS:
            _cut = max(_cut, _records[0].root)
        _records.append(self)
        if not stack and _pending:
            _resolve(False)
        return False


def span(name: str, cuda: bool = False):
    """A context manager timing its body as the span ``name``. ``cuda``,
    for a root span: whether the request's work runs on the card (its
    spans are then timed on the device one request in ``DEVICE_EVERY``);
    a span inside a request takes its root's."""
    profiling = _profiling()
    if not (_on or profiling):
        return _OFF
    return _Span(name, cuda, profiling)


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counter(name: str):
    """The counter ``name``'s value (0 before its first count)."""
    return _counters.get(name, 0)


@contextlib.contextmanager
def timed(name: str):
    """Add the host seconds of the body to the counter ``name``; a body
    inside another ``timed`` of the same name on the same thread adds
    nothing of its own."""
    timing = getattr(_local, "timing", None)
    if timing is None:
        timing = _local.timing = set()
    if name in timing:
        yield
        return
    timing.add(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        timing.discard(name)
        count(name, time.perf_counter() - t0)


def enable(on: bool = True) -> None:
    """Record spans, also while no profiler records, until
    ``enable(False)``."""
    global _on
    _on = bool(on)


def reset(prefix: str = "") -> None:
    """Drop every span record and the counters whose names start with
    ``prefix`` (every counter by default)."""
    global _cut
    _records.clear()
    with _lock:
        _seen.clear()
        for name in [k for k in _counters if k.startswith(prefix)]:
            del _counters[name]
    _cut = -1


def summary(root: str | None = None) -> dict:
    """The span records and counters, reduced: ``spans`` by name, each
    ``n``, ``host_s``, ``self_host_s`` (less the time of its child
    spans), ``device_n`` and ``device_s`` (the spans timed on the device
    and their time between their CUDA events; None where none was);
    ``roots``, the number of root spans by name; ``counters``.
    ``root``: only the spans of requests whose root span is so named.
    Waits for the device to reach the recorded events. Requests that lost
    spans to the bound on the records are left out."""
    _resolve(True)
    spans: dict = {}
    roots: dict = {}
    for r in list(_records):
        if r.root <= _cut or (root is not None and r.root_name != root):
            continue
        s = spans.get(r.name)
        if s is None:
            s = spans[r.name] = {"n": 0, "host_s": 0.0, "self_host_s": 0.0,
                                 "device_n": 0, "device_s": None}
        s["n"] += 1
        s["host_s"] += (r.t1 - r.t0) * 1e-9
        s["self_host_s"] += (r.t1 - r.t0 - r.child_ns) * 1e-9
        if r.device_s is not None:
            s["device_n"] += 1
            s["device_s"] = (s["device_s"] or 0.0) + r.device_s
        if r.parent is None:
            roots[r.name] = roots.get(r.name, 0) + 1
    with _lock:
        counters = dict(_counters)
    return {"spans": spans, "roots": roots, "counters": counters}


def requests(root: str) -> list:
    """The requests whose root span is named ``root`` and that were timed
    on the device, in order: for each, its spans' device seconds by name
    (summed where a name repeats). Waits for the device as ``summary``
    does, and leaves out the same requests."""
    _resolve(True)
    out: dict = {}
    for r in list(_records):
        if r.root <= _cut or r.root_name != root or r.device_s is None:
            continue
        d = out.setdefault(r.root, {})
        d[r.name] = d.get(r.name, 0.0) + r.device_s
    return list(out.values())
