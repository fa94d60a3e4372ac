"""Timing and tracing helpers (counterpart of ygz_slam_tpu/utils/profiling.py):
named wall-clock accumulators that can wait for the card, a torch.profiler
trace, and an in-memory recorder of the program's own spans.

Spans mark where the host is in the work: `span(name)` around a stage,
recorded only inside `tracing()`.  Each record holds its id, its parent's
id, the name, the thread (its name and identifier), the frame the work
belongs to, and its start and end on `time.perf_counter_ns`, the host
clock a profiler trace is mapped onto.  A span neither synchronises the
device nor calls into torch, so it times the host's part of the work: the
launches, and any wait for the device that the code inside it makes.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch


def _synchronize(value) -> None:
    """Wait for the devices that `value`'s tensors (a tensor, or a tuple,
    list or dict of them) live on; CPU tensors need no wait."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _synchronize(v)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _synchronize(v)


class Timers:
    """Named wall-clock accumulators; `time(name, block_on=x)` waits for the
    card to finish x's work before it stops the clock, so asynchronous
    launches do not hide their kernels' time."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": round(self.total[k], 4), "count": self.count[k],
                    "mean_ms": round(1e3 * self.total[k] / max(self.count[k], 1), 3)}
                for k in sorted(self.total)}

    def log_line(self) -> str:
        return json.dumps(self.summary())

    def reset(self):
        self.total.clear()
        self.count.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """A torch.profiler trace of the block (host operators, and the card's
    kernels where CUDA is available), written to `logdir` as a Chrome trace
    (trace.json); yields the profiler, whose key_averages() the caller may
    read after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class SpanRecord(NamedTuple):
    """One finished span."""
    id: int
    parent: int | None     # the id of the span that caused it
    name: str
    thread: str            # the recording thread's name
    tid: int               # and its identifier (threading.get_ident), whose low 32 bits a
                           # profiler's launch events carry as their resource id
    frame: int | None      # the camera frame the work belongs to
    t0: int                # perf_counter_ns at entry
    t1: int                # and at exit


class _NoSpan:
    """What `span` returns while nothing records: one shared object that
    enters and leaves doing nothing."""
    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()
_sink: list | None = None          # the list of the innermost open `tracing()`
_ids = itertools.count(1)          # next() on a count is atomic under the GIL
_open = threading.local()          # .stack: this thread's open spans, innermost last


def _stack() -> list:
    try:
        return _open.stack
    except AttributeError:
        _open.stack = []
        return _open.stack


class Span:
    """An open span; recorded into the list it was made for when it exits.
    A span given no frame takes its parent's."""
    __slots__ = ("_sink", "name", "frame", "parent", "id", "t0")

    def __init__(self, sink: list, name: str, frame, parent):
        self._sink, self.name, self.frame, self.parent = sink, name, frame, parent
        self.id = self.t0 = None

    def __enter__(self) -> "Span":
        stack = _stack()
        up = self.parent if self.parent is not None else (stack[-1] if stack else None)
        if isinstance(up, Span):
            self.parent = up.id
            if self.frame is None:
                self.frame = up.frame
        self.id = next(_ids)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        _stack().pop()
        th = threading.current_thread()
        self._sink.append(SpanRecord(self.id, self.parent, self.name, th.name, th.ident,
                                     self.frame, self.t0, t1))
        return False


def span(name: str, frame: int | None = None, parent=None):
    """A context manager timing the block as span `name`, for `frame` (by
    default its parent's).  Its parent is the innermost span open on this
    thread, or `parent` (a Span or a span id) where given: a span opened on
    a worker thread names the span that started the work.  While no
    `tracing()` is open this returns one shared object that does nothing:
    no clock read, no allocation, no lock."""
    sink = _sink
    if sink is None:
        return _NO_SPAN
    return Span(sink, name, frame, parent)


def current_span() -> Span | None:
    """The innermost span open on this thread (None while none is, or
    while nothing records): what a worker thread's first span takes as its
    `parent`."""
    if _sink is None:
        return None
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def tracing():
    """Record every span opened, on any thread, while the block runs; yields
    the list of SpanRecords, in the order the spans ended.  A span still
    open when the block ends is recorded into that list when it exits."""
    global _sink
    prev, _sink = _sink, []
    try:
        yield _sink
    finally:
        _sink = prev
