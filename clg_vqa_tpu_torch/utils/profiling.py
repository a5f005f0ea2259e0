"""Profiling and observability (port of clg_vqa_tpu/utils/profiling.py on
``torch.profiler`` and ``torch.cuda``):

 - ``trace(logdir)``: a torch.profiler trace of the enclosed code (the host
   and, when CUDA is available, the card's kernels), written as a Chrome
   trace to ``<logdir>/trace.json``;
 - ``span(name)``: a named host phase of the program (``train.forward``,
   ``eval.consume``, ``extract.backbone``, ...). While no torch profiler
   records, it only checks that; while one records (``trace``, any
   ``torch.profiler.profile``), it is a ``record_function`` range, so the
   phase shows in the Chrome trace beside the kernels it launched, and it
   leaves a :class:`SpanRecord` that ``span_records()`` returns;
 - ``count(name, values)``: a counter next to the spans. While a profiler
   records, the device tensor ``values`` is copied without blocking into
   pinned host memory and kept as a :class:`CounterRecord` of the unit the
   spans give it (``counter_records()`` waits for the copies, so read them
   after the trace); off, it only checks for a profiler, and nothing is
   copied or synchronised;
 - ``device_memory_stats()``: per-device bytes in use, peak and limit.

StepTimer, the JAX package's synchronising step timer, has no port: the
profiler's trace gives the device's time without a synchronise a step.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import NamedTuple

import torch

MAX_RECORDS = 1 << 16


class SpanRecord(NamedTuple):
    name: str
    parent: str | None      # the enclosing span's name; None at the top
    unit: int               # the step or pass: counts the top-level spans
    start_ns: int           # time.perf_counter_ns()
    end_ns: int


class CounterRecord(NamedTuple):
    name: str
    unit: int               # the step or pass of the innermost open span
    values: torch.Tensor    # a host copy of the counted tensor


# the latest profiler session's records, oldest first; a session begins at
# the first span that finds a profiler recording after a span found none
# (the profiler itself tells no session from the next)
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_counters: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_session = {"new": True, "units": 0}
_open = threading.local()           # each thread's stack of open spans
_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "unit", "range", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start = time.perf_counter_ns()
        if _session["new"]:
            _session.update(new=False, units=0)
            _records.clear()
            _counters.clear()
        stack = _open.__dict__.setdefault("stack", [])
        if stack:
            self.unit = stack[-1].unit
        else:
            _session["units"] += 1
            self.unit = _session["units"]
        stack.append(self)
        self.range = torch.autograd.profiler.record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        stack = _open.stack
        stack.pop()
        _records.append(SpanRecord(self.name, stack[-1].name if stack else None,
                                   self.unit, self.start, time.perf_counter_ns()))
        return False


def span(name: str):
    """``with span(name):`` around a host phase. Off (no profiler
    recording): one check, nothing allocated or kept. On: a
    ``record_function(name)`` range and a :class:`SpanRecord` whose unit is
    that of the outermost span open on this thread."""
    if not _recording():
        _session["new"] = True
        return _OFF
    return _Span(name)


def span_records() -> list[SpanRecord]:
    """The finished spans of the latest profiler session, in the order they
    closed (at most ``MAX_RECORDS``, the latest kept); not cleared by
    reading. A session begins only after a span has run with no profiler
    recording: two profilers with no such span between them are one
    session, their records kept together."""
    return list(_records)


def count(name: str, values: torch.Tensor) -> None:
    """Keep ``values`` (a tensor on any device) under ``name`` while a
    profiler records: a non-blocking copy into pinned host memory, with an
    event behind it, so the step issues on without waiting. Off: one check,
    nothing copied."""
    if not _recording():
        return
    stack = getattr(_open, "stack", None)
    unit = stack[-1].unit if stack else _session["units"]
    v = values.detach()
    if v.device.type == "cuda":
        host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host.copy_(v, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
    else:
        host, ready = v.clone(), None
    _counters.append((CounterRecord(name, unit, host), ready))


def counter_records() -> list[CounterRecord]:
    """The counters of the latest profiler session, oldest first, each
    copy waited for; not cleared by reading."""
    out = []
    for rec, ready in list(_counters):
        if ready is not None:
            ready.synchronize()
        out.append(rec)
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed code; yields the ``torch.profiler.profile``
    (its ``key_averages()`` give the per-kernel times) and writes
    ``<logdir>/trace.json`` when the block ends."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats() -> list[dict]:
    """One dict per CUDA device: bytes_in_use and peak_bytes_in_use from
    PyTorch's allocator, bytes_limit the device's memory. Without CUDA, one
    entry for the CPU with the device's name only, as JAX's CPU devices
    report no memory stats."""
    if not torch.cuda.is_available():
        return [{"device": "cpu"}]
    return [{"device": f"cuda:{i}",
             "bytes_in_use": torch.cuda.memory_allocated(i),
             "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
             "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
            for i in range(torch.cuda.device_count())]
