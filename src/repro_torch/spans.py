"""Named spans inside the port's hot paths, recorded only while a
`torch.profiler` session records.

    from repro_torch import spans

    with spans.span("gibbs.solve", device):
        ...

With no profiler recording, `span` checks one module flag and returns one
shared null context: no `record_function`, no CUDA event, no record. A
profiler is recording when `torch.autograd.profiler._is_profiler_enabled`
is set: a module flag, True in a schedule's active step on every thread
and False in its warm-up step (`torch.autograd._profiler_enabled()` is
thread-local and reads False on a second thread).

While it records, a span

* enters `torch.profiler.record_function(name)`, so the span is a
  `user_annotation` event of the same trace, on the same clock, as the
  kernels, copies and sets the card ran;
* on a CUDA device, records a start and an end `torch.cuda.Event` on the
  device's current stream, for the stream time between them;
* appends a `Record`: its name, its parent span on the thread, the host
  clock at both ends, the two events, and the id of the thread's outermost
  span (one sweep or one served batch has one id).

Nothing synchronizes on the hot path: `totals()` waits for the recorded
events once, when it is read. A span whose body raises keeps no record.
Records stay in memory until `reset()`; nothing is written to a file.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

__all__ = ["Record", "records", "reset", "span", "totals"]

_OFF = contextlib.nullcontext()
_records: list = []
_records_lock = threading.Lock()
_local = threading.local()
_roots = itertools.count(1)


class Record(NamedTuple):
    """One span as recorded: host times from `time.perf_counter`, the
    events None off the card."""

    name: str
    parent: str | None      # the enclosing span on the same thread
    root: int               # the id of the thread's outermost span
    host_start: float
    host_end: float
    start: torch.cuda.Event | None
    end: torch.cuda.Event | None


def span(name: str, device: torch.device | None = None):
    """A context that records `name` while a profiler records, and does
    nothing otherwise. `device` is where the span's work runs: on a CUDA
    device the span also times the device's current stream."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _recorded(name, device)


def _event(device: torch.device) -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


@contextlib.contextmanager
def _recorded(name: str, device):
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    parent, root = stack[-1] if stack else (None, next(_roots))
    on_card = device is not None and torch.device(device).type == "cuda"
    stack.append((name, root))
    try:
        with torch.profiler.record_function(name):
            start = _event(device) if on_card else None
            t0 = time.perf_counter()
            yield
            t1 = time.perf_counter()
            end = _event(device) if on_card else None
    finally:
        stack.pop()
    with _records_lock:
        _records.append(Record(name, parent, root, t0, t1, start, end))


def records() -> list[Record]:
    """The spans recorded since the last `reset()`, in the order they ended."""
    with _records_lock:
        return list(_records)


def reset() -> None:
    """Forget every recorded span."""
    with _records_lock:
        _records.clear()


def totals() -> dict[str, dict]:
    """By span name: `calls`, `host_s` (summed host time) and `device_s`
    (summed stream time between each span's two events; None where no span
    of the name ran on a card). Waits for the recorded events."""
    out: dict[str, dict] = {}
    for r in records():
        t = out.setdefault(r.name, {"calls": 0, "host_s": 0.0, "device_s": None})
        t["calls"] += 1
        t["host_s"] += r.host_end - r.host_start
        if r.end is not None:
            r.end.synchronize()
            t["device_s"] = (t["device_s"] or 0.0) + 1e-3 * r.start.elapsed_time(r.end)
    return out
