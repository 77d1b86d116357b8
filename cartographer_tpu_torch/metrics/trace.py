"""Spans of the program's own work, recorded only while a torch profiler
session is active.

`span(name, key)` outside a session returns one shared null object: no
clock read, no allocation, a flag test. Inside one (`torch.profiler.profile`
of any activity) it returns a span that, from `start()` (or `with`) to
`stop()`, stamps its wall time on `time.perf_counter_ns()` (the clock
`time.perf_counter` reads, on which the profiler's device events can be
placed) and its thread's CPU time on `time.thread_time_ns()`. Wall time
minus CPU time is the time the thread was runnable or blocked but not
running: a lock, the interpreter lock, a device synchronisation. Where
the thread clock advances in ticks (10 ms on some hosts), one span's CPU
time is a sample, and only a sum over many spans estimates it.

Each recorded span is one tuple in an in-memory list, in the order the
spans started:

    (name, start_ns, end_ns, thread_cpu_ns, thread_id, parent, key)

`parent` is the index in that list of the span that enclosed it on the
same thread (None at the top), `key` ties it to its request (the sensor
time of a range message or an accumulation, the node that dispatched a
drain); a span opened without a key takes its parent's. The list holds at
most `CAPACITY` spans; past it spans are counted in `spans_dropped()`
instead. Nothing is written anywhere: a reader takes `spans()` in the
process after the session. `enable_collection()` does not turn spans on.

`timed(name, key)` is for work that times itself on every call (the pose
graph's drain phases and its SPA solve): it always reads the clock, once
per boundary, returns the seconds from `stop()`, and records the span
while a session is active.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List

from torch.autograd import profiler as _profiler

CAPACITY = 1 << 20

# Spans as (sequence number at start, record), appended at stop; the
# sequence numbers come from one counter, whose next() is atomic.
_records: List[tuple] = []
_sequence = itertools.count()
_dropped = 0
_lock = threading.Lock()
_local = threading.local()


class _NullSpan:
    """What `span` returns outside a profiler session: does nothing."""

    __slots__ = ()

    def start(self) -> "_NullSpan":
        return self

    def stop(self) -> float:
        return 0.0

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "key", "records", "seq", "parent", "t0", "cpu0")

    def __init__(self, name: str, key=None):
        self.name = name
        self.key = key

    def start(self) -> "_Span":
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        # A span open across reset_spans() stops into the old list.
        self.records = _records
        self.seq = next(_sequence)
        self.parent = None
        if stack:
            parent = stack[-1]
            if self.key is None:
                self.key = parent.key
            if parent.records is self.records:
                self.parent = parent.seq
        stack.append(self)
        self.cpu0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def stop(self) -> float:
        global _dropped
        t1 = time.perf_counter_ns()
        cpu = time.thread_time_ns() - self.cpu0
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if len(self.records) < CAPACITY:
            self.records.append((self.seq, (self.name, self.t0, t1, cpu, threading.get_ident(),
                                            self.parent, self.key)))
        else:
            with _lock:
                _dropped += 1
        return (t1 - self.t0) * 1e-9

    def __enter__(self) -> "_Span":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class _Stopwatch:
    """`timed` outside a session: the clock alone, read once a boundary."""

    __slots__ = ("t0",)

    def __init__(self):
        self.t0 = time.perf_counter_ns()

    def stop(self) -> float:
        return (time.perf_counter_ns() - self.t0) * 1e-9


def span(name: str, key=None):
    """A span of `name`, not yet started; the shared null span outside a
    profiler session."""
    if not _profiler._is_profiler_enabled:
        return NULL_SPAN
    return _Span(name, key)


def timed(name: str, key=None):
    """Started: `stop()` returns the seconds since, on every call; a span
    of `name` is recorded as well inside a profiler session."""
    if not _profiler._is_profiler_enabled:
        return _Stopwatch()
    return _Span(name, key).start()


def spans() -> List[tuple]:
    """The spans recorded and stopped, in the order they started, with
    each parent as its index in this list."""
    records = sorted(list(_records), key=lambda r: r[0])
    index = {seq: i for i, (seq, _) in enumerate(records)}
    return [(name, t0, t1, cpu, thread, index.get(parent), key)
            for _, (name, t0, t1, cpu, thread, parent, key) in records]


def spans_dropped() -> int:
    """Spans not recorded because the list was full."""
    return _dropped


def reset_spans() -> None:
    """Clear the list and the count of dropped spans."""
    global _records, _sequence, _dropped
    with _lock:
        _records, _sequence, _dropped = [], itertools.count(), 0
