"""The arithmetic the readers of the program's own spans share.

The port records spans (`cartographer_tpu_torch.metrics.spans()`) only
while a torch profiler session is active, which is the traced run's
(`trace.DeviceTrace`), stamped on `time.perf_counter_ns()`: the clock of
the record's window and of its device events, in nanoseconds. A reader
takes them in the process after the window, clips each to the window
[t0, t1) and divides by the revolutions completed in it. The feeding
thread is the one that ran the facade's `add_sensor_data` spans.

Where the program records no spans (a version without the recorder) or
dropped any past its cap, every reader here returns None: a truncated
trace never reads as a number.
"""

from __future__ import annotations

import bisect
import collections
import heapq

from slam_bench import layers
from slam_bench.trace import gaps

FEEDER = "facade.add_sensor_data"
LOCAL_SLAM = ("local_slam.unwarp", "local_slam.filter", "local_slam.scan_match",
              "local_slam.insert")


def program_spans():
    """[(name, start_s, end_s, cpu_s, thread, parent, key)] on the
    perf_counter clock in seconds, or None where the program recorded
    none or dropped some."""
    from cartographer_tpu_torch import metrics

    read = getattr(metrics, "spans", None)
    dropped = getattr(metrics, "spans_dropped", None)
    if read is None or dropped is None or dropped() > 0:
        return None
    out = [(name, a * 1e-9, b * 1e-9, cpu * 1e-9, thread, parent, key)
           for name, a, b, cpu, thread, parent, key in read()]
    return out or None


def feeding_thread(spans):
    threads = collections.Counter(s[4] for s in spans if s[0] == FEEDER)
    return threads.most_common(1)[0][0] if threads else None


def clipped(record, span) -> float:
    """Seconds of `span` inside the window."""
    return max(0.0, min(span[2], record["t1"]) - max(span[1], record["t0"]))


def ms_per_scan(record, names, feeder_only: bool = False):
    """Milliseconds a revolution of the spans of `names` (on the feeding
    thread alone if `feeder_only`) inside the window."""
    spans = program_spans()
    if spans is None:
        return None
    thread = feeding_thread(spans) if feeder_only else None
    if feeder_only and thread is None:
        return None
    s = sum(clipped(record, sp) for sp in spans
            if sp[0] in names and (thread is None or sp[4] == thread))
    return layers.per_revolution_ms(record, s)


def off_cpu_s(record, spans):
    """{stage: seconds} in which the feeding thread was inside a local
    SLAM stage but not running: the stage's wall time inside the window
    minus its thread CPU time, each span's CPU scaled to its part inside
    the window. Summed before the difference is taken: where the thread
    clock advances in ticks (10 ms on the card's host), one span's CPU
    time reads 0 or a whole tick, and only the sum over the window's
    spans estimates it."""
    thread = feeding_thread(spans)
    out = dict.fromkeys(LOCAL_SLAM, 0.0)
    for sp in spans:
        if sp[0] in out and sp[4] == thread and sp[2] > sp[1]:
            inside = clipped(record, sp)
            out[sp[0]] += inside - sp[3] * inside / (sp[2] - sp[1])
    return {name: max(0.0, s) for name, s in out.items()}


def innermost_at(spans, times):
    """For sorted `times`, the name of the innermost span of `spans` open
    at each (the latest started of those open), or None."""
    ordered = sorted(spans, key=lambda sp: sp[1])
    heap, out, i = [], [], 0
    for t in times:
        while i < len(ordered) and ordered[i][1] <= t:
            heapq.heappush(heap, (-ordered[i][1], i))
            i += 1
        while heap and ordered[heap[0][1]][2] <= t:
            heapq.heappop(heap)
        out.append(ordered[heap[0][1]][0] if heap else None)
    return out


def host_activity(spans, outside, times):
    """What the host was doing at each of `times`: the innermost program
    span open on the feeding thread; where none is, the innermost one on
    the other threads (the pose graph's pool); where no program span is
    open at all (or `spans` is None), the innermost of the benchmark's
    own spans `outside`, (name, start, end); else "feeder (no span open)"."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    at = [times[i] for i in order]
    spans = spans or []
    thread = feeding_thread(spans)
    tiers = (innermost_at([sp for sp in spans if sp[4] == thread], at),
             innermost_at([sp for sp in spans if sp[4] != thread], at),
             innermost_at(outside, at))
    out = [None] * len(times)
    for j, i in enumerate(order):
        out[i] = next((names[j] for names in tiers if names[j]), "feeder (no span open)")
    return out


def idle_by_span(record, spans):
    """Device-idle seconds of the window split by what the program had
    open: {(the feeding thread's innermost span, the other threads'
    innermost span): seconds}. Each idle gap is cut at every span
    boundary inside it, so that a gap across several spans is shared
    among them."""
    t0, t1 = record["t0"], record["t1"]
    idle = gaps([(a, b) for _, _, a, b in record["device_events"]], t0, t1)
    thread = feeding_thread(spans)
    bounds = sorted({t for sp in spans for t in sp[1:3] if t0 < t < t1} | {t0})
    feeder = innermost_at([sp for sp in spans if sp[4] == thread], bounds)
    backend = innermost_at([sp for sp in spans if sp[4] != thread], bounds)
    out = collections.Counter()
    for a, b in idle:
        i = bisect.bisect_right(bounds, a) - 1
        while a < b:
            end = min(b, bounds[i + 1] if i + 1 < len(bounds) else t1)
            if end > a:
                out[(feeder[i] or "feeder (no span open)",
                     backend[i] or "backend (no span open)")] += end - a
            a, i = end, i + 1
    return out
