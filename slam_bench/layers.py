"""The arithmetic the metric readers share: the rate over the window,
span time per revolution, busy and idle shares, and kernel time
against its bound.

Every reader gets one run's `record`: the window [t0, t1) on
`time.perf_counter`, the revolutions due in it and when each one's
result came back, the spans of the kind's `Probe` and, in the traced
run, the device events and kernel launches of `trace.DeviceTrace`.
"""

from __future__ import annotations


import numpy as np

from slam_bench.trace import union_s


def completed_in_window(record) -> int:
    done = np.asarray(record["done"], np.float64)
    return int(np.sum((done >= record["t0"]) & (done < record["t1"])))


def rate(record) -> float:
    """Revolutions whose result returned inside the window, per second
    of the window."""
    return completed_in_window(record) / (record["t1"] - record["t0"])


def span_s(record, name: str) -> float:
    """Seconds of `name` spans inside the window (clipped to it)."""
    t0, t1 = record["t0"], record["t1"]
    return sum(max(0.0, min(b, t1) - max(a, t0)) for n, a, b in record["spans"] if n == name)


def per_revolution_ms(record, seconds: float):
    n = completed_in_window(record)
    return None if n == 0 else 1e3 * seconds / n


def busy_share(record, names) -> float:
    """The share of the window in which any span of `names` was open."""
    t0, t1 = record["t0"], record["t1"]
    spans = [(a, b) for n, a, b in record["spans"] if n in names]
    return union_s(spans, t0, t1) / (t1 - t0)


def device_busy_s(record) -> float:
    return union_s([(a, b) for _, _, a, b in record["device_events"]], record["t0"], record["t1"])


def device_idle_share(record):
    if not record.get("device_events"):
        return None
    return 1.0 - device_busy_s(record) / (record["t1"] - record["t0"])


def kernel_device_s(record, substrings) -> float:
    """Device seconds of the kernels whose names hold one of `substrings`,
    over the whole traced span (the launches recorded alike)."""
    return sum(b - a for name, _, a, b in record["device_events"]
               if any(s in name for s in substrings))
