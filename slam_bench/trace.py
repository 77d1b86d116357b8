"""The traced run's device side: torch.profiler over the window, read
into device intervals on the host's `time.perf_counter` clock, and the
kernels' launch records for the roofline readers (the kernels that the
configuration's kind names, `record_launches` in `harness/<kind>.py`).

The profiler traces CUDA activity only (no host operator events), so its
cost on the host stays small; the host's side comes from the program's
own spans and the kind's `Probe`.
"""

from __future__ import annotations

import time
from typing import List

import torch


class DeviceTrace:
    def __init__(self, record_launches=None):
        """`record_launches(launches)`, where given, wraps the kernels
        whose launches go into `launches` while the trace runs, and
        returns [(module, name, original)] to restore."""
        self.events: List[tuple] = []  # (name, kind, start, end) perf_counter s
        self.launches = {}
        self._record_launches = record_launches
        self._restore = []

    def start(self, device) -> None:
        """Trace the card's activity (on a CPU rehearsal, the host's
        operators, which give no device events)."""
        from torch.profiler import ProfilerActivity, profile

        if self._record_launches is not None:
            self._restore = self._record_launches(self.launches)
        cuda = torch.device(device).type == "cuda"
        self._prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        self._prof.__enter__()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        for module, name, fn in self._restore:
            setattr(module, name, fn)
        # Kineto stamps events in Unix-epoch nanoseconds.
        offset = time.time() - time.perf_counter()
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start = e.start_ns() / 1e9 - offset
            self.events.append((e.name(), kind_of(e.name()), start,
                                start + e.duration_ns() / 1e9))
        self._prof = None


def short_name(name: str) -> str:
    """A kernel's qualified name without its return type, anonymous
    namespaces, template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):  # the parameter list opens at depth 0
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            cut = i
            break
    head, depth, out = name[:cut], 0, []
    for ch in head:  # drop template arguments
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">"
    return "".join(out).split(" ")[-1].strip() or name


def kind_of(name: str) -> str:
    """A device event's kind by its name: the profiler names copies
    "Memcpy ..." and fills "Memset ..."; every other one is a kernel."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def union_s(intervals, t0: float, t1: float) -> float:
    """Seconds of [t0, t1] covered by the union of `intervals`."""
    clipped = sorted((max(a, t0), min(b, t1)) for a, b in intervals if b > t0 and a < t1)
    total, cur_a, cur_b = 0.0, None, None
    for a, b in clipped:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def gaps(intervals, t0: float, t1: float):
    """Idle gaps (start, end) of the device within [t0, t1]."""
    clipped = sorted((max(a, t0), min(b, t1)) for a, b in intervals if b > t0 and a < t1)
    out, cursor = [], t0
    for a, b in clipped:
        if a > cursor:
            out.append((cursor, a))
        cursor = max(cursor, b)
    if t1 > cursor:
        out.append((cursor, t1))
    return out


def breakdown(record) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by what the host was doing at each one's middle
    (`program_spans.host_activity`), within the window."""
    from slam_bench import program_spans  # which imports this module

    t0, t1 = record["t0"], record["t1"]
    by_name = {}
    for name, _, a, b in record["device_events"]:
        if b > t0 and a < t1:
            key = short_name(name)
            by_name[key] = by_name.get(key, 0.0) + (min(b, t1) - max(a, t0))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    g = gaps([(a, b) for _, _, a, b in record["device_events"]], t0, t1)
    longest = sorted(g, key=lambda ab: ab[0] - ab[1])[:10]
    names = program_spans.host_activity(program_spans.program_spans(), record["spans"],
                                        [0.5 * (a + b) for a, b in longest])
    idle = [[name, b - a] for name, (a, b) in zip(names, longest)]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}
