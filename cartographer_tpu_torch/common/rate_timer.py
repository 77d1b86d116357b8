"""Sensor-rate estimation (reference: common/internal/rate_timer.h).

Port of cartographer_tpu/common/rate_timer.py.
"""

from __future__ import annotations

import collections
import math
import time as _walltime
from typing import Optional

from cartographer_tpu_torch.common.time import Time


class RateTimer:
    """Estimates events/sec over a sliding window of event timestamps."""

    def __init__(self, window_duration: float):
        self._window_duration = window_duration
        self._events: collections.deque = collections.deque()  # (sensor_time, wall_time)

    def pulse(self, time: Time, wall_time: Optional[float] = None) -> None:
        if wall_time is None:
            wall_time = _walltime.monotonic()
        self._events.append((time, wall_time))
        while (
            len(self._events) > 2
            and wall_time - self._events[0][1] > self._window_duration
        ):
            self._events.popleft()

    def compute_rate(self) -> float:
        """Events per second in sensor time."""
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        if dt <= 0:
            return 0.0
        return (len(self._events) - 1) / dt

    def compute_wall_time_rate_ratio(self) -> float:
        if len(self._events) < 2:
            return float("nan")
        dt_sensor = self._events[-1][0] - self._events[0][0]
        dt_wall = self._events[-1][1] - self._events[0][1]
        if dt_wall <= 0:
            return float("nan")
        return dt_sensor / dt_wall

    def debug_string(self) -> str:
        r = self.compute_rate()
        ratio = self.compute_wall_time_rate_ratio()
        return f"{r:.2f} Hz ({self.delta_string()}) ({100.0 * ratio:.2f}% real time)"

    def delta_string(self) -> str:
        if len(self._events) < 2:
            return ""
        deltas = [
            self._events[i + 1][0] - self._events[i][0]
            for i in range(len(self._events) - 1)
        ]
        mean = sum(deltas) / len(deltas)
        var = sum((d - mean) ** 2 for d in deltas) / len(deltas)
        return f"pulsed at {1e3 * mean:.2f} ms +/- {1e3 * math.sqrt(var):.2f} ms"
