"""Timestamped transforms and interpolation buffer.

Copy of cartographer_tpu/transform/interpolation.py (numpy; no device code).

Reference: transform/timestamped_transform.h (Interpolate) and
transform/transform_interpolation_buffer.h:35 (bounded pose history with
Lookup(time)).
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np

from cartographer_tpu_torch.common.time import Time
from cartographer_tpu_torch.transform import rigid3


@dataclasses.dataclass
class TimestampedTransform:
    time: Time
    transform: np.ndarray  # SE(3) pose (7,)


def interpolate_timed(
    start: TimestampedTransform, end: TimestampedTransform, time: Time
) -> TimestampedTransform:
    assert start.time <= time <= end.time
    duration = end.time - start.time
    factor = 0.0 if duration == 0 else (time - start.time) / duration
    return TimestampedTransform(
        time=time,
        transform=rigid3.interpolate(start.transform, end.transform, factor),
    )


UNLIMITED_BUFFER_SIZE = 0


class TransformInterpolationBuffer:
    """Sorted, optionally bounded, history of timestamped transforms."""

    def __init__(self, buffer_size_limit: int = UNLIMITED_BUFFER_SIZE):
        self._times: list[Time] = []
        self._transforms: list[np.ndarray] = []
        self._buffer_size_limit = buffer_size_limit

    def push(self, time: Time, transform: np.ndarray) -> None:
        if self._times:
            assert time >= self._times[-1], "New transform is older than latest."
        self._times.append(time)
        self._transforms.append(np.asarray(transform))
        self._remove_old_if_needed()

    def set_size_limit(self, buffer_size_limit: int) -> None:
        self._buffer_size_limit = buffer_size_limit
        self._remove_old_if_needed()

    def _remove_old_if_needed(self) -> None:
        if self._buffer_size_limit == UNLIMITED_BUFFER_SIZE:
            return
        while len(self._times) > self._buffer_size_limit:
            self._times.pop(0)
            self._transforms.pop(0)

    def clear(self) -> None:
        self._times.clear()
        self._transforms.clear()

    def has(self, time: Time) -> bool:
        if not self._times:
            return False
        return self.earliest_time() <= time <= self.latest_time()

    def lookup(self, time: Time) -> np.ndarray:
        assert self.has(time), f"Missing transform for time {time}"
        i = bisect.bisect_left(self._times, time)
        if i < len(self._times) and self._times[i] == time:
            return self._transforms[i]
        start = TimestampedTransform(self._times[i - 1], self._transforms[i - 1])
        end = TimestampedTransform(self._times[i], self._transforms[i])
        return interpolate_timed(start, end, time).transform

    def earliest_time(self) -> Time:
        return self._times[0]

    def latest_time(self) -> Time:
        return self._times[-1]

    def empty(self) -> bool:
        return not self._times

    def size(self) -> int:
        return len(self._times)
