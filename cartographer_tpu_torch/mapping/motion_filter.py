"""Motion filter (reference: mapping/internal/motion_filter.cc:40-60).

Copy of cartographer_tpu/mapping/motion_filter.py.

A pose is "similar" to the last kept one when time, distance, and angle
deltas are all below thresholds; similar nodes are not inserted.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from cartographer_tpu_torch.common.config import MotionFilterOptions
from cartographer_tpu_torch.common.time import Time
from cartographer_tpu_torch.transform import rigid3


class MotionFilter:
    def __init__(self, options: MotionFilterOptions):
        self._options = options
        self._num_total = 0
        self._num_different = 0
        self._last_time: Optional[Time] = None
        self._last_pose: Optional[np.ndarray] = None

    def is_similar(self, time: Time, pose: np.ndarray) -> bool:
        self._num_total += 1
        if (
            self._last_time is not None
            and time - self._last_time <= self._options.max_time_seconds
            and np.linalg.norm(rigid3.trans(pose) - rigid3.trans(self._last_pose))
            <= self._options.max_distance_meters
            and rigid3.quat_angle(
                rigid3.quat(rigid3.relative(self._last_pose, pose))
            )
            <= self._options.max_angle_radians
        ):
            return True
        self._last_time = time
        self._last_pose = np.asarray(pose)
        self._num_different += 1
        return False
