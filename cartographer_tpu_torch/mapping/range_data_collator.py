"""Point-level time interleaving of multiple rangefinders.

Reference: mapping/internal/range_data_collator.cc:25-160. Maintains one
pending delivery per sensor, advances a [current_start, current_end] window
to the oldest pending end time, crops every pending cloud to the window and
merges the overlaps sorted by per-point time.
"""

from __future__ import annotations

from typing import Dict, Optional, Set

import numpy as np

from cartographer_tpu_torch.common.time import TIME_MIN, Time
from cartographer_tpu_torch.sensor.data import (
    TimedPointCloudData,
    TimedPointCloudOriginData,
)

DEFAULT_INTENSITY_VALUE = 0.0


class RangeDataCollator:
    def __init__(self, expected_range_sensor_ids: Set[str]):
        self._expected_sensor_ids = set(expected_range_sensor_ids)
        self._id_to_pending_data: Dict[str, TimedPointCloudData] = {}
        self._current_start: Time = TIME_MIN
        self._current_end: Time = TIME_MIN

    def add_range_data(
        self, sensor_id: str, data: TimedPointCloudData
    ) -> Optional[TimedPointCloudOriginData]:
        assert sensor_id in self._expected_sensor_ids
        if data.intensities is None:
            data.intensities = np.full(
                data.ranges.size, DEFAULT_INTENSITY_VALUE, np.float32
            )
        if sensor_id in self._id_to_pending_data:
            self._current_start = self._current_end
            # Two messages of the same sensor: flush up to the older one.
            self._current_end = self._id_to_pending_data[sensor_id].time
            result = self._crop_and_merge()
            self._id_to_pending_data[sensor_id] = data
            return result
        self._id_to_pending_data[sensor_id] = data
        if len(self._id_to_pending_data) != len(self._expected_sensor_ids):
            return None
        self._current_start = self._current_end
        self._current_end = min(d.time for d in self._id_to_pending_data.values())
        return self._crop_and_merge()

    def _crop_and_merge(self) -> TimedPointCloudOriginData:
        origins, points, times, origin_idx, intensities = [], [], [], [], []
        for sensor_id in sorted(self._id_to_pending_data.keys()):
            data = self._id_to_pending_data[sensor_id]
            abs_times = data.time + data.ranges.times.astype(np.float64)
            begin = int(np.searchsorted(abs_times, self._current_start, side="left"))
            end = int(np.searchsorted(abs_times, self._current_end, side="right"))
            if begin < end:
                origin_index = len(origins)
                origins.append(data.origin)
                time_correction = data.time - self._current_end
                points.append(data.ranges.points[begin:end])
                times.append(
                    data.ranges.times[begin:end] + np.float32(time_correction)
                )
                origin_idx.append(
                    np.full(end - begin, origin_index, np.int32)
                )
                intensities.append(data.intensities[begin:end])
            # Drop consumed points; keep the rest pending.
            if end == data.ranges.size:
                del self._id_to_pending_data[sensor_id]
            elif end > 0:
                data.ranges.points = data.ranges.points[end:]
                data.ranges.times = data.ranges.times[end:]
                data.intensities = data.intensities[end:]

        if points:
            points_arr = np.concatenate(points)
            times_arr = np.concatenate(times)
            origin_arr = np.concatenate(origin_idx)
            intens_arr = np.concatenate(intensities)
            order = np.argsort(times_arr, kind="stable")
            result = TimedPointCloudOriginData(
                time=self._current_end,
                origins=np.stack(origins) if origins else np.zeros((0, 3), np.float32),
                points=points_arr[order],
                times=times_arr[order],
                origin_index=origin_arr[order],
                intensities=intens_arr[order],
            )
        else:
            result = TimedPointCloudOriginData(
                time=self._current_end,
                origins=np.zeros((0, 3), np.float32),
                points=np.zeros((0, 3), np.float32),
                times=np.zeros((0,), np.float32),
                origin_index=np.zeros((0,), np.int32),
                intensities=np.zeros((0,), np.float32),
            )
        return result
