"""Per-trajectory sorted time series with trimming (reference: sensor/map_by_time.h:36)."""

from __future__ import annotations

import bisect
from typing import Any, Dict, Iterator, List, Optional, Tuple

from cartographer_tpu_torch.common.time import Time


class MapByTime:
    """data items must expose `.time`; appended in nondecreasing time order."""

    def __init__(self):
        self._data: Dict[int, List[Any]] = {}

    def append(self, trajectory_id: int, data: Any) -> None:
        items = self._data.setdefault(trajectory_id, [])
        if items:
            assert data.time > items[-1].time
        items.append(data)

    def has_trajectory(self, trajectory_id: int) -> bool:
        return trajectory_id in self._data

    def trajectory(self, trajectory_id: int) -> List[Any]:
        return self._data.get(trajectory_id, [])

    def trajectory_ids(self) -> Iterator[int]:
        return iter(sorted(self._data.keys()))

    def earliest_time(self, trajectory_id: int) -> Time:
        return self._data[trajectory_id][0].time

    def lower_bound(self, trajectory_id: int, time: Time) -> int:
        """Index of first item with item.time >= time."""
        items = self._data.get(trajectory_id, [])
        times = [d.time for d in items]
        return bisect.bisect_left(times, time)

    def trim(self, trajectory_id: int, keep_from_time: Time) -> None:
        """Drops data strictly before keep_from_time, keeping one item before
        it for interpolation (mirrors MapByTime::Trim driven by node times)."""
        items = self._data.get(trajectory_id)
        if not items:
            return
        idx = self.lower_bound(trajectory_id, keep_from_time)
        keep_from = max(0, idx - 1)
        self._data[trajectory_id] = items[keep_from:]
