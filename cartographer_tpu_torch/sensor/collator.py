"""Cross-sensor collation (reference: sensor/internal/collator.h:33,
trajectory_collator.h:38).

Collator: one OrderedMultiQueue shared by all trajectories (global time
ordering). TrajectoryCollator: one OrderedMultiQueue per trajectory (data of
different trajectories is not interleaved).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set

from cartographer_tpu_torch.sensor.ordered_multi_queue import OrderedMultiQueue, QueueKey

# callback(sensor_id, data)
Callback = Callable[[str, Any], None]


class CollatorInterface:
    def add_trajectory(self, trajectory_id: int, expected_sensor_ids: Set[str], callback: Callback) -> None:
        raise NotImplementedError

    def finish_trajectory(self, trajectory_id: int) -> None:
        raise NotImplementedError

    def add_sensor_data(self, trajectory_id: int, sensor_id: str, data: Any) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError

    def get_blocking_trajectory_id(self) -> Optional[int]:
        raise NotImplementedError


class Collator(CollatorInterface):
    def __init__(self):
        self._queue = OrderedMultiQueue()
        self._queue_keys: Dict[int, List[QueueKey]] = {}

    def add_trajectory(self, trajectory_id: int, expected_sensor_ids: Set[str], callback: Callback) -> None:
        for sensor_id in sorted(expected_sensor_ids):
            key = (trajectory_id, sensor_id)
            self._queue_keys.setdefault(trajectory_id, []).append(key)
            self._queue.add_queue(
                key, lambda data, sensor_id=sensor_id: callback(sensor_id, data)
            )

    def finish_trajectory(self, trajectory_id: int) -> None:
        for key in self._queue_keys.get(trajectory_id, []):
            self._queue.mark_queue_as_finished(key)

    def add_sensor_data(self, trajectory_id: int, sensor_id: str, data: Any) -> None:
        self._queue.add((trajectory_id, sensor_id), data)

    def flush(self) -> None:
        self._queue.flush()

    def get_blocking_trajectory_id(self) -> Optional[int]:
        blocker = self._queue.get_blocker()
        return None if blocker is None else blocker[0]


class TrajectoryCollator(CollatorInterface):
    def __init__(self):
        self._trajectory_to_queue: Dict[int, OrderedMultiQueue] = {}
        self._trajectory_to_queue_keys: Dict[int, List[QueueKey]] = {}

    def add_trajectory(self, trajectory_id: int, expected_sensor_ids: Set[str], callback: Callback) -> None:
        assert trajectory_id not in self._trajectory_to_queue
        queue = OrderedMultiQueue()
        self._trajectory_to_queue[trajectory_id] = queue
        for sensor_id in sorted(expected_sensor_ids):
            key = (trajectory_id, sensor_id)
            self._trajectory_to_queue_keys.setdefault(trajectory_id, []).append(key)
            queue.add_queue(
                key, lambda data, sensor_id=sensor_id: callback(sensor_id, data)
            )

    def finish_trajectory(self, trajectory_id: int) -> None:
        for key in self._trajectory_to_queue_keys.get(trajectory_id, []):
            self._trajectory_to_queue[trajectory_id].mark_queue_as_finished(key)

    def add_sensor_data(self, trajectory_id: int, sensor_id: str, data: Any) -> None:
        queue = self._trajectory_to_queue.get(trajectory_id)
        if queue is None:
            return
        queue.add((trajectory_id, sensor_id), data)

    def flush(self) -> None:
        for queue in self._trajectory_to_queue.values():
            queue.flush()

    def get_blocking_trajectory_id(self) -> Optional[int]:
        return None  # Per-trajectory queues never block each other.
