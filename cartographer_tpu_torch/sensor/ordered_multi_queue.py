"""Time-merge of K sorted sensor queues into one ordered callback stream.

Reference: sensor/internal/ordered_multi_queue.cc:27-176. Host-side control
plane: merges per-(trajectory, sensor) queues, dispatching strictly in time
order, blocking (returning) when the next global item cannot be determined
because some queue is empty, and fast-forwarding every trajectory to a
common start time across its sensors.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from cartographer_tpu_torch.common.time import TIME_MIN, Time

# (trajectory_id, sensor_id)
QueueKey = Tuple[int, str]


@dataclasses.dataclass
class _Queue:
    queue: collections.deque
    callback: Callable[[Any], None]
    finished: bool = False


class OrderedMultiQueue:
    """Items must expose a `.time` attribute and be added in per-queue order."""

    def __init__(self):
        self._queues: Dict[QueueKey, _Queue] = {}
        self._common_start_time_per_trajectory: Dict[int, Time] = {}
        self._last_dispatched_time: Time = TIME_MIN
        self._blocker: Optional[QueueKey] = None

    def add_queue(self, queue_key: QueueKey, callback: Callable[[Any], None]) -> None:
        assert queue_key not in self._queues
        self._queues[queue_key] = _Queue(collections.deque(), callback)

    def mark_queue_as_finished(self, queue_key: QueueKey) -> None:
        queue = self._queues[queue_key]
        assert not queue.finished
        queue.finished = True
        self._dispatch()

    def add(self, queue_key: QueueKey, data: Any) -> None:
        if queue_key not in self._queues:
            return  # Ignored data for unknown queue (reference logs a warning).
        self._queues[queue_key].queue.append(data)
        self._dispatch()

    def flush(self) -> None:
        for key in [k for k, q in self._queues.items() if not q.finished]:
            self.mark_queue_as_finished(key)

    def get_blocker(self) -> Optional[QueueKey]:
        return self._blocker

    def empty(self) -> bool:
        return not self._queues

    def _dispatch(self) -> None:
        while True:
            next_data = None
            next_queue: Optional[_Queue] = None
            next_queue_key: Optional[QueueKey] = None
            for key in list(self._queues.keys()):
                queue = self._queues[key]
                if not queue.queue:
                    if queue.finished:
                        del self._queues[key]
                        continue
                    self._blocker = key
                    return
                data = queue.queue[0]
                if next_data is None or data.time < next_data.time:
                    next_data = data
                    next_queue = queue
                    next_queue_key = key
                assert self._last_dispatched_time <= next_data.time, (
                    f"Non-sorted data added to queue {key!r}"
                )
            if next_data is None:
                assert not self._queues
                return

            common_start_time = self._get_common_start_time(next_queue_key[0])
            if next_data.time >= common_start_time:
                # Happy case: beyond the common start time already.
                self._last_dispatched_time = next_data.time
                next_queue.callback(next_queue.queue.popleft())
            elif len(next_queue.queue) < 2:
                if not next_queue.finished:
                    # Cannot decide whether to drop or dispatch this yet.
                    self._blocker = next_queue_key
                    return
                self._last_dispatched_time = next_data.time
                next_queue.callback(next_queue.queue.popleft())
            else:
                # Drop data before the common start time, except the last one
                # before it (the first dispatchable packet of this queue).
                data = next_queue.queue.popleft()
                if next_queue.queue[0].time > common_start_time:
                    self._last_dispatched_time = data.time
                    next_queue.callback(data)

    def _get_common_start_time(self, trajectory_id: int) -> Time:
        if trajectory_id not in self._common_start_time_per_trajectory:
            start = TIME_MIN
            for key, queue in self._queues.items():
                if key[0] == trajectory_id and queue.queue:
                    start = max(start, queue.queue[0].time)
            self._common_start_time_per_trajectory[trajectory_id] = start
        return self._common_start_time_per_trajectory[trajectory_id]
