"""Typed ids and per-trajectory ordered maps (reference: mapping/id.h:57-480)."""

from __future__ import annotations

import bisect
from typing import Any, Dict, Generic, Iterator, List, NamedTuple, Optional, Tuple, TypeVar


class NodeId(NamedTuple):
    trajectory_id: int
    node_index: int


class SubmapId(NamedTuple):
    trajectory_id: int
    submap_index: int


T = TypeVar("T")


class MapById(Generic[T]):
    """Per-trajectory ordered map keyed by (trajectory_id, index)."""

    def __init__(self):
        self._trajectories: Dict[int, Dict[int, T]] = {}

    def insert(self, id_, data: T) -> None:
        traj = self._trajectories.setdefault(id_.trajectory_id, {})
        assert id_[1] not in traj
        traj[id_[1]] = data

    def append(self, trajectory_id: int, data: T, id_type=None) -> Any:
        traj = self._trajectories.setdefault(trajectory_id, {})
        index = max(traj.keys()) + 1 if traj else 0
        traj[index] = data
        if id_type is None:
            return (trajectory_id, index)
        return id_type(trajectory_id, index)

    def __contains__(self, id_) -> bool:
        return (
            id_.trajectory_id in self._trajectories
            and id_[1] in self._trajectories[id_.trajectory_id]
        )

    def at(self, id_) -> T:
        return self._trajectories[id_.trajectory_id][id_[1]]

    def get(self, id_, default=None):
        try:
            return self.at(id_)
        except KeyError:
            return default

    def set(self, id_, data: T) -> None:
        self._trajectories.setdefault(id_.trajectory_id, {})[id_[1]] = data

    def trim(self, id_) -> None:
        traj = self._trajectories[id_.trajectory_id]
        del traj[id_[1]]
        if not traj:
            del self._trajectories[id_.trajectory_id]

    def size_of_trajectory_or_zero(self, trajectory_id: int) -> int:
        return len(self._trajectories.get(trajectory_id, {}))

    def trajectory_ids(self) -> List[int]:
        return sorted(self._trajectories.keys())

    def trajectory(self, trajectory_id: int) -> List[Tuple[int, T]]:
        return sorted(self._trajectories.get(trajectory_id, {}).items())

    def items(self, id_type) -> Iterator[Tuple[Any, T]]:
        for trajectory_id in sorted(self._trajectories.keys()):
            for index in sorted(self._trajectories[trajectory_id].keys()):
                yield id_type(trajectory_id, index), self._trajectories[
                    trajectory_id
                ][index]

    def ids(self, id_type) -> List[Any]:
        return [k for k, _ in self.items(id_type)]

    def empty(self) -> bool:
        return not any(self._trajectories.values())

    def size(self) -> int:
        return sum(len(t) for t in self._trajectories.values())

    def lower_bound(self, trajectory_id: int, time: float) -> Optional[int]:
        """First index in trajectory whose data.time >= time (requires
        data to expose .time, mirroring mapping/id.h:136 lower_bound)."""
        items = self.trajectory(trajectory_id)
        times = [d.time for _, d in items]
        i = bisect.bisect_left(times, time)
        if i == len(items):
            return None
        return items[i][0]
