"""Trajectory connectivity (reference: mapping/internal/connected_components.cc
and trajectory_connectivity_state.cc): union-find over trajectories plus the
time of the last inter-trajectory connection (gates local vs global
loop-closure search)."""

from __future__ import annotations

from typing import Dict, List, Tuple

from cartographer_tpu_torch.common.time import TIME_MIN, Time


class ConnectedComponents:
    def __init__(self):
        self._parent: Dict[int, int] = {}
        self._connection_count: Dict[Tuple[int, int], int] = {}

    def add(self, trajectory_id: int) -> None:
        self._parent.setdefault(trajectory_id, trajectory_id)

    def _find(self, x: int) -> int:
        self.add(x)
        root = x
        while self._parent[root] != root:
            root = self._parent[root]
        while self._parent[x] != root:
            self._parent[x], x = root, self._parent[x]
        return root

    def connect(self, a: int, b: int) -> None:
        ra, rb = self._find(a), self._find(b)
        if ra != rb:
            self._parent[ra] = rb
        key = (min(a, b), max(a, b))
        self._connection_count[key] = self._connection_count.get(key, 0) + 1

    def transitively_connected(self, a: int, b: int) -> bool:
        if a == b:
            return True
        if a not in self._parent or b not in self._parent:
            return False
        return self._find(a) == self._find(b)

    def connection_count(self, a: int, b: int) -> int:
        return self._connection_count.get((min(a, b), max(a, b)), 0)

    def components(self) -> List[List[int]]:
        groups: Dict[int, List[int]] = {}
        for t in self._parent:
            groups.setdefault(self._find(t), []).append(t)
        return [sorted(g) for g in groups.values()]


class TrajectoryConnectivityState:
    def __init__(self):
        self._connected_components = ConnectedComponents()
        self._last_connection_time: Dict[Tuple[int, int], Time] = {}

    def add(self, trajectory_id: int) -> None:
        self._connected_components.add(trajectory_id)

    def connect(self, a: int, b: int, time: Time) -> None:
        if self.transitively_connected(a, b):
            # Only update the direct pair's last connection time.
            key = (min(a, b), max(a, b))
            self._last_connection_time[key] = max(
                time, self._last_connection_time.get(key, TIME_MIN)
            )
        else:
            key = (min(a, b), max(a, b))
            self._last_connection_time[key] = time
        self._connected_components.connect(a, b)

    def transitively_connected(self, a: int, b: int) -> bool:
        return self._connected_components.transitively_connected(a, b)

    def last_connection_time(self, a: int, b: int) -> Time:
        """Most recent direct connection between any pair bridging a and b's
        components; approximated by the max over direct pair times (the
        reference tracks this transitively — equal for the common case)."""
        if not self.transitively_connected(a, b):
            return TIME_MIN
        best = TIME_MIN
        for (x, y), t in self._last_connection_time.items():
            if self.transitively_connected(a, x) and self.transitively_connected(b, y):
                best = max(best, t)
        return best

    def connected_components(self) -> List[List[int]]:
        return self._connected_components.components()
