"""Multi-storey floor segmentation.

Copy of cartographer_tpu/mapping/detect_floors.py (numpy; no device code).

Reference: mapping/detect_floors.cc:40-219. Pipeline:

1. Slice the trajectory at altitude jumps: a new span starts when a node's
   z differs from the running median z of the current span by more than
   LEVEL_HEIGHT_METERS (SliceByAltitudeChange, :81-98).
2. Union spans whose median z values are within
   MIN_LEVEL_SEPARATION_METERS into levels (GroupSegmentsByAltitude,
   :117-128, union-find over all pairs).
3. Spans shorter than MAX_SHORT_SPAN_LENGTH_METERS of 2D travel are
   "short" — stairs / intermediate pieces. Levels are seeded from long
   spans only; a short span joins its own level if that level has a long
   span, otherwise it is attached to the level of the span before AND the
   span after it (FindFloors, :130-173).
4. A floor's z is the median of the z values of its LONG spans only;
   levels consisting exclusively of short spans are dropped (:175-198).

Floors are returned sorted by z. Median follows the reference's
upper-median convention (sorted[size / 2]).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List

import numpy as np

from cartographer_tpu_torch.common.time import Time

# Reference constants (detect_floors.cc:37-39).
MAX_SHORT_SPAN_LENGTH_METERS = 25.0
LEVEL_HEIGHT_METERS = 2.5
MIN_LEVEL_SEPARATION_METERS = 1.0


@dataclasses.dataclass
class Timespan:
    start: Time
    end: Time


@dataclasses.dataclass
class Floor:
    timespans: List[Timespan]
    z: float


@dataclasses.dataclass
class _Span:
    start_index: int
    end_index: int  # exclusive
    z_values: List[float]  # kept sorted

    def median(self) -> float:
        return self.z_values[len(self.z_values) // 2]


def _slice_by_altitude_change(zs: np.ndarray) -> List[_Span]:
    spans = [_Span(0, 1, [float(zs[0])])]
    for i in range(1, len(zs)):
        z = float(zs[i])
        if abs(spans[-1].median() - z) > LEVEL_HEIGHT_METERS:
            spans.append(_Span(i, i, []))
        bisect.insort(spans[-1].z_values, z)
        spans[-1].end_index = i + 1
    return spans


def _span_length_2d(xy: np.ndarray, span: _Span) -> float:
    seg = xy[span.start_index : span.end_index]
    if len(seg) < 2:
        return 0.0
    return float(np.sum(np.linalg.norm(np.diff(seg, axis=0), axis=1)))


class _UnionFind:
    def __init__(self, n: int):
        self._parent = list(range(n))

    def find(self, i: int) -> int:
        root = i
        while self._parent[root] != root:
            root = self._parent[root]
        while self._parent[i] != root:
            self._parent[i], i = root, self._parent[i]
        return root

    def union(self, i: int, j: int) -> None:
        self._parent[self.find(i)] = self.find(j)


def detect_floors(
    node_times: List[Time], node_poses: List[np.ndarray]
) -> List[Floor]:
    """node_poses: SE(3) (7,) per node, time-ordered."""
    if not node_times:
        return []
    poses = np.asarray([p[:3] for p in node_poses], np.float64)
    zs = poses[:, 2]
    xy = poses[:, :2]
    times = list(node_times)

    spans = _slice_by_altitude_change(zs)
    n = len(spans)
    levels = _UnionFind(n)
    for i in range(n):
        for j in range(i + 1, n):
            if (
                abs(spans[i].median() - spans[j].median())
                < MIN_LEVEL_SEPARATION_METERS
            ):
                levels.union(i, j)

    is_short = [
        _span_length_2d(xy, s) < MAX_SHORT_SPAN_LENGTH_METERS for s in spans
    ]

    # Seed levels with long spans only, then place the short ones.
    level_spans: Dict[int, List[int]] = {}
    for i in range(n):
        if not is_short[i]:
            level_spans.setdefault(levels.find(i), []).append(i)
    for i in range(n):
        if not is_short[i]:
            continue
        level = levels.find(i)
        if level_spans.get(level):
            level_spans.setdefault(level, []).append(i)
            continue
        # Intermediate (stairs) piece: attach to the levels adjacent in
        # trajectory order (detect_floors.cc:155-166).
        if i - 1 >= 0:
            level_spans.setdefault(levels.find(i - 1), []).append(i)
        if i + 1 < n:
            level_spans.setdefault(levels.find(i + 1), []).append(i)

    floors: List[Floor] = []
    for level in sorted(level_spans):
        members = sorted(
            level_spans[level],
            key=lambda i: (spans[i].start_index, spans[i].end_index),
        )
        if not members:
            continue
        z_values: List[float] = []
        timespans: List[Timespan] = []
        for i in members:
            span = spans[i]
            if not is_short[i]:
                # Floor height from the long pieces only — a heuristic
                # leaving out intermediate (short) levels
                # (detect_floors.cc:180-186).
                z_values.extend(span.z_values)
            timespans.append(
                Timespan(
                    start=times[span.start_index],
                    end=times[span.end_index - 1],
                )
            )
        if not z_values:
            # All spans in this level are short — not a real floor.
            continue
        z_values.sort()
        floors.append(
            Floor(timespans=timespans, z=z_values[len(z_values) // 2])
        )
    floors.sort(key=lambda f: f.z)
    return floors
