"""2D scan normal estimation (reference: internal/2d/normal_estimation_2d.cc).

Copy of cartographer_tpu/mapping/normal_estimation_2d.py.

For each return (sorted by bearing from the origin), the normal is the mean
of unit normals of tangents to neighbors within `sample_radius` (at most
num_normal_samples/2 on each side), oriented toward the sensor.
Vectorized numpy over a fixed neighbor window.
"""

from __future__ import annotations

import numpy as np

from cartographer_tpu_torch.common.config import NormalEstimationOptions2D


def sort_range_data_by_angle(points: np.ndarray, origin: np.ndarray) -> np.ndarray:
    """Returns sort indices by bearing around origin (RangeDataSorter)."""
    delta = points[:, :2] - origin[None, :2]
    angles = np.arctan2(delta[:, 1], delta[:, 0])
    return np.argsort(angles, kind="stable")


def estimate_normals(
    points: np.ndarray,  # (N, 2+) sorted by bearing
    origin: np.ndarray,  # (2+,)
    options: NormalEstimationOptions2D,
) -> np.ndarray:
    """Per-point normal angles (radians)."""
    n = len(points)
    normals = np.zeros(n, np.float32)
    pts = points[:, :2].astype(np.float64)
    origin2 = np.asarray(origin[:2], np.float64)
    max_half = options.num_normal_samples // 2
    max_half_up = int(np.ceil(options.num_normal_samples / 2.0))
    for i in range(n):
        hit = pts[i]
        begin = i
        while (
            begin > 0
            and i - begin < max_half
            and np.linalg.norm(hit - pts[begin - 1]) < options.sample_radius
        ):
            begin -= 1
        end = i
        while (
            end < n
            and end - i < max_half_up + 1
            and np.linalg.norm(hit - pts[end]) < options.sample_radius
        ):
            end += 1
        to_observation = origin2 - hit
        if end - begin < 2:
            normals[i] = np.arctan2(to_observation[1], to_observation[0])
            continue
        mean_normal = np.zeros(2)
        for j in range(begin, end):
            if j == i:
                continue
            tangent = hit - pts[j]
            sample_normal = np.array([-tangent[1], tangent[0]])
            norm = np.linalg.norm(sample_normal)
            if norm < 1e-6:
                continue
            if np.dot(sample_normal, to_observation) < 0:
                sample_normal = -sample_normal
            mean_normal += sample_normal / norm
        normals[i] = np.arctan2(mean_normal[1], mean_normal[0])
    return normals
