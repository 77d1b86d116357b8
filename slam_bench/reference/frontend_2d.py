"""Plain reference: the point cloud that the 2D local trajectory builder
hands its scan matcher, from one revolution's raw subdivisions.

The stages of cartographer's `local_trajectory_builder_2d.cc` and
`voxel_filter.cc`, written out in numpy:

1. each point of each subdivision to the local frame at its own pose (the
   pose of the tracking frame at the point's time), and its range, the
   distance from the sensor's origin at that pose;
2. the points within [min_range, max_range] kept as returns, the
   revolution's subdivisions accumulated in time order (float32);
3. the returns taken to the gravity-aligned frame at the last point's
   pose, and cropped to [min_z, max_z];
4. the voxel filter: one point per voxel of edge `voxel_filter_size`
   (voxel index: the float32 p / edge rounded half away from zero), the
   first in scan order;
5. the adaptive voxel filter: points within its max_range; if more than
   min_num_points, the voxel filter at max_length, or, where that keeps
   fewer than min_num_points, at the largest edge found by halving and
   then bisecting to within 10% that keeps as many.

The per-point poses and the gravity alignment are the program's (its
pose extrapolator's and IMU tracker's state), looked up by time; the
points, their times and the options are the benchmark's. It imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np


def rotation_matrix(q) -> np.ndarray:
    """[..., 3, 3] of unit quaternions [..., 4] (w, x, y, z)."""
    q = np.asarray(q, np.float64)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def poses_at(times, table_times, table_poses) -> np.ndarray:
    """The pose [7] (translation, quaternion) that the table holds for
    each time: its entry nearest in time."""
    i = np.clip(np.searchsorted(table_times, times), 1, len(table_times) - 1)
    before = np.abs(times - table_times[i - 1]) <= np.abs(table_times[i] - times)
    return table_poses[np.where(before, i - 1, i)]


def voxel_filter(points: np.ndarray, edge: float) -> np.ndarray:
    """The first point, in order, of each voxel of edge `edge`: the voxel
    index is the float32 quotient p / edge rounded half away from zero,
    as `voxel_filter.cc` computes it."""
    if len(points) == 0:
        return points
    q = (points.astype(np.float32) / np.float32(edge)).astype(np.float64)
    index = (np.sign(q) * np.floor(np.abs(q) + 0.5)).astype(np.int64)
    _, first = np.unique(index, axis=0, return_index=True)
    return points[np.sort(first)]


def adaptive_voxel_filter(points: np.ndarray, options: dict) -> np.ndarray:
    points = points[np.linalg.norm(points, axis=1) <= options["max_range"]]
    least = options["min_num_points"]
    if len(points) <= least:
        return points
    result = voxel_filter(points, options["max_length"])
    if len(result) >= least:
        return result
    high = options["max_length"]
    while high > 1e-2 * options["max_length"]:
        low = high / 2.0
        result = voxel_filter(points, low)
        if len(result) >= least:
            while (high - low) / low > 1e-1:
                mid = (low + high) / 2.0
                candidate = voxel_filter(points, mid)
                if len(candidate) >= least:
                    low, result = mid, candidate
                else:
                    high = mid
            return result
        high /= 2.0
    return result


def matcher_cloud(subdivisions, origin, table_times, table_poses, gravity, options: dict):
    """(returns after the voxel filter, the scan matcher's cloud, the
    cropped returns before the voxel filter), each [n, 3] float32 in the
    gravity-aligned frame. `subdivisions` is the revolution's
    [(points [n, 3] in the sensor frame, absolute times [n])] in time
    order; `table_times` [m] and `table_poses` [m, 7] the poses by time."""
    returns, last_pose = [], None
    for points, times in subdivisions:
        pose = poses_at(times, table_times, table_poses)
        rot = rotation_matrix(pose[:, 3:7])
        world = np.einsum("nij,nj->ni", rot, points.astype(np.float64)) + pose[:, :3]
        sensor = rot @ np.asarray(origin, np.float64) + pose[:, :3]
        ranges = np.linalg.norm(world - sensor, axis=1)
        keep = (ranges >= options["min_range"]) & (ranges <= options["max_range"])
        returns.append(world[keep])
        last_pose = pose[-1]
    accumulated = np.concatenate(returns).astype(np.float32)
    # p' = R_g R_last^T (p - t_last)
    to_gravity = rotation_matrix(gravity) @ rotation_matrix(last_pose[3:7]).T
    aligned = ((accumulated.astype(np.float64) - last_pose[:3]) @ to_gravity.T).astype(np.float32)
    aligned = aligned[(aligned[:, 2] >= options["min_z"]) & (aligned[:, 2] <= options["max_z"])]
    filtered = voxel_filter(aligned, options["voxel_filter_size"])
    return filtered, adaptive_voxel_filter(filtered, options["adaptive_voxel_filter"]), aligned
