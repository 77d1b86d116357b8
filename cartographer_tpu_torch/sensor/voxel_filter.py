"""Voxel filters (reference: sensor/internal/voxel_filter.cc:30-200).

Copy of cartographer_tpu/sensor/voxel_filter.py. As there, clouds of more
than 512 points go to the C++ hash set of csrc/native.cc (native/), which
keeps the same first occurrence per voxel; a failed build raises.

Semantics: one representative point per voxel of edge `resolution` (voxel key
= per-axis round(p/res)); the adaptive filter binary-searches the voxel size
so at least `min_num_points` survive (voxel_filter.cc:38-75).

The reference picks a seeded-random member per voxel (reservoir sampling with
a fixed seed — deterministic across runs). Here each voxel keeps its first
point in scan order, which is equally deterministic; downstream consumers
only require one representative per voxel.

Host numpy implementation: the filter is O(N) hashing with data-dependent
output size — a poor fit for fixed-shape XLA, and N is small (~1e3-1e5).
Padding to static buckets happens at the matcher boundary instead.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from cartographer_tpu_torch.common.config import AdaptiveVoxelFilterOptions
from cartographer_tpu_torch.sensor.data import PointCloud


def _voxel_keys(points: np.ndarray, resolution: float) -> np.ndarray:
    # 21 bits per axis, like the reference's VoxelKeyType packing.
    idx = np.round(points[:, :3].astype(np.float64) / resolution).astype(np.int64)
    return (
        ((idx[:, 0] & 0x1FFFFF) << 42)
        | ((idx[:, 1] & 0x1FFFFF) << 21)
        | (idx[:, 2] & 0x1FFFFF)
    )


def voxel_filter_indices(points: np.ndarray, resolution: float) -> np.ndarray:
    """Boolean mask keeping one point per voxel (first occurrence).

    Above 512 points the native C++ hash set (csrc/native.cc) computes it,
    as in the JAX package; this numpy path is the parity reference."""
    if points.shape[0] == 0:
        return np.zeros((0,), dtype=bool)
    if points.shape[0] > 512:
        from cartographer_tpu_torch import native

        return native.voxel_filter_indices(points, resolution)
    keys = _voxel_keys(points, resolution)
    _, first_indices = np.unique(keys, return_index=True)
    mask = np.zeros(points.shape[0], dtype=bool)
    mask[first_indices] = True
    return mask


def voxel_filter(cloud: Union[PointCloud, np.ndarray], resolution: float):
    if isinstance(cloud, PointCloud):
        mask = voxel_filter_indices(cloud.points, resolution)
        return cloud.select(mask)
    cloud = np.asarray(cloud)
    return cloud[voxel_filter_indices(cloud, resolution)]


def filter_by_max_range(cloud: PointCloud, max_range: float) -> PointCloud:
    if cloud.size == 0:
        return cloud
    mask = np.linalg.norm(cloud.points, axis=1) <= max_range
    return cloud.select(mask)


def adaptive_voxel_filter(
    cloud: PointCloud, options: AdaptiveVoxelFilterOptions
) -> PointCloud:
    cloud = filter_by_max_range(cloud, options.max_range)
    if cloud.size <= options.min_num_points:
        return cloud
    result = voxel_filter(cloud, options.max_length)
    if result.size >= options.min_num_points:
        return result
    # Halve the edge length until dense enough, then binary-search to within
    # 10% (voxel_filter.cc:50-74).
    high_length = options.max_length
    while high_length > 1e-2 * options.max_length:
        low_length = high_length / 2.0
        result = voxel_filter(cloud, low_length)
        if result.size >= options.min_num_points:
            while (high_length - low_length) / low_length > 1e-1:
                mid_length = (low_length + high_length) / 2.0
                candidate = voxel_filter(cloud, mid_length)
                if candidate.size >= options.min_num_points:
                    low_length = mid_length
                    result = candidate
                else:
                    high_length = mid_length
            return result
        high_length /= 2.0
    return result
