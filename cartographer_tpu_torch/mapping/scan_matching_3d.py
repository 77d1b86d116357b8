"""Host-facing 3D scan matchers over the device ops.

Port of cartographer_tpu/mapping/scan_matching_3d.py. Mirrors
RealTimeCorrelativeScanMatcher3D (real_time_correlative_scan_matcher_3d.cc)
and CeresScanMatcher3D (ceres_scan_matcher_3d.cc), and pads the clouds to
power-of-two sizes. The matchers run on the grids' device; `match` reads
one packed result back per call, `match_device` none.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from cartographer_tpu_torch.common.config import (
    CeresScanMatcherOptions3D,
    RealTimeCorrelativeScanMatcherOptions,
)
from cartographer_tpu_torch.mapping.paged_grid_3d import PagedGrid3D
from cartographer_tpu_torch.ops.scan_matching import correlative_3d, gauss_newton_3d
from cartographer_tpu_torch.ops.scan_matching.correlative_2d import (
    compute_angular_step,
)
from cartographer_tpu_torch.transform import rigid3


def _round_up_pow2(n: int, minimum: int = 64) -> int:
    v = minimum
    while v < n:
        v *= 2
    return v


def _vol(grid):
    """Grid-read argument for the device matchers: the paged grid itself,
    or the dense int8 log-odds volume."""
    return grid if isinstance(grid, PagedGrid3D) else grid.values


def _device_of(grid) -> torch.device:
    return grid.origin.device


def pad_points_3d(points: np.ndarray, minimum: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    n = len(points)
    n_pad = _round_up_pow2(max(n, 1), minimum)
    out = np.zeros((n_pad, 3), np.float32)
    if n:
        out[:n] = points[:, :3]
    mask = np.zeros(n_pad, bool)
    mask[:n] = True
    return out, mask


def _t(x, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)


def _res(grid):
    """The grid's resolution as a 0-d tensor beside it: the JAX matcher
    takes it as a traced value, so its cell coordinates divide by it."""
    return torch.full((), grid.resolution, dtype=torch.float32, device=_device_of(grid))


class RealTimeCorrelativeScanMatcher3D:
    def __init__(self, options: RealTimeCorrelativeScanMatcherOptions):
        self._options = options

    def match(
        self,
        initial_pose: np.ndarray,  # SE(3) (7,) in submap frame
        point_cloud: np.ndarray,  # (N, 3) tracking frame
        grid,  # Grid3D or PagedGrid3D
    ) -> Tuple[float, np.ndarray]:
        opts = self._options
        dev = _device_of(grid)
        # Rotate the cloud by the initial rotation; search delta yaw on top.
        rotated = rigid3.quat_rotate(
            rigid3.quat(np.asarray(initial_pose, np.float64))[None, :],
            np.asarray(point_cloud[:, :3], np.float64),
        )
        max_scan_range = float(
            np.max(np.linalg.norm(rotated, axis=1), initial=3.0 * grid.resolution)
        )
        step = compute_angular_step(grid.resolution, max_scan_range)
        num_angular = int(math.ceil(opts.angular_search_window / step))
        num_scans = 2 * num_angular + 1
        angles = (np.arange(num_scans) - num_angular) * step
        a_pad = _round_up_pow2(num_scans, 8)
        angles_p = np.zeros(a_pad, np.float32)
        angles_p[:num_scans] = angles
        angle_mask = np.zeros(a_pad, bool)
        angle_mask[:num_scans] = True
        num_linear = int(math.ceil(opts.linear_search_window / grid.resolution))
        points_p, point_mask = pad_points_3d(rotated.astype(np.float32))

        _, best, best_score = correlative_3d.score_candidates_3d(
            _vol(grid),
            grid.origin,
            _t(points_p, dev),
            _t(point_mask, dev, torch.bool),
            _t(angles_p, dev),
            _t(angle_mask, dev, torch.bool),
            _t(np.asarray(initial_pose[:3], np.float32), dev),
            grid.resolution,
            opts.translation_delta_cost_weight,
            opts.rotation_delta_cost_weight,
            num_linear,
        )
        best = int(best)
        d = 2 * num_linear + 1
        ai, rem = divmod(best, d * d * d)
        dzi, rem = divmod(rem, d * d)
        dyi, dxi = divmod(rem, d)
        delta_t = (
            np.array([dxi, dyi, dzi], np.float64) - num_linear
        ) * grid.resolution
        dyaw = float(angles_p[ai])
        half = 0.5 * dyaw
        q_delta = np.array([np.cos(half), 0.0, 0.0, np.sin(half)])
        pose = rigid3.make(
            np.asarray(initial_pose[:3], np.float64) + delta_t,
            rigid3.quat_normalize(
                rigid3.quat_multiply(q_delta, rigid3.quat(np.asarray(initial_pose)))
            ),
        )
        return float(best_score), pose


class CeresScanMatcher3D:
    def __init__(self, options: CeresScanMatcherOptions3D):
        self._options = options

    def match(
        self,
        target_translation: np.ndarray,  # (3,)
        initial_pose: np.ndarray,  # SE(3) (7,) in submap frame
        high_resolution_cloud: np.ndarray,  # (N0, 3) tracking frame
        high_resolution_grid,  # Grid3D or PagedGrid3D
        low_resolution_cloud: np.ndarray,  # (N1, 3)
        low_resolution_grid,
        intensity_avg=None,  # f32 [D, H, W] average-intensity volume
        high_intensities: np.ndarray = None,  # (N0,)
    ) -> Tuple[np.ndarray, float]:
        if intensity_avg is None or high_intensities is None:
            packed = self.match_device(
                target_translation, initial_pose, high_resolution_cloud,
                high_resolution_grid, low_resolution_cloud, low_resolution_grid,
            )
            return self.decode(packed.cpu().numpy())  # one read back
        opts = self._options
        dev = _device_of(high_resolution_grid)
        hp, hm = pad_points_3d(np.asarray(high_resolution_cloud))
        lp, lm = pad_points_3d(np.asarray(low_resolution_cloud))
        hi = np.zeros(len(hm), np.float32)
        hi[: len(high_intensities)] = high_intensities
        iopts = opts.intensity_cost_function_options_0
        packed = gauss_newton_3d.match_3d_intensity(
            _vol(high_resolution_grid),
            high_resolution_grid.origin,
            _vol(low_resolution_grid),
            low_resolution_grid.origin,
            intensity_avg,
            _t(np.asarray(initial_pose[:3], np.float32), dev),
            _t(np.asarray(initial_pose[3:7], np.float32), dev),
            _t(np.asarray(target_translation, np.float32), dev),
            _t(hp, dev),
            _t(hm, dev, torch.bool),
            _t(hi, dev),
            _t(lp, dev),
            _t(lm, dev, torch.bool),
            _res(high_resolution_grid),
            _res(low_resolution_grid),
            opts.occupied_space_weight_0,
            opts.occupied_space_weight_1,
            iopts.weight,
            iopts.huber_scale,
            iopts.intensity_threshold,
            opts.translation_weight,
            opts.rotation_weight,
            opts.ceres_solver_options.max_num_iterations,
            opts.only_optimize_yaw,
            bool(opts.ceres_solver_options.use_nonmonotonic_steps),
        )
        return self.decode(packed.cpu().numpy())  # one read back

    def match_device(
        self,
        target_translation: np.ndarray,
        initial_pose_estimate: np.ndarray,
        high_resolution_cloud: np.ndarray,
        high_resolution_grid,
        low_resolution_cloud: np.ndarray,
        low_resolution_grid,
    ):
        """Dispatch the dual-grid refinement without reading it back;
        returns the packed [8] device tensor [t(3), q(4), cost] for callers
        that batch matches into one read (no intensity cost)."""
        opts = self._options
        dev = _device_of(high_resolution_grid)
        hp, hm = pad_points_3d(np.asarray(high_resolution_cloud))
        lp, lm = pad_points_3d(np.asarray(low_resolution_cloud))
        return gauss_newton_3d.match_3d(
            _vol(high_resolution_grid),
            high_resolution_grid.origin,
            _vol(low_resolution_grid),
            low_resolution_grid.origin,
            _t(np.asarray(initial_pose_estimate[:3], np.float32), dev),
            _t(np.asarray(initial_pose_estimate[3:7], np.float32), dev),
            _t(np.asarray(target_translation, np.float32), dev),
            _t(hp, dev),
            _t(hm, dev, torch.bool),
            _t(lp, dev),
            _t(lm, dev, torch.bool),
            _res(high_resolution_grid),
            _res(low_resolution_grid),
            opts.occupied_space_weight_0,
            opts.occupied_space_weight_1,
            opts.translation_weight,
            opts.rotation_weight,
            opts.ceres_solver_options.max_num_iterations,
            opts.only_optimize_yaw,
            bool(opts.ceres_solver_options.use_nonmonotonic_steps),
        )

    @staticmethod
    def decode(packed: np.ndarray):
        packed = np.asarray(packed, np.float64)
        return packed[:7], float(packed[7])
