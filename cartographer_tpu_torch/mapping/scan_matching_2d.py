"""Host-facing 2D scan matcher interfaces over the device ops.

Port of cartographer_tpu/mapping/scan_matching_2d.py (reference:
real_time_correlative_scan_matcher_2d.cc:117-176 and
ceres_scan_matcher_2d.cc:63-107), for probability grids and TSDFs. The
correlative matcher's window sums run in the CUDA kernel
`kernels/correlative_window` for grids on the card, at any window and grid
size. Clouds and angles are padded as in the JAX package (points to a power
of two of at least 64, angles of at least 16) so that the argmax sees the
same candidate order.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from cartographer_tpu_torch.common.config import (
    CeresScanMatcherOptions2D,
    RealTimeCorrelativeScanMatcherOptions,
)
from cartographer_tpu_torch.mapping.tsdf_2d import TSDF2D
from cartographer_tpu_torch.ops.scan_matching import correlative_2d, gauss_newton_2d
from cartographer_tpu_torch.transform import rigid2


def round_up_pow2(n: int, minimum: int = 64) -> int:
    v = minimum
    while v < n:
        v *= 2
    return v


def pad_points_2d(points: np.ndarray, minimum: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    n = len(points)
    n_pad = round_up_pow2(max(n, 1), minimum)
    out = np.zeros((n_pad, 2), np.float32)
    if n:
        out[:n] = points[:, :2]
    mask = np.zeros(n_pad, bool)
    mask[:n] = True
    return out, mask


class RealTimeCorrelativeScanMatcher2D:
    def __init__(self, options: RealTimeCorrelativeScanMatcherOptions):
        self._options = options

    def match(
        self,
        initial_pose_estimate: np.ndarray,  # SE(2) (3,)
        point_cloud: np.ndarray,  # (N, 2+) local frame
        grid,  # Grid2D or TSDF2D
    ) -> Tuple[float, np.ndarray]:
        """Returns (score, pose_estimate); one fetch from the grid's
        device."""
        opts = self._options
        initial_rotation = float(initial_pose_estimate[2])
        # Rotate the cloud by the initial yaw; the angular search is relative.
        rot = rigid2.make(np.zeros(2), initial_rotation)
        rotated = rigid2.apply(rot, np.asarray(point_cloud[:, :2], np.float64))
        max_scan_range = float(
            np.max(np.linalg.norm(rotated, axis=1), initial=3.0 * grid.resolution)
        )
        step = correlative_2d.compute_angular_step(grid.resolution, max_scan_range)
        num_angular = int(math.ceil(opts.angular_search_window / step))
        num_scans = 2 * num_angular + 1
        angles = (np.arange(num_scans) - num_angular) * step
        a_pad = round_up_pow2(num_scans, 16)
        angles_p = np.zeros(a_pad, np.float32)
        angles_p[:num_scans] = angles
        angle_mask = np.zeros(a_pad, bool)
        angle_mask[:num_scans] = True

        num_linear = int(math.ceil(opts.linear_search_window / grid.resolution))
        points_p, point_mask = pad_points_2d(rotated.astype(np.float32))
        dev = grid.origin.device
        _, best, best_score = correlative_2d.score_candidates(
            grid.probability(),
            grid.origin,
            torch.from_numpy(points_p).to(dev),
            torch.from_numpy(point_mask).to(dev),
            torch.from_numpy(angles_p).to(dev),
            torch.from_numpy(angle_mask).to(dev),
            torch.from_numpy(
                np.asarray(initial_pose_estimate[:2], np.float32)
            ).to(dev),
            grid.resolution,
            opts.translation_delta_cost_weight,
            opts.rotation_delta_cost_weight,
            num_linear,
        )
        best, best_score = torch.stack(
            [best.to(torch.float64), best_score.to(torch.float64)]
        ).tolist()
        d = 2 * num_linear + 1
        ai, rem = divmod(int(best), d * d)
        dyi, dxi = divmod(rem, d)
        dx = (dxi - num_linear) * grid.resolution
        dy = (dyi - num_linear) * grid.resolution
        dtheta = float(angles_p[ai])
        pose = rigid2.make(
            np.asarray(initial_pose_estimate[:2], np.float64) + [dx, dy],
            rigid2.normalize_angle(initial_rotation + dtheta),
        )
        return float(best_score), pose


class CeresScanMatcher2D:
    def __init__(self, options: CeresScanMatcherOptions2D):
        self._options = options

    def match(
        self,
        target_translation: np.ndarray,  # (2,)
        initial_pose_estimate: np.ndarray,  # SE(2) (3,)
        point_cloud: np.ndarray,  # (N, 2+)
        grid: Grid2D,
    ) -> Tuple[np.ndarray, float]:
        """Returns (pose_estimate, final_cost), computed on the grid's
        device (a Grid2D or a TSDF2D)."""
        opts = self._options
        points_p, point_mask = pad_points_2d(np.asarray(point_cloud))
        dev = grid.origin.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev)  # noqa: E731
        common = (
            f32(initial_pose_estimate),
            f32(target_translation),
            f32(points_p),
            torch.from_numpy(point_mask).to(dev),
        )
        solver = opts.ceres_solver_options
        if isinstance(grid, TSDF2D):
            pose, cost = gauss_newton_2d.match_tsdf(
                grid.tsd, grid.weight, grid.origin, *common,
                grid.resolution, grid.truncation_distance,
                opts.occupied_space_weight, opts.translation_weight,
                opts.rotation_weight, solver.max_num_iterations,
                bool(solver.use_nonmonotonic_steps),
            )
        else:
            pose, cost = gauss_newton_2d.match_log_odds(
                grid.log_odds, grid.known, grid.origin, *common,
                grid.resolution, opts.occupied_space_weight,
                opts.translation_weight, opts.rotation_weight,
                solver.max_num_iterations, bool(solver.use_nonmonotonic_steps),
            )
        out = torch.cat([pose, cost[None]]).cpu().numpy().astype(np.float64)
        pose = out[:3]
        pose[2] = rigid2.normalize_angle(pose[2])
        return pose, float(out[3])
