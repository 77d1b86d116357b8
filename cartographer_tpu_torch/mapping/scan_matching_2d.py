"""Host-facing 2D scan matcher interfaces over the device ops.

Port of `round_up_pow2`, `pad_points_2d` and `CeresScanMatcher2D` from
cartographer_tpu/mapping/scan_matching_2d.py (reference:
ceres_scan_matcher_2d.cc:63-107) for probability grids. TSDF grids and
RealTimeCorrelativeScanMatcher2D come with the per-scan 2D path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cartographer_tpu_torch.common.config import CeresScanMatcherOptions2D
from cartographer_tpu_torch.mapping.grid_2d import Grid2D
from cartographer_tpu_torch.ops.scan_matching import gauss_newton_2d
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
        """Returns (pose_estimate, final_cost), on the grid's device."""
        if not isinstance(grid, Grid2D):
            raise NotImplementedError(
                "CeresScanMatcher2D: TSDF grids (match_tsdf) are not ported yet"
            )
        opts = self._options
        points_p, point_mask = pad_points_2d(np.asarray(point_cloud))
        dev = grid.log_odds.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev)  # noqa: E731
        pose, cost = gauss_newton_2d.match_log_odds(
            grid.log_odds,
            grid.known,
            grid.origin,
            f32(initial_pose_estimate),
            f32(target_translation),
            f32(points_p),
            torch.from_numpy(point_mask).to(dev),
            grid.resolution,
            opts.occupied_space_weight,
            opts.translation_weight,
            opts.rotation_weight,
            opts.ceres_solver_options.max_num_iterations,
            bool(opts.ceres_solver_options.use_nonmonotonic_steps),
        )
        pose = pose.cpu().numpy().astype(np.float64)
        pose[2] = rigid2.normalize_angle(pose[2])
        return pose, float(cost)
