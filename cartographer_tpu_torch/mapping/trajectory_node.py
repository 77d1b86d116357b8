"""Trajectory node data (reference: mapping/trajectory_node.h:33-70)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from cartographer_tpu_torch.common.time import Time


@dataclasses.dataclass
class TrajectoryNodeData:
    """Constant (per-node) data computed by local SLAM."""

    time: Time
    gravity_alignment: np.ndarray  # quaternion [w, x, y, z]
    # 2D: gravity-aligned filtered cloud (N, 3); 3D: high/low res clouds.
    filtered_gravity_aligned_point_cloud: np.ndarray
    high_resolution_point_cloud: Optional[np.ndarray] = None
    low_resolution_point_cloud: Optional[np.ndarray] = None
    rotational_scan_matcher_histogram: Optional[np.ndarray] = None
    local_pose: Optional[np.ndarray] = None  # SE(3) (7,)


@dataclasses.dataclass
class TrajectoryNode:
    constant_data: Optional[TrajectoryNodeData]
    global_pose: np.ndarray  # SE(3) (7,)

    @property
    def time(self) -> Time:
        return self.constant_data.time
