"""Result types of 2D local SLAM.

Port of `InsertionResult` and `MatchingResult` from
cartographer_tpu/mapping/local_trajectory_builder_2d.py:46-58
(reference: mapping/internal/2d/local_trajectory_builder_2d.h).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from cartographer_tpu_torch.common.time import Time
from cartographer_tpu_torch.mapping.submap_2d import Submap2D
from cartographer_tpu_torch.mapping.trajectory_node import TrajectoryNodeData
from cartographer_tpu_torch.sensor.data import RangeData


@dataclasses.dataclass
class InsertionResult:
    constant_data: TrajectoryNodeData
    insertion_submaps: List[Submap2D]


@dataclasses.dataclass
class MatchingResult:
    time: Time
    local_pose: np.ndarray  # SE(3) (7,)
    range_data_in_local: RangeData
    insertion_result: Optional[InsertionResult]
