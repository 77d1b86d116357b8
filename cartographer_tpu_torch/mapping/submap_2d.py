"""2D submaps.

Port of `Submap2D` from cartographer_tpu/mapping/submap_2d.py. Reference:
mapping/2d/submap_2d.cc:137-219. A submap has a local pose (pure
translation at the first scan's origin), a grid, and a range-data count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from cartographer_tpu_torch.mapping.grid_2d import Grid2D, grid_from_numpy


@dataclasses.dataclass
class Submap2D:
    local_pose: np.ndarray  # SE(2) (3,) — translation only (rotation 0)
    grid: Optional[Grid2D]
    num_range_data: int = 0
    insertion_finished: bool = False

    def finish(self) -> None:
        self.insertion_finished = True


def submap_from_numpy(
    local_pose, log_odds, known, origin, resolution: float, device,
    num_range_data: int = 0, insertion_finished: bool = False,
) -> Submap2D:
    """Submap2D whose grid is built from numpy arrays on `device`."""
    return Submap2D(
        local_pose=np.asarray(local_pose, np.float64),
        grid=grid_from_numpy(log_odds, known, origin, resolution, device),
        num_range_data=num_range_data,
        insertion_finished=insertion_finished,
    )
