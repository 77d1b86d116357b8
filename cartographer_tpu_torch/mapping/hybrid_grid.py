"""3D occupancy grids as fixed-shape tensors.

Port of cartographer_tpu/mapping/hybrid_grid.py. Reference:
mapping/3d/hybrid_grid.h:66-545 (a 3-level sparse voxel tree with 15-bit
probabilities). Here a grid is a dense int8 log-odds volume [D, H, W]
(z, y, x) with a fixed extent centered on the submap origin:

* value 0 = unknown (matching probability MIN_PROBABILITY),
* value v in [-127, 127] = log-odds v/127 * MAX_LOG_ODDS (the int8 range
  is the clamp to p in [0.1, 0.9]).

Hit and miss updates are precomputed int8 deltas; a voxel whose value
would land on 0 is nudged to +-1 so the unknown sentinel stays
unambiguous. `mapping/paged_grid_3d.PagedGrid3D` is the block-sparse form
of the same values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cartographer_tpu_torch.mapping import probability_values as pv

LOG_ODDS_SCALE = pv.MAX_LOG_ODDS / 127.0


def quantize_log_odds_delta(log_odds_delta: float) -> int:
    """Update delta in int8 steps (at least magnitude 1)."""
    q = int(round(log_odds_delta / LOG_ODDS_SCALE))
    if q == 0:
        q = 1 if log_odds_delta > 0 else -1
    return q


def log_odds_to_probability(values):
    """int8 log-odds -> matching probability; unknown (0) -> MIN_PROBABILITY."""
    l = values.to(torch.float32) * LOG_ODDS_SCALE
    return torch.where(values != 0, 1.0 / (1.0 + torch.exp(-l)), pv.MIN_PROBABILITY)


@dataclasses.dataclass
class Grid3D:
    """Dense int8 log-odds volume on one device."""

    values: torch.Tensor  # i8 [D, H, W] (z, y, x)
    origin: torch.Tensor  # f32 [3] world coords such that cell = round((p-origin)/res)
    resolution: float

    @property
    def shape(self):
        return tuple(self.values.shape)

    def probability(self) -> torch.Tensor:
        return log_odds_to_probability(self.values)

    def known(self) -> torch.Tensor:
        return self.values != 0


def make_grid_3d(center_xyz, resolution: float, grid_size: int, device) -> Grid3D:
    center = torch.as_tensor(np.asarray(center_xyz, np.float32), device=device)
    half = 0.5 * grid_size * resolution
    return Grid3D(
        values=torch.zeros(
            (grid_size, grid_size, grid_size), dtype=torch.int8, device=device
        ),
        origin=center - half,
        resolution=resolution,
    )


def grid3d_from_numpy(values, origin, resolution: float, device) -> Grid3D:
    """Grid3D on `device` from numpy (e.g. a JAX package grid's arrays)."""
    return Grid3D(
        values=torch.tensor(np.asarray(values, np.int8), device=device),
        origin=torch.tensor(np.asarray(origin, np.float32), device=device),
        resolution=float(resolution),
    )


def world_to_cell_3d(grid: Grid3D, points_xyz):
    return (points_xyz - grid.origin) / grid.resolution


def cell_index_3d(grid: Grid3D, points_xyz):
    """Voxel (i, j, k) is centered at origin + idx * res (the reference's
    GetCellIndex rounds p / resolution), so idx = round((p - origin) / res)."""
    return torch.floor(world_to_cell_3d(grid, points_xyz) + 0.5).to(torch.int32)
