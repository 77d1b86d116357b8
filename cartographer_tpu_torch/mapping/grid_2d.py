"""2D occupancy grids as fixed-shape tensors.

Port of cartographer_tpu/mapping/grid_2d.py. Reference:
mapping/2d/grid_2d.h:38-128 and mapping/2d/probability_grid.h. A grid is a
fixed-extent float32 log-odds tensor plus a known-cell mask; cell
(iy, ix) covers world [origin + (ix, iy)*res, +res). Unknown cells have
log_odds == 0 AND known == False; their matching probability is
MIN_PROBABILITY.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cartographer_tpu_torch.mapping import probability_values as pv


@dataclasses.dataclass
class Grid2D:
    """Probability grid state (tensors on one device)."""

    log_odds: torch.Tensor  # f32 [H, W]
    known: torch.Tensor  # bool [H, W]
    origin: torch.Tensor  # f32 [2] world coords of cell (0, 0) min corner
    resolution: float

    @property
    def size(self) -> int:
        return self.log_odds.shape[0]

    def probability(self) -> torch.Tensor:
        """Per-cell matching probability; unknown cells -> MIN_PROBABILITY."""
        p = 1.0 / (1.0 + torch.exp(-self.log_odds))
        return torch.where(self.known, p, pv.MIN_PROBABILITY)

    def correspondence_cost(self) -> torch.Tensor:
        return 1.0 - self.probability()


def grid_from_numpy(log_odds, known, origin, resolution: float, device) -> Grid2D:
    """Grid2D on `device` from numpy (e.g. a JAX package grid's arrays)."""
    return Grid2D(
        log_odds=torch.tensor(np.asarray(log_odds, np.float32), device=device),
        known=torch.tensor(np.asarray(known, bool), device=device),
        origin=torch.tensor(np.asarray(origin, np.float32), device=device),
        resolution=float(resolution),
    )


def make_grid(center_xy, resolution: float, grid_size: int, device) -> Grid2D:
    """Fresh unknown grid centered on `center_xy` (world meters), on
    `device`."""
    center = torch.as_tensor(np.asarray(center_xy, np.float32), device=device)
    half = 0.5 * grid_size * resolution
    return Grid2D(
        log_odds=torch.zeros((grid_size, grid_size), dtype=torch.float32, device=device),
        known=torch.zeros((grid_size, grid_size), dtype=torch.bool, device=device),
        origin=center - half,
        resolution=resolution,
    )


def world_to_cell(grid: Grid2D, points_xy):
    """World (..., 2) -> fractional cell coordinates (..., 2) as (cx, cy)."""
    return (points_xy - grid.origin) / grid.resolution


def cell_center_world(grid: Grid2D, ix, iy):
    return grid.origin + (torch.stack([ix, iy], dim=-1) + 0.5) * grid.resolution


@dataclasses.dataclass
class CroppedGrid:
    """Host-side crop of the known region (for rendering/serialization)."""

    probability: np.ndarray  # [h, w]
    known: np.ndarray  # [h, w]
    origin: np.ndarray  # [2]
    resolution: float
    offset_yx: tuple


def compute_cropped(grid: Grid2D) -> CroppedGrid:
    """Crop to the bounding box of known cells (Grid2D::ComputeCroppedLimits)."""
    known = grid.known.cpu().numpy()
    prob = grid.probability().cpu().numpy()
    origin = grid.origin.cpu().numpy()
    ys, xs = np.nonzero(known)
    if len(ys) == 0:
        return CroppedGrid(
            probability=np.zeros((0, 0), np.float32),
            known=np.zeros((0, 0), bool),
            origin=origin,
            resolution=grid.resolution,
            offset_yx=(0, 0),
        )
    y0, y1 = ys.min(), ys.max() + 1
    x0, x1 = xs.min(), xs.max() + 1
    return CroppedGrid(
        probability=prob[y0:y1, x0:x1],
        known=known[y0:y1, x0:x1],
        origin=origin + np.array([x0, y0]) * grid.resolution,
        resolution=grid.resolution,
        offset_yx=(int(y0), int(x0)),
    )
