"""2D occupancy grids as fixed-shape tensors.

Port of `Grid2D` from cartographer_tpu/mapping/grid_2d.py. Reference:
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
