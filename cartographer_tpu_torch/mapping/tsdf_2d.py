"""2D truncated signed distance field grid.

Port of cartographer_tpu/mapping/tsdf_2d.py. Reference:
mapping/internal/2d/tsdf_2d.h (two uint16 grids: TSD + weight via
TSDValueConverter). Here: float32 tsd + float32 weight tensors with fixed
extent (the layout of grid_2d.Grid2D); weight == 0 marks unknown.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TSDF2D:
    tsd: torch.Tensor  # f32 [H, W] signed distance, clamped to +-truncation
    weight: torch.Tensor  # f32 [H, W], 0 = unknown
    origin: torch.Tensor  # f32 [2]
    resolution: float
    truncation_distance: float
    max_weight: float

    @property
    def size(self) -> int:
        return self.tsd.shape[0]

    def known(self) -> torch.Tensor:
        return self.weight > 0.0

    def probability(self) -> torch.Tensor:
        """Score-grid view for correlative matching: the reference scores
        TSDF cells as (max_cost - |tsd|) / max_cost
        (real_time_correlative_scan_matcher_2d.cc ComputeCandidateScore),
        mapped into the probability range [0.1, 0.9] so the correlative and
        branch-and-bound scorers work unchanged; unknown cells -> 0.1."""
        score = 1.0 - torch.abs(self.tsd) / self.truncation_distance
        return torch.where(self.weight > 0.0, 0.1 + 0.8 * score, 0.1)


def make_tsdf(center_xy, resolution: float, grid_size: int,
              truncation_distance: float, max_weight: float, device) -> TSDF2D:
    center = torch.as_tensor(np.asarray(center_xy, np.float32), device=device)
    half = 0.5 * grid_size * resolution
    return TSDF2D(
        tsd=torch.full((grid_size, grid_size), truncation_distance,
                       dtype=torch.float32, device=device),
        weight=torch.zeros((grid_size, grid_size), dtype=torch.float32, device=device),
        origin=center - half,
        resolution=resolution,
        truncation_distance=truncation_distance,
        max_weight=max_weight,
    )


def tsdf_from_numpy(tsd, weight, origin, resolution: float,
                    truncation_distance: float, max_weight: float, device) -> TSDF2D:
    """TSDF2D on `device` from numpy (e.g. a JAX package TSDF's arrays)."""
    return TSDF2D(
        tsd=torch.tensor(np.asarray(tsd, np.float32), device=device),
        weight=torch.tensor(np.asarray(weight, np.float32), device=device),
        origin=torch.tensor(np.asarray(origin, np.float32), device=device),
        resolution=float(resolution),
        truncation_distance=float(truncation_distance),
        max_weight=float(max_weight),
    )
