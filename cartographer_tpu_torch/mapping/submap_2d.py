"""2D submaps and the two-active-submaps scheme.

Port of cartographer_tpu/mapping/submap_2d.py. Reference:
mapping/2d/submap_2d.cc:137-219. A submap has a local pose (pure
translation at the first scan's origin), a grid, and a range-data count.
There are always (up to) two active submaps; a new one starts every
`num_range_data` inserts, and a submap is finished after 2*num_range_data
inserts, so every scan lands in exactly two submaps (except at the start).
`ActiveSubmaps2D` keeps its grids (probability grids or TSDFs) on one
device; the per-scan bookkeeping stays on the host.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from typing import List, Optional

import numpy as np
import torch

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.common.config import SubmapsOptions2D
from cartographer_tpu_torch.device import resolve_device
from cartographer_tpu_torch.mapping import probability_values as pv
from cartographer_tpu_torch.mapping.grid_2d import (
    Grid2D,
    grid_from_numpy,
    make_grid,
    world_to_cell,
)
from cartographer_tpu_torch.mapping.normal_estimation_2d import (
    estimate_normals,
    sort_range_data_by_angle,
)
from cartographer_tpu_torch.mapping.tsdf_2d import TSDF2D, make_tsdf
from cartographer_tpu_torch.ops import raycast_2d, tsdf_raycast_2d
from cartographer_tpu_torch.sensor.data import RangeData
from cartographer_tpu_torch.transform import rigid2


def _round_up_pow2(n: int, minimum: int = 64) -> int:
    v = minimum
    while v < n:
        v *= 2
    return v


@dataclasses.dataclass
class Submap2D:
    local_pose: np.ndarray  # SE(2) (3,) — translation only (rotation 0)
    grid: Optional[Grid2D]  # or a TSDF2D
    num_range_data: int = 0
    insertion_finished: bool = False
    extent_overflow_warned: bool = False

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


class ActiveSubmaps2D:
    def __init__(self, options: SubmapsOptions2D, device=None):
        """`device=None` means CUDA; pass device="cpu" to run on the CPU."""
        self._options = options
        self._device = resolve_device(device)
        self._submaps: List[Submap2D] = []
        grid_opts = options.grid_options_2d
        self._grid_type = grid_opts.grid_type
        if grid_opts.grid_type == "PROBABILITY_GRID":
            ins = options.range_data_inserter.probability_grid_range_data_inserter
            self._hit_log_odds = pv.hit_update_log_odds(ins.hit_probability)
            self._miss_log_odds = pv.miss_update_log_odds(ins.miss_probability)
            self._insert_free_space = ins.insert_free_space
        elif grid_opts.grid_type == "TSDF":
            self._tsdf_options = options.range_data_inserter.tsdf_range_data_inserter
        else:
            raise ValueError(f"unknown grid type {grid_opts.grid_type}")

    def submaps(self) -> List[Submap2D]:
        return list(self._submaps)

    def to(self, device) -> "ActiveSubmaps2D":
        """A copy on `device`: the bookkeeping copied, the grids moved."""
        device = torch.device(device)
        moved = {
            id(s.grid): dataclasses.replace(s.grid, **{
                f.name: getattr(s.grid, f.name).to(device, copy=True)
                for f in dataclasses.fields(s.grid)
                if isinstance(getattr(s.grid, f.name), torch.Tensor)
            })
            for s in self._submaps
        }
        twin = copy.deepcopy(self, moved)
        twin._device = device
        return twin

    def insert_range_data(self, range_data: RangeData) -> List[Submap2D]:
        """Insert (already in local frame); returns submaps after insertion.

        Mirrors ActiveSubmaps2D::InsertRangeData (submap_2d.cc:161-174):
        starts a new submap when the newest one has seen num_range_data
        scans; finishes the oldest at 2x.
        """
        if (
            not self._submaps
            or self._submaps[-1].num_range_data == self._options.num_range_data
        ):
            self._add_submap(range_data.origin[:2])
        self._insert(range_data)
        for submap in self._submaps:
            submap.num_range_data += 1
        if self._submaps[0].num_range_data == 2 * self._options.num_range_data:
            # Stays in the list (and in the returned insertion result) until
            # the next _add_submap pops it — the pose graph reads the
            # insertion_finished flag off the returned submaps.
            self._submaps[0].finish()
        return list(self._submaps)

    def _add_submap(self, origin_xy: np.ndarray) -> None:
        grid_opts = self._options.grid_options_2d
        center = np.asarray(origin_xy, dtype=np.float32)
        if self._grid_type == "TSDF":
            grid = make_tsdf(
                center,
                grid_opts.resolution,
                grid_opts.grid_size,
                self._tsdf_options.truncation_distance,
                self._tsdf_options.maximum_weight,
                self._device,
            )
        else:
            grid = make_grid(
                center, grid_opts.resolution, grid_opts.grid_size, self._device
            )
        self._submaps.append(
            Submap2D(
                local_pose=rigid2.make(np.asarray(origin_xy, np.float64), 0.0),
                grid=grid,
            )
        )
        if len(self._submaps) > 2:
            self._submaps.pop(0)

    def _insert(self, range_data: RangeData) -> None:
        if self._grid_type == "TSDF":
            self._insert_tsdf(range_data)
            return
        res = self._options.grid_options_2d.resolution
        hits = range_data.returns.points[:, :2]
        misses = range_data.misses.points[:, :2]
        n_hits, n_miss = len(hits), len(misses)
        if n_hits + n_miss == 0:
            return
        ends = np.concatenate([hits, misses], axis=0)
        n_pad = _round_up_pow2(n_hits + n_miss)
        ends_p = np.zeros((n_pad, 2), np.float32)
        ends_p[: n_hits + n_miss] = ends
        valid = np.zeros(n_pad, bool)
        valid[: n_hits + n_miss] = True
        is_hit_p = np.zeros(n_pad, bool)
        is_hit_p[:n_hits] = True

        origin = range_data.origin[:2].astype(np.float64)
        max_len = float(
            np.max(np.linalg.norm(ends - origin[None, :], axis=1), initial=res)
        )
        # Max integer boundary crossings per axis for the exact-supercover
        # scatter (raycast_2d.insert_scan), rounded to a power of two as in
        # the JAX package.
        num_steps = _round_up_pow2(int(np.ceil(max_len / res)) + 2, 32)

        dev = self._device
        origin_d = torch.from_numpy(origin.astype(np.float32)).to(dev)
        ends_d = torch.from_numpy(ends_p).to(dev)
        is_hit_d = torch.from_numpy(is_hit_p).to(dev)
        valid_d = torch.from_numpy(valid).to(dev)
        for submap in self._submaps:
            grid = submap.grid
            origin_cell = world_to_cell(grid, origin_d)
            ends_cell = world_to_cell(grid, ends_d)
            # Extent-overflow observability: the fixed extent replaces the
            # reference's GrowLimits (grid_2d.cc), so out-of-extent HIT
            # endpoints are dropped — count them instead of losing them
            # silently (miss rays merely truncate at the border).
            ec = torch.floor(ends_cell[:n_hits])
            oob = int(torch.sum(torch.any((ec < 0) | (ec >= grid.size), dim=1)))
            if oob:
                metrics.grid_oob_points.increment(oob)
                if not submap.extent_overflow_warned:
                    submap.extent_overflow_warned = True
                    logging.getLogger(__name__).warning(
                        "submap grid extent overflow: %d endpoint(s) outside "
                        "the %dx%d grid this scan; increase "
                        "grid_options_2d.grid_size", oob, grid.size, grid.size,
                    )
            new_log_odds, new_known = raycast_2d.insert_scan(
                grid.log_odds,
                grid.known,
                origin_cell,
                ends_cell,
                is_hit_d,
                valid_d,
                self._hit_log_odds,
                self._miss_log_odds,
                num_steps,
                self._insert_free_space,
            )
            submap.grid = Grid2D(
                log_odds=new_log_odds,
                known=new_known,
                origin=grid.origin,
                resolution=grid.resolution,
            )

    def _insert_tsdf(self, range_data: RangeData) -> None:
        opts = self._tsdf_options
        hits = range_data.returns.points[:, :2].astype(np.float64)
        if len(hits) == 0:
            return
        origin = range_data.origin[:2].astype(np.float64)
        need_normals = (
            opts.project_sdf_distance_to_scan_normal
            or opts.update_weight_angle_scan_normal_to_ray_kernel_bandwidth != 0.0
        )
        if need_normals:
            order = sort_range_data_by_angle(hits, origin)
            hits = hits[order]
            normals = estimate_normals(hits, origin, opts.normal_estimation_options)
        else:
            normals = np.full(len(hits), np.nan, np.float32)
        ranges = np.linalg.norm(hits - origin[None, :], axis=1)

        n_pad = _round_up_pow2(len(hits))
        hits_p = np.zeros((n_pad, 2), np.float64)
        hits_p[: len(hits)] = hits
        normals_p = np.full(n_pad, np.nan, np.float32)
        normals_p[: len(hits)] = normals
        ranges_p = np.zeros(n_pad, np.float32)
        ranges_p[: len(hits)] = ranges
        valid = np.zeros(n_pad, bool)
        valid[: len(hits)] = True

        res = self._options.grid_options_2d.resolution
        if opts.update_free_space:
            max_len = float(np.max(ranges, initial=res)) + opts.truncation_distance
        else:
            max_len = 2.0 * opts.truncation_distance
        num_steps = _round_up_pow2(int(np.ceil(max_len / (0.5 * res))), 16)

        dev = self._device
        normals_d = torch.from_numpy(normals_p).to(dev)
        valid_d = torch.from_numpy(valid).to(dev)
        ranges_d = torch.from_numpy(ranges_p).to(dev)
        for submap in self._submaps:
            grid = submap.grid
            # The cell coordinates in float64 on the host, as the JAX
            # package computes them, then float32 on the device.
            grid_origin = grid.origin.cpu().numpy()
            origin_cell = (origin - grid_origin) / res
            hits_cell = (hits_p - grid_origin[None, :]) / res
            new_tsd, new_weight = tsdf_raycast_2d.insert_scan_tsdf(
                grid.tsd,
                grid.weight,
                torch.from_numpy(origin_cell.astype(np.float32)).to(dev),
                torch.from_numpy(hits_cell.astype(np.float32)).to(dev),
                normals_d,
                valid_d,
                ranges_d,
                res,
                opts.truncation_distance,
                opts.maximum_weight,
                opts.update_weight_angle_scan_normal_to_ray_kernel_bandwidth,
                opts.update_weight_distance_cell_to_hit_kernel_bandwidth,
                opts.update_weight_range_exponent,
                num_steps,
                opts.update_free_space,
            )
            submap.grid = TSDF2D(
                tsd=new_tsd,
                weight=new_weight,
                origin=grid.origin,
                resolution=grid.resolution,
                truncation_distance=grid.truncation_distance,
                max_weight=grid.max_weight,
            )
