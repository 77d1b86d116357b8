"""3D submaps and the two-active-submaps scheme.

Port of cartographer_tpu/mapping/submap_3d.py. Reference:
mapping/3d/submap_3d.h:43-140 and submap_3d.cc:199-354. A Submap3D holds
TWO grids (high and low resolution), an optional intensity volume pair,
and an accumulated rotational histogram rotated into the submap frame.
Range data is inserted in the SUBMAP frame (transform by local_pose^-1);
the submap's local pose is {origin translation, gravity alignment
rotation} (ActiveSubmaps3D::AddSubmap).

The grids are paged (`PagedGrid3D`) while a submap is built when
`sparse_grids` is set and intensities are off, dense `Grid3D` otherwise;
they live on the ActiveSubmaps3D's device, and the per-scan bookkeeping
(cell indices, histograms) stays on the host, as in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from typing import List, Optional

import numpy as np
import torch

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.common.config import SubmapsOptions3D
from cartographer_tpu_torch.device import resolve_device
from cartographer_tpu_torch.mapping import probability_values as pv
from cartographer_tpu_torch.mapping.hybrid_grid import (
    Grid3D,
    grid3d_from_numpy,
    make_grid_3d,
    quantize_log_odds_delta,
)
from cartographer_tpu_torch.mapping.paged_grid_3d import (
    PagedGrid3D,
    insert_scan_3d_paged,
    make_paged_grid_3d,
    paged_from_numpy,
    to_dense,
)
from cartographer_tpu_torch.ops import raycast_3d
from cartographer_tpu_torch.ops.scan_matching import rotational_histogram
from cartographer_tpu_torch.sensor.data import RangeData
from cartographer_tpu_torch.transform import rigid3


def _pad_cells(cells: np.ndarray, minimum: int = 256):
    n = len(cells)
    size = minimum
    while size < n:
        size *= 2
    out = np.zeros((size, 3), np.int32)
    out[:n] = cells
    mask = np.zeros(size, bool)
    mask[:n] = True
    return out, mask


@dataclasses.dataclass
class Submap3D:
    local_pose: np.ndarray  # SE(3) (7,)
    high_resolution_grid: Grid3D  # or PagedGrid3D while building
    low_resolution_grid: Grid3D
    rotational_scan_matcher_histogram: np.ndarray
    intensity_sum: Optional[torch.Tensor] = None
    intensity_count: Optional[torch.Tensor] = None
    num_range_data: int = 0
    insertion_finished: bool = False

    def finish(self) -> None:
        # Paged building grids become dense grids cropped to their occupied
        # blocks: the form the loop-closure search, refinement and
        # serialization consume (the reference's PrecomputationGrid3D also
        # materializes dense bounded volumes, precomputation_grid_3d.cc:54-85).
        for name in ("high_resolution_grid", "low_resolution_grid"):
            grid = getattr(self, name)
            if not isinstance(grid, PagedGrid3D):
                continue
            dropped = int(grid.dropped)
            if dropped:
                metrics.grid_oob_points.increment(dropped)
                logging.getLogger(__name__).warning(
                    "paged 3D grid dropped %d write(s) (%s: pool full or "
                    "outside the virtual extent); raise the sparse_* "
                    "options", dropped, name,
                )
            setattr(self, name, to_dense(grid))
        self.insertion_finished = True


def grid_from_fields(fields: dict, device):
    """A Grid3D or PagedGrid3D on `device` from numpy arrays keyed by field
    name (a paged grid has a "table")."""
    if "table" in fields:
        return paged_from_numpy(
            fields["table"], fields["pool"], fields["num_blocks"],
            fields["dropped"], fields["origin"], fields["resolution"],
            fields["block_bits"], fields["table_size"], device,
        )
    return grid3d_from_numpy(
        fields["values"], fields["origin"], fields["resolution"], device
    )


def submap3d_from_numpy(
    local_pose,
    high_resolution_grid: dict,
    low_resolution_grid: dict,
    rotational_scan_matcher_histogram,
    device,
    intensity_sum=None,
    intensity_count=None,
    num_range_data: int = 0,
    insertion_finished: bool = False,
) -> Submap3D:
    """Submap3D on `device` from numpy arrays, e.g. a JAX package submap's;
    each grid is a dict of fields (see grid_from_fields)."""

    def volume(x):
        if x is None:
            return None
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return Submap3D(
        local_pose=np.asarray(local_pose, np.float64),
        high_resolution_grid=grid_from_fields(high_resolution_grid, device),
        low_resolution_grid=grid_from_fields(low_resolution_grid, device),
        rotational_scan_matcher_histogram=np.asarray(
            rotational_scan_matcher_histogram, np.float32
        ),
        intensity_sum=volume(intensity_sum),
        intensity_count=volume(intensity_count),
        num_range_data=num_range_data,
        insertion_finished=insertion_finished,
    )


def _moved(obj, device):
    """A copy of a grid dataclass (or a tensor) with its tensors on
    `device`."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.to(device, copy=True)
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device, copy=True)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
    })


class ActiveSubmaps3D:
    def __init__(
        self, options: SubmapsOptions3D, use_intensities: bool = False, device=None
    ):
        """`device=None` means CUDA; pass device="cpu" to run on the CPU."""
        self._options = options
        self._use_intensities = use_intensities
        self._device = resolve_device(device)
        self._submaps: List[Submap3D] = []
        ins = options.range_data_inserter
        self._hit_delta = quantize_log_odds_delta(
            pv.hit_update_log_odds(ins.hit_probability)
        )
        self._miss_delta = quantize_log_odds_delta(
            pv.miss_update_log_odds(ins.miss_probability)
        )

    def submaps(self) -> List[Submap3D]:
        return list(self._submaps)

    def to(self, device) -> "ActiveSubmaps3D":
        """A copy on `device`: the bookkeeping copied, the volumes moved."""
        device = torch.device(device)
        moved = {}
        for s in self._submaps:
            for name in ("high_resolution_grid", "low_resolution_grid",
                         "intensity_sum", "intensity_count"):
                value = getattr(s, name)
                if value is not None:
                    moved[id(value)] = _moved(value, device)
        twin = copy.deepcopy(self, moved)
        twin._device = device
        return twin

    def insert_data(
        self,
        range_data_in_local: RangeData,
        local_from_gravity_aligned: np.ndarray,  # quaternion
        scan_histogram_in_gravity: np.ndarray,
    ) -> List[Submap3D]:
        if (
            not self._submaps
            or self._submaps[-1].num_range_data == self._options.num_range_data
        ):
            self._add_submap(range_data_in_local.origin, local_from_gravity_aligned)
        for submap in self._submaps:
            self._insert_into(
                submap,
                range_data_in_local,
                local_from_gravity_aligned,
                scan_histogram_in_gravity,
            )
        if self._submaps[0].num_range_data == 2 * self._options.num_range_data:
            self._submaps[0].finish()
        return list(self._submaps)

    def _add_submap(self, origin: np.ndarray, local_from_gravity_aligned: np.ndarray) -> None:
        if len(self._submaps) == 2:
            self._submaps.pop(0)
        local_pose = rigid3.make(
            np.asarray(origin, np.float64), np.asarray(local_from_gravity_aligned)
        )
        o = self._options
        dev = self._device
        zero = np.zeros(3, np.float32)
        # Intensity volumes are dense companions of the high grid, so the
        # intensity configuration keeps dense building grids.
        if o.sparse_grids and not self._use_intensities:
            high = make_paged_grid_3d(
                zero, o.high_resolution, block_bits=o.sparse_block_bits,
                table_size=o.sparse_high_table_size,
                pool_blocks=o.sparse_high_pool_blocks, device=dev,
            )
            low = make_paged_grid_3d(
                zero, o.low_resolution, block_bits=o.sparse_block_bits,
                table_size=o.sparse_low_table_size,
                pool_blocks=o.sparse_low_pool_blocks, device=dev,
            )
        else:
            high = make_grid_3d(zero, o.high_resolution, o.high_resolution_grid_size, dev)
            low = make_grid_3d(zero, o.low_resolution, o.low_resolution_grid_size, dev)
        submap = Submap3D(
            local_pose=local_pose,
            high_resolution_grid=high,
            low_resolution_grid=low,
            rotational_scan_matcher_histogram=np.zeros(
                len(self._submaps[0].rotational_scan_matcher_histogram)
                if self._submaps
                else 0,
                np.float32,
            ),
        )
        if self._use_intensities:
            shape = high.values.shape
            submap.intensity_sum = torch.zeros(shape, dtype=torch.float32, device=dev)
            submap.intensity_count = torch.zeros(shape, dtype=torch.float32, device=dev)
        self._submaps.append(submap)

    def _insert_into(
        self,
        submap: Submap3D,
        range_data_in_local: RangeData,
        local_from_gravity_aligned: np.ndarray,
        scan_histogram_in_gravity: np.ndarray,
    ) -> None:
        assert not submap.insertion_finished
        dev = self._device
        # Transform into the submap frame (submap_3d.cc InsertData).
        data = range_data_in_local.transform(rigid3.inverse(submap.local_pose))
        hits = data.returns.points
        origin = data.origin

        def upload(x):
            return torch.from_numpy(x).to(dev)

        # High resolution: hits within high_resolution_max_range only. The
        # cell indices are computed in float32 on the host, as in JAX.
        ranges = np.linalg.norm(hits - origin[None, :], axis=1)
        near = ranges <= self._options.high_resolution_max_range
        for name, pts in (
            ("high_resolution_grid", hits[near]),
            ("low_resolution_grid", hits),
        ):
            if len(pts) == 0:
                continue
            grid = getattr(submap, name)
            grid_origin = grid.origin.cpu().numpy()
            cells = np.floor(
                (pts - grid_origin) / grid.resolution + 0.5
            ).astype(np.int32)
            origin_cell = np.floor(
                (origin - grid_origin) / grid.resolution + 0.5
            ).astype(np.int32)
            cells_p, valid = _pad_cells(cells)
            args = (
                upload(origin_cell), upload(cells_p), upload(valid),
                self._hit_delta, self._miss_delta,
                self._options.range_data_inserter.num_free_space_voxels,
            )
            if isinstance(grid, PagedGrid3D):
                new_grid = insert_scan_3d_paged(grid, *args)
            else:
                new_grid = dataclasses.replace(
                    grid, values=raycast_3d.insert_scan_3d(grid.values, *args)
                )
            setattr(submap, name, new_grid)

        if (
            self._use_intensities
            and data.returns.intensities is not None
            and len(data.returns.intensities)
        ):
            thresh = self._options.range_data_inserter.intensity_threshold
            keep = (data.returns.intensities <= thresh) & near
            pts = hits[keep]
            grid = submap.high_resolution_grid
            cells = np.floor(
                (pts - grid.origin.cpu().numpy()) / grid.resolution
            ).astype(np.int32)
            cells_p, valid = _pad_cells(cells)
            intens = np.zeros(len(valid), np.float32)
            intens[: len(pts)] = data.returns.intensities[keep]
            submap.intensity_sum, submap.intensity_count = (
                raycast_3d.insert_intensities_3d(
                    submap.intensity_sum,
                    submap.intensity_count,
                    upload(cells_p),
                    upload(intens),
                    upload(valid),
                )
            )

        submap.num_range_data += 1
        # Histogram accumulated in the submap frame (submap_3d.cc:289-294).
        yaw_in_submap_from_gravity = rigid3.get_yaw(
            rigid3.quat_multiply(
                rigid3.quat_conjugate(rigid3.quat(submap.local_pose)),
                np.asarray(local_from_gravity_aligned),
            )
        )
        if len(submap.rotational_scan_matcher_histogram) == 0:
            submap.rotational_scan_matcher_histogram = np.zeros_like(
                scan_histogram_in_gravity
            )
        submap.rotational_scan_matcher_histogram = (
            submap.rotational_scan_matcher_histogram
            + rotational_histogram.rotate_histogram(
                scan_histogram_in_gravity, float(yaw_in_submap_from_gravity)
            )
        )
