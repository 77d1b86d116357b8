"""3D range-data insertion into dense int8 voxel volumes (device).

Port of cartographer_tpu/ops/raycast_3d.py. Reference:
mapping/3d/range_data_inserter_3d.cc:27-116 — every hit voxel gets one
odds(hit) update; only the last `num_free_space_voxels` voxels before each
hit along the ray get odds(miss) updates (bounded free-space carving);
hits take priority; one update per voxel per scan.

The miss samples come in closed form (miss_cell = origin_cell + delta *
position / num_samples with C++ truncating division, the reference's
integer formula). Where the JAX package adds an update mask over the
whole volume, this port gathers the touched voxels' pre-scan values and
writes them back with two ordered index_put_ calls, misses first and hits
second: duplicates of one kind write the same value and hits overwrite
shared voxels, which is the same result. Dropped writes (off the volume or
unselected) go to one spare element past the end.
"""

from __future__ import annotations

import torch


def free_space_cells(origin_cell, hit_cells, valid, num_free_space_voxels: int):
    """Miss samples of each ray: positions max(0, n-k)..n-1 along it, n its
    Chebyshev length. origin_cell [..., 3], hit_cells [..., N, 3], valid
    [..., N] -> (miss_cells [..., N, K, 3], pos_valid [..., N, K])."""
    k = num_free_space_voxels
    delta = hit_cells - origin_cell[..., None, :]
    num_samples = torch.amax(torch.abs(delta), dim=-1)  # [..., N]
    ks = torch.arange(k, dtype=delta.dtype, device=delta.device)
    position = torch.clamp(num_samples[..., None] - k, min=0) + ks  # [..., N, K]
    pos_valid = (position < num_samples[..., None]) & valid[..., None]
    safe_n = torch.clamp(num_samples, min=1)[..., None, None]
    num = delta[..., None, :] * position[..., None]  # [..., N, K, 3]
    # C++ integer division truncates toward zero (reference formula): the
    # floor of a non-negative quotient, signed afterwards.
    quot = torch.sign(num) * torch.div(torch.abs(num), safe_n, rounding_mode="floor")
    return origin_cell[..., None, None, :] + quot, pos_valid


def _in_bounds(cells, d, h, w):
    return (
        (cells[..., 0] >= 0) & (cells[..., 0] < w)
        & (cells[..., 1] >= 0) & (cells[..., 1] < h)
        & (cells[..., 2] >= 0) & (cells[..., 2] < d)
    )


def insert_scan_3d_lanes(
    values,  # i8 [L, D, H, W]
    origin_cell,  # i32 [L, 3] (x, y, z) cell of the sensor origin per lane
    hit_cells,  # i32 [L, N, 3] (x, y, z)
    valid,  # bool [L, N]
    hit_delta: int,
    miss_delta: int,
    num_free_space_voxels: int,
):
    """`insert_scan_3d` over L independent volumes at once."""
    lanes, d, h, w = values.shape
    size = d * h * w
    miss_cells, pos_valid = free_space_cells(
        origin_cell, hit_cells, valid, num_free_space_voxels
    )
    miss_cells = miss_cells.reshape(lanes, -1, 3)
    pos_valid = pos_valid.reshape(lanes, -1)
    lane_base = (
        torch.arange(lanes, dtype=torch.int64, device=values.device) * size
    )[:, None]

    def flat_index(cells, sel):
        sel = sel & _in_bounds(cells, d, h, w)
        c = cells.to(torch.int64)
        idx = lane_base + (c[..., 2] * h + c[..., 1]) * w + c[..., 0]
        return torch.where(sel, idx, lanes * size)

    flat = torch.cat(
        [values.reshape(-1), torch.zeros(1, dtype=values.dtype, device=values.device)]
    )

    def updated(idx, delta: int):
        # One update per voxel from the PRE-scan value; never lands on 0.
        new = torch.clamp(flat[idx].to(torch.int16) + delta, -127, 127)
        return torch.where(new == 0, 1 if delta > 0 else -1, new).to(torch.int8)

    miss_idx = flat_index(miss_cells, pos_valid)
    hit_idx = flat_index(hit_cells, valid)
    miss_new = updated(miss_idx, miss_delta)
    hit_new = updated(hit_idx, hit_delta)
    flat.index_put_((miss_idx,), miss_new)
    flat.index_put_((hit_idx,), hit_new)  # hits win shared voxels
    return flat[:-1].reshape(values.shape)


def insert_scan_3d(
    values,  # i8 [D, H, W]
    origin_cell,  # i32 [3] (x, y, z) cell of the sensor origin
    hit_cells,  # i32 [N, 3] (x, y, z)
    valid,  # bool [N]
    hit_delta: int,  # int8 log-odds delta (quantized)
    miss_delta: int,
    num_free_space_voxels: int,
):
    """Bounded free-space insertion of one scan; returns the new volume
    (the input is not modified)."""
    return insert_scan_3d_lanes(
        values[None], origin_cell[None], hit_cells[None], valid[None],
        hit_delta, miss_delta, num_free_space_voxels,
    )[0]


def insert_intensities_3d(
    intensity_sum,  # f32 [D, H, W]
    intensity_count,  # f32 [D, H, W]
    hit_cells,  # i32 [N, 3]
    intensities,  # f32 [N]
    valid,  # bool [N]
):
    """Running-average intensity per voxel (IntensityHybridGrid.AddIntensity):
    returns the new (sum, count) volumes."""
    d, h, w = intensity_sum.shape
    size = d * h * w
    sel = valid & _in_bounds(hit_cells, d, h, w)
    c = hit_cells.to(torch.int64)
    idx = torch.where(sel, (c[:, 2] * h + c[:, 1]) * w + c[:, 0], size)
    zero = torch.zeros(1, dtype=intensity_sum.dtype, device=intensity_sum.device)

    def add(volume, amounts):
        flat = torch.cat([volume.reshape(-1), zero])
        flat.index_add_(0, idx, torch.where(sel, amounts, 0.0))
        return flat[:-1].reshape(volume.shape)

    return (
        add(intensity_sum, intensities),
        add(intensity_count, torch.ones_like(intensities)),
    )
