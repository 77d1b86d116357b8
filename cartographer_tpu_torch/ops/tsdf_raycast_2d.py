"""TSDF range-data insertion.

Port of cartographer_tpu/ops/tsdf_raycast_2d.py. Reference:
mapping/internal/2d/tsdf_range_data_inserter_2d.cc:100-245. Per hit:
update cells along the ray within the +-truncation band around the hit
(or the full ray when update_free_space); the signed distance is range -
distance(cell, origin), or projected onto the estimated scan normal; the
update weight combines range, normal-to-ray-angle and distance-to-hit
Gaussian kernels; a cell takes at most one update per scan — the FIRST
hit ray (in bearing-sorted order) wins (CellIsUpdated).

Samples along each ray band are generated in closed form; the
first-ray-wins dedup is a scatter-min of the hit index followed by a
gather compare; then one weighted-average update per cell:
    tsd' = (tsd * w + d * uw) / (w + uw),  w' = min(w + uw, max_weight).
Scatters write into a flat [H * W + 1] buffer whose last cell takes every
sample that is not written (the JAX `mode="drop"` with sentinels). On
CUDA the weighted sums use atomics, so their order is not fixed.
"""

from __future__ import annotations

import math

import torch


def _linspace01(num: int, device):
    """jnp.linspace(0, 1, num) bit for bit: i * f32(1 / (num - 1)), the
    last sample exactly 1."""
    if num == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    step = torch.full((), 1.0 / (num - 1), dtype=torch.float32, device=device)
    ts = torch.arange(num, dtype=torch.float32, device=device) * step
    return torch.cat([ts[:-1], torch.ones(1, dtype=torch.float32, device=device)])


def insert_scan_tsdf(
    tsd,  # f32 [H, W]
    weight,  # f32 [H, W]
    origin_cell,  # f32 [2] fractional cell coords of origin
    hits_cell,  # f32 [N, 2] fractional cell coords of hits
    normals,  # f32 [N] normal angles (world frame), NaN = none
    valid,  # bool [N]
    ranges,  # f32 [N] metric range per hit
    resolution: float,
    truncation_distance: float,
    max_weight: float,
    angle_bandwidth: float,
    distance_bandwidth: float,
    range_exponent: int,
    num_steps: int,
    update_free_space: bool = False,
):
    """Returns (tsd', weight'); the inputs are not modified."""
    h, w = tsd.shape
    dev = tsd.device
    trunc_cells = truncation_distance / resolution

    delta = hits_cell - origin_cell[None, :]  # cells
    ray_len = torch.linalg.norm(delta, dim=-1)
    direction = delta / torch.clamp(ray_len, min=1e-6)[:, None]
    valid = valid & (ranges >= truncation_distance)

    # Sample parameters along the ray in cell units: from the band start
    # to range + truncation.
    start = torch.zeros_like(ray_len) if update_free_space else ray_len - trunc_cells
    end = ray_len + trunc_cells
    ts = _linspace01(num_steps, dev)[None, :]  # [1, S]
    s_param = start[:, None] + ts * (end - start)[:, None]  # [N, S]
    samples = origin_cell[None, None, :] + s_param[..., None] * direction[:, None, :]
    six = torch.floor(samples[..., 0]).to(torch.int32)
    siy = torch.floor(samples[..., 1]).to(torch.int32)
    s_in = (six >= 0) & (six < w) & (siy >= 0) & (siy < h) & valid[:, None]
    flat = torch.where(s_in, siy.long() * w + six.long(), h * w)  # [N, S]

    # First-ray-wins dedup (CellIsUpdated): scatter-min of the hit index.
    n = hits_cell.shape[0]
    hit_idx = torch.arange(n, dtype=torch.int32, device=dev)[:, None].expand(n, num_steps)
    owner = torch.full((h * w + 1,), n, dtype=torch.int32, device=dev)
    owner = owner.scatter_reduce(
        0, flat.reshape(-1), hit_idx.reshape(-1), reduce="amin", include_self=True
    )
    mine = s_in & (owner[flat] == hit_idx)

    # Signed distance per sample.
    cell_center = torch.floor(samples) + 0.5  # cell units
    dist_cell_origin = (
        torch.linalg.norm(cell_center - origin_cell[None, None, :], dim=-1) * resolution
    )
    update_tsd_ray = ranges[:, None] - dist_cell_origin
    # Projection onto the scan normal (project_sdf_distance_to_scan_normal).
    normal_vec = torch.stack([torch.cos(normals), torch.sin(normals)], dim=-1)
    to_hit = (cell_center - hits_cell[:, None, :]) * resolution
    update_tsd_normal = torch.sum(to_hit * normal_vec[:, None, :], dim=-1)
    use_normal = ~torch.isnan(normals)
    update_tsd = torch.where(use_normal[:, None], update_tsd_normal, update_tsd_ray)
    update_tsd = torch.clamp(update_tsd, -truncation_distance, truncation_distance)

    # Weight kernels.
    if range_exponent != 0:
        weight_range = (truncation_distance**range_exponent) / torch.clamp(
            ranges**range_exponent, min=1e-6
        )
    else:
        weight_range = torch.ones_like(ranges)
    if angle_bandwidth != 0.0:
        ray_angle = torch.atan2(-direction[:, 1], -direction[:, 0])
        d_angle = normals - ray_angle
        d_angle = d_angle - 2.0 * math.pi * torch.ceil(
            (d_angle - math.pi) / (2.0 * math.pi)
        )
        weight_angle = torch.exp(-0.5 * torch.square(d_angle / angle_bandwidth))
        weight_angle = torch.where(use_normal, weight_angle, 1.0)
    else:
        weight_angle = torch.ones_like(ranges)
    uw = (weight_range * weight_angle)[:, None].expand(n, num_steps)
    if distance_bandwidth != 0.0:
        uw = uw * torch.exp(-0.5 * torch.square(update_tsd / distance_bandwidth))
    uw = torch.where(mine, uw, 0.0)

    # One update per cell: the mean of the owning ray's samples in it.
    cell = torch.where(mine, flat, h * w).reshape(-1)
    zeros = torch.zeros(h * w + 1, dtype=torch.float32, device=dev)
    sum_w = zeros.index_add(0, cell, uw.reshape(-1))[: h * w].reshape(h, w)
    sum_wd = zeros.index_add(0, cell, (uw * update_tsd).reshape(-1))[: h * w].reshape(h, w)
    count = zeros.index_add(0, cell, mine.to(torch.float32).reshape(-1))[: h * w].reshape(h, w)
    upd_w = torch.where(count > 0, sum_w / torch.clamp(count, min=1.0), 0.0)
    upd_d = torch.where(sum_w > 0, sum_wd / torch.clamp(sum_w, min=1e-12), 0.0)

    new_weight_raw = weight + upd_w
    new_tsd = torch.where(
        upd_w > 0,
        (tsd * weight + upd_d * upd_w) / torch.clamp(new_weight_raw, min=1e-12),
        tsd,
    )
    return new_tsd, torch.clamp(new_weight_raw, max=max_weight)
