"""Real-time correlative scan matching in 3D (device).

Port of cartographer_tpu/ops/scan_matching/correlative_3d.py. Reference:
internal/3d/scan_matching/real_time_correlative_scan_matcher_3d.cc —
exhaustive search over (+-xyz voxel offsets) x (rotations about the z
axis), scoring the mean grid probability with the same translation and
rotation penalty as 2D.

The grid reads for all candidates form an [A, D, D, D, N] gather; it runs
in slices of angles so that one slice stays under `_MAX_GATHER` elements.
The argmax stays on the device and keeps the first maximal index, as
jnp.argmax does.
"""

from __future__ import annotations

import torch

from cartographer_tpu_torch.mapping.paged_grid_3d import gather_probability

_MAX_GATHER = 1 << 23


def score_candidates_3d(
    prob,  # f32 [D, H, W] dense, int8 log-odds, or PagedGrid3D
    origin,  # f32 [3]
    points,  # f32 [N, 3] in the search frame (initial rotation applied)
    point_mask,  # bool [N]
    angles,  # f32 [A]
    angle_mask,  # bool [A]
    init_translation,  # f32 [3]
    resolution: float,
    translation_delta_cost_weight: float,
    rotation_delta_cost_weight: float,
    num_linear: int,
):
    """Returns (scores [A, D, D, D] (dz, dy, dx), best flat index, best
    score), the last two as 0-d device tensors."""
    dev = points.device
    cos_a = torch.cos(angles)[:, None]
    sin_a = torch.sin(angles)[:, None]
    px, py, pz = points[None, :, 0], points[None, :, 1], points[None, :, 2]
    rx = cos_a * px - sin_a * py + init_translation[0]
    ry = sin_a * px + cos_a * py + init_translation[1]
    rz = (pz + init_translation[2]).expand_as(rx)
    # Voxel centers at origin + idx * res: index = round((p - origin) / res),
    # a true division as in the JAX package (its resolution is traced).
    res = torch.full((), resolution, dtype=torch.float32, device=dev)
    ix = torch.floor((rx - origin[0]) / res + 0.5).to(torch.int32)  # [A, N]
    iy = torch.floor((ry - origin[1]) / res + 0.5).to(torch.int32)
    iz = torch.floor((rz - origin[2]) / res + 0.5).to(torch.int32)

    offs = torch.arange(-num_linear, num_linear + 1, dtype=torch.int32, device=dev)
    d3 = offs.shape[0]
    count = torch.clamp(torch.sum(point_mask), min=1)
    weights = point_mask.to(torch.float32)
    a, n = ix.shape
    step = max(1, _MAX_GATHER // (d3**3 * max(n, 1)))
    sums = []
    for lo in range(0, a, step):
        sl = slice(lo, lo + step)
        czi = iz[sl, None, None, None, :] + offs[None, :, None, None, None]
        cyi = iy[sl, None, None, None, :] + offs[None, None, :, None, None]
        cxi = ix[sl, None, None, None, :] + offs[None, None, None, :, None]
        czi, cyi, cxi = torch.broadcast_tensors(czi, cyi, cxi)
        vals = gather_probability(prob, czi, cyi, cxi)
        sums.append(torch.sum(vals * weights, dim=-1))
    mean_prob = torch.cat(sums) / count  # [A, Dz, Dy, Dx]

    offs_m = offs.to(torch.float32) * resolution
    t_norm = (
        torch.sqrt(
            offs_m[:, None, None] ** 2
            + offs_m[None, :, None] ** 2
            + offs_m[None, None, :] ** 2
        )
        * translation_delta_cost_weight
    )
    penalty = torch.exp(
        -torch.square(
            t_norm[None]
            + torch.abs(angles)[:, None, None, None] * rotation_delta_cost_weight
        )
    )
    scores = mean_prob * penalty
    scores = torch.where(angle_mask[:, None, None, None], scores, -torch.inf)
    flat = scores.reshape(-1)
    best = torch.argmax(flat)
    return scores, best, flat[best]
