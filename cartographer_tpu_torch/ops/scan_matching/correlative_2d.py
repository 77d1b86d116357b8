"""Real-time correlative scan matching (exhaustive window search).

Port of cartographer_tpu/ops/scan_matching/correlative_2d.py. Reference:
internal/2d/scan_matching/real_time_correlative_scan_matcher_2d.cc
:61-176 and correlative_scan_matcher_2d.cc:27-111. For every (angle, dx,
dy) candidate, score = mean grid probability at the shifted discretized
scan, weighted by exp(-(|t|*tw + |dtheta|*rw)^2).

The window sums run in the CUDA kernel `kernels/correlative_window` for
CUDA tensors; CPU tensors take its plain version. The angular step is
data-dependent, so angles arrive as a padded tensor with a mask, and the
argmax stays on the device.
"""

from __future__ import annotations

import math

import torch

from cartographer_tpu_torch.kernels import correlative_window


def compute_angular_step(resolution: float, max_scan_range: float) -> float:
    """correlative_scan_matcher_2d.cc:34-43 (safety-margined arccos formula)."""
    max_scan_range = max(max_scan_range, 3.0 * resolution)
    safety_margin = 1.0 - 1e-3
    return safety_margin * math.acos(
        1.0 - resolution**2 / (2.0 * max_scan_range**2)
    )


# The plain version, under the name of its JAX counterpart.
_window_sums_xla = correlative_window.window_sums_plain


def window_sums(prob, ix, iy, point_mask, num_linear: int):
    """Summed window scores [A, D, D]: the CUDA kernel for CUDA tensors
    (one launch, one block per angle), the plain version for CPU tensors.
    `prob` and `point_mask` come from the caller and may be strided; both
    callers below build `ix` and `iy` contiguous."""
    if prob.is_cuda:
        return correlative_window.window_sums(
            prob.contiguous(), ix, iy, point_mask.contiguous(), num_linear
        )
    return _window_sums_xla(prob, ix, iy, point_mask, num_linear)


def _penalty(angles, num_linear: int, resolution: float,
             translation_delta_cost_weight: float,
             rotation_delta_cost_weight: float):
    offs = torch.arange(
        -num_linear, num_linear + 1, dtype=torch.int32, device=angles.device
    )
    t_norm = (
        torch.hypot(
            (offs[:, None] * resolution).float(),
            (offs[None, :] * resolution).float(),
        )
        * translation_delta_cost_weight
    )
    return torch.exp(
        -torch.square(
            t_norm[None, :, :]
            + torch.abs(angles)[:, None, None] * rotation_delta_cost_weight
        )
    )


def score_candidates(
    prob,  # f32 [H, W] probability (unknown -> 0.1)
    origin,  # f32 [2]
    points,  # f32 [N, 2] in local frame, pre-rotated by initial yaw
    point_mask,  # bool [N]
    angles,  # f32 [A] delta angles (padded)
    angle_mask,  # bool [A]
    init_xy,  # f32 [2] initial translation
    resolution: float,
    translation_delta_cost_weight: float,
    rotation_delta_cost_weight: float,
    num_linear: int,  # offsets in [-num_linear, num_linear]
):
    """Returns (scores [A, D, D], best flat index, best score)."""
    cos_a = torch.cos(angles)[:, None]
    sin_a = torch.sin(angles)[:, None]
    px, py = points[:, 0][None, :], points[:, 1][None, :]
    wx = cos_a * px - sin_a * py + init_xy[0]
    wy = sin_a * px + cos_a * py + init_xy[1]
    ix = torch.floor((wx - origin[0]) / resolution).to(torch.int32)  # [A, N]
    iy = torch.floor((wy - origin[1]) / resolution).to(torch.int32)
    sums = window_sums(prob, ix, iy, point_mask, num_linear)
    count = torch.clamp(torch.sum(point_mask), min=1)
    mean_prob = sums / count  # [A, D, D]
    penalty = _penalty(
        angles, num_linear, resolution,
        translation_delta_cost_weight, rotation_delta_cost_weight,
    )
    scores = mean_prob * penalty
    scores = torch.where(angle_mask[:, None, None], scores, -torch.inf)
    best = torch.argmax(scores)
    return scores, best, torch.take(scores, best)


def best_candidate_pose(
    prob,  # f32 [H, W]
    origin,  # f32 [2]
    points,  # f32 [N, 2] local frame (NOT pre-rotated)
    point_mask,  # bool [N]
    initial_pose,  # f32 [3]
    num_angular,  # i32 <= a_cap (data-dependent, a tensor)
    angular_step,  # f32 (a tensor)
    resolution: float,
    translation_delta_cost_weight: float,
    rotation_delta_cost_weight: float,
    num_linear: int,
    a_cap: int,
):
    """RealTimeCorrelativeScanMatcher2D::Match with the STATIC angle
    capacity `a_cap` (rotate per candidate angle, discretize, score
    window, penalty, argmax) — no host synchronisation, so it runs inside
    the chunked frontend's scan loop. Returns (best_score, pose [3])."""
    dev = prob.device
    a = 2 * a_cap + 1
    aidx = torch.arange(a, dtype=torch.int32, device=dev) - a_cap
    angles = aidx.float() * angular_step
    angle_mask = torch.abs(aidx) <= num_angular
    full = initial_pose[2] + angles
    ca, sa = torch.cos(full)[:, None], torch.sin(full)[:, None]
    px, py = points[None, :, 0], points[None, :, 1]
    wx = ca * px - sa * py + initial_pose[0]
    wy = sa * px + ca * py + initial_pose[1]
    ix = torch.floor((wx - origin[0]) / resolution).to(torch.int32)
    iy = torch.floor((wy - origin[1]) / resolution).to(torch.int32)

    sums = window_sums(prob, ix, iy, point_mask, num_linear)
    count = torch.clamp(torch.sum(point_mask), min=1)
    mean_prob = sums / count
    penalty = _penalty(
        angles, num_linear, resolution,
        translation_delta_cost_weight, rotation_delta_cost_weight,
    )
    scores = torch.where(angle_mask[:, None, None], mean_prob * penalty, -torch.inf)
    best = torch.argmax(scores)
    d = 2 * num_linear + 1
    ai = torch.div(best, d * d, rounding_mode="floor")
    rem = best - ai * (d * d)
    dyi = torch.div(rem, d, rounding_mode="floor")
    dxi = rem - dyi * d
    pose = torch.stack(
        [
            initial_pose[0] + (dxi - num_linear).float() * resolution,
            initial_pose[1] + (dyi - num_linear).float() * resolution,
            initial_pose[2] + torch.take(angles, ai),
        ]
    )
    return torch.take(scores, best), pose
