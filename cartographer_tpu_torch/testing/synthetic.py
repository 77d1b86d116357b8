"""Synthetic-world measurement generation for integration tests.

Reference: mapping/internal/testing/test_helpers.cc:41-80
(GenerateFakeRangeMeasurements): a robot translating at constant velocity
observes a semicircular wall of radius 5 m (angles 0..pi at 0.01 rad, five
heights) with perfectly consistent scans computed from ground-truth poses.
"""

from __future__ import annotations

from typing import List

import numpy as np

from cartographer_tpu_torch.sensor.data import TimedPointCloud, TimedPointCloudData
from cartographer_tpu_torch.transform import rigid3

FAKE_START_TIME = 123.0


def semicircle_wall(radius: float = 5.0) -> np.ndarray:
    angles = np.arange(0.0, np.pi, 0.01)
    heights = np.array([-0.4, -0.2, 0.0, 0.2, 0.4])
    ring = np.stack(
        [radius * np.cos(angles), radius * np.sin(angles)], axis=1
    )  # (A, 2)
    pts = np.concatenate(
        [
            np.repeat(ring, len(heights), axis=0),
            np.tile(heights, len(angles))[:, None],
        ],
        axis=1,
    )
    return pts.astype(np.float32)


def generate_fake_range_measurements(
    travel_distance: float = None,
    duration: float = 10.0,
    time_step: float = 0.1,
    translation: np.ndarray = None,
    local_to_global: np.ndarray = None,
) -> List[TimedPointCloudData]:
    if translation is None:
        direction = np.array([2.0, 1.0, 0.0])
        direction /= np.linalg.norm(direction)
        translation = direction * travel_distance
    if local_to_global is None:
        local_to_global = rigid3.identity()
    wall = semicircle_wall().astype(np.float64)
    velocity = np.asarray(translation, np.float64) / duration
    measurements = []
    elapsed = 0.0
    while elapsed < duration:
        time = FAKE_START_TIME + elapsed
        global_pose = rigid3.compose(
            local_to_global, rigid3.translation(elapsed * velocity)
        )
        ranges = rigid3.apply(rigid3.inverse(global_pose), wall)
        measurements.append(
            TimedPointCloudData(
                time=time,
                origin=np.zeros(3, np.float32),
                ranges=TimedPointCloud(
                    points=ranges.astype(np.float32),
                    times=np.zeros(len(wall), np.float32),
                ),
            )
        )
        elapsed += time_step
    return measurements


def ground_truth_poses(measurements: List[TimedPointCloudData], translation, duration):
    velocity = np.asarray(translation, np.float64) / duration
    return [
        rigid3.translation((m.time - FAKE_START_TIME) * velocity)
        for m in measurements
    ]


# ---------------------------------------------------------------------------
# Scaled multi-loop world (benchmark-scale accuracy evidence).
#
# The reference's canonical end-to-end test translates 1.2 m past a
# semicircular wall (map_builder_test.cc:34-36) — good for correctness,
# useless for regression at scale. This world drives a figure-eight
# (two opposing loops with a revisited crossing) through a pillared hall:
# scans are ray-cast against wall segments from ground-truth poses with
# full yaw rotation along the path, so local SLAM accumulates real drift
# and loop closure must snap the crossing shut.
# ---------------------------------------------------------------------------


def _figure_eight_pose(theta: float, a: float, b: float):
    """Lemniscate-of-Gerono position + heading at parameter theta."""
    x = a * np.sin(theta)
    y = b * np.sin(2.0 * theta) * 0.5
    dx = a * np.cos(theta)
    dy = b * np.cos(2.0 * theta)
    yaw = np.arctan2(dy, dx)
    return np.array([x, y]), yaw


def loop_world_segments(a: float, b: float, seed: int = 1234) -> np.ndarray:
    """Wall segments [S, 2, 2] of the hall: outer rectangle + IRREGULAR
    pillars (jittered positions/sizes/orientations) kept clear of the
    figure-eight path. Irregularity matters: a perfectly periodic pillar
    grid is self-similar at the loop-closure search window scale, which
    invites aliased (false) constraints no real building would."""
    rng = np.random.default_rng(seed)
    margin = 5.0
    x0, x1 = -a - margin, a + margin
    y0, y1 = -b - margin, b + margin
    segs = [
        [[x0, y0], [x1, y0]],
        [[x1, y0], [x1, y1]],
        [[x1, y1], [x0, y1]],
        [[x0, y1], [x0, y0]],
    ]
    # Path samples for clearance testing.
    ts = np.linspace(0.0, 2.0 * np.pi, 512)
    px = a * np.sin(ts)
    py = b * np.sin(2.0 * ts) * 0.5
    path = np.stack([px, py], axis=1)
    for gx in np.arange(x0 + 2.5, x1 - 2.4, 3.5):
        for gy in np.arange(y0 + 2.5, y1 - 2.4, 3.5):
            cx = gx + rng.uniform(-0.8, 0.8)
            cy = gy + rng.uniform(-0.8, 0.8)
            half_x = rng.uniform(0.2, 0.55)
            half_y = rng.uniform(0.2, 0.55)
            phi = rng.uniform(0.0, np.pi / 2.0)
            if np.min(np.hypot(path[:, 0] - cx, path[:, 1] - cy)) < 1.7:
                continue
            c, s_ = np.cos(phi), np.sin(phi)
            rot = np.array([[c, -s_], [s_, c]])
            center = np.array([cx, cy])
            corners = [
                center + rot @ [-half_x, -half_y],
                center + rot @ [half_x, -half_y],
                center + rot @ [half_x, half_y],
                center + rot @ [-half_x, half_y],
            ]
            for k in range(4):
                segs.append([corners[k], corners[(k + 1) % 4]])
    return np.asarray(segs, np.float64)


def _raycast(origin, yaw, segments, num_beams, max_range, rng, noise_std):
    """Min-distance ray/segment intersection for a 360-degree scan.
    Returns hit points in the ROBOT frame (z = 0)."""
    angles = yaw + np.linspace(
        -np.pi, np.pi, num_beams, endpoint=False
    )
    u = np.stack([np.cos(angles), np.sin(angles)], axis=1)  # [B, 2]
    p0 = segments[:, 0]  # [S, 2]
    d = segments[:, 1] - segments[:, 0]  # [S, 2]
    # o + t u = p0 + s d  ->  solve per (beam, segment).
    w = p0[None, :, :] - origin[None, None, :]  # [1, S, 2] broadcast to [B, S, 2]
    denom = u[:, None, 0] * (-d[None, :, 1]) - u[:, None, 1] * (-d[None, :, 0])
    safe = np.where(np.abs(denom) < 1e-12, 1.0, denom)
    t = (w[..., 0] * (-d[None, :, 1]) - w[..., 1] * (-d[None, :, 0])) / safe
    s = (u[:, None, 0] * w[..., 1] - u[:, None, 1] * w[..., 0]) / safe
    valid = (np.abs(denom) >= 1e-12) & (t > 0.05) & (s >= 0.0) & (s <= 1.0)
    t = np.where(valid, t, np.inf)
    tmin = t.min(axis=1)  # [B]
    hit = np.isfinite(tmin) & (tmin <= max_range)
    if noise_std > 0.0:
        tmin = tmin + rng.normal(0.0, noise_std, tmin.shape)
    tmin = tmin[hit]
    angles = angles[hit]
    # Robot-frame points: range along the beam direction rotated by -yaw.
    local_angles = angles - yaw
    pts = np.stack(
        [
            tmin * np.cos(local_angles),
            tmin * np.sin(local_angles),
            np.zeros(len(tmin)),
        ],
        axis=1,
    )
    return pts.astype(np.float32)


def generate_loop_world(
    half_width: float = 8.0,
    half_height: float = 6.0,
    laps: float = 2.0,
    duration_per_lap: float = 60.0,
    time_step: float = 0.05,
    num_beams: int = 1024,
    max_range: float = 12.0,
    noise_std: float = 0.005,
    seed: int = 7,
):
    """Returns (measurements, true_poses): a figure-eight trajectory of
    `laps` cycles through the pillared hall, with ground-truth SE(3) poses
    (yaw follows the path tangent). Path length is ~6.1 * half_width per
    lap; defaults give ~100 m travel over ~300-600 nodes depending on the
    motion filter."""
    segments = loop_world_segments(half_width, half_height)
    rng = np.random.default_rng(seed)
    measurements = []
    true_poses = []
    n = int(round(laps * duration_per_lap / time_step))
    for k in range(n):
        elapsed = k * time_step
        theta = 2.0 * np.pi * elapsed / duration_per_lap
        pos, yaw = _figure_eight_pose(theta, half_width, half_height)
        pts = _raycast(
            pos, yaw, segments, num_beams, max_range, rng, noise_std
        )
        measurements.append(
            TimedPointCloudData(
                time=FAKE_START_TIME + elapsed,
                origin=np.zeros(3, np.float32),
                ranges=TimedPointCloud(
                    points=pts,
                    times=np.zeros(len(pts), np.float32),
                ),
            )
        )
        true_poses.append(
            rigid3.make(
                np.array([pos[0], pos[1], 0.0]),
                rigid3.quat_from_angle_axis(np.array([0.0, 0.0, yaw])),
            )
        )
    return measurements, true_poses
