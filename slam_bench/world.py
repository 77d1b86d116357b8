"""What every kind's sensor stream shares, made from a seed.

A robot walks the figure-eight of a pillared hall (the world of the
port's `testing/synthetic.generate_loop_world`, rewritten here) lap after
lap, carrying a configuration's range sensors and an IMU. This module
holds the hall, the path, the IMU that the path gives, and the `Stream`
that a kind's generator (`generate` in `harness/<kind>.py`) returns; the
kind casts its own sensors against the hall (the planar kind against its
wall segments) and cuts their revolutions into range messages.

The seed draws the pillar jitter, the range noise and the IMU noise; the
path, the sensors and the number of revolutions are the same for every
seed, so every seed asks for the same work.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

GRAVITY = 9.80665
START_TIME = 1000.0


@dataclasses.dataclass
class Stream:
    """Time-sorted events and what the harness needs to follow them."""

    events: list  # [(sensor_id, payload)] in time order
    rev_last_event: np.ndarray  # event index of each revolution's last range message
    rev_time: np.ndarray  # float64 time of each revolution's local SLAM result
    true_poses: np.ndarray  # [R, 4] (x, y, z, yaw) of the robot at rev_time
    points_per_rev: int
    # Per sensor, the generator's own copy of every revolution as cast, for
    # the reference: points [R, P, 3] float32 in the sensor frame (NaN where
    # a beam hit nothing) and each point's time after the revolution's end
    # [R, P] float32, with the revolution's end times [R].
    raw: list
    rev_end: np.ndarray


# -- the hall -----------------------------------------------------------


def hall_segments(half_width: float, half_height: float, rng) -> np.ndarray:
    """Wall segments [S, 2, 2]: the outer rectangle and jittered
    rectangular pillars kept clear of the figure-eight path
    (`testing/synthetic.loop_world_segments`, drawn from `rng`)."""
    boxes = hall_pillars(half_width, half_height, rng)
    margin = 5.0
    x0, x1 = -half_width - margin, half_width + margin
    y0, y1 = -half_height - margin, half_height + margin
    segs = [[[x0, y0], [x1, y0]], [[x1, y0], [x1, y1]],
            [[x1, y1], [x0, y1]], [[x0, y1], [x0, y0]]]
    for cx, cy, hx, hy, phi in boxes:
        c, s = math.cos(phi), math.sin(phi)
        rot = np.array([[c, -s], [s, c]])
        corners = [np.array([cx, cy]) + rot @ v
                   for v in ([-hx, -hy], [hx, -hy], [hx, hy], [-hx, hy])]
        segs += [[corners[k], corners[(k + 1) % 4]] for k in range(4)]
    return np.asarray(segs, np.float64)


def hall_pillars(half_width: float, half_height: float, rng) -> List[tuple]:
    """(cx, cy, half_x, half_y, phi) of each pillar on a 3.5 m lattice,
    jittered by `rng`, none within 1.7 m of the path."""
    margin = 5.0
    x0, x1 = -half_width - margin, half_width + margin
    y0, y1 = -half_height - margin, half_height + margin
    ts = np.linspace(0.0, 2.0 * np.pi, 512)
    path = np.stack([half_width * np.sin(ts), half_height * np.sin(2.0 * ts) * 0.5], 1)
    out = []
    for gx in np.arange(x0 + 2.5, x1 - 2.4, 3.5):
        for gy in np.arange(y0 + 2.5, y1 - 2.4, 3.5):
            cx = gx + rng.uniform(-0.8, 0.8)
            cy = gy + rng.uniform(-0.8, 0.8)
            hx, hy = rng.uniform(0.2, 0.55), rng.uniform(0.2, 0.55)
            phi = rng.uniform(0.0, np.pi / 2.0)
            if np.min(np.hypot(path[:, 0] - cx, path[:, 1] - cy)) < 1.7:
                continue
            out.append((cx, cy, hx, hy, phi))
    return out


# -- the path -----------------------------------------------------------


def path_state(t, world: dict):
    """Position (x, y), yaw, yaw rate and world-frame acceleration of the
    figure-eight (lemniscate of Gerono) at times `t` (float64 tensors)."""
    a, b = world["half_width"], world["half_height"]
    w = 2.0 * math.pi / world["lap_s"]
    th = w * (t - START_TIME)
    x, y = a * torch.sin(th), 0.5 * b * torch.sin(2.0 * th)
    dx, dy = a * w * torch.cos(th), b * w * torch.cos(2.0 * th)
    ddx, ddy = -a * w * w * torch.sin(th), -2.0 * b * w * w * torch.sin(2.0 * th)
    yaw = torch.atan2(dy, dx)
    yaw_rate = (dx * ddy - dy * ddx) / (dx * dx + dy * dy)
    return x, y, yaw, yaw_rate, ddx, ddy


# -- the IMU and the stream ------------------------------------------------


def imu_messages(config: dict, num_revolutions: int, rev_s: float, gen, device) -> list:
    """The IMU's messages along the path, from 0.1 s before the first
    point, in the tracking frame: (time, 0, "imu", ImuData, -1), with the
    noise drawn from `gen` (after the range noise)."""
    from cartographer_tpu_torch.sensor.data import ImuData

    world, imu = config["world"], config["imu"]
    f64 = dict(dtype=torch.float64, device=device)
    imu_dt = 1.0 / imu["rate_hz"]
    t_imu = torch.arange(START_TIME - 0.1, START_TIME + (num_revolutions + 1) * rev_s, imu_dt, **f64)
    _, _, yaw, yaw_rate, ddx, ddy = path_state(t_imu, world)
    c, s = torch.cos(yaw), torch.sin(yaw)
    acc = torch.stack([c * ddx + s * ddy, -s * ddx + c * ddy, torch.full_like(ddx, GRAVITY)], -1)
    gyro = torch.stack([torch.zeros_like(yaw_rate), torch.zeros_like(yaw_rate), yaw_rate], -1)
    acc = acc + imu["accel_noise"] * torch.randn(acc.shape, generator=gen, **f64)
    gyro = gyro + imu["gyro_noise"] * torch.randn(gyro.shape, generator=gen, **f64)
    t_imu, acc, gyro = t_imu.cpu().numpy(), acc.cpu().numpy(), gyro.cpu().numpy()
    return [(float(t_imu[i]), 0, "imu", ImuData(
        time=float(t_imu[i]), linear_acceleration=acc[i], angular_velocity=gyro[i]), -1)
        for i in range(len(t_imu))]


def stream(config: dict, num_revolutions: int, rev_s: float, msgs: list, raw: list) -> Stream:
    """The Stream of `msgs`, [(time, order, sensor_id, payload, the
    revolution a message closes or -1)], sorted by time and order (IMU
    before range at one time); `raw` is each sensor's copy for the
    reference."""
    world = config["world"]
    msgs.sort(key=lambda m: (m[0], m[1]))
    events = [(m[2], m[3]) for m in msgs]
    rev_last_event = np.zeros(num_revolutions, np.int64)
    for i, m in enumerate(msgs):
        if m[4] >= 0:
            rev_last_event[m[4]] = i
    rev_time = np.array([msgs[i][0] for i in rev_last_event])
    x, y, yaw, _, _, _ = path_state(torch.from_numpy(rev_time), world)
    base_z = world.get("tracking_height_m", 0.0)
    true_poses = torch.stack([x, y, torch.full_like(x, base_z), yaw], 1).numpy()
    points_per_rev = int(sum(np.mean(np.sum(~np.isnan(p[:, :, 0]), 1)) for p, _ in raw))
    rev_end = START_TIME + (np.arange(num_revolutions) + 1.0) * rev_s
    return Stream(events, rev_last_event, rev_time, true_poses, points_per_rev, raw, rev_end)
