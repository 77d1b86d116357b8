"""The sensor stream of a configuration, made from a seed.

One general generator for every configuration: a robot walks the
figure-eight of a pillared hall (the world of the port's
`testing/synthetic.generate_loop_world`, rewritten here) lap after lap,
carrying the configuration's planar range sensors and an IMU. Rays are
cast on the card in plain torch, as a batched minimum over rays x wall
segments; the points then go to the host as numpy, since sensor data
reaches `MapBuilder` from the host.

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


# -- ray casting on the card ----------------------------------------------


def cast_segments(ox, oy, ang, segments, chunk: int = 1 << 16):
    """Distance along each planar ray (origin (ox, oy), world angle ang)
    to the nearest wall segment; inf where none is hit."""
    p0 = segments[:, 0]
    d = segments[:, 1] - segments[:, 0]
    out = []
    for i in range(0, ox.numel(), chunk):
        sl = slice(i, i + chunk)
        ux, uy = torch.cos(ang[sl])[:, None], torch.sin(ang[sl])[:, None]
        wx, wy = p0[None, :, 0] - ox[sl, None], p0[None, :, 1] - oy[sl, None]
        denom = -ux * d[None, :, 1] + uy * d[None, :, 0]
        ok = denom.abs() >= 1e-12
        safe = torch.where(ok, denom, torch.ones_like(denom))
        t = (-wx * d[None, :, 1] + wy * d[None, :, 0]) / safe
        s = (ux * wy - uy * wx) / safe
        valid = ok & (t > 0.05) & (s >= 0.0) & (s <= 1.0)
        out.append(torch.where(valid, t, torch.inf).min(dim=1).values)
    return torch.cat(out)


# -- the stream ---------------------------------------------------------


def generate(config: dict, num_revolutions: int, seed: int, device) -> Stream:
    """The configuration's stream of `num_revolutions` revolutions."""
    from cartographer_tpu_torch.sensor.data import ImuData, TimedPointCloud, TimedPointCloudData

    world, sensors, imu = config["world"], config["range_sensors"], config["imu"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    f64 = dict(dtype=torch.float64, device=device)
    rev_s = 1.0 / sensors[0]["rate_hz"]
    segments = torch.from_numpy(
        hall_segments(world["half_width"], world["half_height"], rng)).to(device)
    base_z = world.get("tracking_height_m", 0.0)

    per_sensor = []  # per sensor: (points [R, P, 3] f32, rel times [R, P] f32)
    for sensor in sensors:
        beams = sensor["beams"]
        fov = math.radians(sensor["fov_deg"])
        ang0 = torch.linspace(-fov / 2, fov / 2, beams, **f64)
        beam_dt = rev_s / (2.0 * math.pi / (fov / (beams - 1)))
        ray_dt = torch.arange(beams, **f64) * beam_dt - (beams - 1) * beam_dt
        pts_all, times_all = [], []
        for r0 in range(0, num_revolutions, 64):
            revs = torch.arange(r0, min(r0 + 64, num_revolutions), **f64)
            end = START_TIME + (revs + 1.0) * rev_s  # last point of each revolution
            t = end[:, None] + ray_dt[None, :]  # [r, rays]
            x, y, yaw, _, _, _ = path_state(t, world)
            wang = yaw + ang0[None, :]
            rng_ = cast_segments(x.reshape(-1), y.reshape(-1), wang.reshape(-1),
                                 segments).reshape(t.shape)
            hit = torch.isfinite(rng_) & (rng_ <= sensor["max_range_m"])
            rng_ = rng_ + sensor["range_noise_m"] * torch.randn(t.shape, generator=gen, **f64)
            p = torch.stack([rng_ * torch.cos(ang0)[None], rng_ * torch.sin(ang0)[None],
                             torch.zeros_like(rng_)], -1)
            pts_all.append(torch.where(hit[..., None], p, torch.nan).to(torch.float32).cpu())
            times_all.append(ray_dt.to(torch.float32).expand(t.shape).cpu())
        per_sensor.append((torch.cat(pts_all).numpy(), torch.cat(times_all).numpy()))

    # IMU from 0.1 s before the first point, in the tracking frame.
    imu_dt = 1.0 / imu["rate_hz"]
    t_imu = torch.arange(START_TIME - 0.1, START_TIME + (num_revolutions + 1) * rev_s, imu_dt, **f64)
    _, _, yaw, yaw_rate, ddx, ddy = path_state(t_imu, world)
    c, s = torch.cos(yaw), torch.sin(yaw)
    acc = torch.stack([c * ddx + s * ddy, -s * ddx + c * ddy, torch.full_like(ddx, GRAVITY)], -1)
    gyro = torch.stack([torch.zeros_like(yaw_rate), torch.zeros_like(yaw_rate), yaw_rate], -1)
    acc = acc + imu["accel_noise"] * torch.randn(acc.shape, generator=gen, **f64)
    gyro = gyro + imu["gyro_noise"] * torch.randn(gyro.shape, generator=gen, **f64)
    t_imu, acc, gyro = t_imu.cpu().numpy(), acc.cpu().numpy(), gyro.cpu().numpy()

    # Range messages: each sensor's revolution cut into its subdivisions,
    # each stamped with its own last point, whose time in the message is
    # exactly 0 (the others' negative), as a driver stamps them.
    msgs = []  # (time, order, sensor_id, payload, revolution or -1)
    for k in range(num_revolutions):
        end = START_TIME + (k + 1) * rev_s
        for si, (sensor, (pts, rel)) in enumerate(zip(sensors, per_sensor)):
            for j, (p, tt) in enumerate(subdivisions(pts[k], rel[k], sensor)):
                last = j == sensor.get("subdivisions", 1) - 1 and si == len(sensors) - 1
                msgs.append((end + float(tt[-1]), 1, sensor["id"], TimedPointCloudData(
                    time=end + float(tt[-1]), origin=np.zeros(3, np.float32),
                    ranges=TimedPointCloud(points=p, times=tt - tt[-1]),
                ), k if last else -1))
    for i in range(len(t_imu)):
        msgs.append((float(t_imu[i]), 0, "imu", ImuData(
            time=float(t_imu[i]), linear_acceleration=acc[i], angular_velocity=gyro[i]), -1))
    msgs.sort(key=lambda m: (m[0], m[1]))
    events = [(m[2], m[3]) for m in msgs]
    rev_last_event = np.zeros(num_revolutions, np.int64)
    for i, m in enumerate(msgs):
        if m[4] >= 0:
            rev_last_event[m[4]] = i
    rev_time = np.array([msgs[i][0] for i in rev_last_event])
    x, y, yaw, _, _, _ = path_state(torch.from_numpy(rev_time), world)
    true_poses = torch.stack([x, y, torch.full_like(x, base_z), yaw], 1).numpy()
    points_per_rev = int(sum(np.mean(np.sum(~np.isnan(p[:, :, 0]), 1)) for p, _ in per_sensor))
    rev_end = START_TIME + (np.arange(num_revolutions) + 1.0) * rev_s
    return Stream(events, rev_last_event, rev_time, true_poses, points_per_rev,
                  per_sensor, rev_end)


def subdivisions(points, rel, sensor):
    """One revolution's beams that hit, cut into the sensor's
    subdivisions in time order: [(points [n, 3], times after the
    revolution's end [n])]. The range messages carry copies."""
    keep = ~np.isnan(points[:, 0])
    p, tt = points[keep], rel[keep]
    parts = np.array_split(np.arange(len(p)), sensor.get("subdivisions", 1))
    return [(p[idx], tt[idx]) for idx in parts]
