"""IMU-based pose extrapolation: sliding-window batch fit.

Port of cartographer_tpu/mapping/imu_based_pose_extrapolator.py.
Reference: mapping/internal/imu_based_pose_extrapolator.cc:38-439 —
instead of constant-velocity extrapolation, a small Ceres problem over the
recent pose window (pose_queue_duration) fits poses to pose observations,
IMU preintegration (rotation + acceleration) and odometry, then
extrapolates.

The window is posed as an SE(3) SPA problem for the port's device solver
(ops/spa_solver_3d.solve_3d, with the JAX package's arguments): an
anchored virtual "submap" at identity turns pose observations into
submap-node constraints; IMU rotation / acceleration residual tables and
odometry node-node constraints are built on the host exactly as in
optimization_problem_3d, then moved to the device in one problem. Only
the queried poses are read back. Tables are not padded to powers of two
(that served XLA's compile cache); an empty table keeps one masked row,
which adds exactly 0 to the cost. `device=None` means CUDA.
"""

from __future__ import annotations

import bisect
import collections
from typing import Deque, List, Sequence

import numpy as np
import torch

from cartographer_tpu_torch.common.config import ImuBasedExtrapolatorOptions
from cartographer_tpu_torch.common.time import TIME_MIN, Time
from cartographer_tpu_torch.device import resolve_device
from cartographer_tpu_torch.mapping.optimization_problem_3d import integrate_imu
from cartographer_tpu_torch.mapping.pose_extrapolator import ExtrapolationResult
from cartographer_tpu_torch.ops.spa_solver_3d import problem_from_numpy, solve_3d
from cartographer_tpu_torch.sensor.data import ImuData, OdometryData
from cartographer_tpu_torch.transform import rigid3

_IDENTITY_Q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)


def _rows(n: int) -> int:
    return max(n, 1)


class ImuBasedPoseExtrapolator:
    def __init__(self, options: ImuBasedExtrapolatorOptions, device=None):
        self._options = options
        self.device = resolve_device(device)
        self._timed_poses: Deque = collections.deque()  # (time, pose)
        self._imu_data: List[ImuData] = []
        self._odometry_data: List[OdometryData] = []
        self._last_extrapolated_time: Time = TIME_MIN
        self._gravity_from_tracking = np.array([1.0, 0.0, 0.0, 0.0])

    # -- feeds --------------------------------------------------------------

    def add_pose(self, time: Time, pose: np.ndarray) -> None:
        self._timed_poses.append((time, np.asarray(pose)))
        horizon = time - self._options.pose_queue_duration
        while len(self._timed_poses) > 2 and self._timed_poses[1][0] <= horizon:
            self._timed_poses.popleft()
        self._trim_sensor_data()

    def add_imu_data(self, imu_data: ImuData) -> None:
        self._imu_data.append(imu_data)
        self._trim_sensor_data()

    def add_odometry_data(self, odometry_data: OdometryData) -> None:
        self._odometry_data.append(odometry_data)
        self._trim_sensor_data()

    def _trim_sensor_data(self) -> None:
        if not self._timed_poses:
            return
        horizon = self._timed_poses[0][0]
        while len(self._imu_data) > 1 and self._imu_data[1].time <= horizon:
            self._imu_data.pop(0)
        while len(self._odometry_data) > 2 and self._odometry_data[1].time <= horizon:
            self._odometry_data.pop(0)

    def get_last_pose_time(self) -> Time:
        return self._timed_poses[-1][0] if self._timed_poses else TIME_MIN

    def get_last_extrapolated_time(self) -> Time:
        return max(self._last_extrapolated_time, self.get_last_pose_time())

    # -- queries ------------------------------------------------------------

    def extrapolate_pose(self, time: Time) -> np.ndarray:
        return self._solve([time])[0]

    def extrapolate_poses_batch(self, times: Sequence[Time]) -> np.ndarray:
        return self._solve(list(times))

    def extrapolate_poses_with_gravity(self, times: Sequence[Time]) -> ExtrapolationResult:
        poses = self._solve(list(times))
        velocity = np.zeros(3)
        if len(self._timed_poses) >= 2:
            (t0, p0), (t1, p1) = self._timed_poses[-2], self._timed_poses[-1]
            if t1 > t0:
                velocity = (rigid3.trans(p1) - rigid3.trans(p0)) / (t1 - t0)
        return ExtrapolationResult(
            previous_poses=list(poses[:-1]),
            current_pose=poses[-1],
            current_velocity=velocity,
            gravity_from_tracking=self._gravity_from_tracking,
        )

    def estimate_gravity_orientation(self, time: Time) -> np.ndarray:
        return self._gravity_from_tracking

    # -- the batch fit ------------------------------------------------------

    def _odometry_rows(self, all_times, time_index):
        opts = self._options
        rows = []
        if len(self._odometry_data) < 2:
            return rows
        odo_times = [d.time for d in self._odometry_data]

        def odo_at(t):
            if t < odo_times[0] or t > odo_times[-1]:
                return None
            i = bisect.bisect_left(odo_times, t)
            if i < len(odo_times) and odo_times[i] == t:
                return self._odometry_data[i].pose
            lo, hi = self._odometry_data[i - 1], self._odometry_data[i]
            f = (t - lo.time) / (hi.time - lo.time)
            return rigid3.interpolate(lo.pose, hi.pose, f)

        for a, b in zip(all_times, all_times[1:]):
            pa, pb = odo_at(a), odo_at(b)
            if pa is None or pb is None:
                continue
            rows.append((
                time_index[a], time_index[b], rigid3.relative(pa, pb),
                opts.odometry_translation_weight, opts.odometry_rotation_weight,
            ))
        return rows

    def _imu_rows(self, all_times, time_index):
        opts = self._options
        rot_rows, acc_rows = [], []
        if not (self._imu_data and self._imu_data[0].time <= all_times[0]):
            return rot_rows, acc_rows
        imu_end = self._imu_data[-1].time
        for k in range(len(all_times) - 1):
            a, b = all_times[k], all_times[k + 1]
            if b > imu_end or b <= a:
                continue
            _, drot = integrate_imu(self._imu_data, a, b)
            rot_rows.append((
                time_index[a], time_index[b], drot,
                opts.imu_rotation_weight / max(b - a, 1e-3),
            ))
            if k + 2 < len(all_times):
                c = all_times[k + 2]
                if c <= imu_end and c > b:
                    dt1, dt2 = b - a, c - b
                    _, rot_ab = integrate_imu(self._imu_data, a, b)
                    _, rot_fc = integrate_imu(self._imu_data, a, a + dt1 / 2)
                    dv_cc, _ = integrate_imu(
                        self._imu_data, a + dt1 / 2, b + dt2 / 2
                    )
                    dv = rigid3.quat_rotate(
                        rigid3.quat_multiply(rigid3.quat_conjugate(rot_ab), rot_fc),
                        dv_cc,
                    )
                    acc_rows.append((
                        time_index[a], time_index[b], time_index[c], dv, dt1,
                        dt2, opts.imu_acceleration_weight / (dt1 + dt2),
                    ))
        return rot_rows, acc_rows

    def _solve(self, query_times: List[Time]) -> np.ndarray:
        assert self._timed_poses, "ImuBasedPoseExtrapolator needs poses first."
        self._last_extrapolated_time = max(
            self._last_extrapolated_time, query_times[-1]
        )
        opts = self._options

        # Node times: window poses + query times (sorted unique).
        obs_times = [t for t, _ in self._timed_poses]
        all_times = sorted(set(obs_times) | set(float(t) for t in query_times))
        n = len(all_times)
        time_index = {t: i for i, t in enumerate(all_times)}

        # Initial values: the observed pose, else the nearest end's.
        obs_poses = {t: p for t, p in self._timed_poses}
        init = np.stack([
            obs_poses[t] if t in obs_poses
            else obs_poses[obs_times[-1]] if t > obs_times[-1]
            else obs_poses[obs_times[0]]
            for t in all_times
        ])

        tables = dict(
            submap_t=np.zeros((1, 3), np.float32),
            submap_q=_IDENTITY_Q[None],
            node_t=init[:, :3].astype(np.float32),
            node_q=init[:, 3:7].astype(np.float32),
            free_submap=np.zeros(1, bool),
            free_node=np.ones(n, bool),
            fix_z=np.asarray(False),
            gravity=np.asarray([opts.gravity_constant], np.float32),
            calib_q=_IDENTITY_Q[None],
            optimize_calibration=np.asarray(False),
        )

        # Pose observations as constraints to the anchored submap.
        C = _rows(len(self._timed_poses))
        c_z_t = np.zeros((C, 3), np.float32)
        c_z_q = np.tile(_IDENTITY_Q, (C, 1))
        c_node = np.zeros(C, np.int32)
        c_m = np.zeros(C, bool)
        for i, (t, p) in enumerate(self._timed_poses):
            c_node[i] = time_index[t]
            c_z_t[i], c_z_q[i], c_m[i] = p[:3], p[3:7], True
        c_w = np.tile(
            np.array([opts.pose_translation_weight, opts.pose_rotation_weight],
                     np.float32), (C, 1))
        tables.update(
            c_submap=np.zeros(C, np.int32), c_node=c_node, c_z_t=c_z_t,
            c_z_q=c_z_q, c_weight=c_w, c_huber=np.zeros(C, bool), c_mask=c_m,
        )

        # Odometry between consecutive node times.
        nn_rows = self._odometry_rows(all_times, time_index)
        K = _rows(len(nn_rows))
        n_ab = np.zeros((2, K), np.int32)
        n_z_t = np.zeros((K, 3), np.float32)
        n_z_q = np.tile(_IDENTITY_Q, (K, 1))
        n_w = np.ones((K, 2), np.float32)
        n_m = np.zeros(K, bool)
        for i, (a, b, z, wt, wr) in enumerate(nn_rows):
            n_ab[:, i] = a, b
            n_z_t[i], n_z_q[i], n_w[i], n_m[i] = z[:3], z[3:7], (wt, wr), True
        tables.update(n_a=n_ab[0], n_b=n_ab[1], n_z_t=n_z_t, n_z_q=n_z_q,
                      n_weight=n_w, n_mask=n_m)

        # IMU rotation + acceleration residuals between consecutive times.
        rot_rows, acc_rows = self._imu_rows(all_times, time_index)
        R = _rows(len(rot_rows))
        r_ab = np.zeros((2, R), np.int32)
        r_dq = np.tile(_IDENTITY_Q, (R, 1))
        r_w = np.zeros(R, np.float32)
        r_m = np.zeros(R, bool)
        for i, (a, b, dq, w) in enumerate(rot_rows):
            r_ab[:, i] = a, b
            r_dq[i], r_w[i], r_m[i] = dq, w, True
        tables.update(r_a=r_ab[0], r_b=r_ab[1], r_dq=r_dq, r_weight=r_w,
                      r_traj=np.zeros(R, np.int32), r_mask=r_m)
        A = _rows(len(acc_rows))
        a_idx = np.zeros((3, A), np.int32)
        a_dv = np.zeros((A, 3), np.float32)
        a_dt = np.ones((2, A), np.float32)
        a_w = np.zeros(A, np.float32)
        a_m = np.zeros(A, bool)
        for i, (f_, m_, l_, dv, d1, d2, w) in enumerate(acc_rows):
            a_idx[:, i] = f_, m_, l_
            a_dt[:, i] = d1, d2
            a_dv[i], a_w[i], a_m[i] = dv, w, True
        tables.update(
            a_first=a_idx[0], a_mid=a_idx[1], a_last=a_idx[2], a_dv=a_dv,
            a_dt1=a_dt[0], a_dt2=a_dt[1], a_weight=a_w,
            a_traj=np.zeros(A, np.int32), a_mask=a_m,
        )

        _, _, nt, nq, _, _, _ = solve_3d(
            problem_from_numpy(tables, self.device),
            huber_scale=1e3,
            max_iterations=opts.solver_options.max_num_iterations,
            cg_iterations=16,
        )
        # Read back the queried poses and the last one (one transfer).
        rows = [time_index[float(t)] for t in query_times] + [n - 1]
        idx = torch.as_tensor(rows, device=nt.device)
        out = torch.cat([nt[idx], nq[idx]], dim=1).cpu().numpy().astype(np.float64)
        # Gravity estimate from the last pose's orientation vs integrated IMU.
        if rot_rows:
            self._gravity_from_tracking = rigid3.quat_conjugate(out[-1, 3:7])
        return out[:-1]
