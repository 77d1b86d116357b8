"""3D optimization problem: host store feeding the SE(3) SPA solver.

Port of cartographer_tpu/mapping/optimization_problem_3d.py. Reference:
internal/optimization/optimization_problem_3d.cc:150-633 and
imu_integration.h (IntegrateImu: delta rotation from gyro, delta velocity
from rotated accelerometer samples). Assembles constraints, consecutive-node
odometry/local-SLAM residuals, IMU rotation pairs and acceleration triples
(with per-trajectory gravity constant + online IMU extrinsics), then runs
ops/spa_solver_3d.solve_3d on the device. Tables are not padded to powers
of two (that served XLA's compile cache); an empty table keeps one masked
row, which adds exactly 0 to the cost. One device; a sharded solve comes
with multi-GPU support.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.common.config import OptimizationProblemOptions
from cartographer_tpu_torch.common.time import Time
from cartographer_tpu_torch.mapping.constraint_builder_2d import INTER_SUBMAP, Constraint
from cartographer_tpu_torch.mapping.id import MapById, NodeId, SubmapId
from cartographer_tpu_torch.ops import spa_solver_3d
from cartographer_tpu_torch.parallel import sharded
from cartographer_tpu_torch.parallel.partition import mesh_device
from cartographer_tpu_torch.sensor.data import ImuData, OdometryData
from cartographer_tpu_torch.sensor.map_by_time import MapByTime
from cartographer_tpu_torch.transform import rigid3


@dataclasses.dataclass
class NodeSpec3D:
    time: Time
    local_pose: np.ndarray  # SE(3) (7,)
    global_pose: np.ndarray  # SE(3) (7,)


@dataclasses.dataclass
class SubmapSpec3D:
    global_pose: np.ndarray  # SE(3) (7,)


@dataclasses.dataclass
class TrajectoryData:
    gravity_constant: float = 9.8
    imu_calibration: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0.0, 0.0, 0.0])
    )


def integrate_imu(
    imu_data: List[ImuData], start_time: Time, end_time: Time
) -> Tuple[np.ndarray, np.ndarray]:
    """IntegrateImu (imu_integration.h): returns (delta_velocity,
    delta_rotation quaternion) over [start_time, end_time]."""
    assert start_time <= end_time
    times = [d.time for d in imu_data]
    it = bisect.bisect_right(times, start_time)
    if it > 0:
        it -= 1
    delta_velocity = np.zeros(3)
    delta_rotation = np.array([1.0, 0.0, 0.0, 0.0])
    current_time = start_time
    while current_time < end_time:
        next_imu = imu_data[it + 1].time if it + 1 < len(imu_data) else float("inf")
        next_time = min(end_time, next_imu)
        dt = next_time - current_time
        sample = imu_data[min(it, len(imu_data) - 1)]
        delta_velocity = delta_velocity + rigid3.quat_rotate(
            delta_rotation, np.asarray(sample.linear_acceleration) * dt
        )
        delta_rotation = rigid3.quat_normalize(
            rigid3.quat_multiply(
                delta_rotation,
                rigid3.quat_from_angle_axis(
                    np.asarray(sample.angular_velocity) * dt
                ),
            )
        )
        current_time = next_time
        if next_time == next_imu:
            it += 1
    return delta_velocity, delta_rotation


def _fetch(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class OptimizationProblem3D:
    def __init__(self, options: OptimizationProblemOptions, device=None, mesh=None):
        """`device=None` means CUDA (the mesh's device when a mesh is
        given); pass device="cpu" to solve on the CPU. mesh: optional
        parallel/partition.Mesh — every SE(3) residual table (constraints,
        node-node, IMU rotation and acceleration rows, landmark and
        fixed-frame observations) is split over its ranks, pose and
        calibration tables replicated."""
        self._options = options
        self._device = mesh_device(device, mesh)
        self._mesh = mesh
        self.node_data: MapById = MapById()
        self.submap_data: MapById = MapById()
        self._imu_data = MapByTime()
        self._odometry_data = MapByTime()
        self._fixed_frame_pose_data = MapByTime()
        self.trajectory_data: Dict[int, TrajectoryData] = {}
        # Optimized landmark poses (SE(3) 7-vectors) by landmark id and
        # fixed-frame origins by trajectory id (optimization_problem_3d.cc
        # trajectory_data_.fixed_frame_origin_in_map / landmark_data_).
        self.landmark_data: Dict[str, np.ndarray] = {}
        self.fixed_frame_origin_in_map: Dict[int, np.ndarray] = {}
        self._max_num_iterations = options.ceres_solver_options.max_num_iterations

    # -- feeds --------------------------------------------------------------

    def add_imu_data(self, trajectory_id: int, imu_data: ImuData) -> None:
        self._imu_data.append(trajectory_id, imu_data)

    def add_odometry_data(self, trajectory_id: int, odometry_data: OdometryData) -> None:
        self._odometry_data.append(trajectory_id, odometry_data)

    def add_fixed_frame_pose_data(self, trajectory_id: int, data) -> None:
        self._fixed_frame_pose_data.append(trajectory_id, data)

    def _interpolate_fixed_frame(
        self, trajectory_id: int, time: Time
    ) -> Optional[np.ndarray]:
        entries = [
            (d.time, np.asarray(d.pose))
            for d in self._fixed_frame_pose_data.trajectory(trajectory_id)
            if d.pose is not None
        ]
        if not entries or time < entries[0][0] or time > entries[-1][0]:
            return None
        times = [t for t, _ in entries]
        i = bisect.bisect_left(times, time)
        if i < len(times) and times[i] == time:
            return entries[i][1]
        (t0, p0), (t1, p1) = entries[i - 1], entries[i]
        return rigid3.interpolate(p0, p1, (time - t0) / (t1 - t0))

    def add_trajectory_node(self, trajectory_id: int, node_data: NodeSpec3D) -> NodeId:
        self.trajectory_data.setdefault(trajectory_id, TrajectoryData())
        return NodeId(*self.node_data.append(trajectory_id, node_data))

    def insert_trajectory_node(self, node_id: NodeId, node_data: NodeSpec3D) -> None:
        self.trajectory_data.setdefault(node_id.trajectory_id, TrajectoryData())
        self.node_data.insert(node_id, node_data)

    def trim_trajectory_node(self, node_id: NodeId) -> None:
        self.node_data.trim(node_id)

    def add_submap(self, trajectory_id: int, global_submap_pose: np.ndarray) -> SubmapId:
        return SubmapId(
            *self.submap_data.append(trajectory_id, SubmapSpec3D(global_submap_pose))
        )

    def insert_submap(self, submap_id: SubmapId, global_submap_pose: np.ndarray) -> None:
        self.submap_data.insert(submap_id, SubmapSpec3D(global_submap_pose))

    def trim_submap(self, submap_id: SubmapId) -> None:
        self.submap_data.trim(submap_id)

    def set_max_num_iterations(self, max_num_iterations: int) -> None:
        self._max_num_iterations = max_num_iterations

    def _interpolate_odometry(self, trajectory_id: int, time: Time) -> Optional[np.ndarray]:
        data = self._odometry_data.trajectory(trajectory_id)
        if not data or time < data[0].time or time > data[-1].time:
            return None
        times = [d.time for d in data]
        i = bisect.bisect_left(times, time)
        if i < len(times) and times[i] == time:
            return data[i].pose
        lo, hi = data[i - 1], data[i]
        factor = (time - lo.time) / (hi.time - lo.time)
        return rigid3.interpolate(lo.pose, hi.pose, factor)

    # -- solve --------------------------------------------------------------

    def solve(
        self,
        constraints: List[Constraint],
        frozen_trajectories: Set[int],
        landmark_nodes=None,
    ) -> None:
        if self.node_data.empty():
            return
        opts = self._options

        submap_ids = self.submap_data.ids(SubmapId)
        node_ids = self.node_data.ids(NodeId)
        sub_index = {sid: i for i, sid in enumerate(submap_ids)}
        node_index = {nid: i for i, nid in enumerate(node_ids)}
        traj_ids = sorted(self.trajectory_data.keys())
        traj_index = {t: i for i, t in enumerate(traj_ids)}
        S, N, T = len(submap_ids), len(node_ids), max(len(traj_ids), 1)

        sp_t = np.zeros((S, 3), np.float32)
        sp_q = np.tile(np.array([1, 0, 0, 0], np.float32), (S, 1))
        free_s = np.zeros(len(sp_t), bool)
        first_submap = True
        for i, sid in enumerate(submap_ids):
            pose = self.submap_data.at(sid).global_pose
            sp_t[i] = pose[:3]
            sp_q[i] = pose[3:7]
            frozen = sid.trajectory_id in frozen_trajectories
            free_s[i] = not (first_submap or frozen)
            first_submap = False
        np_t = np.zeros((N, 3), np.float32)
        np_q = np.tile(np.array([1, 0, 0, 0], np.float32), (N, 1))
        free_n = np.zeros(len(np_t), bool)
        for i, nid in enumerate(node_ids):
            pose = self.node_data.at(nid).global_pose
            np_t[i] = pose[:3]
            np_q[i] = pose[3:7]
            free_n[i] = nid.trajectory_id not in frozen_trajectories

        # Constraint table.
        rows = []
        for c in constraints:
            if c.submap_id not in sub_index or c.node_id not in node_index:
                continue
            rows.append(
                (
                    sub_index[c.submap_id],
                    node_index[c.node_id],
                    c.pose.zbar_ij,
                    c.pose.translation_weight,
                    c.pose.rotation_weight,
                    c.tag == INTER_SUBMAP,
                )
            )
        C = max(len(rows), 1)
        c_sub = np.zeros(C, np.int32)
        c_node = np.zeros(C, np.int32)
        c_z_t = np.zeros((C, 3), np.float32)
        c_z_q = np.tile(np.array([1, 0, 0, 0], np.float32), (C, 1))
        c_w = np.ones((C, 2), np.float32)
        c_h = np.zeros(C, bool)
        c_m = np.zeros(C, bool)
        for i, (si, ni, z, wt, wr, huber) in enumerate(rows):
            c_sub[i], c_node[i] = si, ni
            c_z_t[i] = z[:3]
            c_z_q[i] = z[3:7]
            c_w[i] = (wt, wr)
            c_h[i] = huber
            c_m[i] = True

        # Node-node (odometry + local slam) and IMU residual tables.
        nn_rows, rot_rows, acc_rows = [], [], []
        for trajectory_id in self.node_data.trajectory_ids():
            if trajectory_id in frozen_trajectories:
                continue
            items = self.node_data.trajectory(trajectory_id)
            imu = self._imu_data.trajectory(trajectory_id)
            ti = traj_index.get(trajectory_id, 0)
            for k, ((idx_a, a), (idx_b, b)) in enumerate(zip(items, items[1:])):
                if idx_b != idx_a + 1:
                    continue
                ia = node_index[NodeId(trajectory_id, idx_a)]
                ib = node_index[NodeId(trajectory_id, idx_b)]
                # Odometry between nodes.
                first_odom = self._interpolate_odometry(trajectory_id, a.time)
                second_odom = self._interpolate_odometry(trajectory_id, b.time)
                if first_odom is not None and second_odom is not None:
                    rel = rigid3.relative(first_odom, second_odom)
                    nn_rows.append(
                        (
                            ia,
                            ib,
                            rel,
                            opts.odometry_translation_weight,
                            opts.odometry_rotation_weight,
                        )
                    )
                rel_local = rigid3.relative(a.local_pose, b.local_pose)
                nn_rows.append(
                    (
                        ia,
                        ib,
                        rel_local,
                        opts.local_slam_pose_translation_weight,
                        opts.local_slam_pose_rotation_weight,
                    )
                )
                # IMU residuals (optimization_problem_3d.cc:395-450).
                if imu and imu[0].time <= a.time and imu[-1].time >= b.time:
                    dt1 = b.time - a.time
                    if dt1 <= 0:
                        continue
                    _, delta_rotation = integrate_imu(imu, a.time, b.time)
                    rot_rows.append(
                        (ia, ib, delta_rotation, opts.rotation_weight / dt1, ti)
                    )
                    if k + 2 < len(items):
                        idx_c, cdata = items[k + 2]
                        if idx_c == idx_b + 1 and imu[-1].time >= cdata.time:
                            dt2 = cdata.time - b.time
                            if dt2 <= 0:
                                continue
                            ic = node_index[NodeId(trajectory_id, idx_c)]
                            first_center = a.time + dt1 / 2
                            second_center = b.time + dt2 / 2
                            _, rot_ab = integrate_imu(imu, a.time, b.time)
                            dv_fc, rot_fc = integrate_imu(
                                imu, a.time, first_center
                            )
                            dv_cc, _ = integrate_imu(
                                imu, first_center, second_center
                            )
                            delta_velocity = rigid3.quat_rotate(
                                rigid3.quat_multiply(
                                    rigid3.quat_conjugate(rot_ab), rot_fc
                                ),
                                dv_cc,
                            )
                            acc_rows.append(
                                (
                                    ia,
                                    ib,
                                    ic,
                                    delta_velocity,
                                    dt1,
                                    dt2,
                                    opts.acceleration_weight / (dt1 + dt2),
                                    ti,
                                )
                            )

        K = max(len(nn_rows), 1)
        n_a = np.zeros(K, np.int32)
        n_b = np.zeros(K, np.int32)
        n_z_t = np.zeros((K, 3), np.float32)
        n_z_q = np.tile(np.array([1, 0, 0, 0], np.float32), (K, 1))
        n_w = np.ones((K, 2), np.float32)
        n_m = np.zeros(K, bool)
        for i, (a, b, z, wt, wr) in enumerate(nn_rows):
            n_a[i], n_b[i] = a, b
            n_z_t[i] = z[:3]
            n_z_q[i] = z[3:7]
            n_w[i] = (wt, wr)
            n_m[i] = True

        R = max(len(rot_rows), 1)
        r_a = np.zeros(R, np.int32)
        r_b = np.zeros(R, np.int32)
        r_dq = np.tile(np.array([1, 0, 0, 0], np.float32), (R, 1))
        r_w = np.zeros(R, np.float32)
        r_t = np.zeros(R, np.int32)
        r_m = np.zeros(R, bool)
        for i, (a, b, dq, w, ti) in enumerate(rot_rows):
            r_a[i], r_b[i] = a, b
            r_dq[i] = dq
            r_w[i] = w
            r_t[i] = ti
            r_m[i] = True

        A = max(len(acc_rows), 1)
        a_first = np.zeros(A, np.int32)
        a_mid = np.zeros(A, np.int32)
        a_last = np.zeros(A, np.int32)
        a_dv = np.zeros((A, 3), np.float32)
        a_dt1 = np.ones(A, np.float32)
        a_dt2 = np.ones(A, np.float32)
        a_w = np.zeros(A, np.float32)
        a_t = np.zeros(A, np.int32)
        a_m = np.zeros(A, bool)
        for i, (f, m_, l, dv, d1, d2, w, ti) in enumerate(acc_rows):
            a_first[i], a_mid[i], a_last[i] = f, m_, l
            a_dv[i] = dv
            a_dt1[i], a_dt2[i] = d1, d2
            a_w[i] = w
            a_t[i] = ti
            a_m[i] = True

        gravity = np.array(
            [self.trajectory_data[t].gravity_constant for t in traj_ids]
            or [9.8],
            np.float32,
        )
        calib = np.stack(
            [self.trajectory_data[t].imu_calibration for t in traj_ids]
            or [np.array([1, 0, 0, 0])]
        ).astype(np.float32)

        tables = dict(
            submap_t=sp_t, submap_q=sp_q, node_t=np_t, node_q=np_q,
            free_submap=free_s, free_node=free_n,
            fix_z=np.asarray(opts.fix_z_in_3d),
            c_submap=c_sub, c_node=c_node, c_z_t=c_z_t, c_z_q=c_z_q,
            c_weight=c_w, c_huber=c_h, c_mask=c_m,
            n_a=n_a, n_b=n_b, n_z_t=n_z_t, n_z_q=n_z_q, n_weight=n_w,
            n_mask=n_m,
            r_a=r_a, r_b=r_b, r_dq=r_dq, r_weight=r_w, r_traj=r_t, r_mask=r_m,
            a_first=a_first, a_mid=a_mid, a_last=a_last, a_dv=a_dv,
            a_dt1=a_dt1, a_dt2=a_dt2, a_weight=a_w, a_traj=a_t, a_mask=a_m,
            gravity=gravity, calib_q=calib,
            optimize_calibration=np.asarray(
                opts.use_online_imu_extrinsics_in_3d and len(rot_rows) > 0
            ),
        )
        problem = spa_solver_3d.problem_from_numpy(tables, self._device)
        extras, landmark_ids, ff_traj_ids = self._build_extras(
            landmark_nodes, node_ids, node_index, frozen_trajectories
        )
        if self._mesh is not None:
            metrics.sharded_spa_solves.increment()
            problem = sharded.shard_spa_problem_3d(self._mesh, problem)
            if extras is not None:
                extras = sharded.shard_spa_extras_3d(self._mesh, extras)
        results = spa_solver_3d.solve_3d(
            problem,
            huber_scale=opts.huber_scale,
            max_iterations=self._max_num_iterations,
            extras=extras,
            use_nonmonotonic_steps=bool(
                opts.ceres_solver_options.use_nonmonotonic_steps
            ),
            mesh=self._mesh,
        )
        if extras is None:
            st, sq, nt, nq, grav, calib_q, _ = results
        else:
            st, sq, nt, nq, grav, calib_q, lt, lq, ft, fq, _ = results
            lt = _fetch(lt).astype(np.float64)
            lq = _fetch(lq).astype(np.float64)
            ft = _fetch(ft).astype(np.float64)
            fq = _fetch(fq).astype(np.float64)
            for i, lid in enumerate(landmark_ids):
                self.landmark_data[lid] = np.concatenate([lt[i], lq[i]])
            for i, t in enumerate(ff_traj_ids):
                self.fixed_frame_origin_in_map[t] = np.concatenate([ft[i], fq[i]])
        st = _fetch(st).astype(np.float64)
        sq = _fetch(sq).astype(np.float64)
        nt = _fetch(nt).astype(np.float64)
        nq = _fetch(nq).astype(np.float64)
        grav = _fetch(grav).astype(np.float64)
        calib_q = _fetch(calib_q).astype(np.float64)
        for i, sid in enumerate(submap_ids):
            self.submap_data.at(sid).global_pose = np.concatenate([st[i], sq[i]])
        for i, nid in enumerate(node_ids):
            self.node_data.at(nid).global_pose = np.concatenate([nt[i], nq[i]])
        for t in traj_ids:
            i = traj_index[t]
            if i < len(grav):
                self.trajectory_data[t].gravity_constant = float(grav[i])
                self.trajectory_data[t].imu_calibration = calib_q[i]

    def _build_extras(self, landmark_nodes, node_ids, node_index, frozen):
        """Assemble SpaExtras3D from landmark observations + fixed-frame
        data. Returns (extras_or_None, landmark_ids, ff_trajectory_ids).
        Reference: optimization_problem_3d.cc:510-570 (fixed frame) and
        landmark_cost_function_3d.h (observations bracketed by node times)."""
        obs_rows = []
        landmark_ids = sorted((landmark_nodes or {}).keys())
        l_index = {lid: i for i, lid in enumerate(landmark_ids)}
        for lid in landmark_ids:
            node = landmark_nodes[lid]
            for obs in node["observations"]:
                trajectory_id = obs["trajectory_id"]
                if trajectory_id in frozen:
                    continue
                time = obs["time"]
                items = self.node_data.trajectory(trajectory_id)
                if not items or time < items[0][1].time or time > items[-1][1].time:
                    continue
                times = [d.time for _, d in items]
                i = bisect.bisect_left(times, time)
                if i == 0:
                    a_idx, b_idx, factor = 0, min(1, len(items) - 1), 0.0
                elif i >= len(items):
                    continue
                else:
                    a_idx, b_idx = i - 1, i
                    dt = times[b_idx] - times[a_idx]
                    factor = 0.0 if dt == 0 else (time - times[a_idx]) / dt
                ia = node_index[NodeId(trajectory_id, items[a_idx][0])]
                ib = node_index[NodeId(trajectory_id, items[b_idx][0])]
                obs_rows.append(
                    (
                        ia,
                        ib,
                        factor,
                        l_index[lid],
                        np.asarray(obs["landmark_to_tracking_transform"]),
                        obs["translation_weight"],
                        obs["rotation_weight"],
                    )
                )

        ff_rows = []
        ff_traj_ids = []
        opts = self._options
        for trajectory_id in self.node_data.trajectory_ids():
            if trajectory_id in frozen:
                continue
            if not self._fixed_frame_pose_data.has_trajectory(trajectory_id):
                continue
            rows_for_traj = []
            for index, spec in self.node_data.trajectory(trajectory_id):
                ff_pose = self._interpolate_fixed_frame(trajectory_id, spec.time)
                if ff_pose is None:
                    continue
                rows_for_traj.append(
                    (
                        node_index[NodeId(trajectory_id, index)],
                        np.asarray(ff_pose),
                        opts.fixed_frame_pose_translation_weight,
                        opts.fixed_frame_pose_rotation_weight,
                    )
                )
            if rows_for_traj:
                ti = len(ff_traj_ids)
                ff_traj_ids.append(trajectory_id)
                if trajectory_id not in self.fixed_frame_origin_in_map:
                    # Initialize from the first constrained node:
                    # origin = node_global * z^-1, yaw-projected
                    # (optimization_problem_3d.cc:536-556).
                    first_node_idx, first_z, _, _ = rows_for_traj[0]
                    first_global = None
                    for nid, i in node_index.items():
                        if i == first_node_idx:
                            first_global = self.node_data.at(nid).global_pose
                            break
                    origin = rigid3.compose(
                        np.asarray(first_global), rigid3.inverse(first_z)
                    )
                    yaw = rigid3.get_yaw(origin)
                    self.fixed_frame_origin_in_map[trajectory_id] = np.concatenate(
                        [
                            origin[:3],
                            [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)],
                        ]
                    )
                for row in rows_for_traj:
                    ff_rows.append((ti, *row))

        if not obs_rows and not ff_rows:
            return None, [], []

        index_to_node = {i: nid for nid, i in node_index.items()}
        L = max(len(landmark_ids), 1)
        O = max(len(obs_rows), 1)
        l_t = np.zeros((L, 3), np.float32)
        l_q = np.tile(np.array([1, 0, 0, 0], np.float32), (L, 1))
        l_free = np.zeros(L, bool)
        initialized = set()
        for lid, i in l_index.items():
            node = landmark_nodes[lid]
            if node.get("global_pose") is not None:
                gp = np.asarray(node["global_pose"])
                l_t[i], l_q[i] = gp[:3], gp[3:7]
                initialized.add(i)
            elif lid in self.landmark_data:
                gp = self.landmark_data[lid]
                l_t[i], l_q[i] = gp[:3], gp[3:7]
                initialized.add(i)
            l_free[i] = True
        for (a, b, f, l, z, wt, wr) in obs_rows:
            if l not in initialized:
                pa = self.node_data.at(index_to_node[a]).global_pose
                gp = rigid3.compose(np.asarray(pa), z)
                l_t[l], l_q[l] = gp[:3], gp[3:7]
                initialized.add(l)
        o_a = np.zeros(O, np.int32)
        o_b = np.zeros(O, np.int32)
        o_f = np.zeros(O, np.float32)
        o_l = np.zeros(O, np.int32)
        o_z_t = np.zeros((O, 3), np.float32)
        o_z_q = np.tile(np.array([1, 0, 0, 0], np.float32), (O, 1))
        o_w = np.ones((O, 2), np.float32)
        o_m = np.zeros(O, bool)
        for i, (a, b, f, l, z, wt, wr) in enumerate(obs_rows):
            o_a[i], o_b[i], o_f[i], o_l[i] = a, b, f, l
            o_z_t[i], o_z_q[i] = z[:3], z[3:7]
            o_w[i] = (wt, wr)
            o_m[i] = True

        F = max(len(ff_traj_ids), 1)
        G = max(len(ff_rows), 1)
        f_t = np.zeros((F, 3), np.float32)
        f_q = np.tile(np.array([1, 0, 0, 0], np.float32), (F, 1))
        f_free = np.zeros(F, bool)
        for i, t in enumerate(ff_traj_ids):
            origin = self.fixed_frame_origin_in_map[t]
            f_t[i], f_q[i] = origin[:3], origin[3:7]
            f_free[i] = True
        g_node = np.zeros(G, np.int32)
        g_traj = np.zeros(G, np.int32)
        g_z_t = np.zeros((G, 3), np.float32)
        g_z_q = np.tile(np.array([1, 0, 0, 0], np.float32), (G, 1))
        g_w = np.ones((G, 2), np.float32)
        g_m = np.zeros(G, bool)
        for i, (ti, ni, z, wt, wr) in enumerate(ff_rows):
            g_node[i], g_traj[i] = ni, ti
            g_z_t[i], g_z_q[i] = z[:3], z[3:7]
            g_w[i] = (wt, wr)
            g_m[i] = True

        extras = spa_solver_3d.extras_from_numpy(
            dict(
                l_t=l_t, l_q=l_q, l_free=l_free,
                o_node_a=o_a, o_node_b=o_b, o_factor=o_f, o_landmark=o_l,
                o_z_t=o_z_t, o_z_q=o_z_q, o_weight=o_w, o_mask=o_m,
                f_t=f_t, f_q=f_q, f_free=f_free,
                g_node=g_node, g_traj=g_traj, g_z_t=g_z_t, g_z_q=g_z_q,
                g_weight=g_w, g_mask=g_m,
                g_tolerant=np.asarray(opts.fixed_frame_pose_use_tolerant_loss),
                g_loss_a=np.float32(opts.fixed_frame_pose_tolerant_loss_param_a),
                g_loss_b=np.float32(opts.fixed_frame_pose_tolerant_loss_param_b),
            ),
            self._device,
        )
        return extras, landmark_ids, ff_traj_ids
