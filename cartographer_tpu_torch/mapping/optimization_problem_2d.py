"""2D optimization problem: host store feeding the device SPA solver.

Port of cartographer_tpu/mapping/optimization_problem_2d.py. Reference:
internal/optimization/optimization_problem_2d.cc:204-470. Keeps per-node
specs (time, gravity-aligned local pose, global pose), per-submap global
poses, and per-trajectory odometry and fixed-frame logs; solve() assembles
the residual tables (constraints + consecutive-node local-SLAM/odometry
pairs, landmark and fixed-frame extras) and runs ops/spa_solver.solve on
the device. Tables are not padded to powers of two (that served XLA's
compile cache); an empty table keeps one masked row, which adds exactly
0 to the cost. One device; a sharded solve comes with multi-GPU support.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.common.config import OptimizationProblemOptions
from cartographer_tpu_torch.common.time import Time
from cartographer_tpu_torch.mapping.constraint_builder_2d import (
    INTER_SUBMAP,
    Constraint,
)
from cartographer_tpu_torch.mapping.id import MapById, NodeId, SubmapId
from cartographer_tpu_torch.ops.spa_solver import SpaExtras, SpaProblem, solve
from cartographer_tpu_torch.parallel import sharded
from cartographer_tpu_torch.parallel.partition import mesh_device
from cartographer_tpu_torch.sensor.data import OdometryData
from cartographer_tpu_torch.sensor.map_by_time import MapByTime
from cartographer_tpu_torch.transform import rigid2, rigid3


@dataclasses.dataclass
class NodeSpec2D:
    time: Time
    local_pose_2d: np.ndarray  # (3,)
    global_pose_2d: np.ndarray  # (3,)
    gravity_alignment: np.ndarray  # quaternion


@dataclasses.dataclass
class SubmapSpec2D:
    global_pose: np.ndarray  # (3,)


class OptimizationProblem2D:
    def __init__(self, options: OptimizationProblemOptions, device=None, mesh=None):
        """`device=None` means CUDA (the mesh's device when a mesh is
        given); pass device="cpu" to solve on the CPU. mesh: optional
        parallel/partition.Mesh — the residual tables of the SPA solve are
        split over its ranks (poses replicated, J^T J sums all-reduced);
        the split needs no padding rows."""
        self._options = options
        self._device = mesh_device(device, mesh)
        self._mesh = mesh
        self.node_data: MapById = MapById()
        self.submap_data: MapById = MapById()
        self._odometry_data = MapByTime()
        self._fixed_frame_pose_data = MapByTime()
        # Optimized landmark poses (SE(2)) and fixed frame origins by
        # trajectory, refreshed by solve().
        self.landmark_data: Dict[str, np.ndarray] = {}
        self.fixed_frame_origin_in_map: Dict[int, np.ndarray] = {}
        self._max_num_iterations = options.ceres_solver_options.max_num_iterations

    # -- feeds --------------------------------------------------------------

    def add_odometry_data(self, trajectory_id: int, odometry_data: OdometryData) -> None:
        self._odometry_data.append(trajectory_id, odometry_data)

    def add_fixed_frame_pose_data(self, trajectory_id: int, data) -> None:
        self._fixed_frame_pose_data.append(trajectory_id, data)

    def _interpolate_fixed_frame(self, trajectory_id: int, time: Time) -> Optional[np.ndarray]:
        data = [
            d
            for d in self._fixed_frame_pose_data.trajectory(trajectory_id)
            if d.pose is not None
        ]
        if not data or time < data[0].time or time > data[-1].time:
            return None
        import bisect

        times = [d.time for d in data]
        i = bisect.bisect_left(times, time)
        if i < len(times) and times[i] == time:
            return data[i].pose
        lo, hi = data[i - 1], data[i]
        factor = (time - lo.time) / (hi.time - lo.time)
        return rigid3.interpolate(lo.pose, hi.pose, factor)

    def add_trajectory_node(self, trajectory_id: int, node_data: NodeSpec2D) -> NodeId:
        return NodeId(*self.node_data.append(trajectory_id, node_data))

    def insert_trajectory_node(self, node_id: NodeId, node_data: NodeSpec2D) -> None:
        self.node_data.insert(node_id, node_data)

    def trim_trajectory_node(self, node_id: NodeId) -> None:
        self.node_data.trim(node_id)

    def add_submap(self, trajectory_id: int, global_submap_pose: np.ndarray) -> SubmapId:
        return SubmapId(
            *self.submap_data.append(trajectory_id, SubmapSpec2D(global_submap_pose))
        )

    def insert_submap(self, submap_id: SubmapId, global_submap_pose: np.ndarray) -> None:
        self.submap_data.insert(submap_id, SubmapSpec2D(global_submap_pose))

    def trim_submap(self, submap_id: SubmapId) -> None:
        self.submap_data.trim(submap_id)

    def set_max_num_iterations(self, max_num_iterations: int) -> None:
        self._max_num_iterations = max_num_iterations

    # -- odometry interpolation (CalculateOdometryBetweenNodes) -------------

    def _interpolate_odometry(self, trajectory_id: int, time: Time) -> Optional[np.ndarray]:
        data = self._odometry_data.trajectory(trajectory_id)
        if not data or time < data[0].time or time > data[-1].time:
            return None
        import bisect

        times = [d.time for d in data]
        i = bisect.bisect_left(times, time)
        if i < len(times) and times[i] == time:
            return data[i].pose
        lo, hi = data[i - 1], data[i]
        factor = (time - lo.time) / (hi.time - lo.time)
        return rigid3.interpolate(lo.pose, hi.pose, factor)

    def _odometry_between_nodes(
        self, trajectory_id: int, first: NodeSpec2D, second: NodeSpec2D
    ) -> Optional[np.ndarray]:
        first_odom = self._interpolate_odometry(trajectory_id, first.time)
        second_odom = self._interpolate_odometry(trajectory_id, second.time)
        if first_odom is None or second_odom is None:
            return None
        # Gravity-align the odometry poses like the reference
        # (optimization_problem_2d.cc:430-470): relative odometry in the
        # gravity-aligned frame of each node.
        first_aligned = rigid3.compose(
            first_odom, rigid3.rotation(rigid3.quat_conjugate(first.gravity_alignment))
        )
        second_aligned = rigid3.compose(
            second_odom, rigid3.rotation(rigid3.quat_conjugate(second.gravity_alignment))
        )
        rel = rigid3.relative(first_aligned, second_aligned)
        return rigid3.project_2d(rel)

    # -- solve --------------------------------------------------------------

    def solve(
        self,
        constraints: List[Constraint],
        frozen_trajectories: Set[int],
        landmark_nodes=None,
    ) -> None:
        if self.node_data.empty():
            return

        submap_ids = self.submap_data.ids(SubmapId)
        node_ids = self.node_data.ids(NodeId)
        sub_index = {sid: i for i, sid in enumerate(submap_ids)}
        node_index = {nid: i for i, nid in enumerate(node_ids)}
        S, N = len(submap_ids), len(node_ids)

        sp = np.zeros((S, 3), np.float32)
        free_s = np.zeros(len(sp), bool)
        first_submap = True
        for i, sid in enumerate(submap_ids):
            sp[i] = self.submap_data.at(sid).global_pose
            frozen = sid.trajectory_id in frozen_trajectories
            free_s[i] = not (first_submap or frozen)
            if first_submap:
                first_submap = False
        npo = np.zeros((N, 3), np.float32)
        free_n = np.zeros(len(npo), bool)
        for i, nid in enumerate(node_ids):
            npo[i] = self.node_data.at(nid).global_pose_2d
            free_n[i] = nid.trajectory_id not in frozen_trajectories

        # Submap-node constraint table.
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
        c_z = np.zeros((C, 3), np.float32)
        c_w = np.ones((C, 2), np.float32)
        c_h = np.zeros(C, bool)
        c_m = np.zeros(C, bool)
        for i, (si, ni, z, wt, wr, huber) in enumerate(rows):
            c_sub[i], c_node[i] = si, ni
            c_z[i] = z
            c_w[i] = (wt, wr)
            c_h[i] = huber
            c_m[i] = True

        # Consecutive-node residuals per trajectory (local SLAM + odometry).
        nn_rows = []
        for trajectory_id in self.node_data.trajectory_ids():
            if trajectory_id in frozen_trajectories:
                continue
            items = self.node_data.trajectory(trajectory_id)
            for (idx_a, a), (idx_b, b) in zip(items, items[1:]):
                if idx_b != idx_a + 1:
                    continue
                ia = node_index[NodeId(trajectory_id, idx_a)]
                ib = node_index[NodeId(trajectory_id, idx_b)]
                rel_odom = self._odometry_between_nodes(trajectory_id, a, b)
                if rel_odom is not None:
                    nn_rows.append(
                        (
                            ia,
                            ib,
                            rel_odom,
                            self._options.odometry_translation_weight,
                            self._options.odometry_rotation_weight,
                        )
                    )
                rel_local = rigid2.relative(a.local_pose_2d, b.local_pose_2d)
                nn_rows.append(
                    (
                        ia,
                        ib,
                        rel_local,
                        self._options.local_slam_pose_translation_weight,
                        self._options.local_slam_pose_rotation_weight,
                    )
                )
        K = max(len(nn_rows), 1)
        n_a = np.zeros(K, np.int32)
        n_b = np.zeros(K, np.int32)
        n_z = np.zeros((K, 3), np.float32)
        n_w = np.ones((K, 2), np.float32)
        n_m = np.zeros(K, bool)
        for i, (a, b, z, wt, wr) in enumerate(nn_rows):
            n_a[i], n_b[i] = a, b
            n_z[i] = z
            n_w[i] = (wt, wr)
            n_m[i] = True

        dev = self._device
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        problem = SpaProblem(
            submap_poses=t(sp), node_poses=t(npo),
            free_submap=t(free_s), free_node=t(free_n),
            c_submap=t(c_sub), c_node=t(c_node), c_z=t(c_z), c_weight=t(c_w),
            c_huber=t(c_h), c_mask=t(c_m),
            n_a=t(n_a), n_b=t(n_b), n_z=t(n_z), n_weight=t(n_w), n_mask=t(n_m),
        )

        extras, landmark_ids, ff_traj_ids = self._build_extras(
            landmark_nodes, node_ids, node_index, frozen_trajectories
        )
        if self._mesh is not None:
            metrics.sharded_spa_solves.increment()
            problem = sharded.shard_spa_problem(self._mesh, problem)
            if extras is not None:
                extras = sharded.shard_spa_extras(self._mesh, extras)
        result = solve(
            problem,
            huber_scale=self._options.huber_scale,
            max_iterations=self._max_num_iterations,
            extras=extras,
            use_nonmonotonic_steps=bool(
                self._options.ceres_solver_options.use_nonmonotonic_steps
            ),
            mesh=self._mesh,
        )
        new_sp = result[0].cpu().numpy().astype(np.float64)
        new_np = result[1].cpu().numpy().astype(np.float64)
        for i, sid in enumerate(submap_ids):
            self.submap_data.at(sid).global_pose = new_sp[i]
        for i, nid in enumerate(node_ids):
            self.node_data.at(nid).global_pose_2d = new_np[i]
        if extras is not None:
            new_lp = result[2].cpu().numpy().astype(np.float64)
            new_fp = result[3].cpu().numpy().astype(np.float64)
            for i, lid in enumerate(landmark_ids):
                self.landmark_data[lid] = new_lp[i]
            for i, t in enumerate(ff_traj_ids):
                self.fixed_frame_origin_in_map[t] = new_fp[i]

    def _build_extras(self, landmark_nodes, node_ids, node_index, frozen):
        """Assemble SpaExtras from landmark observations + fixed frame data.
        Returns (extras_or_None, landmark_ids, fixed_frame_trajectory_ids)."""
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
                import bisect

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
                # Project the SE(3) observation into the gravity-aligned 2D
                # frame of the interpolated node.
                spec_a = items[a_idx][1]
                z3 = rigid3.compose(
                    rigid3.rotation(spec_a.gravity_alignment),
                    np.asarray(obs["landmark_to_tracking_transform"]),
                )
                z2 = rigid3.project_2d(z3)
                obs_rows.append(
                    (
                        ia,
                        ib,
                        factor,
                        l_index[lid],
                        z2,
                        obs["translation_weight"],
                        obs["rotation_weight"],
                    )
                )

        ff_rows = []
        ff_traj_ids = []
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
                z2 = rigid3.project_2d(np.asarray(ff_pose))
                rows_for_traj.append(
                    (
                        node_index[NodeId(trajectory_id, index)],
                        z2,
                        self._options.fixed_frame_pose_translation_weight,
                        self._options.fixed_frame_pose_rotation_weight,
                    )
                )
            if rows_for_traj:
                ti = len(ff_traj_ids)
                ff_traj_ids.append(trajectory_id)
                # Initialize the fixed frame origin from the first node pair
                # (optimization_problem_2d.cc:370-385).
                if trajectory_id not in self.fixed_frame_origin_in_map:
                    first_node_idx, first_z, _, _ = rows_for_traj[0]
                    first_global = None
                    for nid, i in node_index.items():
                        if i == first_node_idx:
                            first_global = self.node_data.at(nid).global_pose_2d
                            break
                    self.fixed_frame_origin_in_map[trajectory_id] = rigid2.compose(
                        np.asarray(first_global), rigid2.inverse(first_z)
                    )
                for row in rows_for_traj:
                    ff_rows.append((ti, *row))

        if not obs_rows and not ff_rows:
            return None, [], []

        O = max(len(obs_rows), 1)
        L = max(len(landmark_ids), 1)
        o_a = np.zeros(O, np.int32)
        o_b = np.zeros(O, np.int32)
        o_f = np.zeros(O, np.float32)
        o_l = np.zeros(O, np.int32)
        o_z = np.zeros((O, 3), np.float32)
        o_w = np.ones((O, 2), np.float32)
        o_m = np.zeros(O, bool)
        for i, (a, b, f, l, z, wt, wr) in enumerate(obs_rows):
            o_a[i], o_b[i], o_f[i], o_l[i] = a, b, f, l
            o_z[i] = z
            o_w[i] = (wt, wr)
            o_m[i] = True
        index_to_node = {i: nid for nid, i in node_index.items()}
        l_poses = np.zeros((L, 3), np.float32)
        l_free = np.zeros(L, bool)
        initialized = set()
        for lid, i in l_index.items():
            node = landmark_nodes[lid]
            if node.get("global_pose") is not None:
                gp = np.asarray(node["global_pose"])
                l_poses[i] = rigid3.project_2d(gp) if gp.shape[-1] == 7 else gp
                initialized.add(i)
            elif lid in self.landmark_data:
                l_poses[i] = self.landmark_data[lid]
                initialized.add(i)
            l_free[i] = True
        # Un-initialized landmarks: first observation's implied pose.
        for (a, b, f, l, z, wt, wr) in obs_rows:
            if l not in initialized:
                pa = self.node_data.at(index_to_node[a]).global_pose_2d
                l_poses[l] = rigid2.compose(np.asarray(pa), z)
                initialized.add(l)

        T = max(len(ff_traj_ids), 1)
        G = max(len(ff_rows), 1)
        f_pose = np.zeros((T, 3), np.float32)
        f_free = np.zeros(T, bool)
        for i, t in enumerate(ff_traj_ids):
            f_pose[i] = self.fixed_frame_origin_in_map[t]
            f_free[i] = True
        g_node = np.zeros(G, np.int32)
        g_traj = np.zeros(G, np.int32)
        g_z = np.zeros((G, 3), np.float32)
        g_w = np.ones((G, 2), np.float32)
        g_m = np.zeros(G, bool)
        for i, (ti, ni, z, wt, wr) in enumerate(ff_rows):
            g_node[i], g_traj[i] = ni, ti
            g_z[i] = z
            g_w[i] = (wt, wr)
            g_m[i] = True

        t = lambda a: torch.from_numpy(a).to(self._device)  # noqa: E731
        extras = SpaExtras(
            l_poses=t(l_poses), l_free=t(l_free),
            o_node_a=t(o_a), o_node_b=t(o_b), o_factor=t(o_f),
            o_landmark=t(o_l), o_z=t(o_z), o_weight=t(o_w), o_mask=t(o_m),
            f_pose=t(f_pose), f_free=t(f_free),
            g_node=t(g_node), g_traj=t(g_traj), g_z=t(g_z), g_weight=t(g_w),
            g_mask=t(g_m),
        )
        return extras, landmark_ids, ff_traj_ids
