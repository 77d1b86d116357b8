"""3D global SLAM backend.

Port of cartographer_tpu/mapping/pose_graph_3d.py. Reference:
internal/3d/pose_graph_3d.cc:50-1320. The structure of PoseGraph2D in
SE(3): poses are full rigid transforms, IMU data feeds the optimization
problem, and loop-closure constraints come from the 3D branch-and-bound
matcher via ConstraintBuilder3D.

PoseGraph3D shares PoseGraph2D's bookkeeping, its drain scheduling (at
most one drain at a time: the pending-task check-and-set under the work
lock, every run_pending under `_drain_lock`, where the JAX package's
PoseGraph3D can run two drains at once), its failed-drain reporting and
its trimming (TrimmingHandle also evicts the 3D constraint builder's
per-node caches). It overrides what differs in 3D: node and submap poses,
the constraint search in the submap frame, and the write-back of the
optimized poses. One more difference from the JAX package: a submap
seen finished by several nodes of one chunked-frontend batch starts the
search against the older nodes once, as in PoseGraph2D.
"""

from __future__ import annotations

import time as _time
from typing import Dict, List

import numpy as np

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.common.time import Time
from cartographer_tpu_torch.mapping.constraint_builder_2d import (
    INTRA_SUBMAP,
    Constraint,
    ConstraintPose,
)
from cartographer_tpu_torch.mapping.constraint_builder_3d import ConstraintBuilder3D
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.optimization_problem_3d import (
    NodeSpec3D,
    OptimizationProblem3D,
)
from cartographer_tpu_torch.mapping.pose_graph_2d import (
    InternalSubmapData,
    PoseGraph2D,
    SubmapState,
    TrajectoryState,
)
from cartographer_tpu_torch.mapping.submap_3d import Submap3D, submap3d_from_numpy
from cartographer_tpu_torch.mapping.trajectory_node import TrajectoryNode, TrajectoryNodeData
from cartographer_tpu_torch.sensor.data import ImuData
from cartographer_tpu_torch.transform import rigid3


class PoseGraph3D(PoseGraph2D):
    _constraint_builder_type = ConstraintBuilder3D
    _optimization_problem_type = OptimizationProblem3D
    _is_2d = False

    def _add_node_locked(
        self,
        constant_data: TrajectoryNodeData,
        trajectory_id: int,
        insertion_submaps: List[Submap3D],
    ) -> NodeId:
        optimized_pose = rigid3.compose(
            self.get_local_to_global_transform(trajectory_id),
            constant_data.local_pose,
        )
        self.add_trajectory_if_needed(trajectory_id)
        node_id = NodeId(
            *self._trajectory_nodes.append(
                trajectory_id, TrajectoryNode(constant_data, optimized_pose)
            )
        )
        traj_submaps = self._submap_data.trajectory(trajectory_id)
        if not traj_submaps or (
            self._submap_data.at(SubmapId(trajectory_id, traj_submaps[-1][0])).submap
            is not insertion_submaps[-1]
        ):
            self._submap_data.append(trajectory_id, InternalSubmapData(insertion_submaps[-1]))
        newly_finished = insertion_submaps[0].insertion_finished
        self._compute_constraints_for_node(node_id, insertion_submaps, newly_finished)
        return node_id

    def add_imu_data(self, trajectory_id: int, imu_data: ImuData) -> None:
        self._optimization_problem.add_imu_data(trajectory_id, imu_data)

    def set_landmark_pose(
        self, landmark_id: str, global_pose: np.ndarray, frozen: bool = False
    ) -> None:
        """Reference PoseGraph3D::SetLandmarkPose; frozen landmarks keep the
        set pose across solves."""
        with self._work_lock:
            node = self._landmark_nodes.setdefault(
                landmark_id, {"observations": [], "global_pose": None}
            )
            node["global_pose"] = np.asarray(global_pose, np.float64)
            node["frozen"] = frozen
            self._optimization_problem.landmark_data[landmark_id] = np.asarray(
                global_pose, np.float64
            )

    def get_local_to_global_transform(self, trajectory_id: int) -> np.ndarray:
        items = self._submap_data.trajectory(trajectory_id)
        if not items:
            if trajectory_id in self._initial_trajectory_poses:
                to_id, pose, _ = self._initial_trajectory_poses[trajectory_id]
                return rigid3.compose(self.get_local_to_global_transform(to_id), pose)
            return rigid3.identity()
        last_index, data = items[-1]
        spec = self._optimization_problem.submap_data.get(SubmapId(trajectory_id, last_index))
        if spec is None:
            return rigid3.identity()
        return rigid3.compose(
            spec.global_pose, rigid3.inverse(np.asarray(data.submap.local_pose))
        )

    def _compute_constraints_for_node(
        self,
        node_id: NodeId,
        insertion_submaps: List[Submap3D],
        newly_finished_submap: bool,
    ) -> None:
        node = self._trajectory_nodes.at(node_id)
        constant_data = node.constant_data
        submap_ids = self._initialize_global_submap_poses(
            node_id.trajectory_id, constant_data.time, insertion_submaps
        )
        matching_id = submap_ids[0]
        matching_submap = insertion_submaps[0]
        local_pose = np.asarray(constant_data.local_pose)
        global_pose = rigid3.compose(
            self._optimization_problem.submap_data.at(matching_id).global_pose,
            rigid3.compose(rigid3.inverse(np.asarray(matching_submap.local_pose)), local_pose),
        )
        self._optimization_problem.insert_trajectory_node(
            node_id,
            NodeSpec3D(time=constant_data.time, local_pose=local_pose, global_pose=global_pose),
        )
        for submap_id, submap in zip(submap_ids, insertion_submaps):
            self._submap_data.at(submap_id).node_ids.add(node_id)
            self._constraints.append(
                Constraint(
                    submap_id=submap_id,
                    node_id=node_id,
                    pose=ConstraintPose(
                        zbar_ij=rigid3.relative(np.asarray(submap.local_pose), local_pose),
                        translation_weight=self._options.matcher_translation_weight,
                        rotation_weight=self._options.matcher_rotation_weight,
                    ),
                    tag=INTRA_SUBMAP,
                )
            )
        for submap_id, _ in self._submap_data.items(SubmapId):
            if self._submap_data.at(submap_id).state == SubmapState.FINISHED:
                self._compute_constraint(node_id, submap_id)
        if newly_finished_submap:
            data = self._submap_data.at(submap_ids[0])
            if data.state == SubmapState.NO_CONSTRAINT_SEARCH:
                data.state = SubmapState.FINISHED
                for old_node_id, _ in self._trajectory_nodes.items(NodeId):
                    if old_node_id not in data.node_ids:
                        self._compute_constraint(old_node_id, submap_ids[0])
        self._num_nodes_since_last_loop_closure += 1
        if (
            self._options.optimize_every_n_nodes > 0
            and self._num_nodes_since_last_loop_closure >= self._options.optimize_every_n_nodes
        ):
            self._dispatch_work_queue()

    def _compute_constraint(self, node_id: NodeId, submap_id: SubmapId) -> None:
        submap_data = self._submap_data.at(submap_id)
        if submap_data.state != SubmapState.FINISHED:
            return
        node = self._trajectory_nodes.at(node_id)
        node_time = node.constant_data.time
        last_connection = self._connectivity.last_connection_time(
            node_id.trajectory_id, submap_id.trajectory_id
        )
        spec = self._optimization_problem.node_data.get(node_id)
        sub_spec = self._optimization_problem.submap_data.get(submap_id)
        if spec is None or sub_spec is None:
            return
        # Node pose in the submap frame (matching happens there in 3D).
        global_node_pose_in_submap = rigid3.relative(sub_spec.global_pose, spec.global_pose)
        gravity_yaw = rigid3.get_yaw(
            rigid3.quat_multiply(
                rigid3.quat(global_node_pose_in_submap),
                rigid3.quat_conjugate(np.asarray(node.constant_data.gravity_alignment)),
            )
        )
        if (
            node_id.trajectory_id == submap_id.trajectory_id
            or node_time
            < last_connection + self._options.global_constraint_search_after_n_seconds
        ):
            self._constraint_builder.maybe_add_constraint(
                submap_id, submap_data.submap, node_id, node.constant_data,
                global_node_pose_in_submap, float(gravity_yaw),
            )
        elif self._global_localization_samplers[node_id.trajectory_id].pulse():
            self._constraint_builder.maybe_add_global_constraint(
                submap_id, submap_data.submap, node_id, node.constant_data,
                float(gravity_yaw),
            )

    def _initialize_global_submap_poses(
        self, trajectory_id: int, time: Time, insertion_submaps: List[Submap3D]
    ) -> List[SubmapId]:
        """Mirrors pose_graph_3d.cc InitializeGlobalSubmapPoses."""
        submap_data = self._optimization_problem.submap_data
        if len(insertion_submaps) == 1:
            if submap_data.size_of_trajectory_or_zero(trajectory_id) == 0:
                if trajectory_id in self._initial_trajectory_poses:
                    to_id, pose, t = self._initial_trajectory_poses[trajectory_id]
                    self._connectivity.connect(trajectory_id, to_id, t)
                first_global = rigid3.compose(
                    self.get_local_to_global_transform(trajectory_id),
                    np.asarray(insertion_submaps[0].local_pose, np.float64),
                )
                self._optimization_problem.add_submap(trajectory_id, first_global)
            return [SubmapId(trajectory_id, self._submap_data.trajectory(trajectory_id)[0][0])]
        assert len(insertion_submaps) == 2
        items = self._submap_data.trajectory(trajectory_id)
        last_submap_id = SubmapId(trajectory_id, items[-1][0])
        prev_submap_id = SubmapId(trajectory_id, items[-2][0])
        if submap_data.get(last_submap_id) is None:
            prev_spec = submap_data.at(prev_submap_id)
            prev_submap = self._submap_data.at(prev_submap_id).submap
            first_global = rigid3.compose(
                prev_spec.global_pose,
                rigid3.relative(
                    np.asarray(prev_submap.local_pose),
                    np.asarray(insertion_submaps[-1].local_pose),
                ),
            )
            self._optimization_problem.insert_submap(last_submap_id, first_global)
        return [prev_submap_id, last_submap_id]

    def run_optimization(self) -> None:
        if self._optimization_problem.node_data.empty():
            return
        frozen = {
            t for t, s in self._trajectory_states.items() if s == TrajectoryState.FROZEN
        }
        t0 = _time.perf_counter()
        self._optimization_problem.solve(self._constraints, frozen, self._landmark_nodes)
        self.solve_seconds.append(_time.perf_counter() - t0)
        for lid, lnode in self._landmark_nodes.items():
            if lnode.get("frozen") and lnode.get("global_pose") is not None:
                self._optimization_problem.landmark_data[lid] = np.asarray(
                    lnode["global_pose"], np.float64
                )
        metrics.optimization_runs.increment()
        for trajectory_id in self._trajectory_nodes.trajectory_ids():
            last_optimized_index = -1
            for index, spec in self._optimization_problem.node_data.trajectory(trajectory_id):
                node = self._trajectory_nodes.at(NodeId(trajectory_id, index))
                node.global_pose = np.asarray(spec.global_pose)
                last_optimized_index = index
            local_to_new_global = self.get_local_to_global_transform(trajectory_id)
            for index, node in self._trajectory_nodes.trajectory(trajectory_id):
                if index > last_optimized_index:
                    node.global_pose = rigid3.compose(
                        local_to_new_global, node.constant_data.local_pose
                    )
        self._notify_optimization()


def replay_nodes_3d(pose_graph: PoseGraph3D, trajectory_id: int, records, submaps, device):
    """Feed a recorded node sequence into `pose_graph`, so that two pose
    graphs (e.g. the JAX package's and this one) start from identical
    state.

    `records`: list of dicts with `node` (kwargs of TrajectoryNodeData, as
    numpy), `submaps` (keys of the node's insertion submaps, oldest first)
    and `finished` (each insertion submap's insertion_finished flag as the
    recording pose graph saw it at add_node). `submaps`: key -> kwargs of
    submap_3d.submap3d_from_numpy without the device (local_pose, the
    high and low grids as dicts of fields, the rotational histogram), the
    grids being the ones the recording constraint builder searched (the
    finished dense grids, else the last). One Submap3D per key is built on
    `device` and shared by every node that names it, as the frontend
    shares them."""
    built: Dict[object, Submap3D] = {}
    node_ids = []
    for rec in records:
        insertion = []
        for key, finished in zip(rec["submaps"], rec["finished"]):
            submap = built.get(key)
            if submap is None:
                submap = built[key] = submap3d_from_numpy(device=device, **submaps[key])
            if finished:
                submap.finish()
            insertion.append(submap)
        node = TrajectoryNodeData(**rec["node"])
        node_ids.append(pose_graph.add_node(node, trajectory_id, insertion))
    return node_ids
