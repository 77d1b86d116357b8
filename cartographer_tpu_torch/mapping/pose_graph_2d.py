"""2D global SLAM backend.

Port of cartographer_tpu/mapping/pose_graph_2d.py. Reference:
internal/2d/pose_graph_2d.cc:52-1340. Owns graph bookkeeping (submaps,
nodes, constraints, connectivity), dispatches loop-closure searches
through the constraint builder, and runs sparse pose adjustment every
optimize_every_n_nodes nodes and at RunFinalOptimization.

Scheduling: without a thread pool the work queue drains inline and
deterministically; with one, drains run on pool threads (the reference's
DrainWorkQueue), the searches outside the work lock. Unlike the JAX
package, at most one drain runs at a time: the check-and-set of the
pending drain task happens under the work lock, and every call into the
constraint builder's run_pending holds `_drain_lock`, so an inline drain
(finish_trajectory, run_final_optimization) waits for a pool drain
instead of racing it over the same queued searches. Trimmers
(`overlapping_submaps_trimmer_2d`, or any added with `add_trimmer`) run
after every optimization through `TrimmingHandle`.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import logging
import threading
import time as _time
from typing import Dict, List, Set

import numpy as np

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.common.config import PoseGraphOptions
from cartographer_tpu_torch.common.fixed_ratio_sampler import FixedRatioSampler
from cartographer_tpu_torch.common.task import Task, TaskState
from cartographer_tpu_torch.common.time import Time
from cartographer_tpu_torch.mapping.connectivity import TrajectoryConnectivityState
from cartographer_tpu_torch.mapping.constraint_builder_2d import (
    INTRA_SUBMAP,
    Constraint,
    ConstraintBuilder2D,
    ConstraintPose,
)
from cartographer_tpu_torch.mapping.id import MapById, NodeId, SubmapId
from cartographer_tpu_torch.mapping.optimization_problem_2d import (
    NodeSpec2D,
    OptimizationProblem2D,
)
from cartographer_tpu_torch.mapping.submap_2d import Submap2D, submap_from_numpy
from cartographer_tpu_torch.mapping.trajectory_node import TrajectoryNode, TrajectoryNodeData
from cartographer_tpu_torch.mapping.trimmers import OverlappingSubmapsTrimmer2D
from cartographer_tpu_torch.sensor.data import FixedFramePoseData, ImuData, OdometryData
from cartographer_tpu_torch.transform import rigid2, rigid3


class SubmapState(enum.Enum):
    NO_CONSTRAINT_SEARCH = 0
    FINISHED = 1


class TrajectoryState(enum.Enum):
    ACTIVE = 0
    FINISHED = 1
    FROZEN = 2
    DELETED = 3


@dataclasses.dataclass
class InternalSubmapData:
    submap: Submap2D
    state: SubmapState = SubmapState.NO_CONSTRAINT_SEARCH
    node_ids: Set[NodeId] = dataclasses.field(default_factory=set)


class PoseGraph2D:
    _constraint_builder_type = ConstraintBuilder2D
    _optimization_problem_type = OptimizationProblem2D
    _is_2d = True

    def __init__(self, options: PoseGraphOptions, thread_pool=None, device=None, mesh=None):
        """thread_pool: optional common.task.ThreadPool. When given, the
        work queue (loop closure + optimization) drains on pool threads —
        the reference's asynchronous global SLAM (pose_graph_2d.cc
        DrainWorkQueue:520-544); otherwise draining is inline and
        deterministic. `device=None` means CUDA (the mesh's device when a
        mesh is given); pass device="cpu" to run the searches, refinements
        and solves on the CPU.

        mesh: optional parallel/partition.Mesh. The two scalable backend
        workloads — the drained loop-closure search batch and the SPA
        residual tables — are split over its ranks (parallel/sharded.py);
        None is the single-device behaviour. Every rank must drive the
        same graph with the same inputs, draining inline: a thread pool
        with a mesh of more than one rank raises."""
        if thread_pool is not None and mesh is not None and mesh.world_size > 1:
            raise ValueError(
                "a mesh of several ranks needs synchronous drains (thread_pool=None)"
            )
        self._options = options
        self._thread_pool = thread_pool
        self._work_lock = threading.RLock()
        self._drain_lock = threading.Lock()
        self._pending_task = None
        self._constraint_builder = self._constraint_builder_type(
            options.constraint_builder, device=device, mesh=mesh
        )
        self._optimization_problem = self._optimization_problem_type(
            options.optimization_problem, device=device, mesh=mesh
        )
        self._submap_data: MapById = MapById()  # SubmapId -> InternalSubmapData
        self._trajectory_nodes: MapById = MapById()  # NodeId -> TrajectoryNode
        self._constraints: List[Constraint] = []
        self._trajectory_states: Dict[int, TrajectoryState] = {}
        self._connectivity = TrajectoryConnectivityState()
        self._global_localization_samplers: Dict[int, FixedRatioSampler] = {}
        self._num_nodes_since_last_loop_closure = 0
        self._trimmers: List = []
        if options.overlapping_submaps_trimmer_2d is not None and self._is_2d:
            t = options.overlapping_submaps_trimmer_2d
            self._trimmers.append(
                OverlappingSubmapsTrimmer2D(
                    t.fresh_submaps_count,
                    t.min_covered_area,
                    t.min_added_submaps_count,
                )
            )
        self._initial_trajectory_poses: Dict[int, tuple] = {}
        self._landmark_nodes: Dict[str, dict] = {}
        self._global_slam_optimization_callback = None
        # Wall seconds of every optimization's solve, in order (timing
        # record for callers; the solve itself is in run_optimization).
        self.solve_seconds: List[float] = []
        # The node whose work item runs the next optimization (guarded by
        # the work lock): the key of the pose_graph.solve span.
        self._work_item_node = None

    # -- public api ---------------------------------------------------------

    @property
    def constraints(self) -> List[Constraint]:
        return list(self._constraints)

    def add_trajectory_if_needed(self, trajectory_id: int) -> None:
        if trajectory_id not in self._trajectory_states:
            self._trajectory_states[trajectory_id] = TrajectoryState.ACTIVE
            self._connectivity.add(trajectory_id)
            self._global_localization_samplers.setdefault(
                trajectory_id,
                FixedRatioSampler(self._options.global_sampling_ratio),
            )

    def add_node(
        self,
        constant_data: TrajectoryNodeData,
        trajectory_id: int,
        insertion_submaps: List[Submap2D],
    ) -> NodeId:
        with metrics.span("pose_graph.add_node", constant_data.time):
            self._acquire_work_lock()
            try:
                return self._add_node_locked(
                    constant_data, trajectory_id, insertion_submaps
                )
            finally:
                self._work_lock.release()

    def _acquire_work_lock(self, key=None) -> None:
        """Take the work lock; the wait is the pose_graph.work_lock_wait
        span (its key the enclosing span's unless given)."""
        with metrics.span("pose_graph.work_lock_wait", key):
            self._work_lock.acquire()

    def _add_node_locked(
        self,
        constant_data: TrajectoryNodeData,
        trajectory_id: int,
        insertion_submaps: List[Submap2D],
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
        # If this is a new submap, register it.
        last_submap_id = None
        traj_submaps = self._submap_data.trajectory(trajectory_id)
        if not traj_submaps or (
            self._submap_data.at(
                SubmapId(trajectory_id, traj_submaps[-1][0])
            ).submap
            is not insertion_submaps[-1]
        ):
            new_id = SubmapId(
                *self._submap_data.append(
                    trajectory_id, InternalSubmapData(insertion_submaps[-1])
                )
            )
            self._constraint_builder.set_submap_local_pose(
                new_id, np.asarray(insertion_submaps[-1].local_pose)
            )
        newly_finished = insertion_submaps[0].insertion_finished
        self._compute_constraints_for_node(node_id, insertion_submaps, newly_finished)
        return node_id

    def add_imu_data(self, trajectory_id: int, imu_data: ImuData) -> None:
        pass  # 2D optimization does not use IMU (3D will).

    def add_odometry_data(self, trajectory_id: int, odometry_data: OdometryData) -> None:
        self._optimization_problem.add_odometry_data(trajectory_id, odometry_data)

    def add_fixed_frame_pose_data(self, trajectory_id: int, data: FixedFramePoseData) -> None:
        self._optimization_problem.add_fixed_frame_pose_data(trajectory_id, data)

    def add_landmark_data(self, trajectory_id: int, landmark_data) -> None:
        """Reference PoseGraph2D::AddLandmarkData: one LandmarkNode per id
        accumulating observations."""
        for obs in landmark_data.landmark_observations:
            node = self._landmark_nodes.setdefault(
                obs.id, {"observations": [], "global_pose": None}
            )
            node["observations"].append(
                {
                    "trajectory_id": trajectory_id,
                    "time": landmark_data.time,
                    "landmark_to_tracking_transform": obs.landmark_to_tracking_transform,
                    "translation_weight": obs.translation_weight,
                    "rotation_weight": obs.rotation_weight,
                }
            )

    def get_landmark_poses(self) -> Dict[str, np.ndarray]:
        return {
            lid: np.asarray(pose)
            for lid, pose in self._optimization_problem.landmark_data.items()
        }

    def set_landmark_pose(
        self, landmark_id: str, global_pose: np.ndarray, frozen: bool = False
    ) -> None:
        """Reference PoseGraphInterface::SetLandmarkPose
        (pose_graph_2d.cc:SetLandmarkPose): seed/override the landmark's
        global pose; frozen landmarks keep the set pose across solves."""
        with self._work_lock:
            node = self._landmark_nodes.setdefault(
                landmark_id, {"observations": [], "global_pose": None}
            )
            pose2 = rigid3.project_2d(np.asarray(global_pose, np.float64))
            node["global_pose"] = np.asarray(global_pose, np.float64)
            node["frozen"] = frozen
            self._optimization_problem.landmark_data[landmark_id] = pose2

    def set_global_slam_optimization_callback(self, callback) -> None:
        """Reference PoseGraph::SetGlobalSlamOptimizationCallback: invoked
        after every optimization with the last optimized submap/node id per
        trajectory."""
        self._global_slam_optimization_callback = callback

    def delete_trajectory(self, trajectory_id: int) -> None:
        """Reference PoseGraph2D::DeleteTrajectory (+DeleteTrajectoriesIfNeeded,
        pose_graph_2d.cc): remove the trajectory's nodes, submaps, and every
        constraint touching them; the trajectory becomes DELETED."""
        self.wait_for_all_computations()
        with self._work_lock:
            self._trajectory_states[trajectory_id] = TrajectoryState.DELETED
            self._constraints = [
                c
                for c in self._constraints
                if c.submap_id.trajectory_id != trajectory_id
                and c.node_id.trajectory_id != trajectory_id
            ]
            for index, _ in list(self._submap_data.trajectory(trajectory_id)):
                submap_id = SubmapId(trajectory_id, index)
                self._submap_data.trim(submap_id)
                if self._optimization_problem.submap_data.get(submap_id) is not None:
                    self._optimization_problem.trim_submap(submap_id)
            for index, _ in list(self._trajectory_nodes.trajectory(trajectory_id)):
                node_id = NodeId(trajectory_id, index)
                self._trajectory_nodes.trim(node_id)
                if self._optimization_problem.node_data.get(node_id) is not None:
                    self._optimization_problem.trim_trajectory_node(node_id)

    def add_trimmer(self, trimmer) -> None:
        with self._work_lock:
            self._trimmers.append(trimmer)

    def finish_trajectory(self, trajectory_id: int) -> None:
        self.wait_for_all_computations()
        with self._work_lock:
            self._trajectory_states[trajectory_id] = TrajectoryState.FINISHED
            for index, data in self._submap_data.trajectory(trajectory_id):
                submap_id = SubmapId(trajectory_id, index)
                if data.state == SubmapState.NO_CONSTRAINT_SEARCH:
                    self._finish_submap(submap_id)
            self._handle_work_queue()

    def freeze_trajectory(self, trajectory_id: int) -> None:
        self.add_trajectory_if_needed(trajectory_id)
        # Mark as connected to itself (reference FreezeTrajectory).
        self._trajectory_states[trajectory_id] = TrajectoryState.FROZEN

    def is_trajectory_frozen(self, trajectory_id: int) -> bool:
        return self._trajectory_states.get(trajectory_id) == TrajectoryState.FROZEN

    def is_trajectory_finished(self, trajectory_id: int) -> bool:
        return self._trajectory_states.get(trajectory_id) == TrajectoryState.FINISHED

    def run_final_optimization(self) -> None:
        self.wait_for_all_computations()
        with self._work_lock:
            self._drain_constraints()
            self._optimization_problem.set_max_num_iterations(
                self._options.max_num_final_iterations
            )
            self.run_optimization()
            self._optimization_problem.set_max_num_iterations(
                self._options.optimization_problem.ceres_solver_options.max_num_iterations
            )

    # -- queries ------------------------------------------------------------

    def get_local_to_global_transform(self, trajectory_id: int) -> np.ndarray:
        """SE(3) mapping local-SLAM frame to global frame for a trajectory,
        from the last optimized submap pose (pose_graph_2d.cc
        ComputeLocalToGlobalTransform)."""
        items = self._submap_data.trajectory(trajectory_id)
        if not items:
            if trajectory_id in self._initial_trajectory_poses:
                to_id, pose, _ = self._initial_trajectory_poses[trajectory_id]
                return rigid3.compose(
                    self.get_local_to_global_transform(to_id), pose
                )
            return rigid3.identity()
        last_index, data = items[-1]
        submap_id = SubmapId(trajectory_id, last_index)
        spec = self._optimization_problem.submap_data.get(submap_id)
        if spec is None:
            return rigid3.identity()
        global_3d = rigid3.embed_3d(spec.global_pose)
        local_3d = rigid3.embed_3d(
            np.asarray(data.submap.local_pose, np.float64)
        )
        return rigid3.compose(global_3d, rigid3.inverse(local_3d))

    def get_trajectory_nodes(self) -> MapById:
        return self._trajectory_nodes

    def get_all_submap_data(self) -> MapById:
        return self._submap_data

    def set_initial_trajectory_pose(
        self, from_trajectory_id: int, to_trajectory_id: int, pose: np.ndarray, time: Time
    ) -> None:
        self._initial_trajectory_poses[from_trajectory_id] = (
            to_trajectory_id,
            np.asarray(pose),
            time,
        )

    # -- internals ----------------------------------------------------------

    def _compute_constraints_for_node(
        self,
        node_id: NodeId,
        insertion_submaps: List[Submap2D],
        newly_finished_submap: bool,
    ) -> None:
        node = self._trajectory_nodes.at(node_id)
        constant_data = node.constant_data
        submap_ids = self._initialize_global_submap_poses(
            node_id.trajectory_id, constant_data.time, insertion_submaps
        )
        matching_id = submap_ids[0]
        local_pose_2d = rigid3.project_2d(
            rigid3.compose(
                constant_data.local_pose,
                rigid3.inverse(rigid3.rotation(constant_data.gravity_alignment)),
            )
        )
        matching_submap = insertion_submaps[0]
        global_pose_2d = rigid2.compose(
            self._optimization_problem.submap_data.at(matching_id).global_pose,
            rigid2.compose(
                rigid2.inverse(np.asarray(matching_submap.local_pose)),
                local_pose_2d,
            ),
        )
        self._optimization_problem.insert_trajectory_node(
            node_id,
            NodeSpec2D(
                time=constant_data.time,
                local_pose_2d=local_pose_2d,
                global_pose_2d=global_pose_2d,
                gravity_alignment=constant_data.gravity_alignment,
            ),
        )
        for submap_id, submap in zip(submap_ids, insertion_submaps):
            self._submap_data.at(submap_id).node_ids.add(node_id)
            constraint_pose = rigid2.compose(
                rigid2.inverse(np.asarray(submap.local_pose)), local_pose_2d
            )
            self._constraints.append(
                Constraint(
                    submap_id=submap_id,
                    node_id=node_id,
                    pose=ConstraintPose(
                        zbar_ij=constraint_pose,
                        translation_weight=self._options.matcher_translation_weight,
                        rotation_weight=self._options.matcher_rotation_weight,
                    ),
                    tag=INTRA_SUBMAP,
                )
            )
        # Loop closure: this node against all finished submaps.
        for submap_id, _ in self._submap_data.items(SubmapId):
            if self._submap_data.at(submap_id).state == SubmapState.FINISHED:
                self._compute_constraint(node_id, submap_id)
        # Newly finished submap against all old nodes. With chunk-batched
        # local-SLAM delivery (chunked_frontend_2d) the shared Submap2D's
        # insertion_finished flag may already be set when EARLIER nodes of
        # the batch are processed (the reference reads it synchronously in
        # AddNode, pose_graph_2d.cc:160); the one-time full search runs at
        # the first observation, and later nodes still match the submap via
        # the per-node FINISHED pass above.
        if newly_finished_submap:
            finished_submap_id = submap_ids[0]
            data = self._submap_data.at(finished_submap_id)
            if data.state == SubmapState.NO_CONSTRAINT_SEARCH:
                data.state = SubmapState.FINISHED
                for old_node_id, _ in self._trajectory_nodes.items(NodeId):
                    if old_node_id not in data.node_ids:
                        self._compute_constraint(old_node_id, finished_submap_id)
        self._constraint_builder.notify_end_of_node()
        self._num_nodes_since_last_loop_closure += 1
        if (
            self._options.optimize_every_n_nodes > 0
            and self._num_nodes_since_last_loop_closure
            >= self._options.optimize_every_n_nodes
        ):
            self._dispatch_work_queue(node_id)

    def _dispatch_work_queue(self, node_id=None) -> None:
        """Drain the work queue: inline without a thread pool, else on it.
        `node_id`, the node that asked for the drain, keys its spans."""
        if self._thread_pool is None:
            self._handle_work_queue(node_id)
            return
        # Schedule at most one drain at a time (DrainWorkQueue semantics):
        # the check and the set happen under the work lock, so two callers
        # (add_node, wait_for_all_computations) cannot both schedule. A
        # drain that FAILED stays pending, so wait_for_all_computations
        # re-raises its error instead of a later drain replacing it.
        self._acquire_work_lock(node_id)
        try:
            task = self._pending_task
            if task is not None and task.state != TaskState.COMPLETED:
                return
            task = Task(functools.partial(self._locked_handle_work_queue, node_id))
            self._pending_task = task
        finally:
            self._work_lock.release()
        self._thread_pool.schedule(task)

    def _run_pending(self, node_id=None):
        """The constraint builder's run_pending, one caller at a time."""
        with self._drain_lock, metrics.span("pose_graph.drain", node_id):
            return self._constraint_builder.run_pending()

    def _locked_handle_work_queue(self, node_id=None) -> None:
        # The loop-closure searches are the multi-second part of a drain
        # and they operate purely on data staged at enqueue time (popped
        # pending list, frozen finished-submap grids, builder-side
        # caches touched only by drain threads) — run them OUTSIDE the
        # work lock so add_node never blocks on a search. Only the
        # merge + optimization phase mutates shared pose graph state and
        # takes the lock. This is what makes the async
        # backend actually hide drain latency from the sensor feed
        # (reference: constraint searches are thread-pool tasks and
        # HandleWorkQueue holds the mutex only for bookkeeping,
        # constraint_builder_2d.cc:102-136, pose_graph_2d.cc:520-544).
        new_constraints = self._run_pending(node_id)
        self._acquire_work_lock(node_id)
        try:
            self._merge_constraints(new_constraints)
            self._finish_work_queue(node_id)
        finally:
            self._work_lock.release()

    def wait_for_all_computations(self, timeout: float = 600.0) -> None:
        """Reference WaitForAllComputations (pose_graph_2d.cc:546-620):
        block until the in-flight drain completes and no constraint
        searches remain, waiting on task completion (not a poll) and
        logging progress while the backend is still busy. A drain that
        raised on the pool re-raises here (common.task.TaskFailed)."""
        if self._thread_pool is None:
            return  # Synchronous mode: nothing in flight.
        deadline = _time.monotonic() + timeout
        last_log = _time.monotonic()
        while _time.monotonic() < deadline:
            task = self._pending_task
            if task is not None and task.state != TaskState.COMPLETED:
                # Block on completion (progress-logging slices, matching
                # the reference's periodic "constraints still being
                # computed" report); raises if the drain failed.
                if not task.wait(
                    timeout=min(5.0, max(0.0, deadline - _time.monotonic()))
                ):
                    pending = self._constraint_builder.num_pending()
                    if _time.monotonic() - last_log >= 5.0:
                        logging.info(
                            "Waiting for the pose graph drain: %d constraint "
                            "searches pending.",
                            pending,
                        )
                        last_log = _time.monotonic()
                    continue
            if self._constraint_builder.num_pending() == 0:
                return
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
        grid = submap_data.submap.grid
        if (
            node_id.trajectory_id == submap_id.trajectory_id
            or node_time
            < last_connection + self._options.global_constraint_search_after_n_seconds
        ):
            # Local search window around the current relative pose estimate.
            spec = self._optimization_problem.node_data.get(node_id)
            sub_spec = self._optimization_problem.submap_data.get(submap_id)
            if spec is None or sub_spec is None:
                return
            initial_relative_pose = rigid2.relative(
                sub_spec.global_pose, spec.global_pose_2d
            )
            self._constraint_builder.maybe_add_constraint(
                submap_id,
                grid,
                node_id,
                node.constant_data,
                initial_relative_pose,
            )
        elif self._global_localization_samplers[node_id.trajectory_id].pulse():
            self._constraint_builder.maybe_add_global_constraint(
                submap_id, grid, node_id, node.constant_data
            )

    def _initialize_global_submap_poses(
        self, trajectory_id: int, time: Time, insertion_submaps: List[Submap2D]
    ) -> List[SubmapId]:
        """Mirrors pose_graph_2d.cc InitializeGlobalSubmapPoses:75-124."""
        submap_data = self._optimization_problem.submap_data
        if len(insertion_submaps) == 1:
            if submap_data.size_of_trajectory_or_zero(trajectory_id) == 0:
                if trajectory_id in self._initial_trajectory_poses:
                    to_id, pose, t = self._initial_trajectory_poses[trajectory_id]
                    self._connectivity.connect(trajectory_id, to_id, t)
                first_global = rigid3.project_2d(
                    rigid3.compose(
                        self.get_local_to_global_transform(trajectory_id),
                        rigid3.embed_3d(
                            np.asarray(insertion_submaps[0].local_pose, np.float64)
                        ),
                    )
                )
                self._optimization_problem.add_submap(trajectory_id, first_global)
            submap_id = SubmapId(
                trajectory_id,
                self._submap_data.trajectory(trajectory_id)[0][0],
            )
            return [submap_id]
        assert len(insertion_submaps) == 2
        items = self._submap_data.trajectory(trajectory_id)
        last_submap_id = SubmapId(trajectory_id, items[-1][0])
        if (
            self._optimization_problem.submap_data.get(last_submap_id) is None
        ):
            # New submap: initialize its global pose relative to the previous.
            prev_submap_id = SubmapId(trajectory_id, items[-2][0])
            prev_spec = self._optimization_problem.submap_data.at(prev_submap_id)
            prev_submap = self._submap_data.at(prev_submap_id).submap
            first_global = rigid2.compose(
                prev_spec.global_pose,
                rigid2.relative(
                    np.asarray(prev_submap.local_pose),
                    np.asarray(insertion_submaps[-1].local_pose),
                ),
            )
            self._optimization_problem.insert_submap(last_submap_id, first_global)
        prev_submap_id = SubmapId(trajectory_id, items[-2][0])
        return [prev_submap_id, last_submap_id]

    def _finish_submap(self, submap_id: SubmapId) -> None:
        data = self._submap_data.at(submap_id)
        if data.state == SubmapState.FINISHED:
            return
        data.submap.finish()
        data.state = SubmapState.FINISHED
        for node_id, _ in self._trajectory_nodes.items(NodeId):
            if node_id not in data.node_ids:
                self._compute_constraint(node_id, submap_id)

    def _drain_constraints(self, node_id=None) -> None:
        self._merge_constraints(self._run_pending(node_id))

    def _merge_constraints(self, new_constraints) -> None:
        for c in new_constraints:
            self._constraints.append(c)
            if c.node_id.trajectory_id != c.submap_id.trajectory_id:
                time = self._trajectory_nodes.at(c.node_id).constant_data.time
                self._connectivity.connect(
                    c.node_id.trajectory_id, c.submap_id.trajectory_id, time
                )
        metrics.pose_graph_constraints_inter.set(
            sum(1 for c in self._constraints if c.tag != INTRA_SUBMAP)
        )
        metrics.pose_graph_constraints_intra.set(
            sum(1 for c in self._constraints if c.tag == INTRA_SUBMAP)
        )

    def _handle_work_queue(self, node_id=None) -> None:
        """Reference HandleWorkQueue: merge found constraints, optimize,
        update connectivity, run trimmers."""
        self._drain_constraints(node_id)
        self._finish_work_queue(node_id)

    def _finish_work_queue(self, node_id=None) -> None:
        self._work_item_node = node_id
        self.run_optimization()
        self._work_item_node = None
        self._num_nodes_since_last_loop_closure = 0
        for trimmer in list(self._trimmers):
            trimmer.trim(TrimmingHandle(self))
            if trimmer.is_finished():
                self._trimmers.remove(trimmer)

    def run_optimization(self) -> None:
        if self._optimization_problem.node_data.empty():
            return
        frozen = {
            t
            for t, s in self._trajectory_states.items()
            if s == TrajectoryState.FROZEN
        }
        solve = metrics.timed("pose_graph.solve", self._work_item_node)
        self._optimization_problem.solve(
            self._constraints, frozen, self._landmark_nodes
        )
        self.solve_seconds.append(solve.stop())
        # Frozen landmarks keep their SetLandmarkPose value (the reference
        # holds the parameter block constant in Ceres).
        for lid, node in self._landmark_nodes.items():
            if node.get("frozen") and node.get("global_pose") is not None:
                self._optimization_problem.landmark_data[lid] = rigid3.project_2d(
                    np.asarray(node["global_pose"], np.float64)
                )
        metrics.optimization_runs.increment()
        # Write back node/submap poses; extrapolate the un-optimized tail
        # (pose_graph_2d.cc:861-909).
        for trajectory_id in self._trajectory_nodes.trajectory_ids():
            local_to_new_global = None
            last_optimized_index = -1
            for index, spec in self._optimization_problem.node_data.trajectory(
                trajectory_id
            ):
                node_id = NodeId(trajectory_id, index)
                node = self._trajectory_nodes.at(node_id)
                node.global_pose = rigid3.compose(
                    rigid3.embed_3d(spec.global_pose_2d),
                    rigid3.rotation(node.constant_data.gravity_alignment),
                )
                last_optimized_index = index
            # Extrapolate nodes added after the optimization snapshot - with
            # synchronous draining there are none, but keep the semantics.
            local_to_new_global = self.get_local_to_global_transform(trajectory_id)
            for index, node in self._trajectory_nodes.trajectory(trajectory_id):
                if index > last_optimized_index:
                    node.global_pose = rigid3.compose(
                        local_to_new_global, node.constant_data.local_pose
                    )
        self._notify_optimization()

    def _notify_optimization(self) -> None:
        """The global SLAM optimization callback, with the last optimized
        submap and node id per trajectory."""
        if self._global_slam_optimization_callback is not None:
            last_submaps = {}
            last_nodes = {}
            for tid in self._optimization_problem.submap_data.trajectory_ids():
                items = self._optimization_problem.submap_data.trajectory(tid)
                if items:
                    last_submaps[tid] = SubmapId(tid, items[-1][0])
            for tid in self._optimization_problem.node_data.trajectory_ids():
                items = self._optimization_problem.node_data.trajectory(tid)
                if items:
                    last_nodes[tid] = NodeId(tid, items[-1][0])
            self._global_slam_optimization_callback(last_submaps, last_nodes)


class TrimmingHandle:
    """Reference Trimmable interface (pose_graph_trimmer.h / TrimmingHandle)."""

    def __init__(self, pose_graph: PoseGraph2D):
        self._pose_graph = pose_graph

    def num_submaps(self, trajectory_id: int) -> int:
        return self._pose_graph._submap_data.size_of_trajectory_or_zero(trajectory_id)

    def get_submap_ids(self, trajectory_id: int) -> List[SubmapId]:
        return [
            SubmapId(trajectory_id, i)
            for i, _ in self._pose_graph._submap_data.trajectory(trajectory_id)
        ]

    def get_optimized_submap_data(self):
        """FINISHED submaps with their optimized global poses, as
        (submap_id, submap, global_pose_2d) tuples
        (TrimmingHandle::GetOptimizedSubmapData)."""
        out = []
        pg = self._pose_graph
        for sid, data in pg._submap_data.items(SubmapId):
            if data.state != SubmapState.FINISHED:
                continue
            spec = pg._optimization_problem.submap_data.get(sid)
            if spec is None:
                continue
            out.append((sid, data.submap, np.asarray(spec.global_pose)))
        return out

    def trim_submap(self, submap_id: SubmapId) -> None:
        """pose_graph_2d.cc TrimmingHandle::TrimSubmap: drop the submap, its
        constraints, and the nodes only connected to it, and evict the
        constraint builder's caches of the submap and of those nodes
        (queued searches against the submap are dropped at the next
        drain). The JAX package keeps the trimmed nodes' staged clouds,
        so its cache grows without bound under the pure-localization
        trimmer."""
        pg = self._pose_graph
        if pg._submap_data.at(submap_id).state != SubmapState.FINISHED:
            raise ValueError(f"trim_submap: {submap_id} is not finished")
        # Constraints to keep: those not referring to this submap.
        constraints = [c for c in pg._constraints if c.submap_id != submap_id]
        # Nodes still constrained by other submaps.
        nodes_with_constraints = {c.node_id for c in constraints}
        orphaned = [
            n
            for n in pg._submap_data.at(submap_id).node_ids
            if n not in nodes_with_constraints
        ]
        constraints = [c for c in constraints if c.node_id not in orphaned]
        pg._constraints = constraints
        pg._submap_data.trim(submap_id)
        pg._optimization_problem.trim_submap(submap_id)
        cb = pg._constraint_builder
        cb.evict_submap(submap_id)
        for node_id in orphaned:
            pg._trajectory_nodes.trim(node_id)
            pg._optimization_problem.trim_trajectory_node(node_id)
            cb.evict_node(node_id)


def replay_nodes(pose_graph: PoseGraph2D, trajectory_id: int, records, submaps, device):
    """Feed a recorded node sequence into `pose_graph`, so that two pose
    graphs (e.g. the JAX package's and this one) start from identical
    state.

    `records`: list of dicts with `node` (kwargs of TrajectoryNodeData, as
    numpy), `submaps` (keys of the node's insertion submaps, oldest
    first) and `finished` (each insertion submap's insertion_finished
    flag as the recording pose graph saw it at add_node). `submaps`: key
    -> dict(local_pose, log_odds, known, origin, resolution), the grid
    being the one the recording constraint builder searched (its grid
    once finished, else its last). One Submap2D per key is built on
    `device` and shared by every node that names it, as the frontend
    shares them."""
    built: Dict[object, Submap2D] = {}
    node_ids = []
    for rec in records:
        insertion = []
        for key, finished in zip(rec["submaps"], rec["finished"]):
            submap = built.get(key)
            if submap is None:
                sm = submaps[key]
                submap = submap_from_numpy(
                    sm["local_pose"], sm["log_odds"], sm["known"], sm["origin"],
                    sm["resolution"], device,
                )
                built[key] = submap
            if finished:
                submap.finish()
            insertion.append(submap)
        node = TrajectoryNodeData(**rec["node"])
        node_ids.append(pose_graph.add_node(node, trajectory_id, insertion))
    return node_ids
