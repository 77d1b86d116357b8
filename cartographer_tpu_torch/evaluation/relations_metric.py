"""Relation-based evaluation: the reference's accuracy metric of record.

Port of cartographer_tpu/evaluation/relations_metric.py.

Reference: ground_truth/autogenerate_ground_truth.cc:40-155 (extract
loop-closure relations from an optimized graph: covered-distance gated,
outlier-thresholded, expected relative pose from the constraint) and
ground_truth/compute_relations_metrics_main.cc:39-219 (abs/sqr
translational [m] and rotational [deg] error statistics against relations).
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from cartographer_tpu_torch.mapping.constraint_builder_2d import INTRA_SUBMAP
from cartographer_tpu_torch.mapping.id import SubmapId
from cartographer_tpu_torch.transform import rigid3


@dataclasses.dataclass
class Relation:
    timestamp1: float
    timestamp2: float
    expected: np.ndarray  # SE(3) relative pose node1 -> node2
    covered_distance: float


@dataclasses.dataclass
class RelationMetrics:
    abs_translational_error_mean: float
    abs_translational_error_stddev: float
    sqr_translational_error_mean: float
    abs_rotational_error_deg_mean: float
    abs_rotational_error_deg_stddev: float
    sqr_rotational_error_deg_mean: float
    num_relations: int

    def __str__(self) -> str:
        return (
            f"Abs translational error {self.abs_translational_error_mean:.5f} "
            f"+/- {self.abs_translational_error_stddev:.5f} m\n"
            f"Sqr translational error {self.sqr_translational_error_mean:.5f} m^2\n"
            f"Abs rotational error {self.abs_rotational_error_deg_mean:.5f} "
            f"+/- {self.abs_rotational_error_deg_stddev:.5f} deg\n"
            f"Sqr rotational error {self.sqr_rotational_error_deg_mean:.5f} deg^2"
        )


def generate_ground_truth(
    pose_graph,
    min_covered_distance: float = 100.0,
    outlier_threshold_meters: float = 0.15,
    outlier_threshold_radians: float = 0.02,
    trajectory_id: int = 0,
) -> List[Relation]:
    """Auto-generate relations from the optimized pose graph's loop closures."""
    nodes = pose_graph.get_trajectory_nodes().trajectory(trajectory_id)
    node_poses = {i: np.asarray(n.global_pose) for i, n in nodes}
    node_times = {i: n.constant_data.time for i, n in nodes}

    # Covered distance along the trajectory.
    covered: Dict[int, float] = {}
    total = 0.0
    prev_index: Optional[int] = None
    for i, n in nodes:
        if prev_index is not None:
            total += float(
                np.linalg.norm(
                    rigid3.trans(node_poses[i]) - rigid3.trans(node_poses[prev_index])
                )
            )
        covered[i] = total
        prev_index = i

    # Representative node per submap: first INTRA constraint whose submap
    # index advances (the middle-of-submap heuristic of the reference).
    submap_to_node: Dict[int, int] = {}
    for c in pose_graph.constraints:
        if c.tag != INTRA_SUBMAP:
            continue
        if c.submap_id.trajectory_id != trajectory_id:
            continue
        idx = c.submap_id.submap_index
        if idx > 0 and idx not in submap_to_node:
            submap_to_node[idx] = c.node_id.node_index

    submap_poses = {}
    for sid, spec in pose_graph._optimization_problem.submap_data.items(SubmapId):
        if sid.trajectory_id == trajectory_id:
            pose = np.asarray(spec.global_pose)
            if pose.shape[-1] == 3:
                pose = rigid3.embed_3d(pose)
            submap_poses[sid.submap_index] = pose

    relations = []
    num_outliers = 0
    for c in pose_graph.constraints:
        if c.tag == INTRA_SUBMAP:
            continue
        if (
            c.submap_id.trajectory_id != trajectory_id
            or c.node_id.trajectory_id != trajectory_id
        ):
            continue
        if c.submap_id.submap_index not in submap_to_node:
            continue
        matched = c.node_id.node_index
        representative = submap_to_node[c.submap_id.submap_index]
        if matched not in covered or representative not in covered:
            continue
        covered_in_constraint = abs(covered[matched] - covered[representative])
        if covered_in_constraint < min_covered_distance:
            continue
        solution_pose1 = node_poses[representative]
        solution_pose2 = node_poses[matched]
        solution = rigid3.relative(solution_pose1, solution_pose2)
        submap_solution = submap_poses[c.submap_id.submap_index]
        submap_to_node_sol = rigid3.relative(solution_pose1, submap_solution)
        zbar = np.asarray(c.pose.zbar_ij)
        if zbar.shape[-1] == 3:
            zbar = rigid3.embed_3d(zbar)
        expected = rigid3.compose(submap_to_node_sol, zbar)
        error = rigid3.compose(solution, rigid3.inverse(expected))
        if (
            np.linalg.norm(rigid3.trans(error)) > outlier_threshold_meters
            or rigid3.quat_angle(rigid3.quat(error)) > outlier_threshold_radians
        ):
            num_outliers += 1
            continue
        relations.append(
            Relation(
                timestamp1=node_times[representative],
                timestamp2=node_times[matched],
                expected=expected,
                covered_distance=covered_in_constraint,
            )
        )
    return relations


def compute_relations_metrics(
    relations: List[Relation], node_times: List[float], node_poses: List[np.ndarray]
) -> RelationMetrics:
    """Evaluate a solution trajectory against ground-truth relations."""
    trans_errors, rot_errors_deg = [], []
    times = list(node_times)

    def pose_at(t: float) -> np.ndarray:
        i = bisect.bisect_left(times, t)
        if i == 0:
            return node_poses[0]
        if i >= len(times):
            return node_poses[-1]
        if times[i] == t:
            return node_poses[i]
        f = (t - times[i - 1]) / (times[i] - times[i - 1])
        return rigid3.interpolate(node_poses[i - 1], node_poses[i], f)

    for r in relations:
        pose1 = pose_at(r.timestamp1)
        pose2 = pose_at(r.timestamp2)
        error = rigid3.compose(
            rigid3.relative(pose1, pose2), rigid3.inverse(r.expected)
        )
        trans_errors.append(float(np.linalg.norm(rigid3.trans(error))))
        rot_errors_deg.append(
            math.degrees(float(rigid3.quat_angle(rigid3.quat(error))))
        )

    def mean_std(v):
        v = np.asarray(v)
        if len(v) < 2:
            return float(v.mean()) if len(v) else 0.0, 0.0
        return float(v.mean()), float(v.std(ddof=1))

    t_mean, t_std = mean_std(trans_errors)
    r_mean, r_std = mean_std(rot_errors_deg)
    return RelationMetrics(
        abs_translational_error_mean=t_mean,
        abs_translational_error_stddev=t_std,
        sqr_translational_error_mean=float(np.mean(np.square(trans_errors))) if trans_errors else 0.0,
        abs_rotational_error_deg_mean=r_mean,
        abs_rotational_error_deg_stddev=r_std,
        sqr_rotational_error_deg_mean=float(np.mean(np.square(rot_errors_deg))) if rot_errors_deg else 0.0,
        num_relations=len(relations),
    )
