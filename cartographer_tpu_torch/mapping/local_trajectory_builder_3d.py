"""3D local SLAM frontend, one scan at a time.

Port of cartographer_tpu/mapping/local_trajectory_builder_3d.py.
Reference: mapping/internal/3d/local_trajectory_builder_3d.cc:48-479. Per
scan: collate -> 0.5x voxel pre-filter -> accumulate -> per-hit-time pose
extrapolation with gravity (ExtrapolatePosesWithGravity) -> range filter
(misses = rays cropped to max_range) -> voxel filter -> high/low-res
adaptive filters -> (optional correlative match) -> two-grid
Levenberg-Marquardt match in the submap frame -> insertion + rotational
histogram per node.

The constant-velocity extrapolator, the voxel and adaptive filters and
the histograms stay on the host, as in the JAX package; the grids, the
correlative match, the LM refinement and the IMU-based extrapolator's
window solve (use_imu_based) run on the builder's device. The result
types are shared with the chunked 3D frontend.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Set

import numpy as np
import torch

from cartographer_tpu_torch.common.config import TrajectoryBuilder3DOptions
from cartographer_tpu_torch.common.time import Time
from cartographer_tpu_torch.device import resolve_device
from cartographer_tpu_torch.mapping.imu_based_pose_extrapolator import (
    ImuBasedPoseExtrapolator,
)
from cartographer_tpu_torch.mapping.motion_filter import MotionFilter
from cartographer_tpu_torch.mapping.pose_extrapolator import PoseExtrapolator
from cartographer_tpu_torch.mapping.pose_extrapolator_interface import (
    create_with_imu_data,
)
from cartographer_tpu_torch.mapping.range_data_collator import RangeDataCollator
from cartographer_tpu_torch.mapping.scan_matching_3d import (
    CeresScanMatcher3D,
    RealTimeCorrelativeScanMatcher3D,
)
from cartographer_tpu_torch.mapping.submap_3d import ActiveSubmaps3D, Submap3D
from cartographer_tpu_torch.mapping.trajectory_node import TrajectoryNodeData
from cartographer_tpu_torch.ops.scan_matching import rotational_histogram
from cartographer_tpu_torch.sensor.data import (
    ImuData,
    OdometryData,
    PointCloud,
    RangeData,
    TimedPointCloudData,
    TimedPointCloudOriginData,
)
from cartographer_tpu_torch.sensor.voxel_filter import (
    adaptive_voxel_filter,
    voxel_filter,
    voxel_filter_indices,
)
from cartographer_tpu_torch.transform import rigid3


@dataclasses.dataclass
class InsertionResult:
    constant_data: TrajectoryNodeData
    insertion_submaps: List[Submap3D]


@dataclasses.dataclass
class MatchingResult:
    time: Time
    local_pose: np.ndarray  # SE(3) (7,)
    range_data_in_local: RangeData
    insertion_result: Optional[InsertionResult]


class LocalTrajectoryBuilder3D:
    """`device=None` means CUDA; pass device="cpu" to run on the CPU."""

    def __init__(
        self,
        options: TrajectoryBuilder3DOptions,
        expected_range_sensor_ids: Set[str],
        device=None,
    ):
        self._options = options
        self._device = resolve_device(device)
        self._active_submaps = ActiveSubmaps3D(
            options.submaps, use_intensities=options.use_intensities,
            device=self._device,
        )
        self._motion_filter = MotionFilter(options.motion_filter)
        self._real_time_correlative_scan_matcher = RealTimeCorrelativeScanMatcher3D(
            options.real_time_correlative_scan_matcher
        )
        self._ceres_scan_matcher = CeresScanMatcher3D(options.ceres_scan_matcher)
        self._range_data_collator = RangeDataCollator(expected_range_sensor_ids)
        self._extrapolator: Optional[PoseExtrapolator] = None
        self._num_accumulated = 0
        self._accumulated: List[TimedPointCloudOriginData] = []

    def to(self, device) -> "LocalTrajectoryBuilder3D":
        """A copy of the builder as it stands, on `device`: the host state
        (extrapolator, motion filter, collator, accumulated scans) copied,
        the submap volumes moved."""
        active = self._active_submaps.to(device)
        twin = copy.deepcopy(self, {id(self._active_submaps): active})
        twin._device = active._device
        if isinstance(twin._extrapolator, ImuBasedPoseExtrapolator):
            twin._extrapolator.device = twin._device
        return twin

    # -- sensor feeds -------------------------------------------------------

    def add_imu_data(self, imu_data: ImuData) -> None:
        if self._extrapolator is not None:
            self._extrapolator.add_imu_data(imu_data)
            return
        self._extrapolator = create_with_imu_data(
            self._options.pose_extrapolator, [imu_data], self._device
        )

    def add_odometry_data(self, odometry_data: OdometryData) -> None:
        if self._extrapolator is None:
            return
        self._extrapolator.add_odometry_data(odometry_data)

    def add_range_data(
        self, sensor_id: str, unsynchronized_data: TimedPointCloudData
    ) -> Optional[MatchingResult]:
        synchronized_data = self._range_data_collator.add_range_data(
            sensor_id, unsynchronized_data
        )
        if synchronized_data is None or synchronized_data.points.shape[0] == 0:
            return None
        if self._extrapolator is None:
            return None  # IMU not yet initialized.
        time = synchronized_data.time
        time_first_point = time + float(synchronized_data.times[0])
        if time_first_point < self._extrapolator.get_last_pose_time():
            return None

        if self._num_accumulated == 0:
            self._accumulated = []
        # 0.5x voxel pre-filter on the raw synchronized points.
        keep = voxel_filter_indices(
            synchronized_data.points, 0.5 * self._options.voxel_filter_size
        )
        synchronized_data = TimedPointCloudOriginData(
            time=synchronized_data.time,
            origins=synchronized_data.origins,
            points=synchronized_data.points[keep],
            times=synchronized_data.times[keep],
            origin_index=synchronized_data.origin_index[keep],
            intensities=None
            if synchronized_data.intensities is None
            else synchronized_data.intensities[keep],
        )
        self._accumulated.append(synchronized_data)
        self._num_accumulated += 1
        if self._num_accumulated < self._options.num_accumulated_range_data:
            return None
        self._num_accumulated = 0

        # Per-hit timestamps (monotonic-clamped) + one extra for scan end.
        hit_times: List[float] = []
        prev_time = self._extrapolator.get_last_extrapolated_time()
        for data in self._accumulated:
            for t_rel in data.times:
                t = max(data.time + float(t_rel), prev_time)
                hit_times.append(t)
                prev_time = t
        hit_times.append(self._accumulated[-1].time)

        extrapolation = self._extrapolator.extrapolate_poses_with_gravity(hit_times)
        hits_poses = np.stack(
            extrapolation.previous_poses + [extrapolation.current_pose]
        )  # (P+1, 7); last row is the scan-end pose, unused per point.

        all_points = np.concatenate([d.points for d in self._accumulated]).astype(
            np.float64
        )
        all_origins = np.concatenate(
            [d.origins[d.origin_index] for d in self._accumulated]
        ).astype(np.float64)
        all_intens = (
            np.concatenate(
                [
                    d.intensities
                    if d.intensities is not None
                    else np.zeros(len(d.points), np.float32)
                    for d in self._accumulated
                ]
            )
            if any(d.intensities is not None for d in self._accumulated)
            else None
        )
        point_poses = hits_poses[: len(all_points)]
        hits_local = (
            rigid3.quat_rotate(point_poses[:, 3:7], all_points)
            + point_poses[:, :3]
        )
        origins_local = (
            rigid3.quat_rotate(point_poses[:, 3:7], all_origins)
            + point_poses[:, :3]
        )
        delta = hits_local - origins_local
        ranges = np.linalg.norm(delta, axis=1)
        keep = ranges >= self._options.min_range
        as_return = keep & (ranges <= self._options.max_range)
        as_miss = keep & ~as_return
        with np.errstate(invalid="ignore", divide="ignore"):
            scale = self._options.max_range / np.maximum(ranges, 1e-12)

        current_pose = extrapolation.current_pose
        returns_cloud = PointCloud(
            hits_local[as_return].astype(np.float32),
            None if all_intens is None else all_intens[as_return],
        )
        misses_cloud = PointCloud(
            (origins_local + scale[:, None] * delta)[as_miss].astype(np.float32)
        )
        filtered_in_local = RangeData(
            origin=rigid3.trans(current_pose).astype(np.float32),
            returns=voxel_filter(returns_cloud, self._options.voxel_filter_size),
            misses=voxel_filter(misses_cloud, self._options.voxel_filter_size),
        )
        current_time = hit_times[-1]
        filtered_in_tracking = filtered_in_local.transform(
            rigid3.inverse(current_pose)
        )
        return self._add_accumulated_range_data(
            current_time,
            filtered_in_tracking,
            current_pose,
            extrapolation.gravity_from_tracking,
        )

    # -- core ---------------------------------------------------------------

    def _add_accumulated_range_data(
        self,
        time: Time,
        filtered_range_data_in_tracking: RangeData,
        pose_prediction: np.ndarray,
        gravity_alignment: np.ndarray,
    ) -> Optional[MatchingResult]:
        if filtered_range_data_in_tracking.returns.size == 0:
            return None
        high_res_cloud = adaptive_voxel_filter(
            filtered_range_data_in_tracking.returns,
            self._options.high_resolution_adaptive_voxel_filter,
        )
        if high_res_cloud.size == 0:
            return None
        low_res_cloud = adaptive_voxel_filter(
            filtered_range_data_in_tracking.returns,
            self._options.low_resolution_adaptive_voxel_filter,
        )
        if low_res_cloud.size == 0:
            return None

        pose_estimate = self._scan_match(
            pose_prediction, low_res_cloud, high_res_cloud
        )
        self._extrapolator.add_pose(time, pose_estimate)
        filtered_range_data_in_local = filtered_range_data_in_tracking.transform(
            pose_estimate
        )
        insertion_result = self._insert_into_submap(
            time,
            filtered_range_data_in_local,
            filtered_range_data_in_tracking,
            high_res_cloud,
            low_res_cloud,
            pose_estimate,
            gravity_alignment,
        )
        return MatchingResult(
            time=time,
            local_pose=pose_estimate,
            range_data_in_local=filtered_range_data_in_local,
            insertion_result=insertion_result,
        )

    def _scan_match(
        self,
        pose_prediction: np.ndarray,
        low_res_cloud: PointCloud,
        high_res_cloud: PointCloud,
    ) -> np.ndarray:
        submaps = self._active_submaps.submaps()
        if not submaps:
            return pose_prediction
        matching_submap = submaps[0]
        initial_pose_in_submap = rigid3.relative(
            matching_submap.local_pose, pose_prediction
        )
        initial = initial_pose_in_submap
        if self._options.use_online_correlative_scan_matching:
            _, initial = self._real_time_correlative_scan_matcher.match(
                initial_pose_in_submap,
                high_res_cloud.points,
                matching_submap.high_resolution_grid,
            )
        intensity_avg = None
        high_intensities = None
        if (
            self._options.use_intensities
            and matching_submap.intensity_sum is not None
            and high_res_cloud.intensities is not None
        ):
            intensity_avg = matching_submap.intensity_sum / torch.clamp(
                matching_submap.intensity_count, min=1.0
            )
            high_intensities = high_res_cloud.intensities
        pose_in_submap, _ = self._ceres_scan_matcher.match(
            initial_pose_in_submap[:3],
            initial,
            high_res_cloud.points,
            matching_submap.high_resolution_grid,
            low_res_cloud.points,
            matching_submap.low_resolution_grid,
            intensity_avg=intensity_avg,
            high_intensities=high_intensities,
        )
        return rigid3.compose(matching_submap.local_pose, pose_in_submap)

    def _insert_into_submap(
        self,
        time: Time,
        filtered_range_data_in_local: RangeData,
        filtered_range_data_in_tracking: RangeData,
        high_res_cloud: PointCloud,
        low_res_cloud: PointCloud,
        pose_estimate: np.ndarray,
        gravity_alignment: np.ndarray,
    ) -> Optional[InsertionResult]:
        if self._motion_filter.is_similar(time, pose_estimate):
            return None
        gravity_cloud = rigid3.quat_rotate(
            np.asarray(gravity_alignment)[None, :],
            filtered_range_data_in_tracking.returns.points.astype(np.float64),
        )
        histogram = rotational_histogram.compute_histogram(
            gravity_cloud, self._options.rotational_histogram_size
        )
        local_from_gravity_aligned = rigid3.quat_multiply(
            rigid3.quat(pose_estimate), rigid3.quat_conjugate(gravity_alignment)
        )
        insertion_submaps = self._active_submaps.insert_data(
            filtered_range_data_in_local, local_from_gravity_aligned, histogram
        )
        return InsertionResult(
            constant_data=TrajectoryNodeData(
                time=time,
                gravity_alignment=gravity_alignment,
                filtered_gravity_aligned_point_cloud=np.zeros((0, 3), np.float32),
                high_resolution_point_cloud=high_res_cloud.points,
                low_resolution_point_cloud=low_res_cloud.points,
                rotational_scan_matcher_histogram=histogram,
                local_pose=pose_estimate,
            ),
            insertion_submaps=insertion_submaps,
        )
