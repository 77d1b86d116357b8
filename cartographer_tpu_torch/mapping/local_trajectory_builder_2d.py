"""2D local SLAM frontend, one scan at a time.

Port of cartographer_tpu/mapping/local_trajectory_builder_2d.py.
Reference: mapping/internal/2d/local_trajectory_builder_2d.cc:38-368. Per
scan: collate multi-sensor points -> stage the scan's points and times;
once the N-th scan closes the accumulation: per-point pose extrapolation
of every staged point in one call (motion unwarp) -> range filtering ->
gravity-align + z-crop + voxel filter -> adaptive voxel filter ->
(optional real-time correlative match) -> Levenberg-Marquardt grid
refinement -> extrapolator update -> motion filter -> insertion into the
two active submaps.

The constant-velocity extrapolator's per-point poses do not depend on how
the query times are grouped, as long as nothing it holds changes between
the scans: so the accumulation is unwarped once, and a feed that would
change what it extrapolates (odometry, an IMU sample no later than a
staged point) first unwarps what is staged. The IMU-based extrapolator
adds the query times to its window fit, so with it each scan is unwarped
as it comes, as in the reference.

The grids, the correlative match (the CUDA window-sum kernel on the card),
the LM refinement, the ray-cast insertion and the IMU-based extrapolator's
window solve (use_imu_based) run on the builder's device; sequencing, the
voxel filters and the constant-velocity extrapolator stay on the host, as
in the JAX package. The result types are shared with the chunked frontend.
"""

from __future__ import annotations

import copy
import dataclasses
import time as _walltime
from typing import List, Optional, Set

import numpy as np

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.common.config import TrajectoryBuilder2DOptions
from cartographer_tpu_torch.common.time import Time
from cartographer_tpu_torch.device import resolve_device
from cartographer_tpu_torch.mapping.imu_based_pose_extrapolator import (
    ImuBasedPoseExtrapolator,
)
from cartographer_tpu_torch.mapping.motion_filter import MotionFilter
from cartographer_tpu_torch.mapping.pose_extrapolator_interface import (
    create_with_imu_data,
    create_without_imu,
)
from cartographer_tpu_torch.mapping.range_data_collator import RangeDataCollator
from cartographer_tpu_torch.mapping.scan_matching_2d import (
    CeresScanMatcher2D,
    RealTimeCorrelativeScanMatcher2D,
)
from cartographer_tpu_torch.mapping.submap_2d import ActiveSubmaps2D, Submap2D
from cartographer_tpu_torch.mapping.trajectory_node import TrajectoryNodeData
from cartographer_tpu_torch.sensor.data import (
    ImuData,
    OdometryData,
    PointCloud,
    RangeData,
    TimedPointCloudData,
)
from cartographer_tpu_torch.sensor.voxel_filter import adaptive_voxel_filter, voxel_filter
from cartographer_tpu_torch.transform import rigid3


@dataclasses.dataclass
class InsertionResult:
    constant_data: TrajectoryNodeData
    insertion_submaps: List[Submap2D]


@dataclasses.dataclass
class MatchingResult:
    time: Time
    local_pose: np.ndarray  # SE(3) (7,)
    range_data_in_local: RangeData
    insertion_result: Optional[InsertionResult]


class LocalTrajectoryBuilder2D:
    """`device=None` means CUDA; pass device="cpu" to run on the CPU."""

    def __init__(
        self,
        options: TrajectoryBuilder2DOptions,
        expected_range_sensor_ids: Set[str],
        device=None,
    ):
        self._options = options
        self._device = resolve_device(device)
        self._active_submaps = ActiveSubmaps2D(options.submaps, self._device)
        self._motion_filter = MotionFilter(options.motion_filter)
        self._real_time_correlative_scan_matcher = RealTimeCorrelativeScanMatcher2D(
            options.real_time_correlative_scan_matcher
        )
        self._ceres_scan_matcher = CeresScanMatcher2D(options.ceres_scan_matcher)
        self._range_data_collator = RangeDataCollator(expected_range_sensor_ids)
        self._extrapolator = None
        self._num_accumulated = 0
        # Scans of the accumulation not yet unwarped: absolute point times
        # (float64), per-point origins and points of each.
        self._staged_times: List[np.ndarray] = []
        self._staged_origins: List[np.ndarray] = []
        self._staged_points: List[np.ndarray] = []
        self._accum_returns: List[np.ndarray] = []
        self._accum_misses: List[np.ndarray] = []
        self._accumulation_started: Optional[float] = None
        self._last_wall_time: Optional[float] = None
        self._last_sensor_time: Optional[Time] = None

    def to(self, device) -> "LocalTrajectoryBuilder2D":
        """A copy of the builder as it stands, on `device`: the host state
        (extrapolator, motion filter, collator, accumulated scans) copied,
        the submap grids moved."""
        active = self._active_submaps.to(device)
        twin = copy.deepcopy(self, {id(self._active_submaps): active})
        twin._device = active._device
        if isinstance(twin._extrapolator, ImuBasedPoseExtrapolator):
            twin._extrapolator.device = twin._device
        return twin

    # -- sensor feeds -------------------------------------------------------

    def add_imu_data(self, imu_data: ImuData) -> None:
        if not self._options.use_imu_data:
            raise RuntimeError("IMU data provided but use_imu_data=False")
        if self._extrapolator is None:
            self._extrapolator = create_with_imu_data(
                self._options.pose_extrapolator, [imu_data], self._device
            )
        if self._staged_times and imu_data.time <= max(t.max() for t in self._staged_times):
            self._unwarp_staged()  # the staged points were due before this sample
        self._extrapolator.add_imu_data(imu_data)

    def add_odometry_data(self, odometry_data: OdometryData) -> None:
        if self._extrapolator is None:
            return  # Until we've initialized the extrapolator we cannot add odometry.
        if self._staged_times:
            self._unwarp_staged()  # odometry changes the extrapolated velocity
        self._extrapolator.add_odometry_data(odometry_data)

    def add_range_data(
        self, sensor_id: str, unsynchronized_data: TimedPointCloudData
    ) -> Optional[MatchingResult]:
        # Four spans tile the call: unwarp (every subdivision: its staging,
        # and at the accumulation's close the one motion unwarp of what is
        # staged), then per accumulation filter (here and in
        # _add_accumulated_range_data), scan_match and insert.
        with metrics.span("local_slam.unwarp", unsynchronized_data.time):
            synchronized_data = self._range_data_collator.add_range_data(
                sensor_id, unsynchronized_data
            )
            if synchronized_data is None or synchronized_data.points.shape[0] == 0:
                return None
            time = synchronized_data.time
            if not self._options.use_imu_data and self._extrapolator is None:
                self._extrapolator = create_without_imu(
                    self._options.pose_extrapolator, time, self._device
                )
            if self._extrapolator is None:
                # Until we've initialized the extrapolator with our first IMU
                # message, we cannot compute the orientation of the rangefinder.
                return None

            time_first_point = time + float(synchronized_data.times[0])
            if time_first_point < self._extrapolator.get_last_pose_time():
                return None  # Extrapolator is still initializing.

            if self._num_accumulated == 0:
                self._accumulation_started = _walltime.monotonic()
            self._staged_times.append(time + synchronized_data.times.astype(np.float64))
            self._staged_origins.append(
                synchronized_data.origins[synchronized_data.origin_index]
            )
            self._staged_points.append(synchronized_data.points)
            self._num_accumulated += 1
            closes = self._num_accumulated >= self._options.num_accumulated_range_data
            if closes or isinstance(self._extrapolator, ImuBasedPoseExtrapolator):
                last_pose, last_origin_world = self._unwarp_staged()
            if not closes:
                return None
            self._num_accumulated = 0

        with metrics.span("local_slam.filter", time):
            gravity_alignment = self._extrapolator.estimate_gravity_orientation(time)
            accumulated = RangeData(
                origin=last_origin_world.astype(np.float32),
                returns=PointCloud(np.concatenate(self._accum_returns).astype(np.float32)),
                misses=PointCloud(np.concatenate(self._accum_misses).astype(np.float32)),
            )
            self._accum_returns = []
            self._accum_misses = []

            # Transform into the gravity-aligned frame at the last pose.
            to_gravity = rigid3.compose(
                rigid3.rotation(gravity_alignment), rigid3.inverse(last_pose)
            )
            gravity_aligned = accumulated.transform(to_gravity)
            cropped = gravity_aligned.crop(self._options.min_z, self._options.max_z)
            filtered = RangeData(
                origin=cropped.origin,
                returns=voxel_filter(cropped.returns, self._options.voxel_filter_size),
                misses=voxel_filter(cropped.misses, self._options.voxel_filter_size),
            )
        return self._add_accumulated_range_data(time, filtered, gravity_alignment)

    def _unwarp_staged(self):
        """Per-point motion unwarp (local_trajectory_builder_2d.cc:139-155) of
        the staged scans in one extrapolator call, vectorized over their
        points; their returns and misses join the accumulation. Returns the
        last point's pose and origin in the local frame."""
        metrics.local_slam_subdivisions_per_unwarp.set(len(self._staged_times))
        times = np.concatenate(self._staged_times)
        origins_local = np.concatenate(self._staged_origins)
        points = np.concatenate(self._staged_points)
        self._staged_times, self._staged_origins, self._staged_points = [], [], []
        point_times = np.maximum(times, self._extrapolator.get_last_extrapolated_time())
        point_times = np.maximum.accumulate(point_times)
        range_data_poses = self._extrapolator.extrapolate_poses_batch(point_times)

        origins_world = (
            rigid3.quat_rotate(range_data_poses[:, 3:7], origins_local.astype(np.float64))
            + range_data_poses[:, :3]
        )
        hits_world = (
            rigid3.quat_rotate(range_data_poses[:, 3:7], points.astype(np.float64))
            + range_data_poses[:, :3]
        )
        delta = hits_world - origins_world
        ranges = np.linalg.norm(delta, axis=1)
        keep = ranges >= self._options.min_range
        as_return = keep & (ranges <= self._options.max_range)
        as_miss = keep & ~as_return
        self._accum_returns.append(hits_world[as_return])
        with np.errstate(invalid="ignore", divide="ignore"):
            scale = self._options.missing_data_ray_length / np.maximum(ranges, 1e-12)
        miss_pts = origins_world + scale[:, None] * delta
        self._accum_misses.append(miss_pts[as_miss])
        return range_data_poses[-1], origins_world[-1]

    # -- core matching ------------------------------------------------------

    def _add_accumulated_range_data(
        self,
        time: Time,
        gravity_aligned_range_data: RangeData,
        gravity_alignment: np.ndarray,
    ) -> Optional[MatchingResult]:
        with metrics.span("local_slam.filter", time):
            if gravity_aligned_range_data.returns.size == 0:
                return None

            non_gravity_aligned_pose_prediction = self._extrapolator.extrapolate_pose(time)
            pose_prediction = rigid3.project_2d(
                rigid3.compose(
                    non_gravity_aligned_pose_prediction,
                    rigid3.inverse(rigid3.rotation(gravity_alignment)),
                )
            )

            filtered_gravity_aligned_point_cloud = adaptive_voxel_filter(
                gravity_aligned_range_data.returns, self._options.adaptive_voxel_filter
            )
        if filtered_gravity_aligned_point_cloud.size == 0:
            return None

        with metrics.span("local_slam.scan_match", time):
            pose_estimate_2d = self._scan_match(
                pose_prediction, filtered_gravity_aligned_point_cloud
            )
        with metrics.span("local_slam.insert", time):
            pose_estimate = rigid3.compose(
                rigid3.embed_3d(pose_estimate_2d), rigid3.rotation(gravity_alignment)
            )
            self._extrapolator.add_pose(time, pose_estimate)

            range_data_in_local = gravity_aligned_range_data.transform(
                rigid3.embed_3d(pose_estimate_2d)
            )
            insertion_result = self._insert_into_submap(
                time,
                range_data_in_local,
                filtered_gravity_aligned_point_cloud,
                pose_estimate,
                gravity_alignment,
            )

            wall_time = _walltime.monotonic()
            if self._last_wall_time is not None:
                metrics.local_slam_latency.set(wall_time - self._accumulation_started)
                wall_duration = wall_time - self._last_wall_time
                if self._last_sensor_time is not None and wall_duration > 0:
                    metrics.local_slam_real_time_ratio.set(
                        (time - self._last_sensor_time) / wall_duration
                    )
            self._last_wall_time = wall_time
            self._last_sensor_time = time

            return MatchingResult(
                time=time,
                local_pose=pose_estimate,
                range_data_in_local=range_data_in_local,
                insertion_result=insertion_result,
            )

    def _scan_match(
        self, pose_prediction: np.ndarray, filtered_cloud: PointCloud
    ) -> np.ndarray:
        submaps = self._active_submaps.submaps()
        if not submaps:
            return pose_prediction
        matching_submap = submaps[0]
        initial = pose_prediction
        if self._options.use_online_correlative_scan_matching:
            _, initial = self._real_time_correlative_scan_matcher.match(
                pose_prediction, filtered_cloud.points, matching_submap.grid
            )
        pose, _ = self._ceres_scan_matcher.match(
            pose_prediction[:2], initial, filtered_cloud.points, matching_submap.grid
        )
        return pose

    def _insert_into_submap(
        self,
        time: Time,
        range_data_in_local: RangeData,
        filtered_gravity_aligned_point_cloud: PointCloud,
        pose_estimate: np.ndarray,
        gravity_alignment: np.ndarray,
    ) -> Optional[InsertionResult]:
        if self._motion_filter.is_similar(time, pose_estimate):
            return None
        insertion_submaps = self._active_submaps.insert_range_data(range_data_in_local)
        return InsertionResult(
            constant_data=TrajectoryNodeData(
                time=time,
                gravity_alignment=gravity_alignment,
                filtered_gravity_aligned_point_cloud=(
                    filtered_gravity_aligned_point_cloud.points
                ),
                local_pose=pose_estimate,
            ),
            insertion_submaps=insertion_submaps,
        )
