"""Constant-velocity pose extrapolation with IMU/odometry fusion.

Copy of cartographer_tpu/mapping/pose_extrapolator.py.

Reference: mapping/pose_extrapolator.cc:35-262. Velocity comes from the pose
history (or odometry when available); rotation comes from the ImuTracker
(gyro + gravity EMA), with fake gravity + pose-derived angular velocity when
no IMU is present. `extrapolate_poses_with_gravity` vectorizes the per-point
queries the 3D frontend needs.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, List, Optional, Sequence

import numpy as np

from cartographer_tpu_torch.common.time import TIME_MIN, Time
from cartographer_tpu_torch.mapping.imu_tracker import ImuTracker
from cartographer_tpu_torch.sensor.data import ImuData, OdometryData
from cartographer_tpu_torch.transform import rigid3


@dataclasses.dataclass
class TimedPose:
    time: Time
    pose: np.ndarray  # SE(3) (7,)


@dataclasses.dataclass
class ExtrapolationResult:
    previous_poses: List[np.ndarray]
    current_pose: np.ndarray
    current_velocity: np.ndarray
    gravity_from_tracking: np.ndarray  # quaternion


class PoseExtrapolator:
    def __init__(self, pose_queue_duration: float, imu_gravity_time_constant: float):
        self._pose_queue_duration = pose_queue_duration
        self._gravity_time_constant = imu_gravity_time_constant
        self._timed_pose_queue: Deque[TimedPose] = collections.deque()
        self._imu_data: Deque[ImuData] = collections.deque()
        self._odometry_data: Deque[OdometryData] = collections.deque()
        self._imu_tracker: Optional[ImuTracker] = None
        self._odometry_imu_tracker: Optional[ImuTracker] = None
        self._extrapolation_imu_tracker: Optional[ImuTracker] = None
        self._linear_velocity_from_poses = np.zeros(3)
        self._angular_velocity_from_poses = np.zeros(3)
        self._linear_velocity_from_odometry = np.zeros(3)
        self._angular_velocity_from_odometry = np.zeros(3)
        self._cached_extrapolated_pose = TimedPose(TIME_MIN, rigid3.identity())

    @staticmethod
    def initialize_with_imu(
        pose_queue_duration: float,
        imu_gravity_time_constant: float,
        imu_data: ImuData,
    ) -> "PoseExtrapolator":
        extrapolator = PoseExtrapolator(pose_queue_duration, imu_gravity_time_constant)
        extrapolator.add_imu_data(imu_data)
        tracker = ImuTracker(imu_gravity_time_constant, imu_data.time)
        tracker.add_imu_linear_acceleration_observation(imu_data.linear_acceleration)
        tracker.add_imu_angular_velocity_observation(imu_data.angular_velocity)
        tracker.advance(imu_data.time)
        extrapolator._imu_tracker = tracker
        extrapolator.add_pose(
            imu_data.time, rigid3.rotation(tracker.orientation())
        )
        return extrapolator

    # -- feeds --------------------------------------------------------------

    def get_last_pose_time(self) -> Time:
        if not self._timed_pose_queue:
            return TIME_MIN
        return self._timed_pose_queue[-1].time

    def get_last_extrapolated_time(self) -> Time:
        if self._extrapolation_imu_tracker is None:
            return TIME_MIN
        return self._extrapolation_imu_tracker.time

    def add_pose(self, time: Time, pose: np.ndarray) -> None:
        if self._imu_tracker is None:
            tracker_start = time
            if self._imu_data:
                tracker_start = min(tracker_start, self._imu_data[0].time)
            self._imu_tracker = ImuTracker(self._gravity_time_constant, tracker_start)
        self._timed_pose_queue.append(TimedPose(time, np.asarray(pose)))
        while (
            len(self._timed_pose_queue) > 2
            and self._timed_pose_queue[1].time <= time - self._pose_queue_duration
        ):
            self._timed_pose_queue.popleft()
        self._update_velocities_from_poses()
        self._advance_imu_tracker(time, self._imu_tracker)
        self._trim_imu_data()
        self._trim_odometry_data()
        self._odometry_imu_tracker = self._imu_tracker.copy()
        self._extrapolation_imu_tracker = self._imu_tracker.copy()

    def add_imu_data(self, imu_data: ImuData) -> None:
        assert (
            not self._timed_pose_queue
            or imu_data.time >= self._timed_pose_queue[-1].time
        )
        self._imu_data.append(imu_data)
        self._trim_imu_data()

    def add_odometry_data(self, odometry_data: OdometryData) -> None:
        assert (
            not self._timed_pose_queue
            or odometry_data.time >= self._timed_pose_queue[-1].time
        )
        self._odometry_data.append(odometry_data)
        self._trim_odometry_data()
        if len(self._odometry_data) < 2:
            return
        # Velocities from the endpoints of the odometry queue
        # (pose_extrapolator.cc:100-135).
        odometry_oldest = self._odometry_data[0]
        odometry_newest = self._odometry_data[-1]
        odometry_time_delta = odometry_oldest.time - odometry_newest.time
        odometry_pose_delta = rigid3.compose(
            rigid3.inverse(odometry_newest.pose), odometry_oldest.pose
        )
        self._angular_velocity_from_odometry = (
            rigid3.quat_to_angle_axis(rigid3.quat(odometry_pose_delta))
            / odometry_time_delta
        )
        if not self._timed_pose_queue:
            return
        linear_velocity_in_tracking_frame = (
            rigid3.trans(odometry_pose_delta) / odometry_time_delta
        )
        orientation_at_newest_odometry_time = rigid3.quat_multiply(
            rigid3.quat(self._timed_pose_queue[-1].pose),
            self._extrapolate_rotation(odometry_newest.time, self._odometry_imu_tracker),
        )
        self._linear_velocity_from_odometry = rigid3.quat_rotate(
            orientation_at_newest_odometry_time, linear_velocity_in_tracking_frame
        )

    # -- queries ------------------------------------------------------------

    def extrapolate_pose(self, time: Time) -> np.ndarray:
        newest_timed_pose = self._timed_pose_queue[-1]
        assert time >= newest_timed_pose.time
        if self._cached_extrapolated_pose.time != time:
            translation = self._extrapolate_translation(time) + rigid3.trans(
                newest_timed_pose.pose
            )
            rotation = rigid3.quat_multiply(
                rigid3.quat(newest_timed_pose.pose),
                self._extrapolate_rotation(time, self._extrapolation_imu_tracker),
            )
            self._cached_extrapolated_pose = TimedPose(
                time, rigid3.make(translation, rigid3.quat_normalize(rotation))
            )
        return self._cached_extrapolated_pose.pose

    def extrapolate_poses_with_gravity(
        self, times: Sequence[Time]
    ) -> ExtrapolationResult:
        poses = list(self.extrapolate_poses_batch(times[:-1]))
        current_velocity = (
            self._linear_velocity_from_poses
            if len(self._odometry_data) < 2
            else self._linear_velocity_from_odometry
        )
        return ExtrapolationResult(
            previous_poses=poses,
            current_pose=self.extrapolate_pose(times[-1]),
            current_velocity=current_velocity,
            gravity_from_tracking=self.estimate_gravity_orientation(times[-1]),
        )

    def extrapolate_poses_batch(self, times: Sequence[Time]) -> np.ndarray:
        """Vectorized ExtrapolatePose over sorted times (the per-point motion
        unwarp). Orientation: one sequential walk over the few IMU samples in
        the window records (time, orientation, angular velocity) breakpoints,
        then every query is orientation = q_bp * exp(w * dt) in one batched
        quaternion op. Within-batch fake-gravity EMA corrections (10 s time
        constant vs <0.2 s scan) are deferred to the breakpoints, which is
        where the reference applies real IMU corrections too."""
        times = np.asarray(list(times), dtype=np.float64)
        if times.size == 0:
            return np.zeros((0, 7))
        newest = self._timed_pose_queue[-1]
        assert times[0] >= newest.time - 1e-9

        # Breakpoint walk with a throwaway tracker.
        tracker = self._extrapolation_imu_tracker.copy()
        last_orientation = self._imu_tracker.orientation()
        bp_times = [tracker.time]
        bp_quats = [tracker.orientation().copy()]
        bp_omegas = [tracker._imu_angular_velocity.copy()]
        if self._imu_data and times[-1] >= self._imu_data[0].time:
            if tracker.time < self._imu_data[0].time:
                tracker.advance(self._imu_data[0].time)
            for imu in self._imu_data:
                if imu.time < tracker.time:
                    continue
                if imu.time >= times[-1]:
                    break
                tracker.advance(imu.time)
                tracker.add_imu_linear_acceleration_observation(
                    imu.linear_acceleration
                )
                tracker.add_imu_angular_velocity_observation(imu.angular_velocity)
                bp_times.append(tracker.time)
                bp_quats.append(tracker.orientation().copy())
                bp_omegas.append(tracker._imu_angular_velocity.copy())
        else:
            # No IMU in window: constant angular velocity from poses/odometry.
            omega = (
                self._angular_velocity_from_poses
                if len(self._odometry_data) < 2
                else self._angular_velocity_from_odometry
            )
            bp_omegas = [np.asarray(omega, np.float64)]

        bp_times_arr = np.asarray(bp_times)
        idx = np.clip(
            np.searchsorted(bp_times_arr, times, side="right") - 1, 0, len(bp_times) - 1
        )
        dt = times - bp_times_arr[idx]
        q_bp = np.asarray(bp_quats)[idx]
        w_bp = np.asarray(bp_omegas)[idx]
        q_t = rigid3.quat_normalize(
            rigid3.quat_multiply(q_bp, rigid3.quat_from_angle_axis(w_bp * dt[:, None]))
        )
        q_rel = rigid3.quat_multiply(
            rigid3.quat_conjugate(last_orientation)[None, :], q_t
        )
        rotation = rigid3.quat_normalize(
            rigid3.quat_multiply(rigid3.quat(newest.pose)[None, :], q_rel)
        )

        velocity = (
            self._linear_velocity_from_poses
            if len(self._odometry_data) < 2
            else self._linear_velocity_from_odometry
        )
        translation = rigid3.trans(newest.pose)[None, :] + np.outer(
            times - newest.time, velocity
        )
        # Advance the cached extrapolation tracker to the end of the batch so
        # subsequent scalar queries continue from here.
        self._advance_imu_tracker(float(times[-1]), self._extrapolation_imu_tracker)
        return np.concatenate([translation, rotation], axis=1)

    def estimate_gravity_orientation(self, time: Time) -> np.ndarray:
        imu_tracker = self._imu_tracker.copy()
        self._advance_imu_tracker(time, imu_tracker)
        return imu_tracker.orientation()

    # -- internals ----------------------------------------------------------

    def _update_velocities_from_poses(self) -> None:
        if len(self._timed_pose_queue) < 2:
            return
        newest = self._timed_pose_queue[-1]
        oldest = self._timed_pose_queue[0]
        queue_delta = newest.time - oldest.time
        if queue_delta < self._pose_queue_duration:
            return
        self._linear_velocity_from_poses = (
            rigid3.trans(newest.pose) - rigid3.trans(oldest.pose)
        ) / queue_delta
        self._angular_velocity_from_poses = (
            rigid3.quat_to_angle_axis(
                rigid3.quat_multiply(
                    rigid3.quat_conjugate(rigid3.quat(oldest.pose)),
                    rigid3.quat(newest.pose),
                )
            )
            / queue_delta
        )

    def _trim_imu_data(self) -> None:
        while (
            len(self._imu_data) > 1
            and self._timed_pose_queue
            and self._imu_data[1].time <= self._timed_pose_queue[-1].time
        ):
            self._imu_data.popleft()

    def _trim_odometry_data(self) -> None:
        while (
            len(self._odometry_data) > 2
            and self._timed_pose_queue
            and self._odometry_data[1].time <= self._timed_pose_queue[-1].time
        ):
            self._odometry_data.popleft()

    def _advance_imu_tracker(self, time: Time, imu_tracker: ImuTracker) -> None:
        assert time >= imu_tracker.time
        if not self._imu_data or time < self._imu_data[0].time:
            # No IMU data until `time`: fake gravity + angular velocity from
            # poses/odometry for 2D stability (pose_extrapolator.cc:201-210).
            imu_tracker.advance(time)
            imu_tracker.add_imu_linear_acceleration_observation(
                np.array([0.0, 0.0, 1.0])
            )
            imu_tracker.add_imu_angular_velocity_observation(
                self._angular_velocity_from_poses
                if len(self._odometry_data) < 2
                else self._angular_velocity_from_odometry
            )
            return
        if imu_tracker.time < self._imu_data[0].time:
            imu_tracker.advance(self._imu_data[0].time)
        for imu_data in self._imu_data:
            if imu_data.time < imu_tracker.time:
                continue
            if imu_data.time >= time:
                break
            imu_tracker.advance(imu_data.time)
            imu_tracker.add_imu_linear_acceleration_observation(
                imu_data.linear_acceleration
            )
            imu_tracker.add_imu_angular_velocity_observation(imu_data.angular_velocity)
        imu_tracker.advance(time)

    def _extrapolate_rotation(self, time: Time, imu_tracker: ImuTracker) -> np.ndarray:
        assert time >= imu_tracker.time
        self._advance_imu_tracker(time, imu_tracker)
        last_orientation = self._imu_tracker.orientation()
        return rigid3.quat_multiply(
            rigid3.quat_conjugate(last_orientation), imu_tracker.orientation()
        )

    def _extrapolate_translation(self, time: Time) -> np.ndarray:
        newest_timed_pose = self._timed_pose_queue[-1]
        extrapolation_delta = time - newest_timed_pose.time
        if len(self._odometry_data) < 2:
            return extrapolation_delta * self._linear_velocity_from_poses
        return extrapolation_delta * self._linear_velocity_from_odometry
