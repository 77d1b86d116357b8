"""Pose extrapolator factory (reference: mapping/pose_extrapolator_interface.cc
— choose constant-velocity vs IMU-based from options).

Port of cartographer_tpu/mapping/pose_extrapolator_interface.py for the
constant-velocity extrapolator. The IMU-based one builds on the 3D
backend (its IMU integration and SPA) and comes with a later slice of the
port; it raises NotImplementedError until then.
"""

from __future__ import annotations

from typing import List

from cartographer_tpu_torch.common.config import PoseExtrapolatorOptions
from cartographer_tpu_torch.mapping.pose_extrapolator import PoseExtrapolator
from cartographer_tpu_torch.sensor.data import ImuData
from cartographer_tpu_torch.transform import rigid3


def _require_constant_velocity(options: PoseExtrapolatorOptions) -> None:
    if options.use_imu_based:
        raise NotImplementedError(
            "the IMU-based pose extrapolator (use_imu_based=True) is not "
            "ported yet; it comes with a later slice of the port"
        )


def create_with_imu_data(
    options: PoseExtrapolatorOptions, imu_data: List[ImuData]
):
    _require_constant_velocity(options)
    return PoseExtrapolator.initialize_with_imu(
        options.constant_velocity.pose_queue_duration,
        options.constant_velocity.imu_gravity_time_constant,
        imu_data[-1],
    )


def create_without_imu(options: PoseExtrapolatorOptions, time: float):
    _require_constant_velocity(options)
    extrapolator = PoseExtrapolator(
        options.constant_velocity.pose_queue_duration,
        options.constant_velocity.imu_gravity_time_constant,
    )
    extrapolator.add_pose(time, rigid3.identity())
    return extrapolator
