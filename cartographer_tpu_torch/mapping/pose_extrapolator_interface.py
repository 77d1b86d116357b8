"""Pose extrapolator factory (reference: mapping/pose_extrapolator_interface.cc
— choose constant-velocity vs IMU-based from options).

Port of cartographer_tpu/mapping/pose_extrapolator_interface.py. The
IMU-based extrapolator solves its window on `device` (the builder's;
None means CUDA); the constant-velocity one is host-only.
"""

from __future__ import annotations

from typing import List

from cartographer_tpu_torch.common.config import PoseExtrapolatorOptions
from cartographer_tpu_torch.mapping.imu_based_pose_extrapolator import (
    ImuBasedPoseExtrapolator,
)
from cartographer_tpu_torch.mapping.pose_extrapolator import PoseExtrapolator
from cartographer_tpu_torch.sensor.data import ImuData
from cartographer_tpu_torch.transform import rigid3


def create_with_imu_data(
    options: PoseExtrapolatorOptions, imu_data: List[ImuData], device=None
):
    if options.use_imu_based:
        extrapolator = ImuBasedPoseExtrapolator(options.imu_based, device=device)
        extrapolator.add_pose(imu_data[-1].time, rigid3.identity())
        for d in imu_data:
            extrapolator.add_imu_data(d)
        return extrapolator
    return PoseExtrapolator.initialize_with_imu(
        options.constant_velocity.pose_queue_duration,
        options.constant_velocity.imu_gravity_time_constant,
        imu_data[-1],
    )


def create_without_imu(options: PoseExtrapolatorOptions, time: float, device=None):
    if options.use_imu_based:
        extrapolator = ImuBasedPoseExtrapolator(options.imu_based, device=device)
        extrapolator.add_pose(time, rigid3.identity())
        return extrapolator
    extrapolator = PoseExtrapolator(
        options.constant_velocity.pose_queue_duration,
        options.constant_velocity.imu_gravity_time_constant,
    )
    extrapolator.add_pose(time, rigid3.identity())
    return extrapolator
