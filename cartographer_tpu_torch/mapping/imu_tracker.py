"""IMU orientation tracking (reference: mapping/imu_tracker.cc:30-74).

Copy of cartographer_tpu/mapping/imu_tracker.py.

Keeps orientation by integrating gyro angular velocity and correcting toward
the gravity direction estimated as an exponential moving average of the
accelerometer. Host-side numpy: this is sequential control-plane state with
trivial arithmetic (the reference runs it inline on the sensor thread too).
"""

from __future__ import annotations

import math

import numpy as np

from cartographer_tpu_torch.common.time import TIME_MIN, Time
from cartographer_tpu_torch.transform import rigid3


class ImuTracker:
    def __init__(self, imu_gravity_time_constant: float, time: Time):
        self._imu_gravity_time_constant = imu_gravity_time_constant
        self._time = time
        self._last_linear_acceleration_time: Time = TIME_MIN
        self._orientation = np.array([1.0, 0.0, 0.0, 0.0])
        self._gravity_vector = np.array([0.0, 0.0, 1.0])
        self._imu_angular_velocity = np.zeros(3)

    def copy(self) -> "ImuTracker":
        out = ImuTracker(self._imu_gravity_time_constant, self._time)
        out._last_linear_acceleration_time = self._last_linear_acceleration_time
        out._orientation = self._orientation.copy()
        out._gravity_vector = self._gravity_vector.copy()
        out._imu_angular_velocity = self._imu_angular_velocity.copy()
        return out

    @property
    def time(self) -> Time:
        return self._time

    def orientation(self) -> np.ndarray:
        """Current orientation quaternion [w, x, y, z]."""
        return self._orientation

    def advance(self, time: Time) -> None:
        assert time >= self._time
        delta_t = time - self._time
        rotation = rigid3.quat_from_angle_axis(self._imu_angular_velocity * delta_t)
        self._orientation = rigid3.quat_normalize(
            rigid3.quat_multiply(self._orientation, rotation)
        )
        self._gravity_vector = rigid3.quat_rotate(
            rigid3.quat_conjugate(rotation), self._gravity_vector
        )
        self._time = time

    def add_imu_linear_acceleration_observation(self, linear_acceleration) -> None:
        linear_acceleration = np.asarray(linear_acceleration, dtype=np.float64)
        delta_t = (
            self._time - self._last_linear_acceleration_time
            if self._last_linear_acceleration_time > TIME_MIN
            else float("inf")
        )
        self._last_linear_acceleration_time = self._time
        alpha = 1.0 - math.exp(-delta_t / self._imu_gravity_time_constant)
        self._gravity_vector = (
            1.0 - alpha
        ) * self._gravity_vector + alpha * linear_acceleration
        # Rotate orientation so it agrees with the gravity estimate.
        rotation = rigid3.quat_from_two_vectors(
            self._gravity_vector,
            rigid3.quat_rotate(
                rigid3.quat_conjugate(self._orientation), np.array([0.0, 0.0, 1.0])
            ),
        )
        self._orientation = rigid3.quat_normalize(
            rigid3.quat_multiply(self._orientation, rotation)
        )

    def add_imu_angular_velocity_observation(self, angular_velocity) -> None:
        self._imu_angular_velocity = np.asarray(angular_velocity, dtype=np.float64)
