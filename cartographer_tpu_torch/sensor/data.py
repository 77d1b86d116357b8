"""Typed sensor data containers.

Reference: cartographer/sensor/{rangefinder_point.h:31, point_cloud.h:33,
range_data.h:32, timed_point_cloud_data.h:27, imu_data.h, odometry_data.h,
fixed_frame_pose_data.h, landmark_data.h}.

Array-first: a point cloud is a float numpy array (N, D) plus optional
parallel arrays (intensities, per-point relative times). Dispatch of typed
data into the trajectory builder (reference sensor/data.h double dispatch)
is done by isinstance checks host-side — the data plane stays arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from cartographer_tpu_torch.common.time import Time
from cartographer_tpu_torch.transform import rigid3


@dataclasses.dataclass
class PointCloud:
    """Points (N, 3) float32 in a sensor/tracking frame, optional intensities.

    2D processing still stores 3D positions (the reference keeps z for
    gravity alignment and z-crops before 2D matching).
    """

    points: np.ndarray  # (N, 3) float32
    intensities: Optional[np.ndarray] = None  # (N,) float32

    def __post_init__(self):
        self.points = np.asarray(self.points, dtype=np.float32).reshape(-1, 3)
        if self.intensities is not None:
            self.intensities = np.asarray(self.intensities, dtype=np.float32)

    @property
    def size(self) -> int:
        return self.points.shape[0]

    def __len__(self) -> int:
        return self.points.shape[0]

    def transform(self, pose3: np.ndarray) -> "PointCloud":
        if self.size == 0:
            return PointCloud(self.points.copy(), None if self.intensities is None else self.intensities.copy())
        pts = rigid3.apply(np.asarray(pose3, dtype=np.float64), self.points.astype(np.float64))
        return PointCloud(pts.astype(np.float32), self.intensities)

    def select(self, mask: np.ndarray) -> "PointCloud":
        return PointCloud(
            self.points[mask],
            None if self.intensities is None else self.intensities[mask],
        )


@dataclasses.dataclass
class TimedPointCloud:
    """Points (N, 3) with per-point relative times (N,) — final point has
    time 0, earlier points negative (reference timed_point_cloud_data.h)."""

    points: np.ndarray  # (N, 3) float32
    times: np.ndarray  # (N,) float32, relative seconds (<= 0)
    intensities: Optional[np.ndarray] = None

    def __post_init__(self):
        self.points = np.asarray(self.points, dtype=np.float32).reshape(-1, 3)
        self.times = np.asarray(self.times, dtype=np.float32).reshape(-1)
        if self.intensities is not None:
            self.intensities = np.asarray(self.intensities, dtype=np.float32)

    @property
    def size(self) -> int:
        return self.points.shape[0]


@dataclasses.dataclass
class TimedPointCloudData:
    """One rangefinder delivery: absolute time of the LAST point, the sensor
    origin in the tracking frame, and the timed cloud."""

    time: Time
    origin: np.ndarray  # (3,) float32
    ranges: TimedPointCloud
    # Empty unless the sensor produces intensities.
    intensities: Optional[np.ndarray] = None


@dataclasses.dataclass
class TimedPointCloudOriginData:
    """Multiple synchronized rangefinder deliveries merged by time
    (reference timed_point_cloud_data.h:35). origin_index maps each point to
    its origin."""

    time: Time
    origins: np.ndarray  # (K, 3) float32
    points: np.ndarray  # (N, 3) float32
    times: np.ndarray  # (N,) float32 relative to `time`
    origin_index: np.ndarray  # (N,) int32
    intensities: Optional[np.ndarray] = None


@dataclasses.dataclass
class RangeData:
    """{origin, returns, misses} in a common frame (reference range_data.h:32)."""

    origin: np.ndarray  # (3,) float32
    returns: PointCloud
    misses: PointCloud

    def transform(self, pose3: np.ndarray) -> "RangeData":
        origin = rigid3.apply(np.asarray(pose3, np.float64), self.origin.reshape(1, 3).astype(np.float64))[0]
        return RangeData(
            origin=origin.astype(np.float32),
            returns=self.returns.transform(pose3),
            misses=self.misses.transform(pose3),
        )

    def crop(self, min_z: float, max_z: float) -> "RangeData":
        def crop_cloud(c: PointCloud) -> PointCloud:
            if c.size == 0:
                return c
            mask = (c.points[:, 2] >= min_z) & (c.points[:, 2] <= max_z)
            return c.select(mask)

        return RangeData(self.origin, crop_cloud(self.returns), crop_cloud(self.misses))


@dataclasses.dataclass
class ImuData:
    time: Time
    linear_acceleration: np.ndarray  # (3,)
    angular_velocity: np.ndarray  # (3,)


@dataclasses.dataclass
class OdometryData:
    time: Time
    pose: np.ndarray  # SE(3) (7,)


@dataclasses.dataclass
class FixedFramePoseData:
    """GPS-like pose in a fixed frame; pose may be missing (invalid fix)."""

    time: Time
    pose: Optional[np.ndarray]  # SE(3) (7,) or None


@dataclasses.dataclass
class LandmarkObservation:
    id: str
    landmark_to_tracking_transform: np.ndarray  # SE(3) (7,)
    translation_weight: float
    rotation_weight: float


@dataclasses.dataclass
class LandmarkData:
    time: Time
    landmark_observations: list


def empty_point_cloud() -> PointCloud:
    return PointCloud(np.zeros((0, 3), dtype=np.float32))
