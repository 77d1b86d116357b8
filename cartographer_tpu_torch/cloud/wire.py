"""Wire encoding for the cloud layer.

Port of cartographer_tpu/cloud/wire.py.

Reference: cloud/internal/{sensor,mapping}/serialization.cc convert sensor
data to protos for the 25-RPC MapBuilderService
(cloud/proto/map_builder_service.proto:255-353). Here every message is a
tagged npz payload (same codec as io/serialization.py) carried over gRPC
generic (bytes) methods — no generated stubs needed. The service name
and the method paths live here, so the client side imports neither the
server nor the MapBuilder.
"""

from __future__ import annotations

import io as _io
import json
from typing import Any, Dict, Tuple

import numpy as np

from cartographer_tpu_torch.sensor.data import (
    FixedFramePoseData,
    ImuData,
    LandmarkData,
    LandmarkObservation,
    OdometryData,
    TimedPointCloud,
    TimedPointCloudData,
)


# The JAX package's service name, byte for byte: either package's stub
# drives either package's server.
SERVICE = "cartographer_tpu.MapBuilderService"


def method_path(name: str) -> str:
    return f"/{SERVICE}/{name}"


def encode(kind: str, meta: Dict[str, Any], arrays: Dict[str, np.ndarray]) -> bytes:
    buf = _io.BytesIO()
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    payload["__meta__"] = np.frombuffer(
        json.dumps({"kind": kind, **meta}).encode(), dtype=np.uint8
    )
    np.savez(buf, **payload)
    return buf.getvalue()


def decode(data: bytes) -> Tuple[str, Dict[str, Any], Dict[str, np.ndarray]]:
    npz = np.load(_io.BytesIO(data), allow_pickle=False)
    meta = json.loads(bytes(npz["__meta__"]).decode())
    arrays = {k: npz[k] for k in npz.files if k != "__meta__"}
    return meta.pop("kind"), meta, arrays


def encode_sensor_data(sensor_id: str, data) -> bytes:
    if isinstance(data, TimedPointCloudData):
        return encode(
            "timed_point_cloud",
            {"sensor_id": sensor_id, "time": data.time},
            {
                "origin": data.origin,
                "points": data.ranges.points,
                "times": data.ranges.times,
                **(
                    {"intensities": data.intensities}
                    if data.intensities is not None
                    else {}
                ),
            },
        )
    if isinstance(data, ImuData):
        return encode(
            "imu",
            {"sensor_id": sensor_id, "time": data.time},
            {
                "linear_acceleration": data.linear_acceleration,
                "angular_velocity": data.angular_velocity,
            },
        )
    if isinstance(data, OdometryData):
        return encode(
            "odometry",
            {"sensor_id": sensor_id, "time": data.time},
            {"pose": data.pose},
        )
    if isinstance(data, FixedFramePoseData):
        return encode(
            "fixed_frame_pose",
            {"sensor_id": sensor_id, "time": data.time, "has_pose": data.pose is not None},
            {"pose": data.pose} if data.pose is not None else {},
        )
    if isinstance(data, LandmarkData):
        obs = data.landmark_observations
        return encode(
            "landmark",
            {
                "sensor_id": sensor_id,
                "time": data.time,
                "ids": [o.id for o in obs],
                "translation_weights": [float(o.translation_weight) for o in obs],
                "rotation_weights": [float(o.rotation_weight) for o in obs],
            },
            {
                "transforms": np.stack(
                    [np.asarray(o.landmark_to_tracking_transform) for o in obs]
                )
                if obs
                else np.zeros((0, 7)),
            },
        )
    raise TypeError(f"unsupported sensor data {type(data)}")


def decode_sensor_data(payload: bytes):
    kind, meta, arrays = decode(payload)
    sensor_id = meta["sensor_id"]
    if kind == "timed_point_cloud":
        return sensor_id, TimedPointCloudData(
            time=meta["time"],
            origin=arrays["origin"],
            ranges=TimedPointCloud(points=arrays["points"], times=arrays["times"]),
            intensities=arrays.get("intensities"),
        )
    if kind == "imu":
        return sensor_id, ImuData(
            time=meta["time"],
            linear_acceleration=arrays["linear_acceleration"],
            angular_velocity=arrays["angular_velocity"],
        )
    if kind == "odometry":
        return sensor_id, OdometryData(time=meta["time"], pose=arrays["pose"])
    if kind == "fixed_frame_pose":
        return sensor_id, FixedFramePoseData(
            time=meta["time"],
            pose=arrays.get("pose") if meta["has_pose"] else None,
        )
    if kind == "landmark":
        return sensor_id, LandmarkData(
            time=meta["time"],
            landmark_observations=[
                LandmarkObservation(
                    id=lid,
                    landmark_to_tracking_transform=arrays["transforms"][i],
                    translation_weight=meta["translation_weights"][i],
                    rotation_weight=meta["rotation_weights"][i],
                )
                for i, lid in enumerate(meta["ids"])
            ],
        )
    raise ValueError(f"unknown sensor payload kind {kind}")
