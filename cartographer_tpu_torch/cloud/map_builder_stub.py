"""Client stub: the MapBuilder interface over the wire.

Port of cartographer_tpu/cloud/map_builder_stub.py.

Reference: cloud/client/map_builder_stub.{h:30,cc} and
cloud/internal/client/trajectory_builder_stub.h:38, pose_graph_stub.h:26 —
the full MapBuilderInterface implemented via RPCs.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Set

import grpc
import numpy as np

from cartographer_tpu_torch.cloud import wire
from cartographer_tpu_torch.common.config import TrajectoryBuilderOptions
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.sensor.data import (
    FixedFramePoseData,
    ImuData,
    LandmarkData,
    OdometryData,
    TimedPointCloudData,
)

# Sensor type -> client-streaming RPC, as in
# cloud/internal/client/trajectory_builder_stub.cc (one write stream per
# sensor type).
_STREAM_METHOD = {
    TimedPointCloudData: "AddRangefinderData",
    ImuData: "AddImuData",
    OdometryData: "AddOdometryData",
    FixedFramePoseData: "AddFixedFramePoseData",
    LandmarkData: "AddLandmarkData",
}

_CLOSE = object()


class _SensorStreamWriter:
    """One client-side write stream: a queue drained by the gRPC
    stream-unary call (reference: async_grpc client writers)."""

    def __init__(self, channel: grpc.Channel, method: str):
        self._queue: queue.Queue = queue.Queue()
        callable_ = channel.stream_unary(
            wire.method_path(method), request_serializer=None, response_deserializer=None
        )
        self._future = callable_.future(self._drain())

    def _drain(self):
        while True:
            item = self._queue.get()
            if item is _CLOSE:
                return
            yield item

    def write(self, request: bytes) -> None:
        self._queue.put(request)

    def close(self) -> None:
        self._queue.put(_CLOSE)
        try:
            self._future.result(timeout=60.0)
        except grpc.RpcError:
            pass


class TrajectoryBuilderStub:
    def __init__(self, parent: "MapBuilderStub", trajectory_id: int):
        self._parent = parent
        self._trajectory_id = trajectory_id
        self._writers: Dict[str, _SensorStreamWriter] = {}

    def add_sensor_data(self, sensor_id: str, data) -> None:
        method = _STREAM_METHOD.get(type(data))
        payload = wire.encode_sensor_data(sensor_id, data)
        request = wire.encode(
            "sensor_data",
            {"trajectory_id": self._trajectory_id},
            {"payload": np.frombuffer(payload, np.uint8)},
        )
        if method is None:
            self._parent._call("AddSensorData", request)
            return
        writer = self._writers.get(sensor_id)
        if writer is None:
            writer = _SensorStreamWriter(self._parent._channel, method)
            self._writers[sensor_id] = writer
        writer.write(request)

    def close_streams(self) -> None:
        """Half-close every sensor stream and wait for acknowledgements
        (called on FinishTrajectory)."""
        for writer in self._writers.values():
            writer.close()
        self._writers.clear()


class PoseGraphStub:
    def __init__(self, parent: "MapBuilderStub"):
        self._parent = parent

    def run_final_optimization(self) -> None:
        self._parent._call(
            "RunFinalOptimization", wire.encode("empty", {}, {}), timeout=600.0
        )

    def get_local_to_global_transform(self, trajectory_id: int) -> np.ndarray:
        response = self._parent._call(
            "GetLocalToGlobalTransform",
            wire.encode("query", {"trajectory_id": trajectory_id}, {}),
        )
        _, _, arrays = wire.decode(response)
        return arrays["pose"]

    def get_trajectory_node_poses(self) -> Dict[NodeId, np.ndarray]:
        response = self._parent._call(
            "GetTrajectoryNodePoses", wire.encode("empty", {}, {})
        )
        _, _, arrays = wire.decode(response)
        return {
            NodeId(int(t), int(i)): pose
            for (t, i), pose in zip(arrays["ids"], arrays["poses"])
        }

    def get_submap_poses(self) -> Dict[SubmapId, np.ndarray]:
        response = self._parent._call("GetSubmapPoses", wire.encode("empty", {}, {}))
        _, _, arrays = wire.decode(response)
        return {
            SubmapId(int(t), int(i)): pose
            for (t, i), pose in zip(arrays["ids"], arrays["poses"])
        }

    def constraints(self):
        response = self._parent._call("GetConstraints", wire.encode("empty", {}, {}))
        _, meta, arrays = wire.decode(response)
        return [
            {
                "submap_id": SubmapId(int(s[0]), int(s[1])),
                "node_id": NodeId(int(n[0]), int(n[1])),
                "tag": tag,
            }
            for s, n, tag in zip(
                arrays["submap_ids"], arrays["node_ids"], meta["tags"]
            )
        ]

    def is_trajectory_finished(self, trajectory_id: int) -> bool:
        response = self._parent._call(
            "IsTrajectoryFinished",
            wire.encode("query", {"trajectory_id": trajectory_id}, {}),
        )
        _, meta, _ = wire.decode(response)
        return meta["value"]

    def is_trajectory_frozen(self, trajectory_id: int) -> bool:
        response = self._parent._call(
            "IsTrajectoryFrozen",
            wire.encode("query", {"trajectory_id": trajectory_id}, {}),
        )
        _, meta, _ = wire.decode(response)
        return meta["value"]

    def get_landmark_poses(self) -> Dict[str, np.ndarray]:
        response = self._parent._call(
            "GetLandmarkPoses", wire.encode("empty", {}, {})
        )
        _, meta, arrays = wire.decode(response)
        return {lid: arrays["poses"][i] for i, lid in enumerate(meta["ids"])}

    def set_landmark_pose(
        self, landmark_id: str, global_pose: np.ndarray, frozen: bool = False
    ) -> None:
        self._parent._call(
            "SetLandmarkPose",
            wire.encode(
                "set_landmark",
                {"landmark_id": landmark_id, "frozen": frozen},
                {"pose": np.asarray(global_pose)},
            ),
        )

    def delete_trajectory(self, trajectory_id: int) -> None:
        self._parent._call(
            "DeleteTrajectory",
            wire.encode("delete", {"trajectory_id": trajectory_id}, {}),
            timeout=600.0,
        )


class MapBuilderStub:
    def __init__(self, server_address: str, client_id: str = "client"):
        self._channel = grpc.insecure_channel(server_address)
        self._client_id = client_id
        self._pose_graph = PoseGraphStub(self)
        self._trajectory_builders: Dict[int, TrajectoryBuilderStub] = {}

    def _call(self, method: str, request: bytes, timeout: float = 60.0) -> bytes:
        callable_ = self._channel.unary_unary(
            wire.method_path(method),
            request_serializer=None,
            response_deserializer=None,
        )
        return callable_(request, timeout=timeout)

    @property
    def pose_graph(self) -> PoseGraphStub:
        return self._pose_graph

    def add_trajectory_builder(
        self,
        expected_sensor_ids: Set[str],
        trajectory_options: TrajectoryBuilderOptions,
        local_slam_result_callback=None,
    ) -> int:
        response = self._call(
            "AddTrajectory",
            wire.encode(
                "add_trajectory",
                {
                    "client_id": self._client_id,
                    "expected_sensor_ids": sorted(expected_sensor_ids),
                    "trajectory_options": trajectory_options.to_dict(),
                },
                {},
            ),
        )
        _, meta, _ = wire.decode(response)
        trajectory_id = meta["trajectory_id"]
        self._trajectory_builders[trajectory_id] = TrajectoryBuilderStub(
            self, trajectory_id
        )
        return trajectory_id

    def get_trajectory_builder(self, trajectory_id: int) -> TrajectoryBuilderStub:
        return self._trajectory_builders[trajectory_id]

    def get_submap_data(self, submap_id: SubmapId):
        """Returns a dict with the submap texture (SubmapQuery analog), or
        None if the submap does not exist."""
        response = self._call(
            "GetSubmapData",
            wire.encode(
                "query",
                {
                    "trajectory_id": submap_id.trajectory_id,
                    "submap_index": submap_id.submap_index,
                },
                {},
            ),
        )
        _, meta, arrays = wire.decode(response)
        if not meta["found"]:
            return None
        return {**meta, **arrays}

    def finish_trajectory(self, trajectory_id: int) -> None:
        builder = self._trajectory_builders.get(trajectory_id)
        if builder is not None:
            builder.close_streams()
        self._call(
            "FinishTrajectory",
            wire.encode("finish", {"trajectory_id": trajectory_id}, {}),
            timeout=600.0,
        )

    def receive_local_slam_results(self, callback) -> "_Subscription":
        """Subscribe to streamed local SLAM results
        (ReceiveLocalSlamResults); callback(trajectory_id, time,
        local_pose). Returns a handle with .cancel()."""
        call = self._channel.unary_stream(
            wire.method_path("ReceiveLocalSlamResults"),
            request_serializer=None,
            response_deserializer=None,
        )(wire.encode("subscribe", {}, {}))

        def run():
            try:
                for response in call:
                    _, meta, arrays = wire.decode(response)
                    callback(
                        meta["trajectory_id"], meta["time"], arrays["local_pose"]
                    )
            except grpc.RpcError:
                pass

        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        return _Subscription(call, thread)

    def receive_global_slam_optimizations(self, callback) -> "_Subscription":
        """Subscribe to optimization events (ReceiveGlobalSlamOptimizations);
        callback(last_submap_ids, last_node_ids) with id maps keyed by
        trajectory."""
        call = self._channel.unary_stream(
            wire.method_path("ReceiveGlobalSlamOptimizations"),
            request_serializer=None,
            response_deserializer=None,
        )(wire.encode("subscribe", {}, {}))

        def run():
            try:
                for response in call:
                    _, meta, _ = wire.decode(response)
                    submaps = {
                        int(t): SubmapId(*v)
                        for t, v in meta["last_submap_ids"].items()
                    }
                    nodes = {
                        int(t): NodeId(*v)
                        for t, v in meta["last_node_ids"].items()
                    }
                    callback(submaps, nodes)
            except grpc.RpcError:
                pass

        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        return _Subscription(call, thread)

    def write_state_to_file(self, filename: str) -> int:
        response = self._call(
            "WriteStateToFile",
            wire.encode("write", {"filename": filename}, {}),
            timeout=600.0,
        )
        _, meta, _ = wire.decode(response)
        return meta["bytes"]

    def load_state_from_file(self, filename: str, load_frozen_state: bool = True):
        response = self._call(
            "LoadStateFromFile",
            wire.encode(
                "load",
                {"filename": filename, "load_frozen_state": load_frozen_state},
                {},
            ),
            timeout=600.0,
        )
        _, meta, _ = wire.decode(response)
        return {int(k): v for k, v in meta["remap"].items()}

    def serialize_state(self) -> bytes:
        return self._call("WriteState", wire.encode("empty", {}, {}), timeout=600.0)

    def load_state(self, state: bytes) -> Dict[int, int]:
        response = self._call("LoadState", state, timeout=300.0)
        _, meta, _ = wire.decode(response)
        return {int(k): v for k, v in meta["remap"].items()}

    def close(self) -> None:
        for builder in self._trajectory_builders.values():
            builder.close_streams()
        self._channel.close()


class _Subscription:
    """Handle for a server-streaming subscription."""

    def __init__(self, call, thread: threading.Thread):
        self._call = call
        self._thread = thread

    def cancel(self) -> None:
        self._call.cancel()
        self._thread.join(timeout=5.0)
