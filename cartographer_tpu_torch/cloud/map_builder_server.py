"""Cloud-mode SLAM server: many robots, one shared pose graph.

Port of cartographer_tpu/cloud/map_builder_server.py.

Reference: cloud/internal/map_builder_server.{h:77-146,cc:130-297} — a gRPC
server feeding a BlockingQueue of incoming sensor data drained by a single
dedicated SLAM thread (ProcessSensorDataQueue), with local-slam subscription
fanout and an optional uplink to an upstream server.

Transport: real gRPC over localhost/TCP using generic bytes methods (method
registry below mirrors the reference's 24 handler classes in
cloud/internal/handlers/). The MapBuilder runs on the server's device
(`device=None` means CUDA, as for MapBuilder itself); every reply is made
of host arrays, so the client side needs no device.
"""

from __future__ import annotations

import threading
from concurrent import futures
from typing import Callable, List, Optional

import grpc
import numpy as np

from cartographer_tpu_torch.cloud import wire
from cartographer_tpu_torch.common.blocking_queue import BlockingQueue
from cartographer_tpu_torch.common.config import (
    MapBuilderOptions,
    TrajectoryBuilderOptions,
)
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.map_builder import MapBuilder

SERVICE = wire.SERVICE


class _QueueItem:
    def __init__(self, trajectory_id: int, sensor_id: str, data):
        self.trajectory_id = trajectory_id
        self.sensor_id = sensor_id
        self.data = data


class MapBuilderServer:
    def __init__(
        self,
        map_builder_options: MapBuilderOptions,
        address: str = "localhost:0",
        uplink_address: Optional[str] = None,
        uplink_batch_size: int = 10,
        monitoring_port: Optional[int] = None,
        device=None,
    ):
        self._map_builder = MapBuilder(map_builder_options, device=device)
        # Prometheus scrape endpoint (map_builder_server.cc monitoring port;
        # metrics collection is switched on so the gauges are live).
        self._exporter = None
        if monitoring_port is not None:
            from cartographer_tpu_torch import metrics
            from cartographer_tpu_torch.metrics.prometheus import PrometheusExporter

            metrics.enable_collection()
            self._exporter = PrometheusExporter(monitoring_port)
        self._incoming_data_queue = BlockingQueue()
        self._local_slam_subscriptions: List[Callable] = []
        self._slam_thread: Optional[threading.Thread] = None
        self._shutdown_event = threading.Event()
        self._shutting_down = False
        self._processing = False
        self._lock = threading.Lock()
        self._uploader = None
        if uplink_address is not None:
            from cartographer_tpu_torch.cloud.local_trajectory_uploader import (
                LocalTrajectoryUploader,
            )

            self._uploader = LocalTrajectoryUploader(
                uplink_address, batch_size=uplink_batch_size
            )

        self._global_slam_subscriptions: List[Callable] = []
        self._map_builder.pose_graph.set_global_slam_optimization_callback(
            self._on_global_slam_optimization
        )

        handlers = {
            "AddTrajectory": self._handle_add_trajectory,
            "FinishTrajectory": self._handle_finish_trajectory,
            "DeleteTrajectory": self._handle_delete_trajectory,
            "AddSensorData": self._handle_add_sensor_data,
            "AddSensorDataBatch": self._handle_add_sensor_data_batch,
            "GetLocalToGlobalTransform": self._handle_get_local_to_global,
            "GetTrajectoryNodePoses": self._handle_get_node_poses,
            "GetSubmapPoses": self._handle_get_submap_poses,
            "GetLandmarkPoses": self._handle_get_landmark_poses,
            "SetLandmarkPose": self._handle_set_landmark_pose,
            "GetConstraints": self._handle_get_constraints,
            "RunFinalOptimization": self._handle_run_final_optimization,
            "WriteState": self._handle_write_state,
            "WriteStateToFile": self._handle_write_state_to_file,
            "LoadState": self._handle_load_state,
            "LoadStateFromFile": self._handle_load_state_from_file,
            "IsTrajectoryFinished": self._handle_is_trajectory_finished,
            "IsTrajectoryFrozen": self._handle_is_trajectory_frozen,
            "GetSubmapData": self._handle_get_submap_data,
        }
        # Per-sensor client-streaming ingestion RPCs, one per sensor type
        # like the reference (map_builder_service.proto:258-271).
        stream_handlers = {
            name: self._handle_sensor_data_stream
            for name in (
                "AddRangefinderData",
                "AddImuData",
                "AddOdometryData",
                "AddFixedFramePoseData",
                "AddLandmarkData",
            )
        }
        # Server-streaming subscription RPCs
        # (map_builder_service.proto ReceiveLocalSlamResults /
        # ReceiveGlobalSlamOptimizations).
        server_stream_handlers = {
            "ReceiveLocalSlamResults": self._handle_receive_local_slam_results,
            "ReceiveGlobalSlamOptimizations": (
                self._handle_receive_global_slam_optimizations
            ),
        }

        class Handler(grpc.GenericRpcHandler):
            def service(self_inner, handler_call_details):
                name = handler_call_details.method.split("/")[-1]
                if name in handlers:
                    fn = handlers[name]
                    return grpc.unary_unary_rpc_method_handler(
                        lambda request, context, fn=fn: fn(request, context),
                        request_deserializer=None,
                        response_serializer=None,
                    )
                if name in stream_handlers:
                    fn = stream_handlers[name]
                    return grpc.stream_unary_rpc_method_handler(
                        lambda it, context, fn=fn: fn(it, context),
                        request_deserializer=None,
                        response_serializer=None,
                    )
                if name in server_stream_handlers:
                    fn = server_stream_handlers[name]
                    return grpc.unary_stream_rpc_method_handler(
                        lambda request, context, fn=fn: fn(request, context),
                        request_deserializer=None,
                        response_serializer=None,
                    )
                return None

        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers((Handler(),))
        self._port = self._server.add_insecure_port(address)

    # -- lifecycle ----------------------------------------------------------

    @property
    def port(self) -> int:
        return self._port

    @property
    def map_builder(self) -> MapBuilder:
        return self._map_builder

    def start(self) -> None:
        self._server.start()
        if self._uploader is not None:
            self._uploader.start()
        self._slam_thread = threading.Thread(
            target=self._process_sensor_data_queue, daemon=True
        )
        self._slam_thread.start()

    def wait_until_idle(self, timeout: float = 300.0) -> None:
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._incoming_data_queue.empty() and not self._processing:
                time.sleep(0.05)
                if self._incoming_data_queue.empty() and not self._processing:
                    return
            time.sleep(0.01)

    def shutdown(self) -> None:
        self._shutting_down = True
        self._incoming_data_queue.push(None)  # wake the SLAM thread
        if self._uploader is not None:
            self._uploader.shutdown()
        self._server.stop(grace=1.0)
        if self._slam_thread is not None:
            self._slam_thread.join(timeout=10.0)
        if self._exporter is not None:
            self._exporter.close()
        self._shutdown_event.set()

    def wait_for_shutdown(self, timeout: Optional[float] = None) -> None:
        """Block until shutdown() is called (reference
        MapBuilderServer::WaitForShutdown, map_builder_server.cc)."""
        self._shutdown_event.wait(timeout)

    # -- SLAM thread (ProcessSensorDataQueue) -------------------------------

    def _process_sensor_data_queue(self) -> None:
        while not self._shutting_down:
            item = self._incoming_data_queue.pop()
            if item is None:
                continue
            self._processing = True
            try:
                builder = self._map_builder.get_trajectory_builder(
                    item.trajectory_id
                )
                if builder is not None:
                    builder.add_sensor_data(item.sensor_id, item.data)
                if self._uploader is not None:
                    self._uploader.enqueue_sensor_data(
                        item.trajectory_id, item.sensor_id, item.data
                    )
            finally:
                self._processing = False

    def _on_local_slam_result(self, trajectory_id, time, local_pose, range_data, insertion_result):
        for callback in list(self._local_slam_subscriptions):
            callback(trajectory_id, time, local_pose, range_data, insertion_result)

    def _on_global_slam_optimization(self, last_submap_ids, last_node_ids) -> None:
        for callback in list(self._global_slam_subscriptions):
            callback(last_submap_ids, last_node_ids)

    # -- handlers -----------------------------------------------------------

    def _handle_add_trajectory(self, request: bytes, context) -> bytes:
        kind, meta, _ = wire.decode(request)
        options = TrajectoryBuilderOptions.from_dict(meta["trajectory_options"])
        with self._lock:
            trajectory_id = self._map_builder.add_trajectory_builder(
                set(meta["expected_sensor_ids"]),
                options,
                self._on_local_slam_result,
            )
        if self._uploader is not None:
            self._uploader.add_trajectory(
                trajectory_id, meta["expected_sensor_ids"], meta["trajectory_options"]
            )
        return wire.encode("trajectory_id", {"trajectory_id": trajectory_id}, {})

    def _handle_finish_trajectory(self, request: bytes, context) -> bytes:
        _, meta, _ = wire.decode(request)
        self.wait_until_idle()
        with self._lock:
            self._map_builder.finish_trajectory(meta["trajectory_id"])
        return wire.encode("ok", {}, {})

    def _handle_add_sensor_data(self, request: bytes, context) -> bytes:
        _, meta, arrays = wire.decode(request)
        sensor_id, data = wire.decode_sensor_data(arrays["payload"].tobytes())
        self._incoming_data_queue.push(
            _QueueItem(meta["trajectory_id"], sensor_id, data)
        )
        return wire.encode("ok", {}, {})

    def _handle_sensor_data_stream(self, request_iterator, context) -> bytes:
        """Client-streaming ingestion (reference handlers add_imu_data_handler
        etc.): every message enqueues one sensor item; the single response
        acknowledges the count when the client half-closes."""
        count = 0
        for request in request_iterator:
            _, meta, arrays = wire.decode(request)
            sensor_id, data = wire.decode_sensor_data(arrays["payload"].tobytes())
            self._incoming_data_queue.push(
                _QueueItem(meta["trajectory_id"], sensor_id, data)
            )
            count += 1
        return wire.encode("ok", {"count": count}, {})

    def _handle_receive_local_slam_results(self, request: bytes, context):
        """Server-streaming subscription (receive_local_slam_results_handler):
        one message per local SLAM result until the client cancels."""
        import queue as _queue

        q: _queue.Queue = _queue.Queue()

        def cb(trajectory_id, time, local_pose, range_data, insertion_result):
            q.put(
                wire.encode(
                    "local_slam_result",
                    {"trajectory_id": trajectory_id, "time": time},
                    {"local_pose": np.asarray(local_pose)},
                )
            )

        self._local_slam_subscriptions.append(cb)
        try:
            while context.is_active() and not self._shutting_down:
                try:
                    yield q.get(timeout=0.1)
                except _queue.Empty:
                    continue
        finally:
            self._local_slam_subscriptions.remove(cb)

    def _handle_receive_global_slam_optimizations(self, request: bytes, context):
        import queue as _queue

        q: _queue.Queue = _queue.Queue()

        def cb(last_submap_ids, last_node_ids):
            q.put(
                wire.encode(
                    "global_slam_optimization",
                    {
                        "last_submap_ids": {
                            str(t): [s.trajectory_id, s.submap_index]
                            for t, s in last_submap_ids.items()
                        },
                        "last_node_ids": {
                            str(t): [n.trajectory_id, n.node_index]
                            for t, n in last_node_ids.items()
                        },
                    },
                    {},
                )
            )

        self._global_slam_subscriptions.append(cb)
        try:
            while context.is_active() and not self._shutting_down:
                try:
                    yield q.get(timeout=0.1)
                except _queue.Empty:
                    continue
        finally:
            self._global_slam_subscriptions.remove(cb)

    def _handle_delete_trajectory(self, request: bytes, context) -> bytes:
        _, meta, _ = wire.decode(request)
        self.wait_until_idle()
        with self._lock:
            self._map_builder.pose_graph.delete_trajectory(meta["trajectory_id"])
        return wire.encode("ok", {}, {})

    def _handle_get_landmark_poses(self, request: bytes, context) -> bytes:
        poses = self._map_builder.pose_graph.get_landmark_poses()
        ids = sorted(poses.keys())
        return wire.encode(
            "landmark_poses",
            {"ids": ids},
            {
                "poses": np.stack([np.asarray(poses[i], np.float64) for i in ids])
                if ids
                else np.zeros((0, 3)),
            },
        )

    def _handle_set_landmark_pose(self, request: bytes, context) -> bytes:
        _, meta, arrays = wire.decode(request)
        self._map_builder.pose_graph.set_landmark_pose(
            meta["landmark_id"], arrays["pose"], frozen=meta.get("frozen", False)
        )
        return wire.encode("ok", {}, {})

    def _handle_write_state_to_file(self, request: bytes, context) -> bytes:
        _, meta, _ = wire.decode(request)
        self.wait_until_idle()
        with self._lock:
            state = self._map_builder.serialize_state()
        with open(meta["filename"], "wb") as f:
            f.write(state)
        return wire.encode("ok", {"bytes": len(state)}, {})

    def _handle_load_state_from_file(self, request: bytes, context) -> bytes:
        _, meta, _ = wire.decode(request)
        with open(meta["filename"], "rb") as f:
            state = f.read()
        with self._lock:
            remap = self._map_builder.load_state(
                state, load_frozen_state=meta.get("load_frozen_state", True)
            )
        return wire.encode("remap", {"remap": {str(k): v for k, v in remap.items()}}, {})

    def _handle_add_sensor_data_batch(self, request: bytes, context) -> bytes:
        kind, meta, arrays = wire.decode(request)
        for i in range(meta["count"]):
            payload = bytes(arrays[f"item_{i}"].tobytes())
            inner_meta = meta["items"][i]
            sensor_id, data = wire.decode_sensor_data(payload)
            self._incoming_data_queue.push(
                _QueueItem(inner_meta["trajectory_id"], sensor_id, data)
            )
        return wire.encode("ok", {}, {})

    def _handle_get_local_to_global(self, request: bytes, context) -> bytes:
        _, meta, _ = wire.decode(request)
        transform = self._map_builder.pose_graph.get_local_to_global_transform(
            meta["trajectory_id"]
        )
        return wire.encode("transform", {}, {"pose": np.asarray(transform)})

    def _handle_get_node_poses(self, request: bytes, context) -> bytes:
        nodes = self._map_builder.pose_graph.get_trajectory_nodes()
        ids, poses, times = [], [], []
        for node_id, node in nodes.items(NodeId):
            ids.append([node_id.trajectory_id, node_id.node_index])
            poses.append(np.asarray(node.global_pose))
            times.append(node.constant_data.time)
        return wire.encode(
            "node_poses",
            {},
            {
                "ids": np.asarray(ids, np.int32).reshape(-1, 2),
                "poses": np.stack(poses) if poses else np.zeros((0, 7)),
                "times": np.asarray(times),
            },
        )

    def _handle_get_submap_poses(self, request: bytes, context) -> bytes:
        pg = self._map_builder.pose_graph
        ids, poses = [], []
        for sid, spec in pg._optimization_problem.submap_data.items(SubmapId):
            ids.append([sid.trajectory_id, sid.submap_index])
            poses.append(np.asarray(spec.global_pose))
        return wire.encode(
            "submap_poses",
            {},
            {
                "ids": np.asarray(ids, np.int32).reshape(-1, 2),
                "poses": np.stack(poses) if poses else np.zeros((0, 3)),
            },
        )

    def _handle_get_constraints(self, request: bytes, context) -> bytes:
        constraints = self._map_builder.pose_graph.constraints
        return wire.encode(
            "constraints",
            {"tags": [c.tag for c in constraints]},
            {
                "submap_ids": np.asarray(
                    [[c.submap_id.trajectory_id, c.submap_id.submap_index] for c in constraints],
                    np.int32,
                ).reshape(-1, 2),
                "node_ids": np.asarray(
                    [[c.node_id.trajectory_id, c.node_id.node_index] for c in constraints],
                    np.int32,
                ).reshape(-1, 2),
            },
        )

    def _handle_run_final_optimization(self, request: bytes, context) -> bytes:
        self.wait_until_idle()
        with self._lock:
            self._map_builder.pose_graph.run_final_optimization()
        return wire.encode("ok", {}, {})

    def _handle_write_state(self, request: bytes, context) -> bytes:
        self.wait_until_idle()
        with self._lock:
            state = self._map_builder.serialize_state()
        return state

    def _handle_load_state(self, request: bytes, context) -> bytes:
        with self._lock:
            remap = self._map_builder.load_state(request, load_frozen_state=True)
        return wire.encode("remap", {"remap": {str(k): v for k, v in remap.items()}}, {})

    def _handle_is_trajectory_finished(self, request: bytes, context) -> bytes:
        _, meta, _ = wire.decode(request)
        finished = self._map_builder.pose_graph.is_trajectory_finished(
            meta["trajectory_id"]
        )
        return wire.encode("bool", {"value": bool(finished)}, {})

    def _handle_get_submap_data(self, request: bytes, context) -> bytes:
        """SubmapQuery analog (cloud handlers + submap_visualization.proto):
        returns the submap's texture (probability image) + pose + version."""
        _, meta, _ = wire.decode(request)
        submap_id = SubmapId(meta["trajectory_id"], meta["submap_index"])
        data = self._map_builder.pose_graph.get_all_submap_data().get(submap_id)
        if data is None:
            return wire.encode("submap_texture", {"found": False}, {})
        submap = data.submap
        if hasattr(submap, "grid"):  # 2D (compute_cropped reads back to the host)
            from cartographer_tpu_torch.mapping.grid_2d import compute_cropped

            cropped = compute_cropped(submap.grid)
            intensity = np.where(
                cropped.known, cropped.probability, 0.5
            ).astype(np.float32)
            alpha = cropped.known.astype(np.float32)
            resolution = cropped.resolution
            origin = cropped.origin
        else:  # 3D: project the high-res grid along z (max probability).
            from cartographer_tpu_torch.mapping.paged_grid_3d import as_dense

            high_grid = as_dense(submap.high_resolution_grid)
            # Reduce on the grid's device; only the planes come back.
            intensity = (
                high_grid.probability().amax(0).cpu().numpy().astype(np.float32)
            )
            alpha = high_grid.known().any(0).cpu().numpy().astype(np.float32)
            resolution = high_grid.resolution
            origin = high_grid.origin.cpu().numpy()[:2]
        return wire.encode(
            "submap_texture",
            {
                "found": True,
                "submap_version": submap.num_range_data,
                "resolution": float(resolution),
                "finished": bool(submap.insertion_finished),
            },
            {
                "intensity": intensity,
                "alpha": alpha,
                "origin": np.asarray(origin, np.float64),
                "local_pose": np.asarray(submap.local_pose, np.float64),
            },
        )

    def _handle_is_trajectory_frozen(self, request: bytes, context) -> bytes:
        _, meta, _ = wire.decode(request)
        frozen = self._map_builder.pose_graph.is_trajectory_frozen(
            meta["trajectory_id"]
        )
        return wire.encode("bool", {"value": bool(frozen)}, {})

    # Direct enqueue used by the sensor-data RPC below (kept separate so the
    # stub can also stream).
    def enqueue(self, trajectory_id: int, sensor_id: str, data) -> None:
        self._incoming_data_queue.push(_QueueItem(trajectory_id, sensor_id, data))
