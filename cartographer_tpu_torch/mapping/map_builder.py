"""MapBuilder: the library's public API facade.

Port of cartographer_tpu/mapping/map_builder.py. Reference:
mapping/map_builder.cc:77-402 and map_builder_interface.h:44-115. Wires
the sensor collator, per-trajectory CollatedTrajectoryBuilder ->
GlobalTrajectoryBuilder (internal/global_trajectory_builder.cc:36-143) ->
pose graph (PoseGraph2D, or PoseGraph3D with use_trajectory_builder_3d),
plus trajectory lifecycle. The local builder is the per-scan
LocalTrajectoryBuilder2D / 3D (the default) or, with
use_chunked_device_frontend, the chunked frontend; a configuration the
chunked frontend does not cover falls back to the per-scan builder with a
warning and a counter, as in the JAX package.

State is saved and loaded in the JAX package's two formats (io/
serialization.py's npz records and io/pbstream_compat.py's reference
protobuf records, both in the pbstream container); their modules are
imported inside the four methods, so building and running a map never
imports protobuf. A loaded state goes onto the MapBuilder's device.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, Optional, Set

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.common.config import (
    MapBuilderOptions,
    TrajectoryBuilderOptions,
)
from cartographer_tpu_torch.common.time import Time
from cartographer_tpu_torch.common.task import ThreadPool
from cartographer_tpu_torch.mapping import chunked_frontend_2d, chunked_frontend_3d
from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (
    LocalTrajectoryBuilder2D,
    MatchingResult,
)
from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
    LocalTrajectoryBuilder3D,
)
from cartographer_tpu_torch.mapping.pose_graph_2d import PoseGraph2D
from cartographer_tpu_torch.mapping.pose_graph_3d import PoseGraph3D
from cartographer_tpu_torch.mapping.trimmers import PureLocalizationTrimmer
from cartographer_tpu_torch.parallel.partition import mesh_device
from cartographer_tpu_torch.sensor.collator import Collator, TrajectoryCollator
from cartographer_tpu_torch.sensor.data import (
    FixedFramePoseData,
    ImuData,
    LandmarkData,
    OdometryData,
    TimedPointCloudData,
)

# callback(trajectory_id, time, local_pose, range_data_in_local, insertion_result)
LocalSlamResultCallback = Callable


@dataclasses.dataclass
class _QueuedData:
    time: Time
    payload: object


class GlobalTrajectoryBuilder:
    """Glue: local SLAM result -> pose_graph.add_node -> user callback
    (internal/global_trajectory_builder.cc:36-143)."""

    def __init__(
        self,
        local_trajectory_builder,
        trajectory_id: int,
        pose_graph: PoseGraph2D,
        local_slam_result_callback: Optional[LocalSlamResultCallback],
    ):
        self._local_trajectory_builder = local_trajectory_builder
        self._trajectory_id = trajectory_id
        self._pose_graph = pose_graph
        self._local_slam_result_callback = local_slam_result_callback

    def add_sensor_data(self, sensor_id: str, data) -> None:
        if isinstance(data, TimedPointCloudData):
            if self._local_trajectory_builder is None:
                return
            matching_result = self._local_trajectory_builder.add_range_data(
                sensor_id, data
            )
            # The chunked device frontend emits results in batches.
            if isinstance(matching_result, list):
                for r in matching_result:
                    self._handle_matching_result(r)
                return
            if matching_result is None:
                return
            self._handle_matching_result(matching_result)
        elif isinstance(data, ImuData):
            if self._local_trajectory_builder is not None:
                self._local_trajectory_builder.add_imu_data(data)
            self._pose_graph.add_imu_data(self._trajectory_id, data)
        elif isinstance(data, OdometryData):
            if self._local_trajectory_builder is not None:
                self._local_trajectory_builder.add_odometry_data(data)
            self._pose_graph.add_odometry_data(self._trajectory_id, data)
        elif isinstance(data, FixedFramePoseData):
            self._pose_graph.add_fixed_frame_pose_data(self._trajectory_id, data)
        elif isinstance(data, LandmarkData):
            self._pose_graph.add_landmark_data(self._trajectory_id, data)
        else:
            raise TypeError(f"unsupported sensor data {type(data)}")

    def _handle_matching_result(self, matching_result: MatchingResult) -> None:
        if matching_result.insertion_result is not None:
            self._pose_graph.add_node(
                matching_result.insertion_result.constant_data,
                self._trajectory_id,
                matching_result.insertion_result.insertion_submaps,
            )
        if self._local_slam_result_callback:
            self._local_slam_result_callback(
                self._trajectory_id,
                matching_result.time,
                matching_result.local_pose,
                matching_result.range_data_in_local,
                matching_result.insertion_result,
            )

    def flush(self) -> None:
        """Drain any scans buffered by a chunked device frontend."""
        builder = self._local_trajectory_builder
        if builder is not None and hasattr(builder, "flush"):
            for r in builder.flush():
                self._handle_matching_result(r)


class CollatedTrajectoryBuilder:
    """Routes sensor data through the collator
    (internal/collated_trajectory_builder.cc:31-87)."""

    def __init__(
        self,
        collator,
        trajectory_id: int,
        expected_sensor_ids: Set[str],
        wrapped: GlobalTrajectoryBuilder,
    ):
        self._collator = collator
        self._trajectory_id = trajectory_id
        self._wrapped = wrapped
        self._expected_sensor_ids = set(expected_sensor_ids)
        self._collator.add_trajectory(
            trajectory_id, expected_sensor_ids, self._handle_collated
        )

    def add_sensor_data(self, sensor_id: str, data) -> None:
        with metrics.span("facade.add_sensor_data", data.time):
            if sensor_id not in self._expected_sensor_ids:
                # Un-collated sensors (e.g. landmarks/fixed-frame with
                # collate_* = false) bypass the ordered queues
                # (collated_trajectory_builder.cc:50-60).
                self._wrapped.add_sensor_data(sensor_id, data)
                return
            self._collator.add_sensor_data(
                self._trajectory_id, sensor_id, _QueuedData(data.time, data)
            )

    def _handle_collated(self, sensor_id: str, queued: _QueuedData) -> None:
        self._wrapped.add_sensor_data(sensor_id, queued.payload)


def _slow_path_fallback(builder, reason: str):
    """The chunked frontend was asked for but does not cover this
    configuration: warn once and count every scan that takes the per-scan
    path (mapping_frontend_slow_path_scans), so the slower path shows in
    the metrics instead of silently."""
    logging.warning(
        "use_chunked_device_frontend requested but unsupported: %s; "
        "falling back to the per-scan path. Scans on it are counted by "
        "mapping_frontend_slow_path_scans.",
        reason,
    )
    orig = builder.add_range_data

    def counted_add_range_data(*args, **kwargs):
        metrics.frontend_slow_path_scans.increment()
        return orig(*args, **kwargs)

    builder.add_range_data = counted_add_range_data
    return builder


class MapBuilder:
    def __init__(self, options: MapBuilderOptions, device=None, mesh=None):
        """`device=None` means CUDA (the mesh's device when a mesh is
        given); pass device="cpu" to run the frontends and the backend on
        the CPU.

        mesh: optional parallel/partition.Mesh — the pose-graph backend's
        loop-closure search batches and SPA solves run split over its
        ranks (parallel/sharded.py). Every rank feeds the same sensor data.
        With more than one rank the pose graph drains synchronously, even
        when `async_pose_graph` is set: an asynchronous drain takes
        whatever is pending when it starts, so the ranks would batch
        different searches. A one-rank mesh keeps the asynchronous drains."""
        assert options.use_trajectory_builder_2d != options.use_trajectory_builder_3d, (
            "Exactly one of use_trajectory_builder_2d / 3d must be set."
        )
        self._options = options
        self._device = mesh_device(device, mesh)
        thread_pool = None
        if options.async_pose_graph:
            if mesh is not None and mesh.world_size > 1:
                logging.info(
                    "MapBuilder: a mesh of %d ranks drains the pose graph "
                    "synchronously (async_pose_graph ignored)", mesh.world_size,
                )
            else:
                thread_pool = ThreadPool(max(1, options.num_background_threads))
        self._thread_pool = thread_pool
        pose_graph_type = PoseGraph3D if options.use_trajectory_builder_3d else PoseGraph2D
        self._pose_graph = pose_graph_type(
            options.pose_graph, thread_pool, device=self._device, mesh=mesh
        )
        self._collator = (
            TrajectoryCollator() if options.collate_by_trajectory else Collator()
        )
        self._trajectory_builders: Dict[int, Optional[CollatedTrajectoryBuilder]] = {}
        self._num_trajectories = 0
        self._all_trajectory_builder_options: Dict[int, TrajectoryBuilderOptions] = {}

    @property
    def pose_graph(self):
        return self._pose_graph

    def num_trajectory_builders(self) -> int:
        return self._num_trajectories

    def get_trajectory_builder(self, trajectory_id: int):
        return self._trajectory_builders[trajectory_id]

    def add_trajectory_builder(
        self,
        expected_sensor_ids: Set[str],
        trajectory_options: TrajectoryBuilderOptions,
        local_slam_result_callback: Optional[LocalSlamResultCallback] = None,
    ) -> int:
        range_ids = {
            s for s in expected_sensor_ids if s.startswith("range")
        } or expected_sensor_ids
        if self._options.use_trajectory_builder_3d:
            local_builder = self._local_builder_3d(trajectory_options, range_ids)
        else:
            local_builder = self._local_builder_2d(trajectory_options, range_ids)
        trajectory_id = self._num_trajectories
        self._num_trajectories += 1
        if trajectory_options.pure_localization_trimmer is not None:
            self._pose_graph.add_trimmer(
                PureLocalizationTrimmer(
                    trajectory_id,
                    trajectory_options.pure_localization_trimmer.max_submaps_to_keep,
                )
            )
        global_builder = GlobalTrajectoryBuilder(
            local_builder,
            trajectory_id,
            self._pose_graph,
            local_slam_result_callback,
        )
        self._trajectory_builders[trajectory_id] = CollatedTrajectoryBuilder(
            self._collator, trajectory_id, expected_sensor_ids, global_builder
        )
        self._all_trajectory_builder_options[trajectory_id] = trajectory_options
        self._pose_graph.add_trajectory_if_needed(trajectory_id)
        return trajectory_id

    def _local_builder_2d(self, trajectory_options, range_ids):
        opts2d = trajectory_options.trajectory_builder_2d
        if not trajectory_options.use_chunked_device_frontend:
            return LocalTrajectoryBuilder2D(opts2d, range_ids, device=self._device)
        if chunked_frontend_2d.supports(opts2d):
            return chunked_frontend_2d.ChunkedLocalTrajectoryBuilder2D(
                opts2d,
                range_ids,
                chunk_size=trajectory_options.device_frontend_chunk_size,
                device=self._device,
            )
        # TSDF, num_accumulated_range_data > 1 or the IMU-based
        # extrapolator: the per-scan path, observably.
        return _slow_path_fallback(
            LocalTrajectoryBuilder2D(opts2d, range_ids, device=self._device),
            "2D configuration outside the chunked device frontend's "
            "scope (needs probability grid, num_accumulated_range_data "
            "== 1, constant-velocity extrapolator)",
        )

    def _local_builder_3d(self, trajectory_options, range_ids):
        opts3d = trajectory_options.trajectory_builder_3d
        if not trajectory_options.use_chunked_device_frontend:
            return LocalTrajectoryBuilder3D(opts3d, range_ids, device=self._device)
        if chunked_frontend_3d.supports(opts3d):
            return chunked_frontend_3d.ChunkedLocalTrajectoryBuilder3D(
                opts3d,
                range_ids,
                chunk_size=trajectory_options.device_frontend_chunk_size,
                device=self._device,
            )
        return _slow_path_fallback(
            LocalTrajectoryBuilder3D(opts3d, range_ids, device=self._device),
            "3D configuration outside the chunked device frontend's scope "
            "(needs IMU, constant-velocity extrapolator, no intensity grids)",
        )

    def finish_trajectory(self, trajectory_id: int) -> None:
        self._collator.finish_trajectory(trajectory_id)
        builder = self._trajectory_builders.get(trajectory_id)
        if builder is not None:
            builder._wrapped.flush()
        self._pose_graph.finish_trajectory(trajectory_id)

    def shutdown(self) -> None:
        """Wait for the backend and stop the drain threads."""
        self._pose_graph.wait_for_all_computations()
        if self._thread_pool is not None:
            self._thread_pool.shutdown()
            self._thread_pool = None

    @property
    def device(self):
        return self._device

    def serialize_state(self, include_unfinished_submaps: bool = True) -> bytes:
        from cartographer_tpu_torch.io.serialization import serialize_state

        return serialize_state(self, include_unfinished_submaps)

    def serialize_state_pbstream(self, include_unfinished_submaps: bool = True) -> bytes:
        """Reference-wire-format pbstream (io/pbstream_compat.py)."""
        from cartographer_tpu_torch.io.pbstream_compat import write_pbstream

        return write_pbstream(self, include_unfinished_submaps)

    def load_state_pbstream(self, state: bytes, load_frozen_state: bool = True):
        from cartographer_tpu_torch.io.pbstream_compat import read_pbstream

        return read_pbstream(self, state, load_frozen_state)

    def load_state(self, state, load_frozen_state: bool = True):
        from cartographer_tpu_torch.io.serialization import load_state

        remap = load_state(self, state, load_frozen_state)
        # Reserve the loaded trajectory ids so new builders don't collide
        # (map_builder.cc LoadState registers placeholder entries).
        for new_id in remap.values():
            self._trajectory_builders[new_id] = None
            self._num_trajectories = max(self._num_trajectories, new_id + 1)
        return remap
