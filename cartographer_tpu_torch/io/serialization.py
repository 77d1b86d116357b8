"""State serialization: checkpoint/resume + pure-localization maps.

Reference: io/internal/mapping_state_serialization.cc:28-237 (canonical write
order: header v2 -> pose graph -> options -> submaps -> nodes -> trajectory
data -> IMU -> odometry -> GPS -> landmarks) and mapping/map_builder.cc:
202-397 (SerializeState / LoadState with frozen-state support and trajectory
remapping).

Records ride the reference's pbstream container framing (io/proto_stream.py);
each record is a tagged npz payload. Version and migration hooks mirror
io/serialization_format_migration.cc.

Port of cartographer_tpu/io/serialization.py: the same records, byte for
byte after decompression (gzip.compress writes the time into each
container record, so the container bytes differ from call to call).
Grids are read back from the device once per submap; 3D submaps are
written dense (paged building grids through paged_grid_3d.as_dense). A
loaded state's grids go onto the MapBuilder's device, and its submaps,
nodes and constraints enter PoseGraph2D / PoseGraph3D through the hooks
the pose graph's own inserts use.
"""

from __future__ import annotations

import io as _io
import json
from typing import Any, Dict

import numpy as np

from cartographer_tpu_torch.io.proto_stream import ProtoStreamReader, ProtoStreamWriter
from cartographer_tpu_torch.mapping.constraint_builder_2d import (
    Constraint,
    ConstraintPose,
)
from cartographer_tpu_torch.mapping.grid_2d import grid_from_numpy
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.optimization_problem_2d import NodeSpec2D
from cartographer_tpu_torch.mapping.optimization_problem_3d import NodeSpec3D
from cartographer_tpu_torch.mapping.paged_grid_3d import as_dense
from cartographer_tpu_torch.mapping.pose_graph_2d import InternalSubmapData, SubmapState
from cartographer_tpu_torch.mapping.submap_2d import Submap2D
from cartographer_tpu_torch.mapping.submap_3d import submap3d_from_numpy
from cartographer_tpu_torch.mapping.trajectory_node import TrajectoryNode, TrajectoryNodeData
from cartographer_tpu_torch.sensor.compression import CompressedPointCloud
from cartographer_tpu_torch.transform import rigid3

SERIALIZATION_VERSION = 2


def _encode_record(kind: str, meta: Dict[str, Any], arrays: Dict[str, np.ndarray]) -> bytes:
    buf = _io.BytesIO()
    payload = dict(arrays)
    payload["__meta__"] = np.frombuffer(
        json.dumps({"kind": kind, **meta}).encode(), dtype=np.uint8
    )
    np.savez(buf, **payload)
    return buf.getvalue()


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def _decode_record(data: bytes):
    buf = _io.BytesIO(data)
    npz = np.load(buf, allow_pickle=False)
    meta = json.loads(bytes(npz["__meta__"]).decode())
    arrays = {k: npz[k] for k in npz.files if k != "__meta__"}
    return meta.pop("kind"), meta, arrays


def serialize_state(map_builder, include_unfinished_submaps: bool = True) -> bytes:
    """Serialize the full SLAM state into a pbstream byte string."""
    pose_graph = map_builder.pose_graph
    out = _io.BytesIO()
    writer = ProtoStreamWriter(out)

    writer.write(
        _encode_record("header", {"format_version": SERIALIZATION_VERSION}, {})
    )

    # Pose graph: constraints + trajectory states.
    constraints = pose_graph.constraints
    writer.write(
        _encode_record(
            "pose_graph",
            {
                "trajectory_states": {
                    str(t): s.name for t, s in pose_graph._trajectory_states.items()
                },
                "constraint_tags": [c.tag for c in constraints],
            },
            {
                "c_submap": np.array(
                    [[c.submap_id.trajectory_id, c.submap_id.submap_index] for c in constraints],
                    np.int32,
                ).reshape(-1, 2),
                "c_node": np.array(
                    [[c.node_id.trajectory_id, c.node_id.node_index] for c in constraints],
                    np.int32,
                ).reshape(-1, 2),
                "c_zbar": np.stack(
                    [np.asarray(c.pose.zbar_ij, np.float64) for c in constraints]
                )
                if constraints
                else np.zeros((0, 3)),
                "c_weights": np.array(
                    [
                        [c.pose.translation_weight, c.pose.rotation_weight]
                        for c in constraints
                    ],
                    np.float64,
                ).reshape(-1, 2),
            },
        )
    )

    # Submaps with grids and optimized global poses.
    for submap_id, data in pose_graph.get_all_submap_data().items(SubmapId):
        submap = data.submap
        spec = pose_graph._optimization_problem.submap_data.get(submap_id)
        meta = {
            "trajectory_id": submap_id.trajectory_id,
            "submap_index": submap_id.submap_index,
            "num_range_data": submap.num_range_data,
            "finished": submap.insertion_finished,
            "state": data.state.name,
        }
        if hasattr(submap, "grid"):  # 2D
            grid = submap.grid
            writer.write(
                _encode_record(
                    "submap_2d",
                    {**meta, "resolution": grid.resolution},
                    {
                        "local_pose": np.asarray(submap.local_pose, np.float64),
                        "global_pose": np.asarray(
                            spec.global_pose if spec is not None else submap.local_pose,
                            np.float64,
                        ),
                        "log_odds": _host(grid.log_odds),
                        "known": _host(grid.known),
                        "origin": _host(grid.origin),
                    },
                )
            )
        else:  # 3D
            high_grid = as_dense(submap.high_resolution_grid)
            low_grid = as_dense(submap.low_resolution_grid)
            writer.write(
                _encode_record(
                    "submap_3d",
                    {
                        **meta,
                        "high_resolution": high_grid.resolution,
                        "low_resolution": low_grid.resolution,
                    },
                    {
                        "local_pose": np.asarray(submap.local_pose, np.float64),
                        "global_pose": np.asarray(
                            spec.global_pose if spec is not None else submap.local_pose,
                            np.float64,
                        ),
                        "high_values": _host(high_grid.values),
                        "high_origin": _host(high_grid.origin),
                        "low_values": _host(low_grid.values),
                        "low_origin": _host(low_grid.origin),
                        "histogram": np.asarray(
                            submap.rotational_scan_matcher_histogram
                        ),
                    },
                )
            )

    # Nodes (clouds stored with the reference's lossy compression).
    for node_id, node in pose_graph.get_trajectory_nodes().items(NodeId):
        cd = node.constant_data
        comp = CompressedPointCloud.compress(cd.filtered_gravity_aligned_point_cloud)
        arrays = {
            "global_pose": np.asarray(node.global_pose, np.float64),
            "local_pose": np.asarray(cd.local_pose, np.float64),
            "gravity_alignment": np.asarray(cd.gravity_alignment, np.float64),
            "cloud_blocks": comp.block_coords,
            "cloud_point_block": comp.point_block,
            "cloud_offsets": comp.packed_offsets,
        }
        if cd.high_resolution_point_cloud is not None:
            arrays["high_resolution_point_cloud"] = np.asarray(
                cd.high_resolution_point_cloud, np.float32
            )
        if cd.low_resolution_point_cloud is not None:
            arrays["low_resolution_point_cloud"] = np.asarray(
                cd.low_resolution_point_cloud, np.float32
            )
        if cd.rotational_scan_matcher_histogram is not None:
            arrays["histogram"] = np.asarray(
                cd.rotational_scan_matcher_histogram, np.float32
            )
        writer.write(
            _encode_record(
                "node",
                {
                    "trajectory_id": node_id.trajectory_id,
                    "node_index": node_id.node_index,
                    "time": cd.time,
                    "num_cloud_points": comp.num_points,
                },
                arrays,
            )
        )
    writer.close()
    return out.getvalue()


def load_state(map_builder, state: bytes, load_frozen_state: bool = True) -> Dict[int, int]:
    """Load serialized state into a MapBuilder's pose graph, its grids on
    the MapBuilder's device. Returns the trajectory remapping (serialized
    id -> new id)."""
    pose_graph = map_builder.pose_graph
    device = map_builder.device
    is_2d = pose_graph._is_2d

    reader = ProtoStreamReader(_io.BytesIO(state))
    records = [_decode_record(r) for r in reader]
    header = next(r for r in records if r[0] == "header")
    version = header[1]["format_version"]
    if version > SERIALIZATION_VERSION:
        raise ValueError(f"unsupported state format version {version}")

    # Trajectory remapping: serialized ids -> fresh ids.
    serialized_trajectory_ids = sorted(
        {
            r[1]["trajectory_id"]
            for r in records
            if r[0] in ("submap_2d", "submap_3d", "node")
        }
    )
    remap: Dict[int, int] = {}
    offset = len(pose_graph._trajectory_states)
    for i, t in enumerate(serialized_trajectory_ids):
        new_id = offset + i
        remap[t] = new_id
        pose_graph.add_trajectory_if_needed(new_id)
        if load_frozen_state:
            pose_graph.freeze_trajectory(new_id)

    submap_poses = {}
    for kind, meta, arrays in records:
        if kind == "submap_2d":
            submap_id = SubmapId(
                remap[meta["trajectory_id"]], meta["submap_index"]
            )
            grid = grid_from_numpy(
                arrays["log_odds"], arrays["known"], arrays["origin"],
                meta["resolution"], device,
            )
            submap = Submap2D(
                local_pose=arrays["local_pose"],
                grid=grid,
                num_range_data=meta["num_range_data"],
                insertion_finished=meta["finished"],
            )
            data = InternalSubmapData(submap)
            data.state = (
                SubmapState.FINISHED
                if meta["state"] == "FINISHED" or load_frozen_state
                else SubmapState.NO_CONSTRAINT_SEARCH
            )
            pose_graph._submap_data.insert(submap_id, data)
            pose_graph._optimization_problem.insert_submap(
                submap_id, arrays["global_pose"]
            )
            pose_graph._constraint_builder.set_submap_local_pose(
                submap_id, arrays["local_pose"]
            )
            submap_poses[submap_id] = arrays["global_pose"]
        elif kind == "submap_3d":
            submap_id = SubmapId(
                remap[meta["trajectory_id"]], meta["submap_index"]
            )
            submap = submap3d_from_numpy(
                local_pose=arrays["local_pose"],
                high_resolution_grid=dict(
                    values=arrays["high_values"],
                    origin=arrays["high_origin"],
                    resolution=meta["high_resolution"],
                ),
                low_resolution_grid=dict(
                    values=arrays["low_values"],
                    origin=arrays["low_origin"],
                    resolution=meta["low_resolution"],
                ),
                rotational_scan_matcher_histogram=arrays["histogram"],
                device=device,
                num_range_data=meta["num_range_data"],
                insertion_finished=meta["finished"],
            )
            data = InternalSubmapData(submap)
            data.state = (
                SubmapState.FINISHED
                if meta["state"] == "FINISHED" or load_frozen_state
                else SubmapState.NO_CONSTRAINT_SEARCH
            )
            pose_graph._submap_data.insert(submap_id, data)
            pose_graph._optimization_problem.insert_submap(
                submap_id, arrays["global_pose"]
            )
            submap_poses[submap_id] = arrays["global_pose"]
        elif kind == "node":
            node_id = NodeId(remap[meta["trajectory_id"]], meta["node_index"])
            comp = CompressedPointCloud(
                block_coords=arrays["cloud_blocks"],
                point_block=arrays["cloud_point_block"],
                packed_offsets=arrays["cloud_offsets"],
                num_points=meta["num_cloud_points"],
            )
            cd = TrajectoryNodeData(
                time=meta["time"],
                gravity_alignment=arrays["gravity_alignment"],
                filtered_gravity_aligned_point_cloud=comp.decompress(),
                high_resolution_point_cloud=arrays.get(
                    "high_resolution_point_cloud"
                ),
                low_resolution_point_cloud=arrays.get("low_resolution_point_cloud"),
                rotational_scan_matcher_histogram=arrays.get("histogram"),
                local_pose=arrays["local_pose"],
            )
            pose_graph._trajectory_nodes.insert(
                node_id, TrajectoryNode(cd, arrays["global_pose"])
            )
            if is_2d:
                local_pose_2d = rigid3.project_2d(
                    rigid3.compose(
                        arrays["local_pose"],
                        rigid3.inverse(
                            rigid3.rotation(arrays["gravity_alignment"])
                        ),
                    )
                )
                global_pose_2d = rigid3.project_2d(arrays["global_pose"])
                pose_graph._optimization_problem.insert_trajectory_node(
                    node_id,
                    NodeSpec2D(
                        time=meta["time"],
                        local_pose_2d=local_pose_2d,
                        global_pose_2d=global_pose_2d,
                        gravity_alignment=arrays["gravity_alignment"],
                    ),
                )
            else:
                pose_graph._optimization_problem.insert_trajectory_node(
                    node_id,
                    NodeSpec3D(
                        time=meta["time"],
                        local_pose=arrays["local_pose"],
                        global_pose=arrays["global_pose"],
                    ),
                )
        elif kind == "pose_graph":
            pass  # handled after submaps/nodes below

    # Constraints (membership + residuals); mirror map_builder.cc:360-381.
    for kind, meta, arrays in records:
        if kind != "pose_graph":
            continue
        for i, tag in enumerate(meta["constraint_tags"]):
            st, si = arrays["c_submap"][i]
            nt, ni = arrays["c_node"][i]
            if int(st) not in remap or int(nt) not in remap:
                continue
            submap_id = SubmapId(remap[int(st)], int(si))
            node_id = NodeId(remap[int(nt)], int(ni))
            if submap_id not in pose_graph._submap_data:
                continue
            if node_id not in pose_graph._trajectory_nodes:
                continue
            pose_graph._submap_data.at(submap_id).node_ids.add(node_id)
            pose_graph._constraints.append(
                Constraint(
                    submap_id=submap_id,
                    node_id=node_id,
                    pose=ConstraintPose(
                        zbar_ij=arrays["c_zbar"][i],
                        translation_weight=float(arrays["c_weights"][i][0]),
                        rotation_weight=float(arrays["c_weights"][i][1]),
                    ),
                    tag=tag,
                )
            )
    return remap


def pbstream_info(state: bytes) -> Dict[str, Any]:
    """pbstream info CLI equivalent (io/internal/pbstream_info.cc).
    Handles both the reference proto payloads and the npz payloads."""
    reader = ProtoStreamReader(_io.BytesIO(state))
    counts: Dict[str, int] = {}
    version = None
    first = reader.read()
    if first is None:
        return {"format_version": None, "record_counts": {}}
    try:
        _, meta, _ = _decode_record(first)
        version = meta["format_version"]
        payload = "npz"
    except Exception:
        from cartographer_tpu_torch.io.proto import state_pb2 as pb

        header = pb.SerializationHeader()
        header.ParseFromString(first)
        version = header.format_version
        payload = "proto"
    for record in reader:
        if payload == "npz":
            kind, _, _ = _decode_record(record)
        else:
            from cartographer_tpu_torch.io.proto import state_pb2 as pb

            msg = pb.SerializedData()
            msg.ParseFromString(record)
            kind = msg.WhichOneof("data") or "unknown"
        counts[kind] = counts.get(kind, 0) + 1
    return {
        "format_version": version,
        "payload": payload,
        "record_counts": counts,
    }
