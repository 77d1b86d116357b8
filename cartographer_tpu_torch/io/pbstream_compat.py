"""Reference-format pbstream reading/writing (wire-level compatibility).

Writes and reads the reference's actual serialization format: the pbstream
container (io/proto_stream.py, byte-identical framing) carrying the protobuf
messages of mapping/proto/serialization.proto (recreated field-for-field in
io/proto/state.proto). Record order follows
io/internal/mapping_state_serialization.cc:28-237.

Representation conversions:
* 2D grids: reference uint16 correspondence-cost cells in (max-corner,
  y-down) indexing <-> our float32 log-odds arrays in (min-corner, y-up)
  indexing: their_cells[W, H] view equals ours[::-1, ::-1].T; values map
  through cost = 0.1 + (v-1) * 0.8/32766 (probability_values.h
  BoundedFloatToValue) with 0 = unknown.
* 3D grids: reference sparse COO uint16 probability values at voxel indices
  (centers at index*resolution) <-> our dense int8 log-odds volumes.
* Compressed clouds: the reference's exact int32 block stream
  (compressed_point_cloud.cc: per block [count, bx, by, bz, packed...],
  10 bits per coordinate at 1 mm).
* Times: seconds <-> int64 universal ticks (100 ns).

Port of cartographer_tpu/io/pbstream_compat.py: the same messages, equal
record by record after decompression. Grids are read back from the device
for writing; the grids a read builds go onto the MapBuilder's device.
"""

from __future__ import annotations

import io as _io
from typing import Dict, List, Optional

import numpy as np

from cartographer_tpu_torch.io.proto import state_pb2 as pb
from cartographer_tpu_torch.io.proto_stream import ProtoStreamReader, ProtoStreamWriter
from cartographer_tpu_torch.mapping import probability_values as pv
from cartographer_tpu_torch.mapping.constraint_builder_2d import (
    INTER_SUBMAP,
    INTRA_SUBMAP,
    Constraint,
    ConstraintPose,
)
from cartographer_tpu_torch.mapping.grid_2d import compute_cropped, grid_from_numpy
from cartographer_tpu_torch.mapping.hybrid_grid import LOG_ODDS_SCALE, grid3d_from_numpy
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.optimization_problem_2d import NodeSpec2D
from cartographer_tpu_torch.mapping.optimization_problem_3d import NodeSpec3D, TrajectoryData
from cartographer_tpu_torch.mapping.paged_grid_3d import as_dense
from cartographer_tpu_torch.mapping.pose_graph_2d import InternalSubmapData, SubmapState
from cartographer_tpu_torch.mapping.submap_2d import Submap2D
from cartographer_tpu_torch.mapping.submap_3d import Submap3D
from cartographer_tpu_torch.mapping.trajectory_node import TrajectoryNode, TrajectoryNodeData
from cartographer_tpu_torch.transform import rigid3

TICKS_PER_SECOND = 10_000_000


def time_to_ticks(t: float) -> int:
    return int(round(t * TICKS_PER_SECOND))


def ticks_to_time(ticks: int) -> float:
    return ticks / TICKS_PER_SECOND


# -- transforms --------------------------------------------------------------


def rigid3_to_proto(pose: np.ndarray, out: pb.Rigid3d) -> None:
    pose = np.asarray(pose, np.float64)
    out.translation.x, out.translation.y, out.translation.z = pose[:3]
    out.rotation.w, out.rotation.x, out.rotation.y, out.rotation.z = pose[3:7]


def rigid3_from_proto(msg: pb.Rigid3d) -> np.ndarray:
    return np.array(
        [
            msg.translation.x,
            msg.translation.y,
            msg.translation.z,
            msg.rotation.w,
            msg.rotation.x,
            msg.rotation.y,
            msg.rotation.z,
        ]
    )


def quat_to_proto(q: np.ndarray, out: pb.Quaterniond) -> None:
    out.w, out.x, out.y, out.z = np.asarray(q, np.float64)


def quat_from_proto(msg: pb.Quaterniond) -> np.ndarray:
    q = np.array([msg.w, msg.x, msg.y, msg.z])
    n = np.linalg.norm(q)
    return q / n if n > 0 else np.array([1.0, 0.0, 0.0, 0.0])


# -- probability value conversion --------------------------------------------


def cost_value_to_log_odds(values: np.ndarray) -> tuple:
    """uint16 correspondence-cost values -> (log_odds f32, known bool)."""
    known = values != 0
    cost = pv.MIN_CORRESPONDENCE_COST + (np.maximum(values, 1) - 1) * (
        (pv.MAX_CORRESPONDENCE_COST - pv.MIN_CORRESPONDENCE_COST) / 32766.0
    )
    prob = np.clip(1.0 - cost, pv.MIN_PROBABILITY, pv.MAX_PROBABILITY)
    log_odds = np.log(prob / (1.0 - prob)).astype(np.float32)
    return np.where(known, log_odds, 0.0).astype(np.float32), known


def log_odds_to_cost_value(log_odds: np.ndarray, known: np.ndarray) -> np.ndarray:
    prob = 1.0 / (1.0 + np.exp(-np.asarray(log_odds, np.float64)))
    cost = np.clip(
        1.0 - prob, pv.MIN_CORRESPONDENCE_COST, pv.MAX_CORRESPONDENCE_COST
    )
    v = (
        np.round(
            (cost - pv.MIN_CORRESPONDENCE_COST)
            * (32766.0 / (pv.MAX_CORRESPONDENCE_COST - pv.MIN_CORRESPONDENCE_COST))
        ).astype(np.int32)
        + 1
    )
    return np.where(known, v, 0).astype(np.int32)


def prob_value_to_log_odds_int8(values: np.ndarray) -> np.ndarray:
    """uint16 probability values -> int8 log-odds (3D grids)."""
    prob = pv.MIN_PROBABILITY + (np.maximum(values, 1) - 1) * (
        (pv.MAX_PROBABILITY - pv.MIN_PROBABILITY) / 32766.0
    )
    log_odds = np.log(prob / (1.0 - prob))
    q = np.round(log_odds / LOG_ODDS_SCALE).astype(np.int32)
    q = np.where(q == 0, np.where(log_odds >= 0, 1, -1), q)
    return np.where(values != 0, np.clip(q, -127, 127), 0).astype(np.int8)


def log_odds_int8_to_prob_value(values: np.ndarray) -> np.ndarray:
    log_odds = values.astype(np.float64) * LOG_ODDS_SCALE
    prob = np.clip(
        1.0 / (1.0 + np.exp(-log_odds)), pv.MIN_PROBABILITY, pv.MAX_PROBABILITY
    )
    v = (
        np.round(
            (prob - pv.MIN_PROBABILITY)
            * (32766.0 / (pv.MAX_PROBABILITY - pv.MIN_PROBABILITY))
        ).astype(np.int32)
        + 1
    )
    return np.where(values != 0, v, 0).astype(np.int32)


# -- compressed point clouds -------------------------------------------------

_BITS = 10
_BLOCK = 1 << _BITS
_MASK = _BLOCK - 1
_PRECISION = 0.001


def compress_cloud_to_proto(points: np.ndarray, out: pb.CompressedPointCloud) -> None:
    """The reference's exact block stream (compressed_point_cloud.cc)."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    out.num_points = len(points)
    if len(points) == 0:
        return
    raster = np.round(points / _PRECISION).astype(np.int64)
    block = raster >> _BITS
    offset = (raster & _MASK).astype(np.int64)
    packed = offset[:, 0] | (offset[:, 1] << _BITS) | (offset[:, 2] << (2 * _BITS))
    keys = (block[:, 0] << 42) ^ (block[:, 1] << 21) ^ block[:, 2]
    order = np.argsort(keys, kind="stable")
    stream: List[int] = []
    i = 0
    while i < len(points):
        j = i
        while j < len(points) and keys[order[j]] == keys[order[i]]:
            j += 1
        b = block[order[i]]
        stream.append(j - i)
        stream.extend(int(c) for c in b)
        stream.extend(int(packed[order[k]]) for k in range(i, j))
        i = j
    out.point_data.extend(stream)


def decompress_cloud_from_proto(msg: pb.CompressedPointCloud) -> np.ndarray:
    data = np.asarray(msg.point_data, np.int64)
    points = np.zeros((msg.num_points, 3), np.float64)
    i = 0
    n = 0
    while n < msg.num_points and i < len(data):
        count = int(data[i])
        bx, by, bz = data[i + 1], data[i + 2], data[i + 3]
        i += 4
        pts = data[i : i + count]
        i += count
        points[n : n + count, 0] = ((bx << _BITS) + (pts & _MASK)) * _PRECISION
        points[n : n + count, 1] = (
            (by << _BITS) + ((pts >> _BITS) & _MASK)
        ) * _PRECISION
        points[n : n + count, 2] = ((bz << _BITS) + (pts >> (2 * _BITS))) * _PRECISION
        n += count
    return points.astype(np.float32)


# -- 2D grid conversion ------------------------------------------------------


def grid2d_to_proto(grid, out: pb.Grid2D) -> None:
    """Our Grid2D (cropped to known cells) -> reference Grid2D message."""
    cropped = compute_cropped(grid)
    known = cropped.known
    h, w = known.shape if known.size else (0, 0)
    log_odds = np.zeros((h, w), np.float32)
    if known.size:
        p = np.clip(cropped.probability, 1e-6, 1 - 1e-6)
        log_odds = np.log(p / (1 - p)).astype(np.float32)
    values = log_odds_to_cost_value(log_odds, known)  # [h, w] mine
    # Reference layout: their_array[W, H] with their[a, b] = mine[H-1-b, W-1-a].
    theirs = values[::-1, ::-1].T  # [w, h]
    out.limits.resolution = grid.resolution
    origin = grid.origin.cpu().numpy() + np.array(
        [cropped.offset_yx[1], cropped.offset_yx[0]]
    ) * grid.resolution
    out.limits.max.x = origin[0] + w * grid.resolution
    out.limits.max.y = origin[1] + h * grid.resolution
    out.limits.cell_limits.num_x_cells = h
    out.limits.cell_limits.num_y_cells = w
    out.cells.extend(int(v) for v in theirs.ravel())
    out.min_correspondence_cost = pv.MIN_CORRESPONDENCE_COST
    out.max_correspondence_cost = pv.MAX_CORRESPONDENCE_COST
    out.probability_grid_2d.SetInParent()
    if known.any():
        ys, xs = np.nonzero(known)
        # Known cells box in THEIR index convention.
        tx = h - 1 - ys
        ty = w - 1 - xs
        out.known_cells_box.min_x = int(tx.min())
        out.known_cells_box.max_x = int(tx.max())
        out.known_cells_box.min_y = int(ty.min())
        out.known_cells_box.max_y = int(ty.max())


def grid2d_from_proto(msg: pb.Grid2D, grid_size: int, device):
    """Reference Grid2D message -> our Grid2D (embedded in a fixed extent)
    on `device`."""
    res = msg.limits.resolution
    h = msg.limits.cell_limits.num_x_cells  # their x-dim = our rows
    w = msg.limits.cell_limits.num_y_cells
    theirs = np.asarray(msg.cells, np.int32).reshape(w, h) if len(msg.cells) else np.zeros((w, h), np.int32)
    mine = theirs.T[::-1, ::-1]  # [h, w]
    log_odds, known = cost_value_to_log_odds(mine)
    origin = np.array([msg.limits.max.x - w * res, msg.limits.max.y - h * res])
    size = max(grid_size, 1)
    while size < max(h, w):
        size *= 2
    lo = np.zeros((size, size), np.float32)
    kn = np.zeros((size, size), bool)
    # Center the content in the fixed extent.
    oy = (size - h) // 2
    ox = (size - w) // 2
    lo[oy : oy + h, ox : ox + w] = log_odds
    kn[oy : oy + h, ox : ox + w] = known
    new_origin = origin - np.array([ox, oy]) * res
    return grid_from_numpy(lo, kn, new_origin, res, device)


# -- 3D grid conversion ------------------------------------------------------


def grid3d_to_proto(grid, out: pb.HybridGrid) -> None:
    values = grid.values.cpu().numpy()
    zi, yi, xi = np.nonzero(values)
    origin = grid.origin.cpu().numpy().astype(np.float64)
    base = np.round(origin / grid.resolution).astype(np.int64)
    out.resolution = grid.resolution
    out.x_indices.extend(int(v) for v in (xi + base[0]))
    out.y_indices.extend(int(v) for v in (yi + base[1]))
    out.z_indices.extend(int(v) for v in (zi + base[2]))
    out.values.extend(
        int(v) for v in log_odds_int8_to_prob_value(values[zi, yi, xi])
    )


def grid3d_from_proto(msg: pb.HybridGrid, grid_size: int, device):
    """Reference HybridGrid message -> our dense Grid3D on `device`."""
    res = msg.resolution
    xi = np.asarray(msg.x_indices, np.int64)
    yi = np.asarray(msg.y_indices, np.int64)
    zi = np.asarray(msg.z_indices, np.int64)
    vals = prob_value_to_log_odds_int8(np.asarray(msg.values, np.int64))
    size = grid_size
    if len(xi):
        span = max(
            xi.max() - xi.min() + 1, yi.max() - yi.min() + 1, zi.max() - zi.min() + 1
        )
        while size < span:
            size *= 2
        cx = (xi.min() + xi.max()) // 2
        cy = (yi.min() + yi.max()) // 2
        cz = (zi.min() + zi.max()) // 2
    else:
        cx = cy = cz = 0
    base = np.array([cx - size // 2, cy - size // 2, cz - size // 2])
    volume = np.zeros((size, size, size), np.int8)
    if len(xi):
        volume[zi - base[2], yi - base[1], xi - base[0]] = vals
    return grid3d_from_numpy(volume, np.float32(base * res), res, device)


# -- top-level write ---------------------------------------------------------


def write_pbstream(map_builder, include_unfinished_submaps: bool = True) -> bytes:
    """Serialize the MapBuilder state in the reference's pbstream format."""
    pose_graph = map_builder.pose_graph
    is_2d = pose_graph._is_2d
    out = _io.BytesIO()
    writer = ProtoStreamWriter(out)

    header = pb.SerializationHeader()
    header.format_version = 2
    writer.write(header.SerializeToString())

    # PoseGraph record.
    record = pb.SerializedData()
    pg = record.pose_graph
    for c in pose_graph.constraints:
        cc = pg.constraint.add()
        cc.submap_id.trajectory_id = c.submap_id.trajectory_id
        cc.submap_id.submap_index = c.submap_id.submap_index
        cc.node_id.trajectory_id = c.node_id.trajectory_id
        cc.node_id.node_index = c.node_id.node_index
        z = np.asarray(c.pose.zbar_ij)
        rigid3_to_proto(rigid3.embed_3d(z) if z.shape[-1] == 3 else z, cc.relative_pose)
        cc.translation_weight = c.pose.translation_weight
        cc.rotation_weight = c.pose.rotation_weight
        cc.tag = (
            pb.PoseGraph.Constraint.INTER_SUBMAP
            if c.tag == INTER_SUBMAP
            else pb.PoseGraph.Constraint.INTRA_SUBMAP
        )
    for trajectory_id in sorted(pose_graph._trajectory_states.keys()):
        traj = pg.trajectory.add()
        traj.trajectory_id = trajectory_id
        for index, node in pose_graph._trajectory_nodes.trajectory(trajectory_id):
            n = traj.node.add()
            n.node_index = index
            n.timestamp = time_to_ticks(node.constant_data.time)
            rigid3_to_proto(np.asarray(node.global_pose), n.pose)
        for index, data in pose_graph._submap_data.trajectory(trajectory_id):
            spec = pose_graph._optimization_problem.submap_data.get(
                SubmapId(trajectory_id, index)
            )
            s = traj.submap.add()
            s.submap_index = index
            gp = (
                np.asarray(spec.global_pose)
                if spec is not None
                else np.asarray(data.submap.local_pose)
            )
            rigid3_to_proto(
                rigid3.embed_3d(gp) if gp.shape[-1] == 3 else gp, s.pose
            )
    for lid, pose in getattr(
        pose_graph._optimization_problem, "landmark_data", {}
    ).items():
        lp = pg.landmark_poses.add()
        lp.landmark_id = lid
        p = np.asarray(pose)
        rigid3_to_proto(rigid3.embed_3d(p) if p.shape[-1] == 3 else p, lp.global_pose)
    writer.write(record.SerializeToString())

    # Submaps.
    for submap_id, data in pose_graph._submap_data.items(SubmapId):
        submap = data.submap
        if not include_unfinished_submaps and not submap.insertion_finished:
            continue
        record = pb.SerializedData()
        record.submap.submap_id.trajectory_id = submap_id.trajectory_id
        record.submap.submap_id.submap_index = submap_id.submap_index
        if is_2d:
            target = record.submap.submap_2d
            lp = np.asarray(submap.local_pose)
            rigid3_to_proto(
                rigid3.embed_3d(lp) if lp.shape[-1] == 3 else lp, target.local_pose
            )
            target.num_range_data = submap.num_range_data
            target.finished = submap.insertion_finished
            grid2d_to_proto(submap.grid, target.grid)
        else:
            target = record.submap.submap_3d
            rigid3_to_proto(np.asarray(submap.local_pose), target.local_pose)
            target.num_range_data = submap.num_range_data
            target.finished = submap.insertion_finished
            grid3d_to_proto(
                as_dense(submap.high_resolution_grid),
                target.high_resolution_hybrid_grid,
            )
            grid3d_to_proto(
                as_dense(submap.low_resolution_grid),
                target.low_resolution_hybrid_grid,
            )
            target.rotational_scan_matcher_histogram.extend(
                float(x) for x in submap.rotational_scan_matcher_histogram
            )
        writer.write(record.SerializeToString())

    # Nodes.
    for node_id, node in pose_graph._trajectory_nodes.items(NodeId):
        record = pb.SerializedData()
        record.node.node_id.trajectory_id = node_id.trajectory_id
        record.node.node_id.node_index = node_id.node_index
        nd = record.node.node_data
        cd = node.constant_data
        nd.timestamp = time_to_ticks(cd.time)
        quat_to_proto(np.asarray(cd.gravity_alignment), nd.gravity_alignment)
        compress_cloud_to_proto(
            cd.filtered_gravity_aligned_point_cloud,
            nd.filtered_gravity_aligned_point_cloud,
        )
        if cd.high_resolution_point_cloud is not None:
            compress_cloud_to_proto(
                cd.high_resolution_point_cloud, nd.high_resolution_point_cloud
            )
        if cd.low_resolution_point_cloud is not None:
            compress_cloud_to_proto(
                cd.low_resolution_point_cloud, nd.low_resolution_point_cloud
            )
        if cd.rotational_scan_matcher_histogram is not None:
            nd.rotational_scan_matcher_histogram.extend(
                float(x) for x in cd.rotational_scan_matcher_histogram
            )
        rigid3_to_proto(np.asarray(cd.local_pose), nd.local_pose)
        writer.write(record.SerializeToString())

    # Trajectory data (3D gravity/extrinsics).
    trajectory_data = getattr(pose_graph._optimization_problem, "trajectory_data", None)
    if trajectory_data:
        for trajectory_id, td in sorted(trajectory_data.items()):
            record = pb.SerializedData()
            record.trajectory_data.trajectory_id = trajectory_id
            record.trajectory_data.gravity_constant = td.gravity_constant
            quat_to_proto(td.imu_calibration, record.trajectory_data.imu_calibration)
            writer.write(record.SerializeToString())

    writer.close()
    return out.getvalue()


# -- top-level read ----------------------------------------------------------


def read_pbstream(map_builder, state: bytes, load_frozen_state: bool = True) -> Dict[int, int]:
    """Load a reference-format pbstream into a MapBuilder, its grids on the
    MapBuilder's device. Returns the trajectory id remapping."""
    pose_graph = map_builder.pose_graph
    device = map_builder.device
    is_2d = pose_graph._is_2d
    reader = ProtoStreamReader(_io.BytesIO(state))

    header = pb.SerializationHeader()
    header.ParseFromString(reader.read())
    if header.format_version not in (1, 2):
        raise ValueError(f"unsupported pbstream format version {header.format_version}")

    pose_graph_proto: Optional[pb.PoseGraph] = None
    submap_records: List[pb.Submap] = []
    node_records: List[pb.Node] = []
    trajectory_data_records: List[pb.TrajectoryData] = []
    for raw in reader:
        record = pb.SerializedData()
        record.ParseFromString(raw)
        kind = record.WhichOneof("data")
        if kind == "pose_graph":
            pose_graph_proto = pb.PoseGraph()
            pose_graph_proto.CopyFrom(record.pose_graph)
        elif kind == "submap":
            submap_records.append(pb.Submap.FromString(record.submap.SerializeToString()))
        elif kind == "node":
            node_records.append(pb.Node.FromString(record.node.SerializeToString()))
        elif kind == "trajectory_data":
            trajectory_data_records.append(
                pb.TrajectoryData.FromString(
                    record.trajectory_data.SerializeToString()
                )
            )
        # imu/odometry/fixed frame/landmark sensor logs and options are
        # skipped for frozen maps (reference LoadState does the same unless
        # resuming).
    if pose_graph_proto is None:
        raise ValueError("pbstream has no pose graph")

    serialized_ids = sorted(t.trajectory_id for t in pose_graph_proto.trajectory)
    remap: Dict[int, int] = {}
    offset = len(pose_graph._trajectory_states)
    for i, t in enumerate(serialized_ids):
        new_id = offset + i
        remap[t] = new_id
        pose_graph.add_trajectory_if_needed(new_id)
        if load_frozen_state:
            pose_graph.freeze_trajectory(new_id)

    # Global poses from the trajectory section.
    node_global = {}
    submap_global = {}
    node_times = {}
    for traj in pose_graph_proto.trajectory:
        tid = remap[traj.trajectory_id]
        for n in traj.node:
            node_global[NodeId(tid, n.node_index)] = rigid3_from_proto(n.pose)
            node_times[NodeId(tid, n.node_index)] = ticks_to_time(n.timestamp)
        for s in traj.submap:
            submap_global[SubmapId(tid, s.submap_index)] = rigid3_from_proto(s.pose)

    # Submaps (fixed-extent embedding; grows to the content size if needed).
    grid_size_2d = 256
    for msg in submap_records:
        submap_id = SubmapId(
            remap[msg.submap_id.trajectory_id], msg.submap_id.submap_index
        )
        if is_2d and msg.HasField("submap_2d"):
            s2 = msg.submap_2d
            grid = grid2d_from_proto(s2.grid, grid_size_2d, device)
            local_pose3 = rigid3_from_proto(s2.local_pose)
            submap = Submap2D(
                local_pose=rigid3.project_2d(local_pose3),
                grid=grid,
                num_range_data=s2.num_range_data,
                insertion_finished=s2.finished,
            )
            data = InternalSubmapData(submap)
            data.state = SubmapState.FINISHED
            pose_graph._submap_data.insert(submap_id, data)
            gp = submap_global.get(submap_id, local_pose3)
            pose_graph._optimization_problem.insert_submap(
                submap_id, rigid3.project_2d(gp)
            )
            pose_graph._constraint_builder.set_submap_local_pose(
                submap_id, rigid3.project_2d(local_pose3)
            )
        elif not is_2d and msg.HasField("submap_3d"):
            s3 = msg.submap_3d
            submap = Submap3D(
                local_pose=rigid3_from_proto(s3.local_pose),
                high_resolution_grid=grid3d_from_proto(
                    s3.high_resolution_hybrid_grid, 128, device
                ),
                low_resolution_grid=grid3d_from_proto(
                    s3.low_resolution_hybrid_grid, 64, device
                ),
                rotational_scan_matcher_histogram=np.asarray(
                    s3.rotational_scan_matcher_histogram, np.float32
                ),
                num_range_data=s3.num_range_data,
                insertion_finished=s3.finished,
            )
            data = InternalSubmapData(submap)
            data.state = SubmapState.FINISHED
            pose_graph._submap_data.insert(submap_id, data)
            gp = submap_global.get(submap_id, rigid3_from_proto(s3.local_pose))
            pose_graph._optimization_problem.insert_submap(submap_id, gp)

    # Nodes.
    for msg in node_records:
        node_id = NodeId(remap[msg.node_id.trajectory_id], msg.node_id.node_index)
        nd = msg.node_data
        local_pose = rigid3_from_proto(nd.local_pose)
        gravity = quat_from_proto(nd.gravity_alignment)
        cd = TrajectoryNodeData(
            time=ticks_to_time(nd.timestamp),
            gravity_alignment=gravity,
            filtered_gravity_aligned_point_cloud=decompress_cloud_from_proto(
                nd.filtered_gravity_aligned_point_cloud
            ),
            high_resolution_point_cloud=decompress_cloud_from_proto(
                nd.high_resolution_point_cloud
            ),
            low_resolution_point_cloud=decompress_cloud_from_proto(
                nd.low_resolution_point_cloud
            ),
            rotational_scan_matcher_histogram=np.asarray(
                nd.rotational_scan_matcher_histogram, np.float32
            ),
            local_pose=local_pose,
        )
        global_pose = node_global.get(node_id, local_pose)
        pose_graph._trajectory_nodes.insert(node_id, TrajectoryNode(cd, global_pose))
        if is_2d:
            local_2d = rigid3.project_2d(
                rigid3.compose(
                    local_pose, rigid3.inverse(rigid3.rotation(gravity))
                )
            )
            pose_graph._optimization_problem.insert_trajectory_node(
                node_id,
                NodeSpec2D(
                    time=cd.time,
                    local_pose_2d=local_2d,
                    global_pose_2d=rigid3.project_2d(global_pose),
                    gravity_alignment=gravity,
                ),
            )
        else:
            pose_graph._optimization_problem.insert_trajectory_node(
                node_id,
                NodeSpec3D(
                    time=cd.time, local_pose=local_pose, global_pose=global_pose
                ),
            )

    # Constraints (membership + residuals).
    for cc in pose_graph_proto.constraint:
        if (
            cc.submap_id.trajectory_id not in remap
            or cc.node_id.trajectory_id not in remap
        ):
            continue
        submap_id = SubmapId(
            remap[cc.submap_id.trajectory_id], cc.submap_id.submap_index
        )
        node_id = NodeId(remap[cc.node_id.trajectory_id], cc.node_id.node_index)
        if submap_id not in pose_graph._submap_data:
            continue
        if node_id not in pose_graph._trajectory_nodes:
            continue
        pose_graph._submap_data.at(submap_id).node_ids.add(node_id)
        zbar3 = rigid3_from_proto(cc.relative_pose)
        zbar = rigid3.project_2d(zbar3) if is_2d else zbar3
        pose_graph._constraints.append(
            Constraint(
                submap_id=submap_id,
                node_id=node_id,
                pose=ConstraintPose(
                    zbar_ij=zbar,
                    translation_weight=cc.translation_weight,
                    rotation_weight=cc.rotation_weight,
                ),
                tag=INTER_SUBMAP
                if cc.tag == pb.PoseGraph.Constraint.INTER_SUBMAP
                else INTRA_SUBMAP,
            )
        )

    for td in trajectory_data_records:
        if td.trajectory_id in remap and hasattr(
            pose_graph._optimization_problem, "trajectory_data"
        ):
            pose_graph._optimization_problem.trajectory_data[
                remap[td.trajectory_id]
            ] = TrajectoryData(
                gravity_constant=td.gravity_constant,
                imu_calibration=quat_from_proto(td.imu_calibration),
            )

    for new_id in remap.values():
        map_builder._trajectory_builders[new_id] = None
        map_builder._num_trajectories = max(map_builder._num_trajectories, new_id + 1)
    return remap


# -- version migration --------------------------------------------------------


def migrate_pbstream(state: bytes) -> bytes:
    """v1 -> v2 pbstream migration (io/serialization_format_migration.cc
    MigrateStreamFormatToVersion2 + MigrateSubmapFormatVersion1ToVersion2):
    3D submaps gain rotational scan matcher histograms accumulated from
    their INTRA-constraint nodes' histograms, each rotated into the submap
    frame by yaw(submap_local_pose^-1 * node_local_pose *
    gravity_alignment^-1); the header version is bumped to 2. Version-2
    streams are rewritten unchanged."""
    from cartographer_tpu_torch.ops.scan_matching.rotational_histogram import (
        rotate_histogram,
    )

    reader = ProtoStreamReader(_io.BytesIO(state))
    header = pb.SerializationHeader()
    header.ParseFromString(reader.read())
    records = [pb.SerializedData.FromString(raw) for raw in reader]

    if header.format_version < 2:
        submaps: Dict[tuple, pb.SerializedData] = {}
        nodes: Dict[tuple, pb.SerializedData] = {}
        pose_graph_proto = None
        for rec in records:
            kind = rec.WhichOneof("data")
            if kind == "submap":
                sid = rec.submap.submap_id
                submaps[(sid.trajectory_id, sid.submap_index)] = rec
            elif kind == "node":
                nid = rec.node.node_id
                nodes[(nid.trajectory_id, nid.node_index)] = rec
            elif kind == "pose_graph":
                pose_graph_proto = rec.pose_graph
        any_3d = any(
            r.submap.HasField("submap_3d") for r in submaps.values()
        )
        if any_3d and pose_graph_proto is not None:
            for con in pose_graph_proto.constraint:
                if con.tag != pb.PoseGraph.Constraint.INTRA_SUBMAP:
                    continue
                node_rec = nodes.get(
                    (con.node_id.trajectory_id, con.node_id.node_index)
                )
                sub_rec = submaps.get(
                    (con.submap_id.trajectory_id, con.submap_id.submap_index)
                )
                if node_rec is None or sub_rec is None:
                    continue
                nd = node_rec.node.node_data
                hist = np.asarray(
                    nd.rotational_scan_matcher_histogram, np.float32
                )
                if hist.size == 0 or not sub_rec.submap.HasField("submap_3d"):
                    continue
                s3 = sub_rec.submap.submap_3d
                submap_pose = rigid3_from_proto(s3.local_pose)
                node_pose = rigid3_from_proto(nd.local_pose)
                gravity = quat_from_proto(nd.gravity_alignment)
                q = rigid3.quat_multiply(
                    rigid3.quat_multiply(
                        rigid3.quat_conjugate(rigid3.quat(submap_pose)),
                        rigid3.quat(node_pose),
                    ),
                    rigid3.quat_conjugate(gravity),
                )
                yaw = float(rigid3.get_yaw(q))
                rotated = np.asarray(rotate_histogram(hist, yaw), np.float32)
                existing = s3.rotational_scan_matcher_histogram
                if len(existing) == 0:
                    existing.extend(rotated.tolist())
                else:
                    for i in range(min(len(existing), rotated.size)):
                        existing[i] += float(rotated[i])
        header.format_version = 2

    buf = _io.BytesIO()
    writer = ProtoStreamWriter(buf)
    writer.write(header.SerializeToString())
    for rec in records:
        writer.write(rec.SerializeToString())
    writer.close()
    return buf.getvalue()
