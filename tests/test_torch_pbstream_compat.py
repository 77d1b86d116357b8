"""The reference wire format through the port against the JAX package:
the golden pbstream (tests/data/reference_golden_mini.pbstream, assembled
independently of both packages) decodes through the port; the port's
write_pbstream gives the JAX package's records for the same loaded state
(2D and 3D); the cell and cloud conversions; v1 -> v2 migration."""

import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.common import config as jconfig
from cartographer_tpu.io import pbstream_compat as jpc
from cartographer_tpu.io.proto_stream import ProtoStreamReader as JReader
from cartographer_tpu.mapping.grid_2d import Grid2D as JGrid2D
from cartographer_tpu.mapping.map_builder import MapBuilder as JaxMapBuilder
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.io import pbstream_compat as tpc
from cartographer_tpu_torch.io.proto import state_pb2 as pb
from cartographer_tpu_torch.io.proto_stream import ProtoStreamReader, ProtoStreamWriter
from cartographer_tpu_torch.mapping.grid_2d import grid_from_numpy, world_to_cell
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.map_builder import MapBuilder
from tests.test_torch_backend_card import one_torch_thread  # noqa: F401
from tests.test_torch_serialization import map_builder_options, port_map  # noqa: F401
import tests.test_torch_pose_graph_3d as pg3d

# In a process that has loaded JAX, the first torch.exp has been seen to
# return values up to 1.4e-4 off (CPU, about 1 run in 12); later calls
# agree with numpy to an ulp. One call here, before any test, takes it.
torch.exp(torch.zeros(4096))

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "data"))
from make_golden_pbstream import (  # noqa: E402
    CLOUD,
    KNOWN_CELLS,
    MAX_X,
    MAX_Y,
    NODE0_POSE,
    NODE0_TICKS,
    NODE1_POSE,
    RES,
    SUBMAP_POSE,
)

CPU = torch.device("cpu")
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "reference_golden_mini.pbstream")


def golden():
    with open(GOLDEN, "rb") as f:
        return f.read()


def records(state):
    return list(ProtoStreamReader(io.BytesIO(state)))


def port_2d():
    return MapBuilder(tconfig.MapBuilderOptions(use_trajectory_builder_2d=True), device=CPU)


@pytest.fixture(scope="module")
def port_map_3d():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mb = MapBuilder(pg3d.map_builder_options("native"), device=CPU)
        pg3d.drive(mb)
    finally:
        torch.set_num_threads(threads)
    return mb


# -- the golden stream ----------------------------------------------------------


def test_golden_poses_and_constraints():
    mb = port_2d()
    assert mb.load_state_pbstream(golden(), load_frozen_state=True) == {0: 0}
    pg = mb.pose_graph
    submaps = pg.get_all_submap_data()
    assert submaps.size() == 1
    sid, sdata = next(iter(submaps.items(SubmapId)))
    assert sid == SubmapId(0, 0) and sdata.submap.insertion_finished
    np.testing.assert_allclose(sdata.submap.local_pose, SUBMAP_POSE[:2] + (0.0,), atol=1e-9)
    np.testing.assert_allclose(
        pg._optimization_problem.submap_data.at(sid).global_pose,
        SUBMAP_POSE[:2] + (0.0,), atol=1e-9)
    nodes = pg.get_trajectory_nodes()
    np.testing.assert_allclose(nodes.at(NodeId(0, 0)).global_pose[:3], NODE0_POSE, atol=1e-9)
    np.testing.assert_allclose(nodes.at(NodeId(0, 1)).global_pose[:3], NODE1_POSE, atol=1e-9)
    assert nodes.at(NodeId(0, 0)).constant_data.time == pytest.approx(NODE0_TICKS / 1e7, rel=1e-12)
    assert any(c.tag == "INTRA_SUBMAP" and c.submap_id == SubmapId(0, 0)
               and c.node_id == NodeId(0, 0) for c in pg.constraints)
    assert pg.is_trajectory_frozen(0) and mb.num_trajectory_builders() == 1


def test_golden_grid_probabilities_at_world_coordinates():
    mb = port_2d()
    mb.load_state_pbstream(golden())
    grid = next(iter(mb.pose_graph.get_all_submap_data().items(SubmapId)))[1].submap.grid
    assert grid.log_odds.device.type == "cpu"
    prob, known = grid.probability().numpy(), grid.known.numpy()
    for cx, cy, p in KNOWN_CELLS:
        world = torch.tensor([MAX_X - RES * (cy + 0.5), MAX_Y - RES * (cx + 0.5)])
        ix, iy = np.floor(world_to_cell(grid, world).numpy()).astype(int)
        assert known[iy, ix], (cx, cy)
        assert prob[iy, ix] == pytest.approx(p, abs=1.0 / 32766)
    assert int(known.sum()) == len(KNOWN_CELLS)


def test_golden_node_cloud_decodes():
    mb = port_2d()
    mb.load_state_pbstream(golden())
    cloud = mb.pose_graph.get_trajectory_nodes().at(
        NodeId(0, 0)).constant_data.filtered_gravity_aligned_point_cloud
    got = sorted(map(tuple, np.round(np.asarray(cloud), 4)))
    np.testing.assert_allclose(got, sorted(tuple(np.round(p, 4)) for p in CLOUD), atol=1e-3)


def test_golden_reserialize_stability_and_jax_records():
    """The port's write of the loaded golden state loads back alike, and is
    the JAX package's write of its own load, record by record."""
    mb = port_2d()
    mb.load_state_pbstream(golden())
    blob = mb.serialize_state_pbstream(include_unfinished_submaps=True)
    mb2 = port_2d()
    mb2.load_state_pbstream(blob)
    a = next(iter(mb.pose_graph.get_all_submap_data().items(SubmapId)))[1].submap
    b = next(iter(mb2.pose_graph.get_all_submap_data().items(SubmapId)))[1].submap
    np.testing.assert_allclose(a.local_pose, b.local_pose, atol=1e-9)
    ka, kb = a.grid.known.numpy(), b.grid.known.numpy()
    assert ka.sum() == kb.sum()
    np.testing.assert_allclose(a.grid.probability().numpy()[ka].sum(),
                               b.grid.probability().numpy()[kb].sum(), rtol=1e-5)
    jmb = JaxMapBuilder(jconfig.MapBuilderOptions(use_trajectory_builder_2d=True))
    jmb.load_state_pbstream(golden())
    assert records(blob) == list(JReader(io.BytesIO(jmb.serialize_state_pbstream())))


# -- write_pbstream against the JAX package's ---------------------------------------


def test_write_pbstream_2d_matches_jax(port_map):  # noqa: F811
    """A port-built 2D map (npz state) loaded into both packages: the two
    write_pbstream streams hold the same records, and the port reads its
    own stream back as the same graph."""
    tmb, state = port_map
    mb = MapBuilder(map_builder_options(tconfig), device=CPU)
    mb.load_state(state)
    jmb = JaxMapBuilder(map_builder_options(jconfig))
    jmb.load_state(state)
    blob = mb.serialize_state_pbstream()
    assert blob[:8] == bytes.fromhex("db01f55b7b1f1d7b")
    assert records(blob) == records(jpc.write_pbstream(jmb))
    mb2 = MapBuilder(map_builder_options(tconfig), device=CPU)
    assert mb2.load_state_pbstream(blob) == {0: 0}
    nodes1, nodes2 = (m.pose_graph.get_trajectory_nodes() for m in (tmb, mb2))
    assert nodes2.size() == nodes1.size()
    for node_id, node in nodes1.items(NodeId):
        np.testing.assert_allclose(nodes2.at(node_id).global_pose, node.global_pose, atol=1e-6)
    assert len(mb2.pose_graph.constraints) == len(tmb.pose_graph.constraints)
    for submap_id, d1 in tmb.pose_graph.get_all_submap_data().items(SubmapId):
        d2 = mb2.pose_graph.get_all_submap_data().at(submap_id)
        assert int(d2.submap.grid.known.sum()) == int(d1.submap.grid.known.sum())


def test_write_pbstream_3d_matches_jax(port_map_3d):
    """The port's 3D map through write_pbstream: the JAX package's records
    for the same state, and a read that keeps poses, histograms and the
    known cells of every grid."""
    state = port_map_3d.serialize_state()
    jmb = JaxMapBuilder(jconfig.MapBuilderOptions(
        use_trajectory_builder_2d=False, use_trajectory_builder_3d=True))
    jmb.load_state(state)
    mb = MapBuilder(pg3d.map_builder_options("native"), device=CPU)
    mb.load_state(state)
    blob = mb.serialize_state_pbstream()
    assert records(blob) == records(jpc.write_pbstream(jmb))
    mb2 = MapBuilder(pg3d.map_builder_options("native"), device=CPU)
    assert mb2.load_state_pbstream(blob) == {0: 0}
    nodes1, nodes2 = (m.pose_graph.get_trajectory_nodes() for m in (port_map_3d, mb2))
    assert nodes2.size() == nodes1.size() > 10
    for node_id, node in nodes1.items(NodeId):
        np.testing.assert_allclose(nodes2.at(node_id).global_pose, node.global_pose, atol=1e-6)
        np.testing.assert_allclose(
            nodes2.at(node_id).constant_data.rotational_scan_matcher_histogram,
            node.constant_data.rotational_scan_matcher_histogram, atol=1e-5)
    for submap_id, d1 in mb.pose_graph.get_all_submap_data().items(SubmapId):
        d2 = mb2.pose_graph.get_all_submap_data().at(submap_id)
        for name in ("high_resolution_grid", "low_resolution_grid"):
            g1, g2 = getattr(d1.submap, name), getattr(d2.submap, name)
            assert g2.values.device.type == "cpu"
            assert int(g2.known().sum()) == int(g1.known().sum())


# -- conversions ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 300])
def test_cloud_conversion_matches_jax(n):
    pts = np.random.default_rng(n).uniform(-40, 40, (n, 3)).astype(np.float32)
    tmsg, jmsg = pb.CompressedPointCloud(), pb.CompressedPointCloud()
    tpc.compress_cloud_to_proto(pts, tmsg)
    jpc.compress_cloud_to_proto(pts, jmsg)
    assert tmsg.SerializeToString() == jmsg.SerializeToString()
    out = tpc.decompress_cloud_from_proto(tmsg)
    np.testing.assert_array_equal(out, jpc.decompress_cloud_from_proto(jmsg))
    qa, qb = np.round(pts.astype(np.float64) / 1e-3), np.round(out.astype(np.float64) / 1e-3)
    np.testing.assert_allclose(pts[np.lexsort(qa.T)], out[np.lexsort(qb.T)], atol=2e-3)


def test_cell_conversions_match_jax():
    values = np.array([0, 1, 100, 16000, 32767], np.int32)
    log_odds, known = tpc.cost_value_to_log_odds(values)
    j_log_odds, j_known = jpc.cost_value_to_log_odds(values)
    np.testing.assert_array_equal(log_odds, j_log_odds)
    np.testing.assert_array_equal(known, j_known)
    np.testing.assert_array_equal(tpc.log_odds_to_cost_value(log_odds, known), values)
    probs = np.array([0, 1, 8000, 16000, 24000, 32767], np.int64)
    q = tpc.prob_value_to_log_odds_int8(probs)
    np.testing.assert_array_equal(q, jpc.prob_value_to_log_odds_int8(probs))
    back = tpc.log_odds_int8_to_prob_value(q)
    np.testing.assert_array_equal(back, jpc.log_odds_int8_to_prob_value(q))
    assert (np.diff(back[1:]) > 0).all() and np.abs(back[1:] - probs[1:]).max() < 300


def test_grid2d_conversion_matches_jax():
    rng = np.random.default_rng(6)
    known = rng.random((128, 128)) < 0.1
    known[:20] = False
    log_odds = np.where(known, rng.normal(0.0, 2.0, (128, 128)), 0.0).astype(np.float32)
    origin = np.array([-3.2, -2.9], np.float32)
    tmsg, jmsg = pb.Grid2D(), pb.Grid2D()
    tpc.grid2d_to_proto(grid_from_numpy(log_odds, known, origin, 0.05, CPU), tmsg)
    jpc.grid2d_to_proto(JGrid2D(log_odds=jnp.asarray(log_odds), known=jnp.asarray(known),
                                origin=jnp.asarray(origin), resolution=0.05), jmsg)
    assert tmsg.SerializeToString() == jmsg.SerializeToString()
    grid, jgrid = tpc.grid2d_from_proto(tmsg, 128, CPU), jpc.grid2d_from_proto(jmsg, 128)
    np.testing.assert_array_equal(grid.log_odds.numpy(), np.asarray(jgrid.log_odds))
    np.testing.assert_array_equal(grid.known.numpy(), np.asarray(jgrid.known))
    np.testing.assert_array_equal(grid.origin.numpy(), np.asarray(jgrid.origin))
    assert int(grid.known.sum()) == int(known.sum())


# -- migration ----------------------------------------------------------------------


def test_v1_to_v2_migration_matches_jax(port_map_3d):
    """serialization_format_migration.cc: a v1 stream (3D submaps without
    histograms) migrates to v2 with histograms rebuilt from the INTRA
    nodes, as the JAX package migrates it; the result loads back."""
    reader = ProtoStreamReader(io.BytesIO(port_map_3d.serialize_state_pbstream()))
    header = pb.SerializationHeader.FromString(reader.read())
    header.format_version = 1
    buf = io.BytesIO()
    writer = ProtoStreamWriter(buf)
    writer.write(header.SerializeToString())
    stripped = 0
    for raw in reader:
        rec = pb.SerializedData.FromString(raw)
        if rec.WhichOneof("data") == "submap" and rec.submap.HasField("submap_3d"):
            stripped += len(rec.submap.submap_3d.rotational_scan_matcher_histogram) > 0
            del rec.submap.submap_3d.rotational_scan_matcher_histogram[:]
        writer.write(rec.SerializeToString())
    assert stripped > 0
    v1 = buf.getvalue()
    migrated = tpc.migrate_pbstream(v1)
    assert records(migrated) == records(jpc.migrate_pbstream(v1))
    out = records(migrated)
    assert pb.SerializationHeader.FromString(out[0]).format_version == 2
    restored = [
        np.asarray(rec.submap.submap_3d.rotational_scan_matcher_histogram)
        for rec in map(pb.SerializedData.FromString, out[1:])
        if rec.WhichOneof("data") == "submap" and rec.submap.HasField("submap_3d")
    ]
    assert sum(h.size > 0 and np.isfinite(h).all() and h.max() > 0 for h in restored) > 0
    mb = MapBuilder(pg3d.map_builder_options("native"), device=CPU)
    assert mb.load_state_pbstream(migrated)
    # A version-2 stream is rewritten unchanged.
    assert records(tpc.migrate_pbstream(migrated)) == out
