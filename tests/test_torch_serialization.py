"""Saving and loading state with the port against the JAX package:
compression and interpolation, the pbstream container, the npz state
records in both directions (a JAX state loaded and re-serialized by the
port gives the JAX package's own records, a port state loads in the JAX
package as the same graph), pure localization on a loaded frozen map
(tests/test_serialization.py's scenario through the port), and a 3D round
trip and 3D localization (native and device search) on
tests/test_torch_pose_graph_3d.py's world."""

import io

import numpy as np
import pytest
import torch

from cartographer_tpu.common import config as jconfig
from cartographer_tpu.io import serialization as jser
from cartographer_tpu.io.proto_stream import ProtoStreamReader as JReader
from cartographer_tpu.mapping.id import NodeId as JNodeId
from cartographer_tpu.mapping.id import SubmapId as JSubmapId
from cartographer_tpu.mapping.map_builder import MapBuilder as JaxMapBuilder
from cartographer_tpu.sensor import compression as jcomp
from cartographer_tpu.transform import interpolation as jinterp
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.io import serialization as tser
from cartographer_tpu_torch.io.proto_stream import ProtoStreamReader, ProtoStreamWriter
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.map_builder import MapBuilder
from cartographer_tpu_torch.mapping.paged_grid_3d import as_dense
from cartographer_tpu_torch.sensor import compression as tcomp
from cartographer_tpu_torch.testing.synthetic import (
    FAKE_START_TIME,
    generate_fake_range_measurements,
)
from cartographer_tpu_torch.transform import interpolation as tinterp
from cartographer_tpu_torch.transform import rigid3
from tests.test_serialization import build_map as build_jax_map
from tests.test_torch_backend_card import one_torch_thread  # noqa: F401
import tests.test_torch_pose_graph_3d as pg3d

# In a process that has loaded JAX, the first torch.exp has been seen to
# return values up to 1.4e-4 off (CPU, about 1 run in 12); later calls
# agree with numpy to an ulp. One call here, before any test, takes it.
torch.exp(torch.zeros(4096))

CPU = torch.device("cpu")
DIRECTION = np.array([2.0, 1.0, 0.0]) / np.sqrt(5.0)


def map_builder_options(mod):
    """tests/test_map_builder.py's 2D options, from either package."""
    pose_graph = mod.PoseGraphOptions(optimize_every_n_nodes=20)
    pose_graph.constraint_builder.fast_correlative_scan_matcher = (
        mod.FastCorrelativeScanMatcherOptions2D(
            linear_search_window=2.0, angular_search_window=np.radians(20.0),
            branch_and_bound_depth=4,
        )
    )
    pose_graph.constraint_builder.sampling_ratio = 0.5
    return mod.MapBuilderOptions(use_trajectory_builder_2d=True, pose_graph=pose_graph)


def trajectory_options(mod, trimmer=None):
    return mod.TrajectoryBuilderOptions(
        trajectory_builder_2d=mod.TrajectoryBuilder2DOptions(
            use_imu_data=False,
            max_range=10.0,
            motion_filter=mod.MotionFilterOptions(max_distance_meters=0.04),
            submaps=mod.SubmapsOptions2D(
                num_range_data=8,
                grid_options_2d=mod.GridOptions2D(resolution=0.05, grid_size=512),
            ),
        ),
        pure_localization_trimmer=trimmer,
    )


def feed_world(mb, tid, time_shift=0.0):
    builder = mb.get_trajectory_builder(tid)
    for m in generate_fake_range_measurements(
        translation=DIRECTION * 1.2, duration=6.0, time_step=0.05
    ):
        m.time += time_shift
        builder.add_sensor_data("range", m)
    mb.finish_trajectory(tid)
    mb.pose_graph.run_final_optimization()


@pytest.fixture(scope="module")
def jax_map():
    """tests/test_serialization.py's map, built by the JAX package."""
    mb, _ = build_jax_map()
    return mb, mb.serialize_state()


@pytest.fixture(scope="module")
def port_map():
    """The same map built by the port on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mb = MapBuilder(map_builder_options(tconfig), device=CPU)
        feed_world(mb, mb.add_trajectory_builder({"range"}, trajectory_options(tconfig)))
    finally:
        torch.set_num_threads(threads)
    return mb, mb.serialize_state()


def records(state):
    return list(ProtoStreamReader(io.BytesIO(state)))


# -- numpy modules and the container -----------------------------------------


@pytest.mark.parametrize("n", [0, 1, 300, 5000])
def test_compression_matches_jax(n):
    pts = np.random.default_rng(n).uniform(-40, 40, (n, 3)).astype(np.float32)
    t, j = tcomp.CompressedPointCloud.compress(pts), jcomp.CompressedPointCloud.compress(pts)
    for name in ("block_coords", "point_block", "packed_offsets"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert t.num_points == j.num_points == n
    np.testing.assert_array_equal(t.decompress(), j.decompress())
    np.testing.assert_allclose(t.decompress(), pts, atol=1e-3)


def test_interpolation_matches_jax():
    rng = np.random.default_rng(2)
    tbuf, jbuf = tinterp.TransformInterpolationBuffer(4), jinterp.TransformInterpolationBuffer(4)
    for k in range(6):
        axis = rng.normal(size=3)
        pose = rigid3.make(rng.normal(size=3), rigid3.quat_from_angle_axis(0.3 * axis))
        tbuf.push(0.5 * k, pose)
        jbuf.push(0.5 * k, pose)
    assert tbuf.size() == jbuf.size() == 4
    assert tbuf.earliest_time() == jbuf.earliest_time() == 1.0
    for t in (1.0, 1.2, 1.75, 2.0, 2.49, 2.5):
        assert tbuf.has(t) and jbuf.has(t)
        np.testing.assert_array_equal(tbuf.lookup(t), jbuf.lookup(t))
    assert not tbuf.has(0.9) and not jbuf.has(0.9)


def test_proto_stream_roundtrip_and_bad_magic():
    buf = io.BytesIO()
    w = ProtoStreamWriter(buf)
    w.write(b"hello world")
    w.write(b"x" * 100000)
    data = buf.getvalue()
    assert data[:8] == bytes.fromhex("db01f55b7b1f1d7b")
    assert records(data) == [b"hello world", b"x" * 100000]
    assert list(JReader(io.BytesIO(data))) == [b"hello world", b"x" * 100000]
    with pytest.raises(ValueError):
        ProtoStreamReader(io.BytesIO(b"not a pbstream..."))


# -- 2D state in both directions ------------------------------------------------


def test_jax_state_loads_in_the_port(jax_map):
    """Poses, grids and the frozen flag carry over; the port's
    re-serialization of the loaded state is the JAX package's own, record
    by record after decompression."""
    jmb, state = jax_map
    info = tser.pbstream_info(state)
    assert info == jser.pbstream_info(state)
    assert info["format_version"] == 2 and info["record_counts"]["node"] > 10
    tmb = MapBuilder(map_builder_options(tconfig), device=CPU)
    assert tmb.load_state(state, load_frozen_state=True) == {0: 0}
    assert tmb.pose_graph.is_trajectory_frozen(0)
    assert tmb.num_trajectory_builders() == 1
    jnodes = jmb.pose_graph.get_trajectory_nodes()
    tnodes = tmb.pose_graph.get_trajectory_nodes()
    assert tnodes.size() == jnodes.size()
    for node_id, node in jnodes.items(JNodeId):
        np.testing.assert_array_equal(
            tnodes.at(NodeId(*node_id)).global_pose, node.global_pose)
    for submap_id, data in jmb.pose_graph.get_all_submap_data().items(JSubmapId):
        grid = tmb.pose_graph.get_all_submap_data().at(SubmapId(*submap_id)).submap.grid
        assert grid.log_odds.device.type == "cpu"
        np.testing.assert_array_equal(grid.log_odds.numpy(), np.asarray(data.submap.grid.log_odds))
        np.testing.assert_array_equal(grid.known.numpy(), np.asarray(data.submap.grid.known))
    assert [c.tag for c in tmb.pose_graph.constraints] == [
        c.tag for c in jmb.pose_graph.constraints]
    jmb2 = JaxMapBuilder(map_builder_options(jconfig))
    jmb2.load_state(state, load_frozen_state=True)
    assert records(tmb.serialize_state()) == records(jmb2.serialize_state())


def test_port_state_loads_in_jax(port_map):
    tmb, state = port_map
    assert [k for k in tser.pbstream_info(state)["record_counts"]] == [
        "pose_graph", "submap_2d", "node"]
    jmb = JaxMapBuilder(map_builder_options(jconfig))
    assert jmb.load_state(state, load_frozen_state=True) == {0: 0}
    tnodes = tmb.pose_graph.get_trajectory_nodes()
    jnodes = jmb.pose_graph.get_trajectory_nodes()
    assert jnodes.size() == tnodes.size() > 10
    for node_id, node in tnodes.items(NodeId):
        jnode = jnodes.at(JNodeId(*node_id))
        np.testing.assert_array_equal(jnode.global_pose, node.global_pose)
        np.testing.assert_array_equal(jnode.constant_data.local_pose, node.constant_data.local_pose)
    for submap_id, data in tmb.pose_graph.get_all_submap_data().items(SubmapId):
        jgrid = jmb.pose_graph.get_all_submap_data().at(JSubmapId(*submap_id)).submap.grid
        np.testing.assert_array_equal(np.asarray(jgrid.log_odds), data.submap.grid.log_odds.numpy())
        np.testing.assert_array_equal(np.asarray(jgrid.known), data.submap.grid.known.numpy())
    jcons, tcons = jmb.pose_graph.constraints, tmb.pose_graph.constraints
    assert [(c.submap_id, c.node_id, c.tag) for c in jcons] == [
        (JSubmapId(*c.submap_id), JNodeId(*c.node_id), c.tag) for c in tcons]
    # Loaded back into the port, the state serializes to the same records
    # as the JAX package's load of it.
    tmb2 = MapBuilder(map_builder_options(tconfig), device=CPU)
    tmb2.load_state(state)
    assert records(tmb2.serialize_state()) == records(jmb.serialize_state())


def test_pure_localization_on_a_loaded_frozen_map(port_map):
    """tests/test_serialization.py::test_pure_localization_on_frozen_map
    through the port: localized within 0.15 m in the frozen map's frame,
    INTER constraints to the frozen trajectory, at most 3 submaps kept."""
    _, state = port_map
    mb = MapBuilder(map_builder_options(tconfig), device=CPU)
    mb.load_state(state, load_frozen_state=True)
    tid = mb.add_trajectory_builder(
        {"range"}, trajectory_options(
            tconfig, tconfig.PureLocalizationTrimmerOptions(max_submaps_to_keep=3)))
    assert tid == 1
    mb.pose_graph.set_initial_trajectory_pose(
        tid, 0, rigid3.identity(), FAKE_START_TIME + 100.0)
    feed_world(mb, tid, time_shift=100.0)
    velocity = DIRECTION * 1.2 / 6.0
    errs = [
        np.linalg.norm(rigid3.trans(node.global_pose)
                       - (node.constant_data.time - 100.0 - FAKE_START_TIME) * velocity)
        for node_id, node in mb.pose_graph.get_trajectory_nodes().items(NodeId)
        if node_id.trajectory_id == tid
    ]
    assert len(errs) > 10 and max(errs) < 0.15
    assert any(c.tag == "INTER_SUBMAP" and c.submap_id.trajectory_id == 0
               and c.node_id.trajectory_id == tid for c in mb.pose_graph.constraints)
    assert mb.pose_graph.get_all_submap_data().size_of_trajectory_or_zero(tid) <= 3
    assert mb.pose_graph.is_trajectory_frozen(0)


# -- 3D ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_map_3d():
    """tests/test_torch_pose_graph_3d.py's 3D map, built by the port."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mb = MapBuilder(pg3d.map_builder_options("native"), device=CPU)
        pg3d.drive(mb)
    finally:
        torch.set_num_threads(threads)
    return mb, mb.serialize_state()


def test_3d_round_trip(port_map_3d, one_torch_thread):  # noqa: F811
    """tests/test_torch_pose_graph_3d.py's world: poses, the
    dense grids (the paged building grids through to_dense) and the
    histograms come back; the JAX package loads the port's 3D state and
    re-serializes it to the port's records."""
    mb, state = port_map_3d
    assert tser.pbstream_info(state)["record_counts"]["submap_3d"] >= 2
    mb2 = MapBuilder(pg3d.map_builder_options("native"), device=CPU)
    assert mb2.load_state(state) == {0: 0}
    assert mb2.pose_graph.is_trajectory_frozen(0)
    nodes1, nodes2 = (m.pose_graph.get_trajectory_nodes() for m in (mb, mb2))
    assert nodes2.size() == nodes1.size() > 10
    for node_id, node in nodes1.items(NodeId):
        loaded = nodes2.at(node_id)
        np.testing.assert_allclose(loaded.global_pose, node.global_pose, atol=1e-6)
        np.testing.assert_array_equal(
            loaded.constant_data.rotational_scan_matcher_histogram,
            node.constant_data.rotational_scan_matcher_histogram)
        np.testing.assert_array_equal(
            loaded.constant_data.high_resolution_point_cloud,
            node.constant_data.high_resolution_point_cloud)
    for submap_id, data in mb.pose_graph.get_all_submap_data().items(SubmapId):
        loaded = mb2.pose_graph.get_all_submap_data().at(submap_id).submap
        for name in ("high_resolution_grid", "low_resolution_grid"):
            want, got = as_dense(getattr(data.submap, name)), getattr(loaded, name)
            np.testing.assert_array_equal(got.values.numpy(), want.values.numpy())
            np.testing.assert_array_equal(got.origin.numpy(), want.origin.numpy())
        np.testing.assert_array_equal(loaded.rotational_scan_matcher_histogram,
                                      data.submap.rotational_scan_matcher_histogram)
    jmb = JaxMapBuilder(jconfig.MapBuilderOptions(
        use_trajectory_builder_2d=False, use_trajectory_builder_3d=True))
    jmb.load_state(state)
    assert records(jmb.serialize_state()) == records(mb2.serialize_state())


@pytest.mark.parametrize("backend", ["native", "device"])
def test_3d_localization_on_a_loaded_frozen_map(port_map_3d, backend, one_torch_thread):  # noqa: F811
    """A second pass over the world in the loaded frozen 3D map: the
    loaded submaps (their histograms, dense grids and, for the native
    search, the nodes' clouds) are searched, INTER constraints reach the
    frozen trajectory, the trimmer keeps 3 submaps, every node within
    0.1 x travel of the truth."""
    _, state = port_map_3d
    mb = MapBuilder(pg3d.map_builder_options(backend), device=CPU)
    mb.load_state(state)
    _, errs = pg3d.drive(
        mb, trimmer=tconfig.PureLocalizationTrimmerOptions(max_submaps_to_keep=3),
        before_feed=lambda: mb.pose_graph.set_initial_trajectory_pose(
            1, 0, rigid3.identity(), FAKE_START_TIME))
    assert max(errs) < 0.1 * pg3d.TRAVEL
    assert any(c.tag == "INTER_SUBMAP" and c.node_id.trajectory_id == 1
               and c.submap_id.trajectory_id == 0 for c in mb.pose_graph.constraints)
    assert mb.pose_graph.get_all_submap_data().size_of_trajectory_or_zero(1) <= 3
    assert mb.pose_graph.is_trajectory_frozen(0)


def test_load_rejects_unknown_format_versions():
    """A state of a later format version, in either format, or a pbstream
    without a pose graph raises ValueError (the JAX package asserts)."""
    from cartographer_tpu_torch.io.proto import state_pb2 as pb

    buf = io.BytesIO()
    writer = ProtoStreamWriter(buf)
    writer.write(tser._encode_record("header", {"format_version": 3}, {}))
    with pytest.raises(ValueError, match="version 3"):
        MapBuilder(map_builder_options(tconfig), device=CPU).load_state(buf.getvalue())
    for version, match in ((3, "version 3"), (2, "no pose graph")):
        buf = io.BytesIO()
        writer = ProtoStreamWriter(buf)
        writer.write(pb.SerializationHeader(format_version=version).SerializeToString())
        with pytest.raises(ValueError, match=match):
            MapBuilder(map_builder_options(tconfig), device=CPU).load_state_pbstream(
                buf.getvalue())
