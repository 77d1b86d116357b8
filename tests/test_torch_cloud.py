"""The port's cloud layer against the JAX package: the wire codec both
ways for every sensor kind, a JAX stub driving the port's server (one
service name, one wire), the port's server against an in-process port
MapBuilder fed the same stream (node poses equal exactly) and against the
JAX server (the first local-SLAM results within 1e-3 m / 1e-3 rad), the
port's copies of tests/test_client_server.py, and GetSubmapData on a short
3D trajectory. Every server here runs on the CPU over real gRPC on
localhost."""

import time

import numpy as np
import pytest
import torch

from cartographer_tpu.cloud import map_builder_server as jserver_module
from cartographer_tpu.cloud import wire as jwire
from cartographer_tpu.cloud.map_builder_server import MapBuilderServer as JaxServer
from cartographer_tpu.cloud.map_builder_stub import MapBuilderStub as JaxStub
from cartographer_tpu.common import config as jconfig
from cartographer_tpu.sensor import data as jdata
from cartographer_tpu.testing import synthetic as jsynthetic
from cartographer_tpu_torch.cloud import map_builder_server as tserver_module
from cartographer_tpu_torch.cloud import wire as twire
from cartographer_tpu_torch.cloud.map_builder_server import MapBuilderServer
from cartographer_tpu_torch.cloud.map_builder_stub import MapBuilderStub
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.mapping.grid_2d import compute_cropped
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.map_builder import MapBuilder
from cartographer_tpu_torch.mapping.paged_grid_3d import as_dense
from cartographer_tpu_torch.sensor import data as tdata
from cartographer_tpu_torch.sensor.data import LandmarkData, LandmarkObservation
from cartographer_tpu_torch.testing import synthetic as tsynthetic
from cartographer_tpu_torch.testing.synthetic import (
    FAKE_START_TIME,
    generate_fake_range_measurements,
)
from cartographer_tpu_torch.transform import rigid3
from tests.test_torch_backend_card import one_torch_thread  # noqa: F401
from tests.test_torch_serialization import map_builder_options, trajectory_options
import tests.test_torch_pose_graph_3d as pg3d

CPU = torch.device("cpu")
DURATION = 4.0
TRAVEL = 1.0
DIRECTION = np.array([2.0, 1.0, 0.0]) / np.sqrt(5.0)


# -- the wire codec -------------------------------------------------------------------


def sensor_data(mod, kind):
    """One sample of `kind` from either package's sensor.data, made from a
    seed."""
    rng = np.random.default_rng(7)
    pose = rigid3.make(rng.normal(size=3), rigid3.quat_normalize(rng.normal(size=4)))
    if kind.startswith("range"):
        return mod.TimedPointCloudData(
            time=FAKE_START_TIME + 0.25,
            origin=rng.normal(size=3).astype(np.float32),
            ranges=mod.TimedPointCloud(
                points=rng.normal(size=(50, 3)).astype(np.float32),
                times=np.linspace(-0.05, 0.0, 50).astype(np.float32),
            ),
            intensities=rng.uniform(size=50).astype(np.float32)
            if kind == "range_intensities" else None,
        )
    if kind == "imu":
        return mod.ImuData(time=FAKE_START_TIME + 0.01, linear_acceleration=rng.normal(size=3),
                           angular_velocity=rng.normal(size=3))
    if kind == "odometry":
        return mod.OdometryData(time=FAKE_START_TIME + 0.02, pose=pose)
    if kind.startswith("fixed_frame_pose"):
        return mod.FixedFramePoseData(time=FAKE_START_TIME + 0.03,
                                      pose=None if kind.endswith("none") else pose)
    observations = [] if kind == "landmark_empty" else [
        mod.LandmarkObservation(id=f"lm_{i}", landmark_to_tracking_transform=pose + i,
                                translation_weight=10.0 + i, rotation_weight=2.0 * i)
        for i in range(3)
    ]
    return mod.LandmarkData(time=FAKE_START_TIME + 0.04, landmark_observations=observations)


def fields(data):
    """A decoded sample as plain values: arrays, numbers, strings, None."""
    if data is None or isinstance(data, (str, int, float)):
        return data
    if isinstance(data, np.ndarray):
        return np.asarray(data)
    if isinstance(data, (list, tuple)):
        return [fields(x) for x in data]
    return {k: fields(v) for k, v in vars(data).items()}


def assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


KINDS = ["range", "range_intensities", "imu", "odometry", "fixed_frame_pose",
         "fixed_frame_pose_none", "landmark", "landmark_empty"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sensor_payload_decodes_equal_in_the_other_package(kind, direction):
    """Encoded by one package, decoded by both: the same sensor id, the
    same type name and fields, arrays equal with their dtypes (the npz
    bytes hold no time stamp, but are compared only as decoded)."""
    src, dst = (jwire, twire) if direction == "jax_to_port" else (twire, jwire)
    src_data = jdata if src is jwire else tdata
    payload = src.encode_sensor_data("sensor_7", sensor_data(src_data, kind))
    sid_own, own = src.decode_sensor_data(payload)
    sid_other, other = dst.decode_sensor_data(payload)
    assert sid_own == sid_other == "sensor_7"
    assert type(own).__name__ == type(other).__name__
    assert_same(fields(own), fields(other))


def test_message_codec_and_service_agree():
    """Tagged messages decode to equal kinds, meta and arrays in both
    packages, and the service name is the JAX package's."""
    arrays = {"ids": np.arange(6, dtype=np.int32).reshape(3, 2),
              "poses": np.random.default_rng(0).normal(size=(3, 7))}
    meta = {"trajectory_id": 3, "tags": ["INTRA_SUBMAP", "INTER_SUBMAP"], "value": 0.5}
    for src, dst in ((jwire, twire), (twire, jwire)):
        kind, m, a = dst.decode(src.encode("node_poses", meta, arrays))
        assert kind == "node_poses" and m == meta
        assert_same(a, arrays)
    assert tserver_module.SERVICE == jserver_module.SERVICE == "cartographer_tpu.MapBuilderService"
    assert twire.method_path("AddTrajectory") == jserver_module._method_path("AddTrajectory")


def test_server_defaults_to_cuda():
    """`device=None` means cuda: without CUDA the server raises, as
    MapBuilder does, and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MapBuilderServer(map_builder_options(tconfig))


# -- servers driven over the wire -----------------------------------------------------


def stream_world(builder, duration=DURATION, travel=TRAVEL, t_offset=0.0, synthetic=tsynthetic):
    """tests/test_client_server.py's drive: the semicircle wall while moving
    `travel` along (2, 1, 0) in `duration` s, a scan every 0.05 s, as
    `synthetic`'s package's sensor data."""
    measurements = synthetic.generate_fake_range_measurements(
        translation=DIRECTION * travel, duration=duration, time_step=0.05
    )
    for m in measurements:
        m.time += t_offset
        builder.add_sensor_data("range", m)
    return DIRECTION * travel / duration


def node_errors(poses, times, velocity):
    return [float(np.linalg.norm(pose[:3] - (t - FAKE_START_TIME) * velocity))
            for pose, t in zip(poses, times)]


def run_over_wire(server_type, stub_type, options, topts, device=None, synthetic=tsynthetic):
    """A server of `server_type` driven through a stub of `stub_type`:
    local-SLAM results by subscription, node poses and times after the
    final optimization."""
    server = server_type(options) if device is None else server_type(options, device=device)
    server.start()
    try:
        stub = stub_type(f"localhost:{server.port}")
        results = []
        subscription = stub.receive_local_slam_results(
            lambda tid, t, pose: results.append((t, np.asarray(pose))))
        tid = stub.add_trajectory_builder({"range"}, topts)
        velocity = stream_world(stub.get_trajectory_builder(tid), synthetic=synthetic)
        stub.finish_trajectory(tid)
        stub.pose_graph.run_final_optimization()
        poses = stub.pose_graph.get_trajectory_node_poses()
        nodes = server.map_builder.pose_graph.get_trajectory_nodes()
        times = [nodes.at(nid).constant_data.time for nid in poses]
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and len(results) < len(poses):
            time.sleep(0.05)
        subscription.cancel()
        stub.close()
    finally:
        server.shutdown()
    return dict(server=server, results=sorted(results, key=lambda r: r[0]),
                poses=poses, times=times, velocity=velocity)


def sync_options(mod):
    options = map_builder_options(mod)
    options.async_pose_graph = False
    return options


@pytest.fixture(scope="module")
def port_run():
    """The port's server on the CPU, synchronous pose graph, the test
    world streamed through the port's stub."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield run_over_wire(MapBuilderServer, MapBuilderStub, sync_options(tconfig),
                            trajectory_options(tconfig), device=CPU)
    finally:
        torch.set_num_threads(threads)


def test_server_matches_an_in_process_map_builder(port_run):
    """The same stream fed to a port MapBuilder in this thread gives the
    server's node poses exactly (one collation order, one pose graph)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mb = MapBuilder(sync_options(tconfig), device=CPU)
        tid = mb.add_trajectory_builder({"range"}, trajectory_options(tconfig))
        stream_world(mb.get_trajectory_builder(tid))
        mb.finish_trajectory(tid)
        mb.pose_graph.run_final_optimization()
    finally:
        torch.set_num_threads(threads)
    local = {nid: node.global_pose for nid, node in mb.pose_graph.get_trajectory_nodes().items(NodeId)}
    assert len(local) > 10
    assert local.keys() == port_run["poses"].keys()
    for nid, pose in port_run["poses"].items():
        assert np.array_equal(pose, local[nid]), nid


def test_server_against_the_jax_server(port_run):
    """The JAX server (synchronous drain) on the same stream: the first 8
    local-SLAM results within 1e-3 m / 1e-3 rad (free runs part later,
    ROADMAP Queue C), and both runs' nodes within the JAX test's 0.1 x
    travel of the truth."""
    jax_run = run_over_wire(JaxServer, JaxStub, sync_options(jconfig), trajectory_options(jconfig),
                            synthetic=jsynthetic)
    assert len(port_run["results"]) >= 8 and len(jax_run["results"]) >= 8
    for (tp, pp), (tj, pj) in zip(port_run["results"][:8], jax_run["results"][:8]):
        assert tp == tj
        a, b = rigid3.project_2d(pp), rigid3.project_2d(pj)
        assert np.max(np.abs(a[:2] - b[:2])) < 1e-3
        assert abs(np.arctan2(np.sin(a[2] - b[2]), np.cos(a[2] - b[2]))) < 1e-3
    for run in (port_run, jax_run):
        assert len(run["poses"]) > 10
        assert max(node_errors(run["poses"].values(), run["times"], run["velocity"])) < 0.1 * TRAVEL


def test_jax_stub_drives_the_port_server(one_torch_thread):  # noqa: F811
    """The JAX package's stub against the port's server: trajectory,
    streamed scans, finish, optimization, node poses, constraints and a
    submap texture, all as the server holds them."""
    server = MapBuilderServer(map_builder_options(tconfig), device=CPU)
    server.start()
    try:
        stub = JaxStub(f"localhost:{server.port}")
        tid = stub.add_trajectory_builder({"range"}, trajectory_options(jconfig))
        stream_world(stub.get_trajectory_builder(tid), duration=2.0, travel=0.5, synthetic=jsynthetic)
        stub.finish_trajectory(tid)
        stub.pose_graph.run_final_optimization()
        poses = stub.pose_graph.get_trajectory_node_poses()
        nodes = server.map_builder.pose_graph.get_trajectory_nodes()
        assert len(poses) > 3 and len(poses) == nodes.size()
        for nid, pose in poses.items():
            assert np.array_equal(pose, nodes.at(NodeId(*nid)).global_pose)
        assert stub.pose_graph.is_trajectory_finished(tid)
        assert [c["tag"] for c in stub.pose_graph.constraints()] == [
            c.tag for c in server.map_builder.pose_graph.constraints]
        texture = stub.get_submap_data(SubmapId(tid, 0))
        cropped = compute_cropped(
            server.map_builder.pose_graph.get_all_submap_data().at(SubmapId(tid, 0)).submap.grid)
        assert np.array_equal(texture["alpha"], cropped.known.astype(np.float32))
        assert np.array_equal(
            texture["intensity"], np.where(cropped.known, cropped.probability, 0.5).astype(np.float32))
        stub.close()
    finally:
        server.shutdown()


# -- tests/test_client_server.py through the port ------------------------------------------


def test_local_slam_through_rpc(one_torch_thread):  # noqa: F811
    server = MapBuilderServer(map_builder_options(tconfig), device=CPU)
    server.start()
    try:
        stub = MapBuilderStub(f"localhost:{server.port}")
        tid = stub.add_trajectory_builder({"range"}, trajectory_options(tconfig))
        velocity = stream_world(stub.get_trajectory_builder(tid))
        server.wait_until_idle()
        stub.finish_trajectory(tid)
        stub.pose_graph.run_final_optimization()

        node_poses = stub.pose_graph.get_trajectory_node_poses()
        assert len(node_poses) > 10
        nodes = server.map_builder.pose_graph.get_trajectory_nodes()
        times = [nodes.at(nid).constant_data.time for nid in node_poses]
        assert max(node_errors(node_poses.values(), times, velocity)) < 0.1 * TRAVEL
        assert stub.pose_graph.is_trajectory_finished(tid)
        assert any(c["tag"] == "INTRA_SUBMAP" for c in stub.pose_graph.constraints())
        assert len(stub.serialize_state()) > 1000

        texture = stub.get_submap_data(SubmapId(tid, 0))
        assert texture is not None
        assert texture["submap_version"] > 0
        assert texture["intensity"].shape == texture["alpha"].shape
        assert texture["alpha"].any()
        assert stub.get_submap_data(SubmapId(99, 0)) is None
        stub.close()
    finally:
        server.shutdown()


def test_uplink_federation_with_restart(one_torch_thread):  # noqa: F811
    uplink = MapBuilderServer(map_builder_options(tconfig), device=CPU)
    uplink.start()
    uplink_port = uplink.port
    robot = MapBuilderServer(map_builder_options(tconfig), uplink_address=f"localhost:{uplink_port}",
                             uplink_batch_size=5, device=CPU)
    robot.start()
    try:
        stub = MapBuilderStub(f"localhost:{robot.port}")
        tid = stub.add_trajectory_builder({"range"}, trajectory_options(tconfig))
        builder = stub.get_trajectory_builder(tid)
        stream_world(builder, duration=1.5)
        builder.close_streams()
        robot.wait_until_idle()
        assert robot._uploader.wait_until_drained()

        # The upstream goes away mid-stream; the uploader reconnects to its
        # restarted successor and keeps uploading.
        uplink.shutdown()
        stream_world(builder, duration=1.0, t_offset=10.0)
        builder.close_streams()
        time.sleep(0.5)
        uplink2 = MapBuilderServer(map_builder_options(tconfig), address=f"localhost:{uplink_port}",
                                   device=CPU)
        uplink2.start()
        try:
            stream_world(builder, duration=1.5, t_offset=20.0)
            builder.close_streams()
            robot.wait_until_idle()
            assert robot._uploader.wait_until_drained()
            uplink2.wait_until_idle()
            assert robot.map_builder.pose_graph.get_trajectory_nodes().size() > 10
            assert uplink2.map_builder.pose_graph.get_trajectory_nodes().size() >= 1
        finally:
            uplink2.shutdown()
        stub.close()
    finally:
        robot.shutdown()


def test_subscriptions_landmarks_delete(tmp_path, one_torch_thread):  # noqa: F811
    server = MapBuilderServer(map_builder_options(tconfig), device=CPU)
    server.start()
    try:
        stub = MapBuilderStub(f"localhost:{server.port}")
        local_results, optimizations = [], []
        sub1 = stub.receive_local_slam_results(lambda tid, t, pose: local_results.append((tid, t, pose)))
        sub2 = stub.receive_global_slam_optimizations(
            lambda submaps, nodes: optimizations.append((submaps, nodes)))
        topts = trajectory_options(tconfig)
        topts.collate_landmarks = False
        tid = stub.add_trajectory_builder({"range"}, topts)
        builder = stub.get_trajectory_builder(tid)
        builder.add_sensor_data("landmarks", LandmarkData(
            time=FAKE_START_TIME + 0.501,
            landmark_observations=[LandmarkObservation(
                id="lm_0", landmark_to_tracking_transform=rigid3.translation(np.array([1.0, 0.0, 0.0])),
                translation_weight=10.0, rotation_weight=10.0)],
        ))
        stream_world(builder)
        stub.finish_trajectory(tid)
        stub.pose_graph.run_final_optimization()

        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not (local_results and optimizations):
            time.sleep(0.05)
        assert len(local_results) > 10
        assert optimizations, "no global optimization events received"

        assert "lm_0" in stub.pose_graph.get_landmark_poses()
        stub.pose_graph.set_landmark_pose("lm_0", rigid3.translation(np.array([2.0, 3.0, 0.0])), frozen=True)
        assert np.allclose(stub.pose_graph.get_landmark_poses()["lm_0"][:2], [2.0, 3.0], atol=1e-6)

        path = str(tmp_path / "state.bin")
        assert stub.write_state_to_file(path) > 1000
        stub.pose_graph.delete_trajectory(tid)
        assert len(stub.pose_graph.get_trajectory_node_poses()) == 0
        assert stub.load_state_from_file(path)
        assert len(stub.pose_graph.get_trajectory_node_poses()) > 0

        sub1.cancel()
        sub2.cancel()
        stub.close()
    finally:
        server.shutdown()


# -- 3D ---------------------------------------------------------------------------------------


def test_get_submap_data_3d(one_torch_thread):  # noqa: F811
    """A short 3D trajectory (tests/test_torch_pose_graph_3d.py's world,
    1 s) through the server: submap 0's texture is its high-resolution
    grid's max probability and known mask along z, read back by hand."""
    server = MapBuilderServer(pg3d.map_builder_options(), device=CPU)
    server.start()
    try:
        stub = MapBuilderStub(f"localhost:{server.port}")
        tid = stub.add_trajectory_builder({"range", "imu"}, pg3d.trajectory_options())
        builder = stub.get_trajectory_builder(tid)
        measurements = generate_fake_range_measurements(
            translation=DIRECTION * 0.25, duration=1.0, time_step=0.1)
        imu = [tdata.ImuData(time=t, linear_acceleration=np.array([0.0, 0.0, 9.8]),
                             angular_velocity=np.zeros(3))
               for t in np.arange(FAKE_START_TIME - 0.5, FAKE_START_TIME + 1.2, 1.0 / 50.0)]
        for kind, _, payload in sorted([("imu", d.time, d) for d in imu]
                                       + [("range", m.time, m) for m in measurements],
                                       key=lambda e: e[1]):
            builder.add_sensor_data(kind, payload)
        stub.finish_trajectory(tid)
        texture = stub.get_submap_data(SubmapId(tid, 0))
        submap = server.map_builder.pose_graph.get_all_submap_data().at(SubmapId(tid, 0)).submap
        grid = as_dense(submap.high_resolution_grid)
        prob = grid.probability().numpy()
        assert texture is not None and texture["submap_version"] == submap.num_range_data > 0
        assert np.array_equal(texture["intensity"], prob.max(axis=0).astype(np.float32))
        assert np.array_equal(texture["alpha"], grid.known().numpy().any(axis=0).astype(np.float32))
        assert np.array_equal(texture["origin"], grid.origin.numpy()[:2].astype(np.float64))
        assert np.array_equal(texture["local_pose"], submap.local_pose)
        assert texture["resolution"] == grid.resolution
        assert texture["alpha"].any()
        stub.close()
    finally:
        server.shutdown()
