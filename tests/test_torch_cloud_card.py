"""The cloud server on the card: a MapBuilderServer on cuda behind real
gRPC on localhost answers a stub's AddTrajectory, a short stream,
GetTrajectoryNodePoses and a 2D GetSubmapData that agrees with the CPU's
read of the same submap. Nothing here imports the JAX package:
`python -m pytest tests/test_torch_cloud_card.py -m cuda`."""

import numpy as np
import pytest
import torch

from cartographer_tpu_torch.common.config import (
    GridOptions2D,
    MapBuilderOptions,
    MotionFilterOptions,
    SubmapsOptions2D,
    TrajectoryBuilder2DOptions,
    TrajectoryBuilderOptions,
)
from cartographer_tpu_torch.mapping.grid_2d import Grid2D, compute_cropped
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.testing.synthetic import generate_fake_range_measurements


@pytest.mark.cuda
def test_server_on_card_answers_and_matches_the_cpu_read():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    pytest.importorskip("grpc")
    from cartographer_tpu_torch.cloud.map_builder_server import MapBuilderServer
    from cartographer_tpu_torch.cloud.map_builder_stub import MapBuilderStub
    from cartographer_tpu_torch.kernels import correlative_window as cw

    server = MapBuilderServer(MapBuilderOptions(use_trajectory_builder_2d=True))
    assert server.map_builder.device.type == "cuda"
    server.start()
    try:
        stub = MapBuilderStub(f"localhost:{server.port}")
        options = TrajectoryBuilderOptions(trajectory_builder_2d=TrajectoryBuilder2DOptions(
            use_imu_data=False, max_range=10.0, use_online_correlative_scan_matching=True,
            motion_filter=MotionFilterOptions(max_distance_meters=0.04),
            submaps=SubmapsOptions2D(num_range_data=8, grid_options_2d=GridOptions2D(
                resolution=0.05, grid_size=512)),
        ))
        cw.LAUNCHES = 0
        tid = stub.add_trajectory_builder({"range"}, options)
        builder = stub.get_trajectory_builder(tid)
        direction = np.array([2.0, 1.0, 0.0]) / np.sqrt(5.0)
        for m in generate_fake_range_measurements(
                translation=direction * 0.5, duration=2.0, time_step=0.05):
            builder.add_sensor_data("range", m)
        stub.finish_trajectory(tid)
        assert cw.LAUNCHES > 0

        poses = stub.pose_graph.get_trajectory_node_poses()
        nodes = server.map_builder.pose_graph.get_trajectory_nodes()
        assert len(poses) > 3 and len(poses) == nodes.size()
        for nid, pose in poses.items():
            assert np.array_equal(pose, nodes.at(nid).global_pose)
        assert all(np.all(np.isfinite(p)) for p in poses.values())

        texture = stub.get_submap_data(SubmapId(tid, 0))
        grid = server.map_builder.pose_graph.get_all_submap_data().at(SubmapId(tid, 0)).submap.grid
        assert grid.log_odds.device.type == "cuda"
        cpu = compute_cropped(Grid2D(log_odds=grid.log_odds.cpu(), known=grid.known.cpu(),
                                     origin=grid.origin.cpu(), resolution=grid.resolution))
        assert np.array_equal(texture["alpha"], cpu.known.astype(np.float32))
        assert np.array_equal(texture["origin"], np.asarray(cpu.origin, np.float64))
        # The card's and the CPU's exp may differ in the last bit.
        np.testing.assert_allclose(
            texture["intensity"], np.where(cpu.known, cpu.probability, 0.5).astype(np.float32),
            rtol=0, atol=1e-6)
        assert NodeId(tid, 0) in poses
        stub.close()
    finally:
        server.shutdown()
        server.map_builder.shutdown()
