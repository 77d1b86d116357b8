"""The 3D backend on the card against its CPU runs: the device 3D
branch-and-bound at depth 8 (against the CPU and the native search), the
batched dual-grid LM refinement, and MapBuilder's 3D route end to end with
its last SPA 3D solve re-run on the CPU. Nothing here imports the JAX
package: `python -m pytest tests/test_torch_backend_3d_card.py -m cuda`."""

import numpy as np
import pytest
import torch

from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.mapping.constraint_builder_3d import ConstraintBuilder3D
from cartographer_tpu_torch.mapping.hybrid_grid import grid3d_from_numpy
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.map_builder import MapBuilder
from cartographer_tpu_torch.mapping.submap_3d import Submap3D
from cartographer_tpu_torch.mapping.trajectory_node import TrajectoryNodeData
from cartographer_tpu_torch.ops import spa_solver_3d
from cartographer_tpu_torch.ops.scan_matching import gauss_newton_3d, rotational_histogram
from cartographer_tpu_torch.sensor.data import ImuData
from cartographer_tpu_torch.testing.synthetic import (
    FAKE_START_TIME,
    generate_fake_range_measurements,
)
from cartographer_tpu_torch.transform import rigid3


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def angle(a, b):
    a, b = (rigid3.quat_normalize(np.asarray(q, np.float64)) for q in (a, b))
    d = rigid3.quat_multiply(rigid3.quat_conjugate(a), b)
    return 2 * np.arctan2(np.linalg.norm(d[1:]), abs(d[0]))


def wall_world(seed=3, size=48, res=0.2):
    """A ring wall with a pillar as varied int8 log-odds (high 0.2 m, low
    0.8 m grids), its histogram and a scan of it."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, 300)
    r = 3.0 + 0.4 * np.sin(3 * ang)
    cloud = np.stack([r * np.cos(ang), r * np.sin(ang), rng.uniform(-0.8, 1.2, 300)], -1)
    cloud[:40, :2] = np.stack([1.0 + 0.15 * np.cos(ang[:40]), -0.5 + 0.15 * np.sin(ang[:40])], -1)
    cloud = cloud.astype(np.float32)
    grids = []
    for n, g_res in ((size, res), (size // 3, 4 * res)):
        vals = np.zeros((n, n, n), np.int8)
        origin = np.full(3, -0.5 * n * g_res)
        cells = np.floor((cloud - origin) / g_res + 0.5).astype(int)
        c = cells[np.all((cells >= 0) & (cells < n), axis=1)]
        vals[c[:, 2], c[:, 1], c[:, 0]] = rng.integers(30, 127, len(c))
        grids.append((vals, origin.astype(np.float32), g_res))
    hist = rotational_histogram.compute_histogram(cloud.astype(np.float64), 120)
    return grids, hist, cloud


def searches(backend, device, count=4):
    grids, hist, cloud = wall_world()
    submap = Submap3D(
        local_pose=rigid3.identity(),
        high_resolution_grid=grid3d_from_numpy(*grids[0], device),
        low_resolution_grid=grid3d_from_numpy(*grids[1], device),
        rotational_scan_matcher_histogram=hist,
        insertion_finished=True,
    )
    node = TrajectoryNodeData(
        time=0.0, gravity_alignment=np.array([1.0, 0, 0, 0]),
        filtered_gravity_aligned_point_cloud=None, local_pose=rigid3.identity(),
        high_resolution_point_cloud=cloud, low_resolution_point_cloud=cloud[::3].copy(),
        rotational_scan_matcher_histogram=hist,
    )
    options = tconfig.ConstraintBuilderOptions()
    options.sampling_ratio = 1.0
    options.min_score = 0.35
    options.loop_closure_backend = backend
    options.fast_correlative_scan_matcher_3d = tconfig.FastCorrelativeScanMatcherOptions3D(
        branch_and_bound_depth=8, linear_xy_search_window=1.0,
        linear_z_search_window=0.4, min_rotational_score=0.1,
        min_low_resolution_score=0.1,
    )
    cb = ConstraintBuilder3D(options, device=device)
    rng = np.random.default_rng(7)
    for k in range(count):
        pose = rigid3.make(
            rng.normal(0, 0.15, 3),
            rigid3.quat_from_angle_axis(np.array([0.0, 0.0, rng.normal(0, 0.04)])),
        )
        cb.maybe_add_constraint(SubmapId(0, 0), submap, NodeId(0, k), node, pose, 0.0)
    return cb


@pytest.mark.cuda
def test_bnb_3d_on_card_matches_cpu_and_native():
    """Depth 8: the card's device search, the CPU's and the native one pick
    the same candidates, scores within 1e-6; the drains' refined poses
    agree within 1e-4 m / rad."""
    need_card()
    found = {}
    for name, backend, device in (
        ("card", "device", "cuda"), ("cpu", "device", "cpu"), ("native", "native", "cuda"),
    ):
        cb = searches(backend, device)
        run = cb._run_searches_native if backend == "native" else cb._run_searches_device
        found[name] = run(list(cb._pending))
    matched = 0
    for results in zip(found["card"], found["cpu"], found["native"]):
        kinds = [r is None for _, r in results]
        assert len(set(kinds)) == 1
        if kinds[0]:
            continue
        matched += 1
        card = results[0][1]
        for _, other in results[1:]:
            np.testing.assert_allclose(other.pose, card.pose, atol=1e-6, rtol=0)
            assert abs(other.score - card.score) < 1e-6
    assert matched >= 2
    drains = {d: {c.node_id: c.pose.zbar_ij for c in searches("device", d).run_pending()}
              for d in ("cuda", "cpu")}
    assert drains["cuda"] and set(drains["cuda"]) == set(drains["cpu"])
    for k, z in drains["cuda"].items():
        np.testing.assert_allclose(z[:3], drains["cpu"][k][:3], atol=1e-4, rtol=0)
        assert angle(z[3:], drains["cpu"][k][3:]) < 1e-4


@pytest.mark.cuda
def test_match_3d_batch_on_card_matches_cpu():
    """Six lanes over three volumes: rows within 1e-4 of the CPU's."""
    need_card()
    grids, _, cloud = wall_world()
    rng = np.random.default_rng(1)
    vals = np.stack([np.roll(grids[0][0], s, axis=2) for s in (0, 1, 2)])
    low = np.stack([grids[1][0]] * 3)
    k = 6
    pts = np.stack([cloud[rng.permutation(len(cloud))[:256]] for _ in range(k)])
    t0 = rng.normal(0, 0.05, (k, 3)).astype(np.float32)
    q0 = np.stack([rigid3.quat_from_angle_axis(rng.normal(0, 0.03, 3)) for _ in range(k)])
    args = [vals, np.tile(grids[0][1], (k, 1)), low, np.tile(grids[1][1], (k, 1)),
            t0, q0.astype(np.float32), t0, pts, np.ones((k, 256), bool), pts[:, ::2].copy(),
            np.ones((k, 128), bool), np.full(k, 0.2, np.float32), np.full(k, 0.8, np.float32)]
    out = {
        d: gauss_newton_3d.match_3d_batch(
            *[torch.from_numpy(np.asarray(a)).to(d) for a in args], 1.0, 6.0, 5.0, 4e2, 12,
            volume_index=torch.tensor([0, 1, 2, 0, 1, 2], device=d),
        ).cpu().numpy()
        for d in ("cuda", "cpu")
    }
    np.testing.assert_allclose(out["cuda"][:, :3], out["cpu"][:, :3], atol=1e-4, rtol=0)
    for a, b in zip(out["cuda"], out["cpu"]):
        assert angle(a[3:7], b[3:7]) < 1e-4


@pytest.mark.cuda
def test_map_builder_3d_on_card():
    """tests/test_map_builder_3d.py's scenario on the card: node error
    under 0.1 x travel, an INTRA_SUBMAP constraint, a search; the last SPA
    3D solve re-run on the CPU within 1e-4 m / rad."""
    need_card()
    pose_graph = tconfig.PoseGraphOptions(optimize_every_n_nodes=12)
    pose_graph.constraint_builder.sampling_ratio = 0.6
    pose_graph.constraint_builder.fast_correlative_scan_matcher_3d = (
        tconfig.FastCorrelativeScanMatcherOptions3D(
            branch_and_bound_depth=8, linear_xy_search_window=1.0,
            linear_z_search_window=0.4, angular_search_window=np.radians(10.0),
            min_rotational_score=0.1,
        )
    )
    c = tconfig
    traj = c.TrajectoryBuilderOptions(trajectory_builder_3d=c.TrajectoryBuilder3DOptions(
        min_range=0.1, max_range=10.0,
        motion_filter=c.MotionFilterOptions(
            max_time_seconds=0.5, max_distance_meters=0.05, max_angle_radians=0.004),
        submaps=c.SubmapsOptions3D(
            num_range_data=8, high_resolution=0.10, low_resolution=0.45,
            high_resolution_grid_size=192, low_resolution_grid_size=96),
    ))
    solve = spa_solver_3d.solve_3d
    calls = []

    def recorded(problem, **kw):
        calls.append((problem, kw))
        return solve(problem, **kw)

    spa_solver_3d.solve_3d = recorded
    try:
        mb = MapBuilder(c.MapBuilderOptions(
            use_trajectory_builder_2d=False, use_trajectory_builder_3d=True,
            pose_graph=pose_graph), device="cuda")
        searched = []
        cb = mb.pose_graph._constraint_builder
        run = cb.run_pending
        cb.run_pending = lambda: (run(), searched.append(len(cb.last_drain_searches)))[0]
        tid = mb.add_trajectory_builder({"range", "imu"}, traj)
        builder = mb.get_trajectory_builder(tid)
        direction = np.array([2.0, 1.0, 0.0]) / np.sqrt(5.0)
        data = generate_fake_range_measurements(
            translation=direction, duration=4.0, time_step=0.1)
        imu = [ImuData(time=t, linear_acceleration=np.array([0.0, 0.0, 9.8]),
                       angular_velocity=np.zeros(3))
               for t in np.arange(FAKE_START_TIME - 0.5, FAKE_START_TIME + 4.2, 0.02)]
        for kind, _, p in sorted([("imu", d.time, d) for d in imu]
                                 + [("range", m.time, m) for m in data], key=lambda e: e[1]):
            builder.add_sensor_data(kind, p)
        mb.finish_trajectory(tid)
        mb.pose_graph.run_final_optimization()
    finally:
        spa_solver_3d.solve_3d = solve
    nodes = list(mb.pose_graph.get_trajectory_nodes().items(NodeId))
    errs = [np.linalg.norm(n.global_pose[:3] - (n.constant_data.time - FAKE_START_TIME) * direction / 4.0)
            for _, n in nodes]
    assert max(errs) < 0.1
    assert any(c.tag == "INTRA_SUBMAP" for c in mb.pose_graph.constraints)
    assert sum(searched) >= 1
    problem, kw = calls[-1]
    card = [t.cpu().numpy() for t in solve(problem, **kw)]
    cpu_problem = type(problem)(*[t.cpu() for t in problem])
    cpu = [t.numpy() for t in solve(cpu_problem, **kw)]
    for i in (0, 2):
        np.testing.assert_allclose(card[i], cpu[i], atol=1e-4, rtol=0)
    for i in (1, 3):
        assert max(angle(a, b) for a, b in zip(card[i], cpu[i])) < 1e-4
