"""The production pose-graph drain on a mesh of ranks.

Port of cartographer_tpu/testing/production_dryrun.py, reused by
`dryrun_multichip` (below) and the multi-rank worker
(tools/multihost_worker --production) so that one-rank runs, spawned
ranks on one host and separately started ranks all drive the SAME code
path: MapBuilder -> PoseGraph2D -> ConstraintBuilder2D batched
branch-and-bound drain -> SPA solve, with the search batch and residual
tables split over the mesh (parallel/sharded.py). The options and worlds
are the JAX module's.

Reference equivalent: the ThreadPool-fanned constraint search and
single-server pose graph (constraint_builder_2d.cc:102-136,
cloud/internal/map_builder_server.h:77-146).
"""

from __future__ import annotations

import numpy as np


def _drain_stats(mb, mesh, direction, travel, duration, counts0):
    """The stats dict of a finished drain: sharded dispatch counts, inter
    constraints, node errors against the straight-line truth, a digest
    of the optimized node positions (equal across the ranks of a run iff
    they computed the same drain) and the device types the run's tensors
    lay on (its collectives', its searches' pyramids')."""
    from cartographer_tpu_torch import metrics
    from cartographer_tpu_torch.kernels import launch_counts
    from cartographer_tpu_torch.mapping.id import NodeId
    from cartographer_tpu_torch.testing.synthetic import FAKE_START_TIME
    from cartographer_tpu_torch.transform import rigid3

    velocity = direction * travel / duration
    errs, poses = [], []
    for _, node in mb.pose_graph.get_trajectory_nodes().items(NodeId):
        t = node.constant_data.time
        expected = rigid3.translation((t - FAKE_START_TIME) * velocity)
        poses.append(np.asarray(rigid3.trans(node.global_pose)))
        errs.append(
            np.linalg.norm(rigid3.trans(node.global_pose) - rigid3.trans(expected))
        )
    cb = mb.pose_graph._constraint_builder
    devices = {cb.device.type} | set(mesh.collectives if mesh is not None else ())
    for m in cb._matchers.values():  # 2D: the pyramid; 3D: the low-res volume
        devices.add(getattr(m, "_low_prob", m._pyramid).device.type)
    batches0, solves0, launches0 = counts0
    return {
        "sharded_search_batches": int(
            metrics.sharded_constraint_batches.value() - batches0
        ),
        "sharded_spa_solves": int(metrics.sharded_spa_solves.value() - solves0),
        "inter_constraints": sum(
            1 for c in mb.pose_graph.constraints if c.tag == "INTER_SUBMAP"
        ),
        "num_nodes": len(errs),
        "max_node_error_m": float(max(errs)) if errs else float("nan"),
        "travel_m": travel,
        "pose_digest": float(np.sum(np.round(np.stack(poses), 6))),
        "launches": {k: n - launches0[k] for k, n in launch_counts().items()},
        "tensor_devices": sorted(devices),
    }


def _counts():
    from cartographer_tpu_torch import metrics
    from cartographer_tpu_torch.kernels import launch_counts

    metrics.enable_collection()
    return (
        metrics.sharded_constraint_batches.value(),
        metrics.sharded_spa_solves.value(),
        launch_counts(),
    )


def run_production_drain_2d(mesh, travel: float = 0.9, duration: float = 4.5):
    """Run a small synthetic-world 2D SLAM problem end to end with the
    pose-graph backend split over `mesh` (on the mesh's device).
    Deterministic: every rank computes identical host state. Returns a
    stats dict (sharded dispatch counts, inter constraints, max node
    error, pose digest for cross-rank equality checks)."""
    from cartographer_tpu_torch.common.config import (
        FastCorrelativeScanMatcherOptions2D,
        GridOptions2D,
        MapBuilderOptions,
        MotionFilterOptions,
        PoseGraphOptions,
        SubmapsOptions2D,
        TrajectoryBuilder2DOptions,
        TrajectoryBuilderOptions,
    )
    from cartographer_tpu_torch.mapping.map_builder import MapBuilder
    from cartographer_tpu_torch.testing.synthetic import (
        generate_fake_range_measurements,
    )

    counts0 = _counts()
    pose_graph = PoseGraphOptions(optimize_every_n_nodes=12)
    pose_graph.constraint_builder.fast_correlative_scan_matcher = (
        FastCorrelativeScanMatcherOptions2D(
            linear_search_window=2.0,
            angular_search_window=np.radians(20.0),
            branch_and_bound_depth=4,
        )
    )
    pose_graph.constraint_builder.sampling_ratio = 0.5
    # This dryrun certifies the SHARDED DEVICE search path across the
    # mesh; pin it explicitly (the default "auto" prefers the native
    # host backend wherever the C++ toolchain built it).
    pose_graph.constraint_builder.loop_closure_backend = "device"
    options = MapBuilderOptions(
        use_trajectory_builder_2d=True, pose_graph=pose_graph
    )
    trajectory_options = TrajectoryBuilderOptions(
        trajectory_builder_2d=TrajectoryBuilder2DOptions(
            use_imu_data=False,
            max_range=10.0,
            motion_filter=MotionFilterOptions(max_distance_meters=0.04),
            submaps=SubmapsOptions2D(
                num_range_data=8,
                grid_options_2d=GridOptions2D(resolution=0.05, grid_size=512),
            ),
        )
    )

    mb = MapBuilder(options, mesh=mesh)
    tid = mb.add_trajectory_builder({"range"}, trajectory_options)
    builder = mb.get_trajectory_builder(tid)
    direction = np.array([2.0, 1.0, 0.0])
    direction /= np.linalg.norm(direction)
    for m in generate_fake_range_measurements(
        translation=direction * travel, duration=duration, time_step=0.05
    ):
        builder.add_sensor_data("range", m)
    mb.finish_trajectory(tid)
    mb.pose_graph.run_final_optimization()
    return _drain_stats(mb, mesh, direction, travel, duration, counts0)


def run_production_drain_3d(mesh, travel: float = 0.8, duration: float = 4.0):
    """Small synthetic-world 3D SLAM end to end with the SE(3) pose-graph
    backend split over `mesh`: PoseGraph3D -> ConstraintBuilder3D ->
    batch_match_device_3d(mesh) (split BnB search batches) -> sharded 3D
    SPA. The per-scan local-SLAM path keeps the dryrun light — the
    multi-rank surface under test is the DRAIN, which is identical for
    both frontends. Returns a stats dict like run_production_drain_2d.
    Reference: constraint_builder_3d.cc, pose_graph_3d.cc:50-1320."""
    from cartographer_tpu_torch.common.config import (
        AdaptiveVoxelFilterOptions,
        FastCorrelativeScanMatcherOptions3D,
        MapBuilderOptions,
        MotionFilterOptions,
        PoseGraphOptions,
        SubmapsOptions3D,
        TrajectoryBuilder3DOptions,
        TrajectoryBuilderOptions,
    )
    from cartographer_tpu_torch.mapping.map_builder import MapBuilder
    from cartographer_tpu_torch.sensor.data import ImuData
    from cartographer_tpu_torch.testing.synthetic import (
        FAKE_START_TIME,
        generate_fake_range_measurements,
    )

    counts0 = _counts()
    pose_graph = PoseGraphOptions(optimize_every_n_nodes=10)
    pose_graph.constraint_builder.sampling_ratio = 1.0
    pose_graph.constraint_builder.fast_correlative_scan_matcher_3d = (
        FastCorrelativeScanMatcherOptions3D(
            branch_and_bound_depth=3,
            full_resolution_depth=3,
            linear_xy_search_window=0.8,
            linear_z_search_window=0.3,
            angular_search_window=np.radians(10.0),
            min_rotational_score=0.1,
        )
    )
    # Pin the sharded device search path (see the 2D twin above).
    pose_graph.constraint_builder.loop_closure_backend = "device"
    options = MapBuilderOptions(
        use_trajectory_builder_3d=True, pose_graph=pose_graph
    )
    trajectory_options = TrajectoryBuilderOptions(
        trajectory_builder_3d=TrajectoryBuilder3DOptions(
            min_range=0.1,
            max_range=10.0,
            # Dense nodes + small submaps so submaps FINISH inside the
            # short run and the drain has (node, finished submap) pairs.
            motion_filter=MotionFilterOptions(
                max_time_seconds=0.09,
                max_distance_meters=0.015,
                max_angle_radians=0.02,
            ),
            high_resolution_adaptive_voxel_filter=AdaptiveVoxelFilterOptions(
                max_length=2.0, min_num_points=100, max_range=15.0
            ),
            low_resolution_adaptive_voxel_filter=AdaptiveVoxelFilterOptions(
                max_length=4.0, min_num_points=150, max_range=15.0
            ),
            submaps=SubmapsOptions3D(
                num_range_data=4,
                high_resolution=0.10,
                low_resolution=0.45,
                high_resolution_grid_size=160,
                low_resolution_grid_size=80,
            ),
        )
    )

    mb = MapBuilder(options, mesh=mesh)
    tid = mb.add_trajectory_builder({"range", "imu"}, trajectory_options)
    builder = mb.get_trajectory_builder(tid)
    direction = np.array([2.0, 1.0, 0.0])
    direction /= np.linalg.norm(direction)
    measurements = generate_fake_range_measurements(
        translation=direction * travel, duration=duration, time_step=0.1
    )
    imu = [
        ImuData(
            time=t,
            linear_acceleration=np.array([0.0, 0.0, 9.8]),
            angular_velocity=np.zeros(3),
        )
        for t in np.arange(
            FAKE_START_TIME - 0.5, FAKE_START_TIME + duration + 0.2, 0.02
        )
    ]
    events = [("imu", d.time, d) for d in imu] + [
        ("range", m.time, m) for m in measurements
    ]
    events.sort(key=lambda e: e[1])
    for kind, _, payload in events:
        builder.add_sensor_data(kind, payload)
    mb.finish_trajectory(tid)
    mb.pose_graph.run_final_optimization()
    return _drain_stats(mb, mesh, direction, travel, duration, counts0)


def _require(ok: bool, message: str) -> None:
    if not ok:
        raise AssertionError(message)


def check_drain_2d(stats) -> None:
    """What the JAX package's dryrun asserts of the 2D drain."""
    _require(stats["sharded_search_batches"] > 0,
             "sharded constraint-search batch never dispatched")
    _require(stats["sharded_spa_solves"] > 0, "sharded SPA solve never dispatched")
    _require(stats["inter_constraints"] > 0,
             "no loop closures found through the sharded drain")
    _require(stats["max_node_error_m"] < 0.15 * stats["travel_m"],
             f"sharded SLAM diverged: max err {stats['max_node_error_m']:.3f}")


def check_drain_3d(stats) -> None:
    """What the JAX package's dryrun asserts of the 3D drain."""
    _require(stats["sharded_search_batches"] > 0,
             "sharded 3D constraint-search batch never dispatched")
    _require(stats["sharded_spa_solves"] > 0, "sharded 3D SPA solve never dispatched")
    _require(stats["max_node_error_m"] < 0.2 * stats["travel_m"],
             f"sharded 3D SLAM diverged: max err {stats['max_node_error_m']:.3f}")


def _dryrun_rank(ctx):
    stats = run_production_drain_2d(ctx.mesh)
    check_drain_2d(stats)
    stats3d = run_production_drain_3d(ctx.mesh)
    check_drain_3d(stats3d)
    return stats, stats3d


def dryrun_multichip(n_ranks: int, device=None, backend=None) -> None:
    """Run the PRODUCTION pose-graph drain split over `n_ranks` spawned
    ranks, in BOTH dimensions: a real 2D MapBuilder (local SLAM ->
    PoseGraph2D -> ConstraintBuilder2D batched branch-and-bound drain ->
    SPA solve) and a real 3D MapBuilder (PoseGraph3D ->
    ConstraintBuilder3D split BnB drain -> sharded SE(3) SPA). Every rank
    asserts that the sharded paths ran and tracked the truth; the ranks
    must agree on the pose digests. `device`/`backend` as in
    parallel/multihost.initialize (None: cuda:{rank % cards}, NCCL; two
    ranks on one card need backend="gloo")."""
    from cartographer_tpu_torch.parallel import multihost

    results = multihost.run_ranks(
        _dryrun_rank, n_ranks, backend=backend, device=device, timeout=1800.0
    )
    stats, stats3d = results[0]
    for other, other3d in results[1:]:
        _require(abs(other["pose_digest"] - stats["pose_digest"]) <= 1e-6,
                 "ranks disagree on the 2D drain")
        _require(abs(other3d["pose_digest"] - stats3d["pose_digest"]) <= 1e-6,
                 "ranks disagree on the 3D drain")
    print(
        f"dryrun_multichip ok: {n_ranks} ranks, 2D production drain "
        f"({stats['sharded_search_batches']} sharded search batches, "
        f"{stats['sharded_spa_solves']} sharded SPA solves, "
        f"{stats['inter_constraints']} inter constraints, max node err "
        f"{stats['max_node_error_m']:.3f} m), 3D production drain "
        f"({stats3d['sharded_search_batches']} sharded search batches, "
        f"{stats3d['sharded_spa_solves']} sharded SPA solves, "
        f"{stats3d['num_nodes']} nodes, max node err "
        f"{stats3d['max_node_error_m']:.3f} m)"
    )
