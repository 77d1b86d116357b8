"""The JAX package's 3D local-SLAM bench setting (bench.py:_bench_3d,
bench.py:313-391), built from the port's own modules: the world and the
options that `chip_smoke.py`'s local_slam_3d and backend_3d phases and
`testing/op_count.py` drive, and the 3D loop-closure drain options of
bench.py:_bench_bnb3 (bench.py:811-945)."""

from __future__ import annotations

import numpy as np

from cartographer_tpu_torch.common.config import (
    AdaptiveVoxelFilterOptions,
    ConstraintBuilderOptions,
    FastCorrelativeScanMatcherOptions3D,
    MapBuilderOptions,
    MotionFilterOptions,
    PoseGraphOptions,
    SubmapsOptions3D,
    TrajectoryBuilder3DOptions,
    TrajectoryBuilderOptions,
)
from cartographer_tpu_torch.sensor.data import ImuData
from cartographer_tpu_torch.testing.synthetic import (
    FAKE_START_TIME,
    generate_fake_range_measurements,
)

TIME_STEP = 0.1


def bench_3d_world(num_scans: int = 300):
    """The first `num_scans` of 300 scans of the semicircle wall (1,575
    points each) at 10 Hz while the platform moves 5 m along (2, 1, 0), and
    IMU at 50 Hz (gravity, no rotation) from 0.5 s before the first scan.
    Returns time-sorted (kind, time, payload) events, each IMU sample
    before the scans at its time, the scan count, and the true position
    at a time."""
    direction = np.array([2.0, 1.0, 0.0]) / np.sqrt(5.0)
    duration = 30.0
    measurements = generate_fake_range_measurements(
        translation=direction * 5.0, duration=duration, time_step=TIME_STEP
    )[:num_scans]
    imu = [
        ImuData(time=float(t), linear_acceleration=np.array([0.0, 0.0, 9.8]),
                angular_velocity=np.zeros(3))
        for t in np.arange(FAKE_START_TIME - 0.5, measurements[-1].time + 0.2, 0.02)
    ]
    events = [("imu", d.time, d) for d in imu] + [
        ("range", m.time, m) for m in measurements]
    events.sort(key=lambda e: (e[1], e[0] == "range"))

    def true_position(t):
        return (t - FAKE_START_TIME) * direction * 5.0 / duration

    return events, len(measurements), true_position


def bench_3d_options(per_scan: bool = False) -> TrajectoryBuilder3DOptions:
    """The bench's grids (256 cells at 0.10 m, 128 at 0.45 m, 40 range data
    per submap, paged by default); for the chunked frontend also its
    range limits, adaptive filters and motion filter, for the per-scan
    builder the default options otherwise."""
    submaps = SubmapsOptions3D(
        num_range_data=40, high_resolution=0.10, low_resolution=0.45,
        high_resolution_grid_size=256, low_resolution_grid_size=128,
    )
    if per_scan:
        return TrajectoryBuilder3DOptions(submaps=submaps)
    return TrajectoryBuilder3DOptions(
        min_range=0.1,
        max_range=10.0,
        motion_filter=MotionFilterOptions(
            max_time_seconds=0.5, max_distance_meters=0.2, max_angle_radians=0.2
        ),
        high_resolution_adaptive_voxel_filter=AdaptiveVoxelFilterOptions(
            max_length=2.0, min_num_points=100, max_range=15.0
        ),
        low_resolution_adaptive_voxel_filter=AdaptiveVoxelFilterOptions(
            max_length=4.0, min_num_points=150, max_range=15.0
        ),
        submaps=submaps,
    )


def backend_3d_options(optimize_every_n_nodes: int = 15, num_range_data: int = 20):
    """MapBuilder's 3D route as chip_smoke.py's backend_3d phase drives it:
    the default PoseGraphOptions (3D constraint builder: BnB depth 8,
    full-resolution depth 3, 5 m / 1 m / 15 degree windows, the native
    search) with the asynchronous pose graph and `optimize_every_n_nodes`;
    the per-scan LocalTrajectoryBuilder3D with the bench's grids, the
    motion filter of the bench's drain workload (bench.py:721-728: 0.2 s,
    0.05 m, 0.1 rad) and `num_range_data` per submap (the bench's 40 cut
    to 20, so that submaps finish within the scans fed)."""
    pose_graph = PoseGraphOptions(optimize_every_n_nodes=optimize_every_n_nodes)
    trajectory = bench_3d_options(per_scan=True)
    trajectory.submaps.num_range_data = num_range_data
    trajectory.motion_filter = MotionFilterOptions(
        max_time_seconds=0.2, max_distance_meters=0.05, max_angle_radians=0.1
    )
    return (
        MapBuilderOptions(
            use_trajectory_builder_2d=False, use_trajectory_builder_3d=True,
            pose_graph=pose_graph, async_pose_graph=True,
        ),
        TrajectoryBuilderOptions(trajectory_builder_3d=trajectory),
    )


def bnb3_drain_options(backend: str) -> ConstraintBuilderOptions:
    """bench.py:_bench_bnb3's drain: every search kept (sampling 1, no
    distance gate), min_score 0.35, depth 8 with min_rotational_score 0.5
    and min_low_resolution_score 0.35, the default windows."""
    options = ConstraintBuilderOptions()
    options.sampling_ratio = 1.0
    options.max_constraint_distance = 1e6
    options.min_score = 0.35
    options.loop_closure_backend = backend
    options.fast_correlative_scan_matcher_3d = FastCorrelativeScanMatcherOptions3D(
        branch_and_bound_depth=8, min_rotational_score=0.5,
        min_low_resolution_score=0.35,
    )
    return options
