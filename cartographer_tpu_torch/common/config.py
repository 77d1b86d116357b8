"""Structured configuration mirroring the reference's Lua schema.

The reference drives everything from Lua dictionaries
(configuration_files/trajectory_builder_2d.lua, trajectory_builder_3d.lua,
pose_graph.lua, map_builder.lua) converted into protobuf options. Here the
same parameter names and defaults are expressed as Python dataclasses, so a
reference config translates 1:1. `from_dict` performs the same strictness the
reference enforces via reference-counted key checking
(common/lua_parameter_dictionary.h): unknown keys are a hard error.

TPU-specific additions live under `tpu` sub-configs (e.g. fixed submap grid
extent, padding bucket sizes) since XLA requires static shapes.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Optional


def _from_dict(cls, data: dict):
    if not isinstance(data, dict):
        raise TypeError(f"expected dict for {cls.__name__}, got {type(data)}")
    field_names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in field_names:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        default = _default_of(cls, key)
        if dataclasses.is_dataclass(default) and isinstance(value, dict):
            kwargs[key] = _from_dict(type(default), value)
        elif default is None and isinstance(value, dict) and key in _OPTIONAL_NESTED:
            kwargs[key] = _from_dict(_OPTIONAL_NESTED[key], value)
        elif (
            isinstance(default, bool)
            or isinstance(value, bool)
            or default is None
        ):
            kwargs[key] = value
        elif isinstance(default, int) and isinstance(value, float):
            # Lua numbers are all floats; integer fields coerce like the
            # reference's LuaParameterDictionary::GetInt.
            if not value.is_integer():
                raise ValueError(
                    f"config key {key!r} of {cls.__name__} expects an "
                    f"integer, got {value!r}"
                )
            kwargs[key] = int(value)
        elif isinstance(default, float) and isinstance(value, int):
            kwargs[key] = float(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def _default_of(cls, name):
    for f in dataclasses.fields(cls):
        if f.name == name:
            if f.default is not dataclasses.MISSING:
                return f.default
            if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                return f.default_factory()  # type: ignore[misc]
    return None


class ConfigBase:
    @classmethod
    def from_dict(cls, data: dict):
        return _from_dict(cls, data)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


# ---------------------------------------------------------------------------
# Shared solver options (reference: common/internal/ceres_solver_options.h).
# The TPU engine uses Levenberg-Marquardt with Ceres trust-region radius
# dynamics in the SPA solvers and fixed-iteration LM in the scan matchers;
# max_num_iterations maps directly, num_threads is ignored
# (device-parallel), and use_nonmonotonic_steps enables Ceres's
# nonmonotonic trust region (TrustRegionStepEvaluator — step quality
# against a lagging reference cost) in both the scan-match LM loops and
# the SPA solvers; the reference's default turns it on for the constraint
# builder's refinement matcher (pose_graph.lua:35), mirrored here.
# ---------------------------------------------------------------------------


@dataclass
class SolverOptions(ConfigBase):
    use_nonmonotonic_steps: bool = False
    max_num_iterations: int = 20
    num_threads: int = 1


# -- sensor / filtering ------------------------------------------------------


@dataclass
class AdaptiveVoxelFilterOptions(ConfigBase):
    max_length: float = 0.5
    min_num_points: int = 200
    max_range: float = 50.0


@dataclass
class RealTimeCorrelativeScanMatcherOptions(ConfigBase):
    linear_search_window: float = 0.1
    angular_search_window: float = math.radians(20.0)
    translation_delta_cost_weight: float = 1e-1
    rotation_delta_cost_weight: float = 1e-1


@dataclass
class CeresScanMatcherOptions2D(ConfigBase):
    occupied_space_weight: float = 1.0
    translation_weight: float = 10.0
    rotation_weight: float = 40.0
    ceres_solver_options: SolverOptions = field(
        default_factory=lambda: SolverOptions(max_num_iterations=20)
    )


@dataclass
class MotionFilterOptions(ConfigBase):
    max_time_seconds: float = 5.0
    max_distance_meters: float = 0.2
    max_angle_radians: float = math.radians(1.0)


@dataclass
class ConstantVelocityExtrapolatorOptions(ConfigBase):
    imu_gravity_time_constant: float = 10.0
    pose_queue_duration: float = 0.001


@dataclass
class ImuBasedExtrapolatorOptions(ConfigBase):
    pose_queue_duration: float = 5.0
    gravity_constant: float = 9.806
    pose_translation_weight: float = 1.0
    pose_rotation_weight: float = 1.0
    imu_acceleration_weight: float = 1.0
    imu_rotation_weight: float = 1.0
    odometry_translation_weight: float = 1.0
    odometry_rotation_weight: float = 1.0
    solver_options: SolverOptions = field(
        default_factory=lambda: SolverOptions(max_num_iterations=10)
    )


@dataclass
class PoseExtrapolatorOptions(ConfigBase):
    use_imu_based: bool = False
    constant_velocity: ConstantVelocityExtrapolatorOptions = field(
        default_factory=ConstantVelocityExtrapolatorOptions
    )
    imu_based: ImuBasedExtrapolatorOptions = field(
        default_factory=ImuBasedExtrapolatorOptions
    )


# -- 2D submaps --------------------------------------------------------------


@dataclass
class ProbabilityGridRangeDataInserterOptions2D(ConfigBase):
    insert_free_space: bool = True
    hit_probability: float = 0.55
    miss_probability: float = 0.49


@dataclass
class NormalEstimationOptions2D(ConfigBase):
    num_normal_samples: int = 4
    sample_radius: float = 0.5


@dataclass
class TSDFRangeDataInserterOptions2D(ConfigBase):
    truncation_distance: float = 0.3
    maximum_weight: float = 10.0
    update_free_space: bool = False
    normal_estimation_options: NormalEstimationOptions2D = field(
        default_factory=NormalEstimationOptions2D
    )
    project_sdf_distance_to_scan_normal: bool = True
    update_weight_range_exponent: int = 0
    update_weight_angle_scan_normal_to_ray_kernel_bandwidth: float = 0.5
    update_weight_distance_cell_to_hit_kernel_bandwidth: float = 0.5


@dataclass
class RangeDataInserterOptions(ConfigBase):
    range_data_inserter_type: str = "PROBABILITY_GRID_INSERTER_2D"
    probability_grid_range_data_inserter: ProbabilityGridRangeDataInserterOptions2D = (
        field(default_factory=ProbabilityGridRangeDataInserterOptions2D)
    )
    tsdf_range_data_inserter: TSDFRangeDataInserterOptions2D = field(
        default_factory=TSDFRangeDataInserterOptions2D
    )


@dataclass
class GridOptions2D(ConfigBase):
    grid_type: str = "PROBABILITY_GRID"
    resolution: float = 0.05
    # TPU addition: fixed grid extent in cells (static shapes for XLA). The
    # grid is centered on the submap origin; the reference grows dynamically
    # (mapping/2d/grid_2d.cc GrowLimits), we pre-allocate.
    grid_size: int = 1024


@dataclass
class SubmapsOptions2D(ConfigBase):
    num_range_data: int = 90
    grid_options_2d: GridOptions2D = field(default_factory=GridOptions2D)
    range_data_inserter: RangeDataInserterOptions = field(
        default_factory=RangeDataInserterOptions
    )


# -- 2D trajectory builder ---------------------------------------------------


@dataclass
class TrajectoryBuilder2DOptions(ConfigBase):
    use_imu_data: bool = True
    min_range: float = 0.0
    max_range: float = 30.0
    min_z: float = -0.8
    max_z: float = 2.0
    missing_data_ray_length: float = 5.0
    num_accumulated_range_data: int = 1
    voxel_filter_size: float = 0.025
    adaptive_voxel_filter: AdaptiveVoxelFilterOptions = field(
        default_factory=AdaptiveVoxelFilterOptions
    )
    loop_closure_adaptive_voxel_filter: AdaptiveVoxelFilterOptions = field(
        default_factory=lambda: AdaptiveVoxelFilterOptions(
            max_length=0.9, min_num_points=100, max_range=50.0
        )
    )
    use_online_correlative_scan_matching: bool = False
    real_time_correlative_scan_matcher: RealTimeCorrelativeScanMatcherOptions = field(
        default_factory=RealTimeCorrelativeScanMatcherOptions
    )
    ceres_scan_matcher: CeresScanMatcherOptions2D = field(
        default_factory=CeresScanMatcherOptions2D
    )
    motion_filter: MotionFilterOptions = field(default_factory=MotionFilterOptions)
    imu_gravity_time_constant: float = 10.0
    pose_extrapolator: PoseExtrapolatorOptions = field(
        default_factory=PoseExtrapolatorOptions
    )
    submaps: SubmapsOptions2D = field(default_factory=SubmapsOptions2D)


# -- 3D trajectory builder ---------------------------------------------------

MAX_3D_RANGE = 60.0
INTENSITY_THRESHOLD = 40.0


@dataclass
class IntensityCostFunctionOptions(ConfigBase):
    weight: float = 0.5
    huber_scale: float = 0.3
    intensity_threshold: float = INTENSITY_THRESHOLD


@dataclass
class CeresScanMatcherOptions3D(ConfigBase):
    occupied_space_weight_0: float = 1.0
    occupied_space_weight_1: float = 6.0
    intensity_cost_function_options_0: IntensityCostFunctionOptions = field(
        default_factory=IntensityCostFunctionOptions
    )
    translation_weight: float = 5.0
    rotation_weight: float = 4e2
    only_optimize_yaw: bool = False
    ceres_solver_options: SolverOptions = field(
        default_factory=lambda: SolverOptions(max_num_iterations=12)
    )


@dataclass
class RangeDataInserterOptions3D(ConfigBase):
    hit_probability: float = 0.55
    miss_probability: float = 0.49
    num_free_space_voxels: int = 2
    intensity_threshold: float = INTENSITY_THRESHOLD


@dataclass
class SubmapsOptions3D(ConfigBase):
    high_resolution: float = 0.10
    high_resolution_max_range: float = 20.0
    low_resolution: float = 0.45
    num_range_data: int = 160
    range_data_inserter: RangeDataInserterOptions3D = field(
        default_factory=RangeDataInserterOptions3D
    )
    # TPU addition: fixed voxel-grid extents per resolution (cells per axis).
    high_resolution_grid_size: int = 512
    low_resolution_grid_size: int = 256
    # TPU addition: block-sparse (paged) active-submap grids — fixed block
    # pool + dense block table (mapping/paged_grid_3d.py), the HybridGrid
    # pointer-tree replacement. Virtual extent per axis =
    # table_size * 2^block_bits cells (defaults: high 1024 cells = +-51.2 m
    # at 10 cm; low 512 cells = +-115 m at 0.45 m — beyond the reference's
    # default max ranges). Finished submaps densify cropped to content.
    sparse_grids: bool = True
    sparse_block_bits: int = 4
    sparse_high_table_size: int = 64
    # Pool sizing: sparse updates on TPU are copy-bound in the pool bytes
    # (measured threshold ~16 MB total across the four scan-loop lanes);
    # 1024 blocks/lane = 4.2M voxel capacity anywhere inside the virtual
    # extent — beyond a typical reference submap's content, and overflow
    # is counted (mapping_grid_out_of_extent_points) + configurable.
    sparse_high_pool_blocks: int = 1024
    # Equal low/high table+pool shapes let the chunked device frontend
    # stack both resolutions x both active slots into ONE batched
    # gather/scatter lane axis; virtual low extent 1024 cells = +-230 m
    # at 0.45 m.
    sparse_low_table_size: int = 64
    sparse_low_pool_blocks: int = 1024


@dataclass
class TrajectoryBuilder3DOptions(ConfigBase):
    min_range: float = 1.0
    max_range: float = MAX_3D_RANGE
    num_accumulated_range_data: int = 1
    voxel_filter_size: float = 0.15
    high_resolution_adaptive_voxel_filter: AdaptiveVoxelFilterOptions = field(
        default_factory=lambda: AdaptiveVoxelFilterOptions(
            max_length=2.0, min_num_points=150, max_range=15.0
        )
    )
    low_resolution_adaptive_voxel_filter: AdaptiveVoxelFilterOptions = field(
        default_factory=lambda: AdaptiveVoxelFilterOptions(
            max_length=4.0, min_num_points=200, max_range=MAX_3D_RANGE
        )
    )
    use_online_correlative_scan_matching: bool = False
    real_time_correlative_scan_matcher: RealTimeCorrelativeScanMatcherOptions = field(
        default_factory=lambda: RealTimeCorrelativeScanMatcherOptions(
            linear_search_window=0.15,
            angular_search_window=math.radians(1.0),
        )
    )
    ceres_scan_matcher: CeresScanMatcherOptions3D = field(
        default_factory=CeresScanMatcherOptions3D
    )
    motion_filter: MotionFilterOptions = field(
        default_factory=lambda: MotionFilterOptions(
            max_time_seconds=0.5, max_distance_meters=0.1, max_angle_radians=0.004
        )
    )
    rotational_histogram_size: int = 120
    imu_gravity_time_constant: float = 10.0
    pose_extrapolator: PoseExtrapolatorOptions = field(
        default_factory=PoseExtrapolatorOptions
    )
    submaps: SubmapsOptions3D = field(default_factory=SubmapsOptions3D)
    use_intensities: bool = False


# -- pose graph --------------------------------------------------------------


@dataclass
class FastCorrelativeScanMatcherOptions2D(ConfigBase):
    linear_search_window: float = 7.0
    angular_search_window: float = math.radians(30.0)
    branch_and_bound_depth: int = 7
    # TPU addition: per-level candidate beam in the device BnB
    # (ops/scan_matching/fast_correlative_2d.bnb_search). Exactness is lost
    # only when more candidates survive bound-pruning than the beam keeps;
    # scoring cost scales linearly with the beam.
    beam_width: int = 4096


@dataclass
class FastCorrelativeScanMatcherOptions3D(ConfigBase):
    branch_and_bound_depth: int = 8
    full_resolution_depth: int = 3
    min_rotational_score: float = 0.77
    min_low_resolution_score: float = 0.55
    linear_xy_search_window: float = 5.0
    linear_z_search_window: float = 1.0
    angular_search_window: float = math.radians(15.0)
    # TPU addition: per-level candidate beam in the device BnB.
    beam_width: int = 2048


@dataclass
class ConstraintBuilderOptions(ConfigBase):
    sampling_ratio: float = 0.3
    max_constraint_distance: float = 15.0
    min_score: float = 0.55
    global_localization_min_score: float = 0.6
    # Where the branch-and-bound loop-closure search runs: "auto"
    # (DEFAULT — native when the C++ toolchain built the library, else
    # device), "device" (vmapped TPU program), or "native" (threaded C++
    # across host cores, native/bnb_native.cc + bnb3d_native.cc — hybrid
    # placement: BnB is cache-resident pointer-chasing that host cores
    # run 1-2 orders of magnitude faster per search than the
    # gather-bound XLA formulation; the GN refinement batch stays on
    # device either way). Extension beyond the reference's Lua schema;
    # "native" warns and falls back to "device" if no C++ toolchain is
    # available, "auto" falls back silently.
    loop_closure_backend: str = "auto"
    loop_closure_translation_weight: float = 1.1e4
    loop_closure_rotation_weight: float = 1e5
    log_matches: bool = True
    fast_correlative_scan_matcher: FastCorrelativeScanMatcherOptions2D = field(
        default_factory=FastCorrelativeScanMatcherOptions2D
    )
    ceres_scan_matcher: CeresScanMatcherOptions2D = field(
        default_factory=lambda: CeresScanMatcherOptions2D(
            occupied_space_weight=20.0,
            translation_weight=10.0,
            rotation_weight=1.0,
            ceres_solver_options=SolverOptions(
                use_nonmonotonic_steps=True, max_num_iterations=10
            ),
        )
    )
    fast_correlative_scan_matcher_3d: FastCorrelativeScanMatcherOptions3D = field(
        default_factory=FastCorrelativeScanMatcherOptions3D
    )
    ceres_scan_matcher_3d: CeresScanMatcherOptions3D = field(
        default_factory=lambda: CeresScanMatcherOptions3D(
            occupied_space_weight_0=5.0,
            occupied_space_weight_1=30.0,
            translation_weight=10.0,
            rotation_weight=1.0,
            only_optimize_yaw=False,
            ceres_solver_options=SolverOptions(max_num_iterations=10),
        )
    )


@dataclass
class OptimizationProblemOptions(ConfigBase):
    huber_scale: float = 1e1
    acceleration_weight: float = 1.1e2
    rotation_weight: float = 1.6e4
    local_slam_pose_translation_weight: float = 1e5
    local_slam_pose_rotation_weight: float = 1e5
    odometry_translation_weight: float = 1e5
    odometry_rotation_weight: float = 1e5
    fixed_frame_pose_translation_weight: float = 1e1
    fixed_frame_pose_rotation_weight: float = 1e2
    fixed_frame_pose_use_tolerant_loss: bool = False
    fixed_frame_pose_tolerant_loss_param_a: float = 1.0
    fixed_frame_pose_tolerant_loss_param_b: float = 1.0
    log_solver_summary: bool = False
    use_online_imu_extrinsics_in_3d: bool = True
    fix_z_in_3d: bool = False
    ceres_solver_options: SolverOptions = field(
        default_factory=lambda: SolverOptions(max_num_iterations=50, num_threads=7)
    )


@dataclass
class OverlappingSubmapsTrimmerOptions2D(ConfigBase):
    fresh_submaps_count: int = 1
    min_covered_area: float = 2.0
    min_added_submaps_count: int = 5


@dataclass
class PoseGraphOptions(ConfigBase):
    optimize_every_n_nodes: int = 90
    constraint_builder: ConstraintBuilderOptions = field(
        default_factory=ConstraintBuilderOptions
    )
    matcher_translation_weight: float = 5e2
    matcher_rotation_weight: float = 1.6e3
    optimization_problem: OptimizationProblemOptions = field(
        default_factory=OptimizationProblemOptions
    )
    max_num_final_iterations: int = 200
    global_sampling_ratio: float = 0.003
    log_residual_histograms: bool = True
    global_constraint_search_after_n_seconds: float = 10.0
    overlapping_submaps_trimmer_2d: Optional[OverlappingSubmapsTrimmerOptions2D] = None


# -- top level ---------------------------------------------------------------


@dataclass
class PureLocalizationTrimmerOptions(ConfigBase):
    max_submaps_to_keep: int = 3


@dataclass
class TrajectoryBuilderOptions(ConfigBase):
    trajectory_builder_2d: TrajectoryBuilder2DOptions = field(
        default_factory=TrajectoryBuilder2DOptions
    )
    trajectory_builder_3d: TrajectoryBuilder3DOptions = field(
        default_factory=TrajectoryBuilder3DOptions
    )
    pure_localization_trimmer: Optional[PureLocalizationTrimmerOptions] = None
    collate_fixed_frame: bool = True
    collate_landmarks: bool = False
    # TPU additions: run the full 2D local-SLAM pipeline device-resident in
    # chunks (mapping/chunked_frontend_2d.py). Requires the no-IMU/
    # no-odometry probability-grid configuration; local SLAM results are
    # then delivered in chunk batches (asynchronously, like the reference's
    # callback timing).
    use_chunked_device_frontend: bool = False
    device_frontend_chunk_size: int = 32


@dataclass
class MapBuilderOptions(ConfigBase):
    use_trajectory_builder_2d: bool = False
    use_trajectory_builder_3d: bool = False
    num_background_threads: int = 4
    pose_graph: PoseGraphOptions = field(default_factory=PoseGraphOptions)
    collate_by_trajectory: bool = False
    # TPU addition: when True (DEFAULT — the production configuration,
    # the reference's DrainWorkQueue behavior, pose_graph_2d.cc:520-544)
    # loop closure + optimization drain on a background thread pool so
    # the sensor feed never blocks on a drain; when False the work queue
    # drains deterministically inline (useful for tests and debugging).
    async_pose_graph: bool = True


# Optional nested sub-configs whose dataclass type cannot be inferred from a
# None default (see _from_dict).
_OPTIONAL_NESTED = {
    "pure_localization_trimmer": PureLocalizationTrimmerOptions,
    "overlapping_submaps_trimmer_2d": OverlappingSubmapsTrimmerOptions2D,
}
