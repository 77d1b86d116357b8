"""Chunked device-resident 2D local SLAM frontend (host wrapper).

Port of cartographer_tpu/mapping/chunked_frontend_2d.py. The whole
per-scan pipeline runs on the device (ops/frontend_2d.run_chunk), one
dispatch and one small fetch per chunk of scans, so `add_range_data`
returns a LIST of MatchingResults at chunk boundaries (empty otherwise)
and `flush` returns the rest.

Submap lifecycle events (create/pop/finish) decided on the device are
replayed on the host from the fetched event flags, so the Submap2D
objects match ActiveSubmaps2D semantics (mapping/2d/submap_2d.cc:137-219).
Grids stay device tensors end to end.

Scope of this port: IMU and odometry fusion, online correlative matching
on or off. Chunks are dispatched synchronously.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time as _walltime
from typing import List, Optional, Set

import numpy as np
import torch

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.common.config import TrajectoryBuilder2DOptions
from cartographer_tpu_torch.common.time import Time
from cartographer_tpu_torch.device import resolve_device
from cartographer_tpu_torch.mapping import probability_values as pv
from cartographer_tpu_torch.mapping.grid_2d import Grid2D
from cartographer_tpu_torch.mapping.imu_tracker import ImuTracker
from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (
    InsertionResult,
    MatchingResult,
)
from cartographer_tpu_torch.mapping.range_data_collator import RangeDataCollator
from cartographer_tpu_torch.mapping.submap_2d import Submap2D
from cartographer_tpu_torch.mapping.trajectory_node import TrajectoryNodeData
from cartographer_tpu_torch.ops import frontend_2d
from cartographer_tpu_torch.ops.scan_matching.correlative_2d import (
    compute_angular_step,
)
from cartographer_tpu_torch.sensor.data import (
    PointCloud,
    RangeData,
    TimedPointCloudData,
)
from cartographer_tpu_torch.transform import rigid2, rigid3


class _ChunkCloudHolder:
    """Owns one chunk's full per-scan point output as a DEVICE tensor,
    copying it to host memory at most once, on first demand (the SLAM
    pipeline consumes only the compact filtered clouds)."""

    def __init__(self, out_points: torch.Tensor):
        self._dev: Optional[torch.Tensor] = out_points
        self._np: Optional[np.ndarray] = None

    def get(self) -> np.ndarray:
        if self._np is None:
            self._np = self._dev.cpu().numpy()
            self._dev = None
        return self._np


class LazyRangeData:
    """Drop-in RangeData whose returns/misses decode from the chunk's
    device output on first access (RangeData semantics of
    sensor/range_data.h:32 — origin, returns, misses in the local frame)."""

    def __init__(self, holder: _ChunkCloudHolder, row: int, pose2d, origin3):
        self._holder = holder
        self._row = row
        self._pose2d = pose2d
        self.origin = origin3
        self._rd: Optional[RangeData] = None

    def _materialize(self) -> RangeData:
        if self._rd is None:
            out_points = self._holder.get()
            pose2d = self._pose2d
            has_misses = out_points.shape[-1] == 7
            code_col = 6 if has_misses else 3
            cy, sy = math.cos(pose2d[2]), math.sin(pose2d[2])
            rot = np.array([[cy, -sy], [sy, cy]])
            code = out_points[self._row, :, code_col]
            rm = (code >= 0.5) & (code < 2.5)
            ga_hits = out_points[self._row, rm, 0:3].astype(np.float64)
            local_hits = np.concatenate(
                [ga_hits[:, :2] @ rot.T + pose2d[:2], ga_hits[:, 2:3]], axis=1
            )
            if has_misses:
                mm = code >= 2.5
                ga_miss = out_points[self._row, mm, 3:6].astype(np.float64)
                local_miss = np.concatenate(
                    [ga_miss[:, :2] @ rot.T + pose2d[:2], ga_miss[:, 2:3]],
                    axis=1,
                )
            else:
                local_miss = np.zeros((0, 3), np.float64)
            self._rd = RangeData(
                origin=self.origin,
                returns=PointCloud(local_hits.astype(np.float32)),
                misses=PointCloud(local_miss.astype(np.float32)),
            )
        return self._rd

    @property
    def returns(self) -> PointCloud:
        return self._materialize().returns

    @property
    def misses(self) -> PointCloud:
        return self._materialize().misses

    def transform(self, pose3: np.ndarray) -> RangeData:
        return self._materialize().transform(pose3)

    def crop(self, min_z: float, max_z: float) -> RangeData:
        return self._materialize().crop(min_z, max_z)


def _round_up_pow2(n: int, minimum: int = 256) -> int:
    v = minimum
    while v < n:
        v *= 2
    return v


def _round_up_multiple(n: int, multiple: int = 256) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def supports(options: TrajectoryBuilder2DOptions) -> bool:
    """Whether the chunked frontend covers the given configuration (as in
    the JAX package: one accumulated scan, probability grids, the
    constant-velocity extrapolator)."""
    return (
        options.num_accumulated_range_data == 1
        and options.submaps.grid_options_2d.grid_type == "PROBABILITY_GRID"
        and not options.pose_extrapolator.use_imu_based
    )


class ChunkedLocalTrajectoryBuilder2D:
    """2D frontend with the whole per-scan pipeline on the device.
    `device=None` means CUDA; pass device="cpu" to run on the CPU."""

    def __init__(
        self,
        options: TrajectoryBuilder2DOptions,
        expected_range_sensor_ids: Set[str],
        chunk_size: int = 64,
        device=None,
    ):
        if not supports(options):
            raise ValueError(
                "ChunkedLocalTrajectoryBuilder2D supports probability-grid "
                "configurations with the constant-velocity extrapolator"
            )
        self._device = resolve_device(device)
        self._options = options
        self._range_data_collator = RangeDataCollator(expected_range_sensor_ids)
        sub = options.submaps
        grid = sub.grid_options_2d
        ins = sub.range_data_inserter.probability_grid_range_data_inserter
        self._chunk = max(1, chunk_size)
        max_ray = max(options.max_range, options.missing_data_ray_length)
        num_steps = _round_up_pow2(
            int(math.ceil(max_ray / grid.resolution)) + 2, 32
        )
        self._cfg = frontend_2d.FrontendConfig2D(
            grid_size=grid.grid_size,
            resolution=grid.resolution,
            num_range_data=sub.num_range_data,
            hit_log_odds=pv.hit_update_log_odds(ins.hit_probability),
            miss_log_odds=pv.miss_update_log_odds(ins.miss_probability),
            insert_free_space=ins.insert_free_space,
            min_range=options.min_range,
            max_range=options.max_range,
            missing_data_ray_length=options.missing_data_ray_length,
            min_z=options.min_z,
            max_z=options.max_z,
            voxel_filter_size=options.voxel_filter_size,
            avf_max_length=options.adaptive_voxel_filter.max_length,
            avf_min_num_points=options.adaptive_voxel_filter.min_num_points,
            avf_max_range=options.adaptive_voxel_filter.max_range,
            occupied_space_weight=options.ceres_scan_matcher.occupied_space_weight,
            translation_weight=options.ceres_scan_matcher.translation_weight,
            rotation_weight=options.ceres_scan_matcher.rotation_weight,
            gn_iterations=options.ceres_scan_matcher.ceres_solver_options.max_num_iterations,
            mf_max_time=options.motion_filter.max_time_seconds,
            mf_max_distance=options.motion_filter.max_distance_meters,
            mf_max_angle=options.motion_filter.max_angle_radians,
            pose_queue_duration=options.pose_extrapolator.constant_velocity.pose_queue_duration,
            num_steps=num_steps,
            use_imu=options.use_imu_data,
            imu_gravity_time_constant=(
                options.pose_extrapolator.constant_velocity.imu_gravity_time_constant
            ),
            use_band_matcher=False,
        )
        if options.use_online_correlative_scan_matching:
            rt = options.real_time_correlative_scan_matcher
            # Static bounds: the data-dependent angular step is smallest
            # at the longest possible matching range.
            msr_max = min(
                options.max_range, options.adaptive_voxel_filter.max_range
            )
            step_min = compute_angular_step(grid.resolution, msr_max)
            a_cap = int(math.ceil(rt.angular_search_window / step_min))
            num_linear = int(
                math.ceil(rt.linear_search_window / grid.resolution)
            )
            self._cfg = dataclasses.replace(
                self._cfg,
                use_online_correlative=True,
                rtcsm_linear_search_window=rt.linear_search_window,
                rtcsm_angular_search_window=rt.angular_search_window,
                rtcsm_translation_weight=rt.translation_delta_cost_weight,
                rtcsm_rotation_weight=rt.rotation_delta_cost_weight,
                rtcsm_num_linear=num_linear,
                rtcsm_a_cap=a_cap,
            )
        self._state: Optional[frontend_2d.FrontendState2D] = None
        self._epoch: Optional[Time] = None
        self._buffer: List[dict] = []  # scans awaiting dispatch
        self._imu_buffer: List = []  # IMU samples awaiting assignment
        self._odom_buffer: List = []  # odometry samples awaiting assignment
        self._sticky_odometry = False  # upgraded on the first sample
        self._results: List[MatchingResult] = []  # of dispatched chunks
        # Sticky static shapes/flags, grow-only, as in the JAX builder, so
        # both implementations see the same chunk layouts.
        self._pad_n = 256
        self._pad_imu = 4
        self._pack_cap = min(8, self._chunk)
        self._sticky_misses = False
        self._sticky_planar = True
        self._sticky_linear = True
        self._submaps: List[Submap2D] = []
        self._popped_submaps: List[Submap2D] = []
        self._last_wall_time: Optional[float] = None
        self._last_sensor_time: Optional[Time] = None
        self._extent_overflow_warned = False

    # -- sensor feeds ---------------------------------------------------------

    def add_imu_data(self, imu_data) -> None:
        if not self._options.use_imu_data:
            raise RuntimeError("IMU data provided but use_imu_data=False")
        if self._state is None:
            # PoseExtrapolator::InitializeWithImu: seed the tracker from the
            # first sample and add the initial pose at its time — computed
            # with the host ImuTracker, then mirrored into device state.
            tracker = ImuTracker(
                self._cfg.imu_gravity_time_constant, imu_data.time
            )
            tracker.add_imu_linear_acceleration_observation(
                imu_data.linear_acceleration
            )
            tracker.add_imu_angular_velocity_observation(
                imu_data.angular_velocity
            )
            tracker.advance(imu_data.time)
            self._state = frontend_2d.init_state(
                self._cfg.grid_size,
                0.0,
                initial_q=tracker.orientation(),
                tracker_grav=tracker._gravity_vector,
                tracker_omega=tracker._imu_angular_velocity,
                tracker_last_acc_t=0.0,
                device=self._device,
            )
            self._epoch = imu_data.time
        self._imu_buffer.append(imu_data)

    def add_odometry_data(self, odometry_data) -> None:
        # IMU + odometry interleave on the device: the odometry tracker
        # copy syncs to the gyro-fed main tracker at each add_pose and
        # advances with the latest gyro rate (ops/frontend_2d._odometry_fold).
        if self._state is None:
            # Extrapolator not yet initialized
            # (local_trajectory_builder_2d.cc AddOdometryData).
            return
        self._sticky_odometry = True
        self._odom_buffer.append(odometry_data)

    def add_range_data(
        self, sensor_id: str, unsynchronized_data: TimedPointCloudData
    ) -> List[MatchingResult]:
        synchronized = self._range_data_collator.add_range_data(
            sensor_id, unsynchronized_data
        )
        if synchronized is None or synchronized.points.shape[0] == 0:
            return []
        time = synchronized.time
        if self._state is None:
            if self._options.use_imu_data:
                # Until the first IMU message arrives we cannot compute the
                # rangefinder orientation (local_trajectory_builder_2d.cc).
                return []
            # create_without_imu: identity pose at the first scan's time.
            self._state = frontend_2d.init_state(
                self._cfg.grid_size, 0.0, device=self._device
            )
            self._epoch = time
        # Samples strictly before this scan belong to its window.
        scan_imu = []
        while self._imu_buffer and self._imu_buffer[0].time < time:
            scan_imu.append(self._imu_buffer.pop(0))
        scan_odom = []
        while self._odom_buffer and self._odom_buffer[0].time < time:
            scan_odom.append(self._odom_buffer.pop(0))
        origins = synchronized.origins[synchronized.origin_index]  # (N, 3)
        # Single-origin scans only (one rangefinder, or collated to one).
        origin = origins[0] if origins.ndim == 2 else origins
        self._buffer.append(
            {
                "time": time,
                "points": np.asarray(synchronized.points, np.float32),
                "times": np.asarray(synchronized.times, np.float64),
                "origin": np.asarray(origin, np.float32).reshape(3),
                "imu": scan_imu,
                "odom": scan_odom,
            }
        )
        if len(self._buffer) >= self._chunk:
            self._dispatch()
        return self._take_results()

    def flush(self) -> List[MatchingResult]:
        """Process any buffered scans (end of stream / trajectory finish)."""
        if self._buffer:
            self._dispatch()
        return self._take_results()

    def _take_results(self) -> List[MatchingResult]:
        results, self._results = self._results, []
        return results

    # -- chunk processing -----------------------------------------------------

    def _pack(self, scans):
        """Quantize and pack one chunk as the JAX builder does (same sticky
        flags, so one buffer layout serves both); returns (cfg, buf,
        epoch_shift)."""
        c = self._chunk
        n = max(
            self._pad_n,
            _round_up_multiple(max(s["points"].shape[0] for s in scans)),
        )
        self._pad_n = n
        new_epoch = scans[0]["time"]
        epoch_shift = np.float32(new_epoch - self._epoch)
        self._epoch = new_epoch
        q_scale = frontend_2d.point_quantization_scale(self._cfg)
        max_range = self._options.max_range
        # Beyond max_range only the ray direction matters, so ranges are
        # clamped to keep the int16 packing in bounds.
        clamp_r = 1.25 * max(max_range, self._options.missing_data_ray_length)
        # IMU slots are per chunk (not sticky): a first chunk's backlog of
        # samples would otherwise lengthen the sequential tracker fold for
        # the whole run.
        m = self._pad_imu
        while m < max((len(s["imu"]) for s in scans), default=1):
            m *= 2
        use_odom = self._sticky_odometry
        mo = 4
        while mo < max((len(s["odom"]) for s in scans), default=1):
            mo *= 2
        # Pass 1: per-scan quantization + sticky-flag detection.
        has_misses = self._sticky_misses
        planar = self._sticky_planar
        linear = self._sticky_linear
        rows = []
        for s in scans:
            k = s["points"].shape[0]
            delta = s["points"][:, :3] - s["origin"][None, :]
            r = np.linalg.norm(delta, axis=1)
            over = r > clamp_r
            if np.any(over):
                delta = delta * np.minimum(1.0, clamp_r / np.maximum(r, 1e-12))[
                    :, None
                ]
            pts_i16 = np.clip(
                np.round(delta / q_scale), -32767, 32767
            ).astype(np.int16)
            zc = 0.0
            if planar:
                zmin = float(np.min(delta[:, 2]))
                zmax = float(np.max(delta[:, 2]))
                if zmax - zmin <= q_scale:
                    zc = 0.5 * (zmin + zmax)
                else:
                    planar = False
            abs_times = (s["time"] - new_epoch) + s["times"]
            t0 = float(abs_times[0])
            span = float(max(abs_times[-1] - t0, 0.0))
            if span > 0.0:
                u = np.clip(
                    np.round((abs_times - t0) / span * 255.0), 0, 255
                ).astype(np.uint8)
            else:
                u = np.zeros(k, np.uint8)
            if linear and k > 1 and span > 0.0:
                # Compare against the f32 ramp the device regenerates.
                expected = np.round(
                    np.arange(k, dtype=np.float32)
                    * np.float32(255.0)
                    / np.float32(k - 1)
                ).astype(np.uint8)
                if not np.array_equal(u, expected):
                    linear = False
            if not has_misses:
                # Ranges are invariant under the rigid per-point unwarp, so
                # out-of-range points are knowable before dispatch; the
                # 4*q_scale margin covers quantization flips at the border.
                has_misses = bool(np.any(r > max_range - 4.0 * q_scale))
            rows.append(dict(k=k, pts=pts_i16, zc=zc, u=u, t0=t0, span=span))

        self._sticky_misses = has_misses
        self._sticky_planar = planar
        self._sticky_linear = linear
        cfg = dataclasses.replace(
            self._cfg, max_imu_per_scan=m, chunk_size=c, num_points=n,
            max_packed_inserts=self._pack_cap,
            planar_z=planar, linear_times=linear, has_misses=has_misses,
            use_odometry=use_odom, max_odom_per_scan=mo,
        )
        (o_points, o_times, o_meta, o_imu, o_odom, total) = (
            frontend_2d.input_layout(cfg)
        )
        buf = np.zeros(total, np.uint8)
        pdim = 2 if planar else 3
        scan_points = buf[o_points:o_times].view(np.int16).reshape(c, n, pdim)
        scan_meta = buf[o_meta:o_imu].view(np.float32).reshape(c, 8)
        imu_input = buf[o_imu:o_odom].view(np.float32).reshape(c, m, 8)
        odom_input = (
            buf[o_odom:].view(np.float32).reshape(c, mo, 9) if use_odom else None
        )
        scan_times = None if linear else buf[o_times:o_meta].reshape(c, n)
        last_t = 0.0
        for i, (s, row) in enumerate(zip(scans, rows)):
            k = row["k"]
            scan_points[i, :k] = row["pts"][:, :pdim]
            if scan_times is not None and row["span"] > 0.0:
                scan_times[i, :k] = row["u"]
                scan_times[i, k:] = row["u"][-1]
            scan_meta[i, 0] = s["time"] - new_epoch
            scan_meta[i, 1:4] = s["origin"]
            scan_meta[i, 4] = k
            scan_meta[i, 5] = row["t0"]
            scan_meta[i, 6] = row["span"]
            scan_meta[i, 7] = row["zc"]
            for j, d in enumerate(s["imu"]):
                imu_input[i, j, 0] = d.time - new_epoch
                imu_input[i, j, 1:4] = d.linear_acceleration
                imu_input[i, j, 4:7] = d.angular_velocity
                imu_input[i, j, 7] = 1.0
            if odom_input is not None:
                for j, d in enumerate(s["odom"]):
                    odom_input[i, j, 0] = d.time - new_epoch
                    odom_input[i, j, 1:4] = d.pose[:3]
                    odom_input[i, j, 4:8] = d.pose[3:7]
                    odom_input[i, j, 8] = 1.0
            last_t = scan_meta[i, 0]
        for i in range(len(scans), c):
            # Padding scans: no valid points -> matched False, state frozen.
            scan_meta[i, 0] = last_t
            scan_meta[i, 5] = last_t
        return cfg, buf, epoch_shift

    def _dispatch(self) -> None:
        scans = self._buffer
        self._buffer = []
        cfg, buf, epoch_shift = self._pack(scans)
        rcap = self._pack_cap
        packed_in = torch.from_numpy(buf).to(self._device)
        state, fin, out_points, packed_out = frontend_2d.run_chunk(
            cfg, self._state, epoch_shift, packed_in
        )
        self._state = state
        self._results.extend(
            self._collect(scans, rcap, state, fin, out_points, packed_out)
        )

    def _collect(self, scans, rcap, state, fin, out_points, packed_out):
        holder = _ChunkCloudHolder(out_points)  # stays on the device
        packed = packed_out.cpu().numpy()  # one flat fetch
        c = self._chunk
        n_sc = len(frontend_2d.SCALARS)
        sc = packed[: c * n_sc * 4].view(np.float32).reshape(c, n_sc)
        out_filtered = packed[c * n_sc * 4:].view(np.int16).reshape(rcap, -1, 3)
        q_scale = np.float32(frontend_2d.point_quantization_scale(self._cfg))
        S = frontend_2d.SIDX
        num_inserted = int(np.sum(sc[:, S["inserted"]] > 0.5))
        if num_inserted > rcap:
            # More inserts than fetched cloud rows: grow the sticky cap for
            # later chunks; this chunk's excess rows decode from the full
            # clouds below.
            cap = self._pack_cap
            while cap < min(num_inserted, self._chunk):
                cap *= 2
            self._pack_cap = min(cap, self._chunk)

        oob_total = int(np.sum(sc[:, S["oob_hits"]]))
        if oob_total:
            metrics.grid_oob_points.increment(oob_total)
            if not self._extent_overflow_warned:
                self._extent_overflow_warned = True
                logging.getLogger(__name__).warning(
                    "submap grid extent overflow: %d hit endpoint(s) outside "
                    "the %dx%d grid this chunk; increase "
                    "grid_options_2d.grid_size",
                    oob_total, self._cfg.grid_size, self._cfg.grid_size,
                )

        results: List[MatchingResult] = []
        res = self._cfg.resolution
        insert_idx = 0
        for i, s in enumerate(scans):
            if sc[i, S["matched"]] < 0.5:
                continue
            pose2d = sc[i, S["pose_x"]: S["pose_yaw"] + 1].astype(np.float64)
            g_quat = sc[i, S["g_qw"]: S["g_qz"] + 1].astype(np.float64)
            pose_estimate = rigid3.make(
                np.array([pose2d[0], pose2d[1], 0.0]),
                rigid3.quat_normalize(
                    rigid3.quat_multiply(
                        rigid3.quat_from_angle_axis(
                            np.array([0.0, 0.0, pose2d[2]])
                        ),
                        g_quat,
                    )
                ),
            )
            anchor = sc[i, S["anchor_x"]: S["anchor_y"] + 1]
            local_origin3 = np.array(
                [anchor[0], anchor[1], s["origin"][2]], np.float32
            )
            range_data_in_local = LazyRangeData(
                holder, i, pose2d, local_origin3
            )
            insertion_result = None
            if sc[i, S["inserted"]] > 0.5:
                nf = int(sc[i, S["num_filtered"]])
                if insert_idx < rcap:
                    filtered = (
                        out_filtered[insert_idx, :nf].astype(np.float32)
                        * q_scale
                    )
                else:
                    # Cap overflow: recover the compacted adaptive cloud
                    # from the full per-scan output (mask code 2, scan
                    # order — the same set the device compaction packs).
                    pts = holder.get()
                    code_col = 6 if pts.shape[-1] == 7 else 3
                    code = pts[i, :, code_col]
                    adaptive = (code >= 1.5) & (code < 2.5)
                    filtered = pts[i, adaptive, 0:3][:nf].astype(np.float32)
                insert_idx += 1
                insertion_result = self._replay_insert(
                    sc[i], filtered, s, g_quat, pose_estimate
                )
            results.append(
                MatchingResult(
                    time=s["time"],
                    local_pose=pose_estimate,
                    range_data_in_local=range_data_in_local,
                    insertion_result=insertion_result,
                )
            )
            self._update_metrics(s["time"])

        # Attach end-of-chunk grid snapshots to the live submaps.
        for slot, submap in enumerate(self._submaps):
            submap.grid = Grid2D(
                log_odds=state.grids_lo[slot],
                known=state.grids_known[slot],
                origin=state.grid_origin[slot],
                resolution=res,
            )
        # Submaps popped mid-chunk get their exact finished grids from the
        # chunk's snapshot ring (in pop order).
        for slot, submap in enumerate(self._popped_submaps):
            submap.grid = Grid2D(
                log_odds=fin["lo"][slot],
                known=fin["known"][slot],
                origin=fin["origin"][slot],
                resolution=res,
            )
        self._popped_submaps = []
        return results

    def _replay_insert(
        self, sc_row, filtered, s: dict, g_quat, pose_estimate
    ) -> InsertionResult:
        """Mirror ActiveSubmaps2D::InsertRangeData bookkeeping from the
        device-decided event flags."""
        S = frontend_2d.SIDX
        anchor = sc_row[S["anchor_x"]: S["anchor_y"] + 1].astype(np.float64)
        if sc_row[S["created"]] > 0.5:
            if sc_row[S["popped"]] > 0.5:
                self._popped_submaps.append(self._submaps.pop(0))
            self._submaps.append(
                Submap2D(local_pose=rigid2.make(anchor, 0.0), grid=None)
            )
        for submap in self._submaps:
            submap.num_range_data += 1
        if sc_row[S["finished"]] > 0.5:
            self._submaps[0].finish()
        return InsertionResult(
            constant_data=TrajectoryNodeData(
                time=s["time"],
                gravity_alignment=rigid3.quat_normalize(np.asarray(g_quat)),
                filtered_gravity_aligned_point_cloud=filtered,
                local_pose=pose_estimate,
            ),
            insertion_submaps=list(self._submaps),
        )

    def _update_metrics(self, sensor_time: Time) -> None:
        wall_time = _walltime.monotonic()
        if self._last_wall_time is not None and self._last_sensor_time is not None:
            wall_duration = wall_time - self._last_wall_time
            if wall_duration > 0:
                metrics.local_slam_real_time_ratio.set(
                    (sensor_time - self._last_sensor_time) / wall_duration
                )
        self._last_wall_time = wall_time
        self._last_sensor_time = sensor_time
