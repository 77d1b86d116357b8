"""Chunked device-resident 3D local SLAM frontend (host wrapper).

Port of cartographer_tpu/mapping/chunked_frontend_3d.py. The alternative
to LocalTrajectoryBuilder3D for the common 3D configuration (IMU and
constant-velocity extrapolation, no odometry, one accumulated scan, no
online correlative matching, no intensities): the whole per-scan pipeline
runs on the device (ops/frontend_3d.run_chunk), one dispatch and one
packed fetch per chunk of scans, so `add_range_data` returns a LIST of
MatchingResults at chunk boundaries (empty otherwise) and `flush` returns
the rest.

Submap lifecycle events decided on the device are replayed on the host,
so the Submap3D objects match ActiveSubmaps3D semantics
(mapping/3d/submap_3d.cc:199-354), including the rotational histograms
(computed on the host from the fetched tracking-frame clouds). Grids stay
device tensors; finished paged grids become dense, cropped to content.

Chunks are dispatched synchronously, as in the port's 2D wrapper.
"""

from __future__ import annotations

import dataclasses
import logging
import time as _walltime
from typing import List, Optional, Set

import numpy as np
import torch

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.common.config import TrajectoryBuilder3DOptions
from cartographer_tpu_torch.common.time import Time
from cartographer_tpu_torch.device import resolve_device
from cartographer_tpu_torch.mapping import probability_values as pv
from cartographer_tpu_torch.mapping.hybrid_grid import Grid3D, quantize_log_odds_delta
from cartographer_tpu_torch.mapping.imu_tracker import ImuTracker
from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
    InsertionResult,
    MatchingResult,
)
from cartographer_tpu_torch.mapping.paged_grid_3d import PagedGrid3D, to_dense
from cartographer_tpu_torch.mapping.range_data_collator import RangeDataCollator
from cartographer_tpu_torch.mapping.submap_3d import Submap3D
from cartographer_tpu_torch.mapping.trajectory_node import TrajectoryNodeData
from cartographer_tpu_torch.ops import frontend_3d
from cartographer_tpu_torch.ops.scan_matching import rotational_histogram
from cartographer_tpu_torch.sensor.data import (
    PointCloud,
    RangeData,
    TimedPointCloudData,
)
from cartographer_tpu_torch.sensor.voxel_filter import voxel_filter_indices
from cartographer_tpu_torch.transform import rigid3


def _round_up_multiple(n: int, multiple: int = 256) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def supports(options: TrajectoryBuilder3DOptions) -> bool:
    """Whether this frontend covers the given configuration (IMU-driven
    constant-velocity extrapolation, no odometry, no intensities)."""
    return (
        options.num_accumulated_range_data == 1
        and not options.use_online_correlative_scan_matching
        and not options.pose_extrapolator.use_imu_based
        and not options.use_intensities
    )


class ChunkedLocalTrajectoryBuilder3D:
    """3D frontend with the whole per-scan pipeline on the device.
    `device=None` means CUDA; pass device="cpu" to run on the CPU."""

    def __init__(
        self,
        options: TrajectoryBuilder3DOptions,
        expected_range_sensor_ids: Set[str],
        chunk_size: int = 16,
        device=None,
    ):
        if not supports(options):
            raise ValueError(
                "ChunkedLocalTrajectoryBuilder3D supports IMU/constant-velocity "
                "no-intensity configurations; use LocalTrajectoryBuilder3D "
                "otherwise"
            )
        self._device = resolve_device(device)
        self._options = options
        self._range_data_collator = RangeDataCollator(expected_range_sensor_ids)
        sub = options.submaps
        ins = sub.range_data_inserter
        avf_hi = options.high_resolution_adaptive_voxel_filter
        avf_lo = options.low_resolution_adaptive_voxel_filter
        csm = options.ceres_scan_matcher
        cv = options.pose_extrapolator.constant_velocity
        self._chunk = max(1, chunk_size)
        self._cfg = frontend_3d.FrontendConfig3D(
            high_grid_size=sub.high_resolution_grid_size,
            low_grid_size=sub.low_resolution_grid_size,
            high_resolution=sub.high_resolution,
            low_resolution=sub.low_resolution,
            high_resolution_max_range=sub.high_resolution_max_range,
            num_range_data=sub.num_range_data,
            hit_delta=quantize_log_odds_delta(pv.hit_update_log_odds(ins.hit_probability)),
            miss_delta=quantize_log_odds_delta(pv.miss_update_log_odds(ins.miss_probability)),
            num_free_space_voxels=ins.num_free_space_voxels,
            min_range=options.min_range,
            max_range=options.max_range,
            voxel_filter_size=options.voxel_filter_size,
            hi_avf_max_length=avf_hi.max_length,
            hi_avf_min_num_points=avf_hi.min_num_points,
            hi_avf_max_range=avf_hi.max_range,
            lo_avf_max_length=avf_lo.max_length,
            lo_avf_min_num_points=avf_lo.min_num_points,
            lo_avf_max_range=avf_lo.max_range,
            occupied_space_weight_0=csm.occupied_space_weight_0,
            occupied_space_weight_1=csm.occupied_space_weight_1,
            translation_weight=csm.translation_weight,
            rotation_weight=csm.rotation_weight,
            gn_iterations=csm.ceres_solver_options.max_num_iterations,
            only_optimize_yaw=csm.only_optimize_yaw,
            mf_max_time=options.motion_filter.max_time_seconds,
            mf_max_distance=options.motion_filter.max_distance_meters,
            mf_max_angle=options.motion_filter.max_angle_radians,
            pose_queue_duration=cv.pose_queue_duration,
            imu_gravity_time_constant=cv.imu_gravity_time_constant,
            paged=sub.sparse_grids,
            block_bits=sub.sparse_block_bits,
            high_table_size=sub.sparse_high_table_size,
            high_pool_blocks=sub.sparse_high_pool_blocks,
            low_table_size=sub.sparse_low_table_size,
            low_pool_blocks=sub.sparse_low_pool_blocks,
        )
        self._state: Optional[frontend_3d.FrontendState3D] = None
        self._epoch: Optional[Time] = None
        self._buffer: List[dict] = []  # scans awaiting dispatch
        self._imu_buffer: List = []  # IMU samples awaiting assignment
        self._results: List[MatchingResult] = []  # of dispatched chunks
        # Sticky static shapes/flags, grow-only, as in the JAX builder, so
        # both implementations see the same chunk layouts.
        self._pad_n = 256
        self._pad_imu = 4
        self._sticky_misses = False
        self._sticky_linear = True
        self._submaps: List[Submap3D] = []
        self._popped_submaps: List[Submap3D] = []
        self._last_wall_time: Optional[float] = None
        self._last_sensor_time: Optional[Time] = None
        self._warned_odometry = False
        self._extent_overflow_warned = False

    # -- sensor feeds ---------------------------------------------------------

    def add_imu_data(self, imu_data) -> None:
        if self._state is None:
            # create_with_imu_data -> PoseExtrapolator::InitializeWithImu:
            # seed the tracker from the first sample; the initial pose is the
            # pure rotation to the tracker orientation at its time.
            tracker = ImuTracker(self._cfg.imu_gravity_time_constant, imu_data.time)
            tracker.add_imu_linear_acceleration_observation(
                imu_data.linear_acceleration
            )
            tracker.add_imu_angular_velocity_observation(imu_data.angular_velocity)
            tracker.advance(imu_data.time)
            self._state = frontend_3d.init_state(
                self._cfg,
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
        """The chunked 3D frontend does not fuse odometry (its IMU-driven
        extrapolator runs inside the chunk program). Odometry presence is
        not a configuration field, so a stream with odometry degrades
        observably: a warning once, and every dropped sample counted by
        mapping_frontend_odometry_samples_dropped. The per-scan
        LocalTrajectoryBuilder3D fuses odometry."""
        del odometry_data
        if not self._warned_odometry:
            self._warned_odometry = True
            logging.warning(
                "chunked 3D device frontend does not fuse odometry; "
                "dropping samples (counted by "
                "mapping_frontend_odometry_samples_dropped). Use "
                "use_chunked_device_frontend=False for odometry fusion."
            )
        metrics.frontend_odometry_dropped.increment()

    def add_range_data(
        self, sensor_id: str, unsynchronized_data: TimedPointCloudData
    ) -> List[MatchingResult]:
        synchronized = self._range_data_collator.add_range_data(
            sensor_id, unsynchronized_data
        )
        if synchronized is None or synchronized.points.shape[0] == 0:
            return []
        if self._state is None:
            # 3D needs IMU before any range data can be processed
            # (local_trajectory_builder_3d.cc:141-147).
            return []
        time = synchronized.time
        # 0.5x voxel pre-filter on the raw synchronized points
        # (local_trajectory_builder_3d.cc:153-158), on the host; it also
        # shrinks the upload.
        keep = voxel_filter_indices(
            synchronized.points, 0.5 * self._options.voxel_filter_size
        )
        points = np.asarray(synchronized.points[keep], np.float32)
        times = np.asarray(synchronized.times[keep], np.float64)
        scan_imu = []
        while self._imu_buffer and self._imu_buffer[0].time < time:
            scan_imu.append(self._imu_buffer.pop(0))
        origins = synchronized.origins[synchronized.origin_index[keep]]
        origin = origins[0] if origins.ndim == 2 else origins
        self._buffer.append(
            {
                "time": time,
                "points": points,
                "times": times,
                "origin": np.asarray(origin, np.float32).reshape(3),
                "imu": scan_imu,
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
        q_scale = frontend_3d.point_quantization_scale(self._cfg)
        max_range = self._options.max_range
        clamp_r = 1.25 * max_range
        # IMU slots are per chunk (not sticky): a first chunk's backlog of
        # samples would otherwise lengthen the sequential tracker fold for
        # the whole run.
        m = self._pad_imu
        while m < max((len(s["imu"]) for s in scans), default=1):
            m *= 2
        # Pass 1: quantization + sticky-flag detection.
        has_misses = self._sticky_misses
        linear = self._sticky_linear
        rows = []
        for s in scans:
            k = s["points"].shape[0]
            delta = s["points"][:, :3] - s["origin"][None, :]
            r = np.linalg.norm(delta, axis=1)
            if np.any(r > clamp_r):
                # Beyond max_range only the ray direction matters (misses are
                # cropped AT max_range), so ranges are clamped to keep the
                # int16 packing in bounds.
                delta = delta * np.minimum(1.0, clamp_r / np.maximum(r, 1e-12))[:, None]
            pts_i16 = np.clip(np.round(delta / q_scale), -32767, 32767).astype(np.int16)
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
                has_misses = bool(np.any(r > max_range - 4.0 * q_scale))
            rows.append(dict(k=k, pts=pts_i16, u=u, t0=t0, span=span))

        self._sticky_misses = has_misses
        self._sticky_linear = linear
        cfg = dataclasses.replace(
            self._cfg, max_imu_per_scan=m, chunk_size=c, num_points=n,
            linear_times=linear, has_misses=has_misses,
        )
        o_points, o_times, o_meta, o_imu, total = frontend_3d.input_layout(cfg)
        buf = np.zeros(total, np.uint8)
        scan_points = buf[o_points:o_times].view(np.int16).reshape(c, n, 3)
        scan_times = None if linear else buf[o_times:o_meta].reshape(c, n)
        scan_meta = buf[o_meta:o_imu].view(np.float32).reshape(c, 7)
        imu_input = buf[o_imu:].view(np.float32).reshape(c, m, 8)
        last_t = 0.0
        for i, (s, row) in enumerate(zip(scans, rows)):
            k = row["k"]
            scan_points[i, :k] = row["pts"]
            if scan_times is not None and row["span"] > 0.0:
                scan_times[i, :k] = row["u"]
                scan_times[i, k:] = row["u"][-1]
            scan_meta[i, 0] = s["time"] - new_epoch
            scan_meta[i, 1:4] = s["origin"]
            scan_meta[i, 4] = k
            scan_meta[i, 5] = row["t0"]
            scan_meta[i, 6] = row["span"]
            for j, d in enumerate(s["imu"]):
                imu_input[i, j, 0] = d.time - new_epoch
                imu_input[i, j, 1:4] = d.linear_acceleration
                imu_input[i, j, 4:7] = d.angular_velocity
                imu_input[i, j, 7] = 1.0
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
        packed_in = torch.from_numpy(buf).to(self._device)
        state, fin, packed_out = frontend_3d.run_chunk(
            cfg, self._state, epoch_shift, packed_in
        )
        self._state = state
        self._results.extend(self._collect(scans, cfg, state, fin, packed_out))

    def _collect(self, scans, cfg, state, fin, packed_out) -> List[MatchingResult]:
        packed = packed_out.cpu().numpy()  # one flat fetch
        c, n = cfg.chunk_size, cfg.num_points
        has_misses = cfg.has_misses
        o_sc, o_hits, o_code, o_miss, _ = frontend_3d.output_layout(cfg)
        n_sc = len(frontend_3d.SCALARS)
        sc = packed[o_sc:o_hits].view(np.float32).reshape(c, n_sc)
        hits_q = packed[o_hits:o_code].view(np.int16).reshape(c, n, 3)
        codes = packed[o_code:o_miss].reshape(c, n)
        if has_misses:
            miss_q = packed[o_miss:].view(np.int16).reshape(c, n, 3)
        q_scale = float(frontend_3d.point_quantization_scale(cfg))
        S = frontend_3d.SIDX
        opts = self._options

        results: List[MatchingResult] = []
        for i, s in enumerate(scans):
            if sc[i, S["matched"]] < 0.5:
                continue
            est_t = sc[i, S["est_x"]: S["est_z"] + 1].astype(np.float64)
            est_q = rigid3.quat_normalize(
                sc[i, S["est_qw"]: S["est_qz"] + 1].astype(np.float64)
            )
            g_quat = rigid3.quat_normalize(
                sc[i, S["g_qw"]: S["g_qz"] + 1].astype(np.float64)
            )
            pose_estimate = rigid3.make(est_t, est_q)
            code = codes[i].astype(np.int32)
            ret = (code & 1) > 0
            hits_track = hits_q[i].astype(np.float64) * q_scale
            ret_track = hits_track[ret]
            hits_local = rigid3.quat_rotate(est_q[None, :], ret_track) + est_t[None, :]
            if has_misses:
                mm = (code & 8) > 0
                miss_track = miss_q[i, mm].astype(np.float64) * q_scale
                miss_local = (
                    rigid3.quat_rotate(est_q[None, :], miss_track) + est_t[None, :]
                )
            else:
                miss_local = np.zeros((0, 3), np.float64)
            range_data_in_local = RangeData(
                origin=est_t.astype(np.float32),
                returns=PointCloud(hits_local.astype(np.float32)),
                misses=PointCloud(miss_local.astype(np.float32)),
            )
            insertion_result = None
            if sc[i, S["inserted"]] > 0.5:
                high_cloud = hits_track[(code & 2) > 0].astype(np.float32)
                low_cloud = hits_track[(code & 4) > 0].astype(np.float32)
                gravity_cloud = rigid3.quat_rotate(g_quat[None, :], ret_track)
                histogram = rotational_histogram.compute_histogram(
                    gravity_cloud, opts.rotational_histogram_size
                )
                insertion_result = self._replay_insert(
                    sc[i], s, est_t, est_q, g_quat, pose_estimate,
                    high_cloud, low_cloud, histogram,
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

        # Dropped grid writes are counted (the reference grows its
        # HybridGrid; the fixed extent or block pool makes the loss visible).
        oob_total = int(np.sum(sc[:, S["oob_high"]]) + np.sum(sc[:, S["oob_low"]]))
        if oob_total:
            metrics.grid_oob_points.increment(oob_total)
            if not self._extent_overflow_warned:
                self._extent_overflow_warned = True
                what = (
                    "virtual extent/block pool (raise submaps.sparse_* "
                    "table/pool sizes)"
                    if cfg.paged
                    else "grid extent (raise submaps.*_resolution_grid_size)"
                )
                logging.getLogger(__name__).warning(
                    "3D submap grid overflow: %d dropped write(s) this "
                    "chunk; increase the %s", oob_total, what,
                )
        self._attach_grids(cfg, state, fin)
        return results

    def _attach_grids(self, cfg, state, fin) -> None:
        """End-of-chunk grids for the live submaps (from the state) and the
        submaps popped in this chunk (from the chunk's ring, in pop order).
        Finished paged grids become dense, cropped to content (their
        dropped writes were counted per chunk already)."""
        sub = self._options.submaps
        dev = self._device
        if cfg.paged:
            def grid_of(source, slot, gi):
                res = sub.high_resolution if gi == 0 else sub.low_resolution
                tsize = cfg.high_table_size if gi == 0 else cfg.low_table_size
                half = 0.5 * (tsize << cfg.block_bits) * res
                if isinstance(source, dict):  # fin ring: [r, 2 (grid), ...]
                    get = lambda part: source[f"pg_{part}"][slot][gi]  # noqa: E731
                else:  # state lanes [high_s0, low_s0, high_s1, low_s1]
                    get = lambda part: getattr(source, f"pg_{part}")[2 * slot + gi]  # noqa: E731
                return PagedGrid3D(
                    table=get("table"),
                    pool=get("pool"),
                    num_blocks=get("nblocks"),
                    dropped=get("dropped"),
                    origin=torch.full((3,), -half, dtype=torch.float32, device=dev),
                    resolution=res,
                    block_bits=cfg.block_bits,
                    table_size=tsize,
                )
        else:
            half_high = 0.5 * sub.high_resolution_grid_size * sub.high_resolution
            half_low = 0.5 * sub.low_resolution_grid_size * sub.low_resolution

            def grid_of(source, slot, gi):
                if isinstance(source, dict):
                    values = source["high" if gi == 0 else "low"][slot]
                else:
                    values = (state.high_values if gi == 0 else state.low_values)[slot]
                half = half_high if gi == 0 else half_low
                return Grid3D(
                    values=values,
                    origin=torch.full((3,), -half, dtype=torch.float32, device=dev),
                    resolution=sub.high_resolution if gi == 0 else sub.low_resolution,
                )

        def attach(submap, source, slot):
            hi, lo = grid_of(source, slot, 0), grid_of(source, slot, 1)
            if submap.insertion_finished and cfg.paged:
                hi, lo = to_dense(hi), to_dense(lo)
            submap.high_resolution_grid = hi
            submap.low_resolution_grid = lo

        for slot, submap in enumerate(self._submaps):
            attach(submap, state, slot)
        for slot, submap in enumerate(self._popped_submaps):
            attach(submap, fin, slot)
        self._popped_submaps = []

    def _replay_insert(
        self, sc_row, s: dict, est_t, est_q, g_quat, pose_estimate,
        high_cloud, low_cloud, histogram,
    ) -> InsertionResult:
        """Mirror ActiveSubmaps3D::InsertData bookkeeping from the device
        event flags, including the rotational-histogram accumulation
        (submap_3d.cc:199-354)."""
        S = frontend_3d.SIDX
        lfga = rigid3.quat_normalize(
            rigid3.quat_multiply(est_q, rigid3.quat_conjugate(g_quat))
        )
        if sc_row[S["created"]] > 0.5:
            if sc_row[S["popped"]] > 0.5:
                self._popped_submaps.append(self._submaps.pop(0))
            self._submaps.append(
                Submap3D(
                    local_pose=rigid3.make(est_t, lfga),
                    high_resolution_grid=None,
                    low_resolution_grid=None,
                    rotational_scan_matcher_histogram=np.zeros_like(histogram),
                )
            )
        for submap in self._submaps:
            submap.num_range_data += 1
            yaw = rigid3.get_yaw(
                rigid3.quat_multiply(
                    rigid3.quat_conjugate(rigid3.quat(submap.local_pose)), lfga
                )
            )
            submap.rotational_scan_matcher_histogram = (
                submap.rotational_scan_matcher_histogram
                + rotational_histogram.rotate_histogram(histogram, float(yaw))
            )
        if sc_row[S["finished"]] > 0.5:
            if self._cfg.paged:
                # The attached grid is the last chunk's; only flag it here —
                # the end-of-chunk attachment densifies the current grids.
                self._submaps[0].insertion_finished = True
            else:
                self._submaps[0].finish()
        return InsertionResult(
            constant_data=TrajectoryNodeData(
                time=s["time"],
                gravity_alignment=g_quat,
                filtered_gravity_aligned_point_cloud=np.zeros((0, 3), np.float32),
                high_resolution_point_cloud=high_cloud,
                low_resolution_point_cloud=low_cloud,
                rotational_scan_matcher_histogram=histogram,
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
