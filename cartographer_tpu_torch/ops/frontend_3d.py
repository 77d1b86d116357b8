"""Device-resident 3D local-SLAM frontend (chunked).

Port of cartographer_tpu/ops/frontend_3d.py. The whole per-scan pipeline
of LocalTrajectoryBuilder3D (reference:
mapping/internal/3d/local_trajectory_builder_3d.cc:48-479) runs on the
device for a chunk of scans: IMU-fused pose extrapolation
(pose_extrapolator.cc, imu_tracker.cc) -> per-point SE(3) unwarp
(ExtrapolatePosesWithGravity) -> min/max range split with misses cropped
at max_range -> voxel filter in the local frame -> high/low-resolution
adaptive voxel filters on the tracking-frame returns -> dual-grid LM scan
match (ceres_scan_matcher_3d.cc) -> extrapolator pose update -> motion
filter -> bounded-free-space insertion into the two active submaps' high
and low resolution grids with submap rotation (range_data_inserter_3d.cc,
submap_3d.cc:199-354).

The JAX `lax.scan` over the chunk is a Python loop here; inside it no
value leaves the device (every data-dependent branch is a `torch.where`).
The packed uint8 input and output layouts are the JAX package's, so one
buffer feeds both implementations. Rotational histograms are computed by
the host wrapper from the fetched clouds.

Grids: dense int8 volumes per slot, or (`paged`, the default of the host
wrapper) the stacked block-sparse lanes [high_s0, low_s0, high_s1,
low_s1], inserted into with one lane-batched insert. Scope (asserted by
the host wrapper): IMU-driven constant-velocity extrapolation, no
odometry, one accumulated scan, no online correlative matching, no
intensities.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cartographer_tpu_torch.device import resolve_device
from cartographer_tpu_torch.mapping.paged_grid_3d import (
    PagedGrid3D,
    insert_cells_paged,
)
from cartographer_tpu_torch.ops import frontend_common as fc
from cartographer_tpu_torch.ops import raycast_3d
from cartographer_tpu_torch.ops.scan_matching import gauss_newton_3d
from cartographer_tpu_torch.ops.scan_matching.gauss_newton_3d import scaled


@dataclasses.dataclass
class FrontendState3D:
    """Device state carried across scans and chunks. All times are float32
    offsets from a host-managed epoch (rebased every chunk). Field for
    field the JAX FrontendState3D (see state_from_numpy); the grid fields
    of the other mode are None."""

    # Pose queue (timed_pose_queue, length 2).
    older_t: torch.Tensor
    older_xyz: torch.Tensor  # [3]
    older_q: torch.Tensor  # [4] wxyz
    newest_t: torch.Tensor
    newest_xyz: torch.Tensor  # [3]
    newest_q: torch.Tensor  # [4]
    queue_len: torch.Tensor  # i32 (1 or 2)
    vel: torch.Tensor  # [3]
    ang_vel: torch.Tensor  # [3]
    # ImuTracker (advanced to newest_t at every add_pose).
    tracker_ori: torch.Tensor  # [4]
    tracker_grav: torch.Tensor  # [3]
    tracker_omega: torch.Tensor  # [3]
    tracker_last_acc_t: torch.Tensor  # f32; -1e30 = never observed
    last_extrap_t: torch.Tensor
    # Motion filter memory.
    mf_valid: torch.Tensor
    mf_t: torch.Tensor
    mf_xyz: torch.Tensor  # [3]
    mf_q: torch.Tensor  # [4]
    # Active submaps: slot 0 = older, slot 1 = newer.
    anchor_t: torch.Tensor  # f32 [2, 3] submap local_pose translation
    anchor_q: torch.Tensor  # f32 [2, 4] submap local_pose rotation
    counts: torch.Tensor  # i32 [2]
    slot_valid: torch.Tensor  # bool [2]
    high_values: torch.Tensor = None  # i8 [2, Gh, Gh, Gh] (dense)
    low_values: torch.Tensor = None  # i8 [2, Gl, Gl, Gl] (dense)
    # Paged: lanes [high_s0, low_s0, high_s1, low_s1].
    pg_table: torch.Tensor = None  # i32 [4, T^3]
    pg_pool: torch.Tensor = None  # i8 [4, P, B^3]
    pg_nblocks: torch.Tensor = None  # i32 [4]
    pg_dropped: torch.Tensor = None  # i32 [4]

    def replace(self, **changes) -> "FrontendState3D":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class FrontendConfig3D:
    """Static configuration, from TrajectoryBuilder3DOptions. The field
    names are the JAX FrontendConfig3D's, so configs convert field for
    field."""

    high_grid_size: int
    low_grid_size: int
    high_resolution: float
    low_resolution: float
    high_resolution_max_range: float
    num_range_data: int
    hit_delta: int  # quantized int8 log-odds deltas (hybrid_grid)
    miss_delta: int
    num_free_space_voxels: int
    min_range: float
    max_range: float
    voxel_filter_size: float
    hi_avf_max_length: float
    hi_avf_min_num_points: int
    hi_avf_max_range: float
    lo_avf_max_length: float
    lo_avf_min_num_points: int
    lo_avf_max_range: float
    occupied_space_weight_0: float
    occupied_space_weight_1: float
    translation_weight: float
    rotation_weight: float
    gn_iterations: int
    only_optimize_yaw: bool
    mf_max_time: float
    mf_max_distance: float
    mf_max_angle: float
    pose_queue_duration: float
    imu_gravity_time_constant: float = 10.0
    max_imu_per_scan: int = 16
    use_imu: bool = True  # 3D always fuses IMU (tracker fold contract)
    # Block-sparse (paged) active-submap grids: virtual extent per axis =
    # table_size * 2^block_bits cells, memory bounded by the block pool,
    # dropped writes counted (oob_high / oob_low).
    paged: bool = False
    block_bits: int = 4
    high_table_size: int = 64
    high_pool_blocks: int = 4096
    low_table_size: int = 32
    low_pool_blocks: int = 2048
    # Whether any scan in the chunk has points beyond max_range; when False
    # all missing-echo processing and outputs are left out.
    has_misses: bool = True
    # Static bound on each matching cloud (high/low) handed to the LM
    # matcher; overflow drops the excess from matching only.
    match_max_points: int = 512
    # Packed-transfer geometry (see input_layout/output_layout).
    chunk_size: int = 0
    num_points: int = 0
    # Upload compression: per-point times regenerated as the uniform
    # uint8 ramp.
    linear_times: bool = False
    # The JAX package's debug stage stubs; this port accepts only "".
    disable: str = ""


def init_state(
    cfg: FrontendConfig3D,
    t0: float = 0.0,
    initial_q=None,
    tracker_grav=None,
    tracker_omega=None,
    tracker_last_acc_t: float = -1e30,
    device=None,
) -> FrontendState3D:
    """State after PoseExtrapolator::InitializeWithImu: the host wrapper
    computes the initial ImuTracker state from the first IMU sample and
    seeds it here (pose at t0 = pure rotation to the tracker orientation).
    `device=None` means CUDA."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    q0 = f32([1.0, 0.0, 0.0, 0.0] if initial_q is None else initial_q)
    grav0 = f32([0.0, 0.0, 1.0] if tracker_grav is None else tracker_grav)
    omega0 = f32(np.zeros(3) if tracker_omega is None else tracker_omega)
    z3 = torch.zeros(3, dtype=torch.float32, device=dev)
    if cfg.paged:
        if (cfg.low_table_size, cfg.low_pool_blocks) != (
            cfg.high_table_size, cfg.high_pool_blocks
        ):
            raise ValueError(
                "the paged device frontend needs equal high/low table and "
                "pool sizes (stacked 4-lane layout)"
            )
        b3 = 1 << (3 * cfg.block_bits)
        grids = dict(
            pg_table=torch.full(
                (4, cfg.high_table_size**3), -1, dtype=torch.int32, device=dev
            ),
            pg_pool=torch.zeros(
                (4, cfg.high_pool_blocks, b3), dtype=torch.int8, device=dev
            ),
            pg_nblocks=torch.zeros(4, dtype=torch.int32, device=dev),
            pg_dropped=torch.zeros(4, dtype=torch.int32, device=dev),
        )
    else:
        gh, gl = cfg.high_grid_size, cfg.low_grid_size
        grids = dict(
            high_values=torch.zeros((2, gh, gh, gh), dtype=torch.int8, device=dev),
            low_values=torch.zeros((2, gl, gl, gl), dtype=torch.int8, device=dev),
        )
    unit_q = f32([1.0, 0.0, 0.0, 0.0])
    return FrontendState3D(
        **grids,
        older_t=f32(t0),
        older_xyz=z3,
        older_q=q0,
        newest_t=f32(t0),
        newest_xyz=z3,
        newest_q=q0,
        queue_len=torch.tensor(1, dtype=torch.int32, device=dev),
        vel=z3,
        ang_vel=z3,
        tracker_ori=q0,
        tracker_grav=grav0,
        tracker_omega=omega0,
        tracker_last_acc_t=f32(tracker_last_acc_t),
        last_extrap_t=f32(t0),
        mf_valid=torch.tensor(False, device=dev),
        mf_t=f32(0.0),
        mf_xyz=z3,
        mf_q=unit_q,
        anchor_t=torch.zeros((2, 3), dtype=torch.float32, device=dev),
        anchor_q=unit_q.repeat(2, 1),
        counts=torch.zeros(2, dtype=torch.int32, device=dev),
        slot_valid=torch.zeros(2, dtype=torch.bool, device=dev),
    )


def state_from_numpy(d, device=None) -> FrontendState3D:
    """A state from numpy arrays keyed by field name — e.g. a JAX
    FrontendState3D as `{f.name: np.asarray(getattr(s, f.name))}`, with
    None for the grid fields of the other mode — so that both
    implementations can start a chunk from the same state."""
    dev = resolve_device(device)
    out = {}
    for f in dataclasses.fields(FrontendState3D):
        if f.name not in d:
            if f.default is dataclasses.MISSING:
                raise KeyError(f"state field missing: {f.name}")
            continue
        v = d[f.name]
        out[f.name] = None if v is None else torch.as_tensor(np.array(v), device=dev)
    return FrontendState3D(**out)


def state_to_numpy(state: FrontendState3D) -> dict:
    """Numpy arrays keyed by field name (the inverse of state_from_numpy)."""
    return {
        f.name: None if getattr(state, f.name) is None
        else getattr(state, f.name).cpu().numpy()
        for f in dataclasses.fields(state)
    }


def _half_extents(cfg: FrontendConfig3D):
    if cfg.paged:
        return (
            0.5 * (cfg.high_table_size << cfg.block_bits) * cfg.high_resolution,
            0.5 * (cfg.low_table_size << cfg.block_bits) * cfg.low_resolution,
        )
    return (
        0.5 * cfg.high_grid_size * cfg.high_resolution,
        0.5 * cfg.low_grid_size * cfg.low_resolution,
    )


def _paged_slot(cfg: FrontendConfig3D, state: FrontendState3D, name, slot):
    """One active-submap slot of the state as a PagedGrid3D (views of the
    state's tensors; geometry from cfg). Lane layout: [high_s0, low_s0,
    high_s1, low_s1]."""
    res = cfg.high_resolution if name == "high" else cfg.low_resolution
    tsize = cfg.high_table_size if name == "high" else cfg.low_table_size
    half = 0.5 * (tsize << cfg.block_bits) * res
    lane = 2 * slot + (0 if name == "high" else 1)
    return PagedGrid3D(
        table=state.pg_table[lane],
        pool=state.pg_pool[lane],
        num_blocks=state.pg_nblocks[lane],
        dropped=state.pg_dropped[lane],
        origin=torch.full((3,), -half, dtype=torch.float32, device=state.pg_table.device),
        resolution=res,
        block_bits=cfg.block_bits,
        table_size=tsize,
    )


@functools.lru_cache(maxsize=None)
def _lane_geometry(cfg: FrontendConfig3D, device):
    """Per-lane resolution and half extent [4, 1, 1] of the paged lanes
    [high_s0, low_s0, high_s1, low_s1], as tensors on `device`: the JAX
    package vmaps the lanes, so these divide as traced values."""
    half_high, half_low = _half_extents(cfg)
    geometry = torch.tensor(
        [[cfg.high_resolution, half_high], [cfg.low_resolution, half_low]] * 2,
        dtype=torch.float32,
    ).to(device)
    return geometry[:, 0, None, None], geometry[:, 1, None, None]


def _ring_put(ring, cnt, pop, value):
    """ring[cnt] = value where `pop`, on the device (cnt clamped: once the
    ring is full no later pop can follow)."""
    slot = torch.clamp(cnt, max=ring.shape[0] - 1).long().reshape(1)
    old = ring.index_select(0, slot)
    return ring.index_copy(0, slot, torch.where(pop, value[None], old))


def _scan_body(cfg: FrontendConfig3D, state: FrontendState3D, fin: dict, x):
    points, pmask, ptimes, t_scan, sensor_origin, imu = x
    dev = points.device
    half_high, half_low = _half_extents(cfg)

    # -- skip gate: scan starts before the newest pose
    # (local_trajectory_builder_3d.cc:141-147).
    active = ptimes[0] >= state.newest_t

    # -- ImuTracker fold to t_scan + per-point unwarp -------------------------
    (trk_t, trk_ori, trk_grav, trk_om, trk_la), (bp_t, bp_ori, bp_om) = (
        fc.tracker_fold(cfg, state, t_scan, imu)
    )
    g_quat = trk_ori  # estimate_gravity_orientation(t_scan)
    rot_i, tr_i, pt = fc.unwarp_points(state, bp_t, bp_ori, bp_om, ptimes)

    origins_w = fc.qrot(rot_i, sensor_origin[None, :]) + tr_i  # [N, 3]
    hits_w = fc.qrot(rot_i, points[:, :3]) + tr_i
    delta = hits_w - origins_w
    ranges = torch.linalg.norm(delta, dim=1)
    keep = pmask & (ranges >= cfg.min_range)
    as_return = keep & (ranges <= cfg.max_range)
    if cfg.has_misses:
        as_miss = keep & (ranges > cfg.max_range)
        # Misses are the rays cropped AT max_range
        # (local_trajectory_builder_3d.cc:239-247); a true division, as in
        # JAX (the numerator is the constant).
        crop = torch.full_like(ranges, cfg.max_range) / torch.clamp(ranges, min=1e-12)
        miss_w = origins_w + crop[:, None] * delta

    # -- voxel filter in the LOCAL frame --------------------------------------
    ret_mask = fc.voxel_first_mask(hits_w, as_return, cfg.voxel_filter_size)
    if cfg.has_misses:
        miss_mask = fc.voxel_first_mask(miss_w, as_miss, cfg.voxel_filter_size)

    # -- pose prediction (extrapolate_pose(t_scan)) ----------------------------
    dt_s = t_scan - state.newest_t
    pred_q = fc.qnorm(
        fc.qmul(state.newest_q, fc.qmul(fc.qconj(state.tracker_ori), trk_ori))
    )
    pred_t = state.newest_xyz + state.vel * dt_s

    # -- tracking frame + adaptive filters -------------------------------------
    hits_track = fc.qrot(fc.qconj(pred_q)[None, :], hits_w - pred_t[None, :])
    rr = torch.linalg.norm(hits_track, dim=1)
    high_mask = fc.adaptive_voxel_mask(
        hits_track,
        ret_mask & (rr <= cfg.hi_avf_max_range),
        cfg.hi_avf_max_length,
        cfg.hi_avf_min_num_points,
    )
    low_mask = fc.adaptive_voxel_mask(
        hits_track,
        ret_mask & (rr <= cfg.lo_avf_max_range),
        cfg.lo_avf_max_length,
        cfg.lo_avf_min_num_points,
    )
    matched = active & torch.any(ret_mask) & torch.any(high_mask) & torch.any(low_mask)

    # -- dual-grid LM match against the older active submap --------------------
    # initial_pose_in_submap = submap.local_pose^-1 * prediction.
    aq0, at0 = state.anchor_q[0], state.anchor_t[0]
    init_q = fc.qnorm(fc.qmul(fc.qconj(aq0), pred_q))
    init_t = fc.qrot(fc.qconj(aq0), pred_t - at0)
    high_origin = torch.full((3,), -half_high, dtype=torch.float32, device=dev)
    low_origin = torch.full((3,), -half_low, dtype=torch.float32, device=dev)
    # Compact each matching cloud to its adaptive-filtered points, in scan
    # order (cumsum + scatter; the overflow row m_cap is cut off).
    m_cap = min(cfg.match_max_points, hits_track.shape[0])
    iota_cap = torch.arange(m_cap, device=dev)

    def compact(mask):
        pos = torch.cumsum(mask.to(torch.int32), dim=0) - 1
        dst = torch.where(mask & (pos < m_cap), pos, m_cap)
        pts = torch.zeros(
            (m_cap + 1, 3), dtype=hits_track.dtype, device=dev
        ).index_copy(0, dst.long(), hits_track)[:m_cap]
        cnt = torch.clamp(torch.sum(mask.to(torch.int32)), max=m_cap)
        return pts, iota_cap < cnt

    hi_pts, hi_m = compact(high_mask)
    lo_pts, lo_m = compact(low_mask)
    if cfg.paged:
        high_vol0 = _paged_slot(cfg, state, "high", 0)
        low_vol0 = _paged_slot(cfg, state, "low", 0)
    else:
        high_vol0 = state.high_values[0]
        low_vol0 = state.low_values[0]
    packed = gauss_newton_3d._match_3d_impl(
        high_vol0,
        high_origin,
        low_vol0,
        low_origin,
        init_t,
        init_q,
        init_t,
        hi_pts,
        hi_m,
        lo_pts,
        lo_m,
        cfg.high_resolution,
        cfg.low_resolution,
        cfg.occupied_space_weight_0,
        cfg.occupied_space_weight_1,
        cfg.translation_weight,
        cfg.rotation_weight,
        cfg.gn_iterations,
        cfg.only_optimize_yaw,
    )
    gn_t, gn_q = packed[:3], packed[3:7]
    use_gn = state.slot_valid[0] & matched
    sub_t = torch.where(use_gn, gn_t, init_t)
    sub_q = torch.where(use_gn, gn_q, init_q)
    # pose_estimate = submap.local_pose * pose_in_submap; with no submap
    # yet the estimate is the prediction itself.
    est_q = fc.qnorm(fc.qmul(aq0, sub_q))
    est_xyz = at0 + fc.qrot(aq0, sub_t)
    est_q = torch.where(state.slot_valid[0], est_q, pred_q)
    est_xyz = torch.where(state.slot_valid[0], est_xyz, pred_t)

    # -- extrapolator add_pose --------------------------------------------------
    queue_delta = t_scan - state.newest_t
    do_update = (state.queue_len >= 1) & (queue_delta >= cfg.pose_queue_duration)
    safe_delta = torch.clamp(queue_delta, min=1e-12)
    vel_new = torch.where(do_update, (est_xyz - state.newest_xyz) / safe_delta, state.vel)
    ang_new = torch.where(
        do_update,
        fc.qlog(fc.qmul(fc.qconj(state.newest_q), est_q)) / safe_delta,
        state.ang_vel,
    )

    def upd(old, new):
        return torch.where(matched, new, old)

    state = state.replace(
        older_t=upd(state.older_t, state.newest_t),
        older_xyz=upd(state.older_xyz, state.newest_xyz),
        older_q=upd(state.older_q, state.newest_q),
        newest_t=upd(state.newest_t, t_scan),
        newest_xyz=upd(state.newest_xyz, est_xyz),
        newest_q=upd(state.newest_q, est_q),
        queue_len=upd(state.queue_len, torch.clamp(state.queue_len + 1, max=2)),
        vel=upd(state.vel, vel_new),
        ang_vel=upd(state.ang_vel, ang_new),
        tracker_ori=upd(state.tracker_ori, trk_ori),
        tracker_grav=upd(state.tracker_grav, trk_grav),
        tracker_omega=upd(state.tracker_omega, trk_om),
        tracker_last_acc_t=upd(state.tracker_last_acc_t, trk_la),
        last_extrap_t=torch.where(
            active, torch.maximum(pt[-1], t_scan), state.last_extrap_t
        ),
    )

    # -- motion filter -----------------------------------------------------------
    similar = (
        state.mf_valid
        & ((t_scan - state.mf_t) <= cfg.mf_max_time)
        & (torch.linalg.norm(est_xyz - state.mf_xyz) <= cfg.mf_max_distance)
        & (fc.quat_angle(fc.qmul(fc.qconj(state.mf_q), est_q)) <= cfg.mf_max_angle)
    )
    insert = matched & ~similar
    state = state.replace(
        mf_valid=state.mf_valid | insert,
        mf_t=torch.where(insert, t_scan, state.mf_t),
        mf_xyz=torch.where(insert, est_xyz, state.mf_xyz),
        mf_q=torch.where(insert, est_q, state.mf_q),
    )

    # -- submap rotation (ActiveSubmaps3D::InsertData) -----------------------------
    lfga = fc.qnorm(fc.qmul(est_q, fc.qconj(g_quat)))  # local_from_gravity_aligned
    sv0, sv1 = state.slot_valid[0], state.slot_valid[1]
    newest_count = torch.where(sv1, state.counts[1], state.counts[0])
    need_first = insert & ~sv0
    need_new = insert & sv0 & (newest_count == cfg.num_range_data)
    pop = need_new & sv1
    created = need_first | need_new

    # The popped (finished) submap's grids go to the chunk's ring.
    cnt = fin["count"]
    if cfg.paged:
        fin = {
            "count": cnt + pop.to(torch.int32),
            **{
                f"pg_{k}": _ring_put(fin[f"pg_{k}"], cnt, pop, getattr(state, f"pg_{k}")[:2])
                for k in ("table", "pool", "nblocks", "dropped")
            },
        }

        def rotate_paged(cur, fresh):
            # Slot rotation in lane space: [s1 lanes, fresh lanes].
            return torch.where(pop, torch.cat([cur[2:4], fresh]), cur)

        pg_table = rotate_paged(state.pg_table, torch.full_like(state.pg_table[:2], -1))
        pg_pool = rotate_paged(state.pg_pool, torch.zeros_like(state.pg_pool[:2]))
        pg_nblocks = rotate_paged(state.pg_nblocks, torch.zeros_like(state.pg_nblocks[:2]))
        pg_dropped = rotate_paged(state.pg_dropped, torch.zeros_like(state.pg_dropped[:2]))
    else:
        fin = {
            "count": cnt + pop.to(torch.int32),
            "high": _ring_put(fin["high"], cnt, pop, state.high_values[0]),
            "low": _ring_put(fin["low"], cnt, pop, state.low_values[0]),
        }
        # need_first implies slot 0 is still the zero volume from init, so
        # the rotation is one select per volume.
        high_values = torch.where(
            pop,
            torch.stack([state.high_values[1], torch.zeros_like(state.high_values[0])]),
            state.high_values,
        )
        low_values = torch.where(
            pop,
            torch.stack([state.low_values[1], torch.zeros_like(state.low_values[0])]),
            state.low_values,
        )
    zero_i32 = torch.zeros((), dtype=torch.int32, device=dev)
    anchor_t = torch.where(pop, torch.stack([state.anchor_t[1], est_xyz]), state.anchor_t)
    anchor_q = torch.where(pop, torch.stack([state.anchor_q[1], lfga]), state.anchor_q)
    counts = torch.where(pop, torch.stack([state.counts[1], zero_i32]), state.counts)
    anchor_t = torch.where(need_first, torch.stack([est_xyz, anchor_t[1]]), anchor_t)
    anchor_q = torch.where(need_first, torch.stack([lfga, anchor_q[1]]), anchor_q)
    counts = torch.where(need_first, torch.stack([zero_i32, counts[1]]), counts)

    add_second = need_new & ~sv1
    anchor_t = torch.where(add_second, torch.stack([anchor_t[0], est_xyz]), anchor_t)
    anchor_q = torch.where(add_second, torch.stack([anchor_q[0], lfga]), anchor_q)
    counts = torch.where(add_second, torch.stack([counts[0], zero_i32]), counts)
    slot_valid = torch.stack([sv0 | need_first, sv1 | need_new])

    # -- bounded-free-space insertion into all valid slots ------------------------
    # Hits in the local frame from the tracking cloud at the MATCHED pose;
    # the sensor origin is trans(pose_estimate)
    # (local_trajectory_builder_3d.cc:300-312).
    hits_local = fc.qrot(est_q[None, :], hits_track) + est_xyz[None, :]
    ins_range = torch.linalg.norm(hits_local - est_xyz[None, :], dim=1)
    near = ins_range <= cfg.high_resolution_max_range

    def slot_cells(a_t, a_q, res, half):
        # Hits and the sensor origin (one more row) into each slot's submap
        # frame; cell = round((p - origin) / res) with origin = -half (the
        # matcher's lattice). Returns hit cells [S, N, 3], origin cells [S, 3].
        pts = torch.cat([hits_local, est_xyz[None]])
        sub = fc.qrot(fc.qconj(a_q)[:, None, :], pts[None] - a_t[:, None, :])
        cells = torch.floor(scaled(sub + half, res) + 0.5).to(torch.int32)
        return cells[:, :-1], cells[:, -1]

    slot_insert = slot_valid & insert
    if cfg.paged:
        pre = pg_dropped
        lane_res, lane_half = _lane_geometry(cfg, dev)
        cells, origin_cell = slot_cells(
            anchor_t.repeat_interleave(2, dim=0),
            anchor_q.repeat_interleave(2, dim=0),
            lane_res,
            lane_half,
        )
        lane_valid = torch.stack(
            [ret_mask & near, ret_mask, ret_mask & near, ret_mask]
        ) & slot_insert.repeat_interleave(2)[:, None]
        pg_table, pg_pool, pg_nblocks, pg_dropped = insert_cells_paged(
            pg_table, pg_pool, pg_nblocks, pg_dropped,
            origin_cell, cells, lane_valid,
            cfg.hit_delta, cfg.miss_delta, cfg.num_free_space_voxels,
            block_bits=cfg.block_bits, table_size=cfg.high_table_size,
        )
        # Per-scan dropped-write deltas (outside the virtual extent or pool
        # exhausted), summed over both slots, per resolution.
        d = pg_dropped - pre
        oob_high = d[0] + d[2]
        oob_low = d[1] + d[3]
    else:
        oobs = []
        new_volumes = []
        for values, res, half, size, valid in (
            (high_values, cfg.high_resolution, half_high, cfg.high_grid_size, ret_mask & near),
            (low_values, cfg.low_resolution, half_low, cfg.low_grid_size, ret_mask),
        ):
            cells, origin_cell = slot_cells(anchor_t, anchor_q, res, half)
            lane_valid = valid[None, :] & slot_insert[:, None]
            new_volumes.append(raycast_3d.insert_scan_3d_lanes(
                values, origin_cell, cells, lane_valid,
                cfg.hit_delta, cfg.miss_delta, cfg.num_free_space_voxels,
            ))
            # Hit endpoints off the dense extent are dropped by the
            # inserter; count them so that a too-small grid shows.
            oob = lane_valid & torch.any((cells < 0) | (cells >= size), dim=-1)
            oobs.append(torch.sum(oob, dtype=torch.int32))
        high_values, low_values = new_volumes
        oob_high, oob_low = oobs
    counts = counts + slot_insert.to(torch.int32)
    finished = slot_valid[0] & insert & (counts[0] == 2 * cfg.num_range_data)

    grids = (
        dict(pg_table=pg_table, pg_pool=pg_pool, pg_nblocks=pg_nblocks,
             pg_dropped=pg_dropped)
        if cfg.paged else dict(high_values=high_values, low_values=low_values)
    )
    state = state.replace(
        **grids,
        anchor_t=anchor_t,
        anchor_q=anchor_q,
        counts=counts,
        slot_valid=slot_valid,
    )

    out = {
        "matched": matched,
        "est_t": est_xyz,
        "est_q": est_q,
        "g_quat": g_quat,
        "inserted": insert,
        "created": created,
        "popped": pop,
        "finished": finished,
        "counts": counts,
        "oob_high": oob_high,
        "oob_low": oob_low,
        "hits_track": hits_track,
        "ret_mask": ret_mask,
        "high_mask": high_mask,
        "low_mask": low_mask,
    }
    if cfg.has_misses:
        out["miss_track"] = fc.qrot(fc.qconj(pred_q)[None, :], miss_w - pred_t[None, :])
        out["miss_mask"] = miss_mask
    return state, fin, out


# Per-scan scalar output layout in the packed [C, 20] array. oob_high /
# oob_low count dropped grid writes that scan (dense: hit endpoints
# outside the fixed extent; paged: outside the virtual extent or block
# pool exhausted).
SCALARS = (
    "matched", "est_x", "est_y", "est_z",
    "est_qw", "est_qx", "est_qy", "est_qz",
    "g_qw", "g_qx", "g_qy", "g_qz",
    "inserted", "created", "popped", "finished", "count0", "count1",
    "oob_high", "oob_low",
)
SIDX = {k: i for i, k in enumerate(SCALARS)}


def input_layout(cfg: FrontendConfig3D):
    """Byte offsets of the sections inside the packed input buffer:
    (points i16 [C,N,3], times u8 [C,N] — absent under linear_times,
    meta f32 [C,7], imu f32 [C,M,8], total_bytes). Per-point times are
    uint8 fractions of the scan's [t0, t0+span]."""
    c, n, m = cfg.chunk_size, cfg.num_points, cfg.max_imu_per_scan
    o_points = 0
    o_times = o_points + c * n * 6
    o_meta = o_times + (0 if cfg.linear_times else c * n)
    o_imu = o_meta + c * 28
    total = o_imu + c * m * 32
    return o_points, o_times, o_meta, o_imu, total


def output_layout(cfg: FrontendConfig3D):
    """Byte offsets in the packed output buffer: scalars f32
    [C, len(SCALARS)], hits i16 [C,N,3] (tracking frame, quantized),
    code u8 [C,N] (bitmask: 1 voxel-filtered return, +2 high-res adaptive,
    +4 low-res adaptive, +8 miss), then — only when cfg.has_misses —
    misses i16 [C,N,3]; finally total_bytes."""
    c, n = cfg.chunk_size, cfg.num_points
    o_scalars = 0
    o_hits = o_scalars + c * len(SCALARS) * 4
    o_code = o_hits + c * n * 6
    o_miss = o_code + c * n
    total = o_miss + (c * n * 6 if cfg.has_misses else 0)
    return o_scalars, o_hits, o_code, o_miss, total


def point_quantization_scale(cfg: FrontendConfig3D) -> float:
    """Meters per int16 step for the packed transfers (3D misses are
    cropped AT max_range, so 1.5x max_range bounds both the upload deltas —
    the host clamps to 1.25x — and the tracking-frame outputs)."""
    return 1.5 * cfg.max_range / 32767.0


def run_chunk(
    cfg: FrontendConfig3D,
    state: FrontendState3D,
    epoch_shift,  # f32; subtracted from all state times
    packed_input,  # uint8 [input_layout(cfg).total] tensor or numpy array
):
    """Process a chunk of C scans on the state's device: one flat uint8
    input and one flat uint8 output (input_layout / output_layout; meta f32
    [C,7] = (t_scan, origin xyz, count, t0, span), IMU f32 [C,M,8] = (time,
    acc xyz, gyro xyz, valid)).

    Returns (state, fin, packed_out), as the JAX function; fin is the ring
    of submaps finished in this chunk ({count, high, low} dense, {count,
    pg_table, pg_pool, pg_nblocks, pg_dropped} paged, [r, 2 (high, low),
    ...]). The input state is not modified."""
    if cfg.disable:
        raise NotImplementedError("run_chunk: debug stage stubs are not ported")
    dev = state.anchor_t.device
    shift = torch.as_tensor(np.float32(epoch_shift), device=dev)
    state = state.replace(
        older_t=state.older_t - shift,
        newest_t=state.newest_t - shift,
        last_extrap_t=state.last_extrap_t - shift,
        mf_t=state.mf_t - shift,
    )
    c, n, mi = cfg.chunk_size, cfg.num_points, cfg.max_imu_per_scan
    o_points, o_times, o_meta, o_imu, total = input_layout(cfg)
    packed = torch.as_tensor(packed_input, device=dev)
    if packed.dtype != torch.uint8 or packed.shape != (total,):
        raise ValueError(
            f"packed_input: expected uint8 [{total}], got "
            f"{packed.dtype} {tuple(packed.shape)}"
        )
    packed = packed.contiguous()
    scan_points = packed[o_points:o_times].view(torch.int16).reshape(c, n, 3)
    scan_meta = packed[o_meta:o_imu].view(torch.float32).reshape(c, 7)
    imu_input = packed[o_imu:].view(torch.float32).reshape(c, mi, 8)
    q_scale = point_quantization_scale(cfg)

    r = c // cfg.num_range_data + 1
    count0 = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.paged:
        b3 = 1 << (3 * cfg.block_bits)
        t3, p = cfg.high_table_size**3, cfg.high_pool_blocks
        fin = {
            "count": count0,
            "pg_table": torch.full((r, 2, t3), -1, dtype=torch.int32, device=dev),
            "pg_pool": torch.zeros((r, 2, p, b3), dtype=torch.int8, device=dev),
            "pg_nblocks": torch.zeros((r, 2), dtype=torch.int32, device=dev),
            "pg_dropped": torch.zeros((r, 2), dtype=torch.int32, device=dev),
        }
    else:
        gh, gl = cfg.high_grid_size, cfg.low_grid_size
        fin = {
            "count": count0,
            "high": torch.zeros((r, gh, gh, gh), dtype=torch.int8, device=dev),
            "low": torch.zeros((r, gl, gl, gl), dtype=torch.int8, device=dev),
        }
    t_scan = scan_meta[:, 0]
    sensor_origin = scan_meta[:, 1:4]
    counts_in = scan_meta[:, 4].to(torch.int32)
    t0s = scan_meta[:, 5]
    spans = scan_meta[:, 6]
    # q_scale is a constant in the JAX program: the product rounds alike.
    points = sensor_origin[:, None, :] + scan_points.to(torch.float32) * q_scale
    iota_n = torch.arange(n, dtype=torch.int32, device=dev).expand(c, n)
    if cfg.linear_times:
        # Regenerate the exact uint8 ramp the host verified against:
        # u_i = round(i * 255 / (k - 1)), clamped at the last real point.
        denom = torch.clamp(counts_in - 1, min=1).to(torch.float32)
        u8_frac = torch.round(
            torch.minimum(iota_n, counts_in[:, None] - 1).to(torch.float32)
            * 255.0
            / denom[:, None]
        )
    else:
        u8_frac = packed[o_times:o_meta].reshape(c, n).to(torch.float32)
    ptimes = t0s[:, None] + u8_frac * (spans[:, None] / 255.0)
    pmask = iota_n < counts_in[:, None]
    imu = (
        imu_input[:, :, 0],
        imu_input[:, :, 1:4],
        imu_input[:, :, 4:7],
        imu_input[:, :, 7] > 0.5,
    )

    per_scan = []
    for i in range(c):
        x = (
            points[i], pmask[i], ptimes[i], t_scan[i], sensor_origin[i],
            tuple(a[i] for a in imu),
        )
        state, fin, out = _scan_body(cfg, state, fin, x)
        per_scan.append(out)
    outs = {k: torch.stack([o[k] for o in per_scan]) for k in per_scan[0]}

    code = (
        outs["ret_mask"].to(torch.uint8)
        + 2 * outs["high_mask"].to(torch.uint8)
        + 4 * outs["low_mask"].to(torch.uint8)
    )
    if cfg.has_misses:
        code = code + 8 * outs["miss_mask"].to(torch.uint8)

    def q16(a):
        return torch.clamp(torch.round(a * (1.0 / q_scale)), -32767, 32767).to(torch.int16)

    def f(k):
        return outs[k].to(torch.float32)

    out_scalars = torch.stack(
        [
            f("matched"),
            outs["est_t"][:, 0], outs["est_t"][:, 1], outs["est_t"][:, 2],
            outs["est_q"][:, 0], outs["est_q"][:, 1],
            outs["est_q"][:, 2], outs["est_q"][:, 3],
            outs["g_quat"][:, 0], outs["g_quat"][:, 1],
            outs["g_quat"][:, 2], outs["g_quat"][:, 3],
            f("inserted"), f("created"), f("popped"), f("finished"),
            outs["counts"][:, 0].to(torch.float32),
            outs["counts"][:, 1].to(torch.float32),
            f("oob_high"), f("oob_low"),
        ],
        dim=1,
    )

    def as_bytes(a):
        return a.contiguous().view(torch.uint8).reshape(-1)

    parts = [as_bytes(out_scalars), as_bytes(q16(outs["hits_track"])), code.reshape(-1)]
    if cfg.has_misses:
        parts.append(as_bytes(q16(outs["miss_track"])))
    return state, fin, torch.cat(parts)
