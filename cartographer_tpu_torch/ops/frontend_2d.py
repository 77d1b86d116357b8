"""Device-resident 2D local-SLAM frontend (chunked).

Port of cartographer_tpu/ops/frontend_2d.py. The whole per-scan pipeline
of LocalTrajectoryBuilder2D (reference:
mapping/internal/2d/local_trajectory_builder_2d.cc:38-368) runs on the
device for a chunk of scans: pose extrapolation (pose_extrapolator.cc,
imu_tracker.cc) -> per-point motion unwarp -> min/max range split ->
gravity alignment + z-crop + voxel filter -> adaptive voxel filter ->
online correlative pre-match (real_time_correlative_scan_matcher_2d.cc)
-> Levenberg-Marquardt scan match (ceres_scan_matcher_2d.cc) ->
extrapolator pose update -> motion filter -> ray-cast insertion into the
two active submaps with submap rotation (mapping/2d/submap_2d.cc:137-219).

The JAX `lax.scan` over the chunk is a Python loop here. Inside it no
value leaves the device: every data-dependent branch is a `torch.where`,
so the loop never waits on the card. The packed uint8 input and output
layouts are the JAX package's, so one buffer feeds both implementations.

Scope of this port: IMU and odometry fusion on or off, the direct-gather
LM matcher (`use_band_matcher=False`; the JAX package's band matcher is a
TPU formulation of the same residuals), and the full state, so a JAX
`FrontendState2D` carries across with `state_from_numpy`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cartographer_tpu_torch.device import resolve_device
from cartographer_tpu_torch.ops import frontend_common as fc
from cartographer_tpu_torch.ops import raycast_2d
from cartographer_tpu_torch.ops.frontend_common import (
    MIN_PROBABILITY,
    adaptive_voxel_mask,
    voxel_first_mask,
)
from cartographer_tpu_torch.ops.scan_matching import (
    correlative_2d,
    gauss_newton_2d,
)


# -- frontend state -----------------------------------------------------------


@dataclasses.dataclass
class FrontendState2D:
    """Device state carried across scans and chunks. All times are float32
    offsets from a host-managed epoch (rebased every chunk for precision).
    Field for field the JAX FrontendState2D (see state_from_numpy)."""

    # Pose queue (timed_pose_queue, length 2).
    older_t: torch.Tensor
    older_xyz: torch.Tensor  # [3]
    older_q: torch.Tensor  # [4] wxyz
    newest_t: torch.Tensor
    newest_xyz: torch.Tensor  # [3]
    newest_q: torch.Tensor  # [4]
    queue_len: torch.Tensor  # i32 (1 or 2)
    # Velocities from poses (pose_extrapolator.cc:261-280).
    vel: torch.Tensor  # [3] linear
    ang_vel: torch.Tensor  # [3] angular (from poses)
    # ImuTracker (advanced to newest_t at every add_pose).
    tracker_ori: torch.Tensor  # [4]
    tracker_grav: torch.Tensor  # [3]
    tracker_omega: torch.Tensor  # [3]
    tracker_last_acc_t: torch.Tensor  # f32; -1e30 = never observed
    # Extrapolation frontier (get_last_extrapolated_time()).
    last_extrap_t: torch.Tensor
    # Odometry queue (ODO_RING slots) and the odometry tracker copy.
    odo_t: torch.Tensor  # f32 [K]
    odo_xyz: torch.Tensor  # f32 [K, 3]
    odo_q: torch.Tensor  # f32 [K, 4]
    odo_len: torch.Tensor  # i32
    lin_vel_odo: torch.Tensor  # [3]
    ang_vel_odo: torch.Tensor  # [3]
    odo_trk_ori: torch.Tensor  # [4]
    odo_trk_grav: torch.Tensor  # [3]
    odo_trk_omega: torch.Tensor  # [3]
    odo_trk_t: torch.Tensor
    odo_trk_last_acc_t: torch.Tensor
    # Motion filter memory.
    mf_valid: torch.Tensor  # bool
    mf_t: torch.Tensor
    mf_xyz: torch.Tensor  # [3]
    mf_q: torch.Tensor  # [4]
    # Active submaps: slot 0 = older, slot 1 = newer.
    grids_lo: torch.Tensor  # f32 [2, H, W]
    grids_known: torch.Tensor  # bool [2, H, W]
    grid_origin: torch.Tensor  # f32 [2, 2]
    anchor: torch.Tensor  # f32 [2, 2] submap local_pose translation
    counts: torch.Tensor  # i32 [2]
    slot_valid: torch.Tensor  # bool [2]

    def replace(self, **changes) -> "FrontendState2D":
        return dataclasses.replace(self, **changes)


# Fixed odometry-ring capacity (the JAX package's ODO_RING).
ODO_RING = 8


def init_state(
    grid_size: int,
    t0: float = 0.0,
    initial_q=None,
    tracker_grav=None,
    tracker_omega=None,
    tracker_last_acc_t: float = -1e30,
    device=None,
) -> FrontendState2D:
    """State after PoseExtrapolator initialization with a pose at t0:
    identity (create_without_imu) or a given orientation. `device=None`
    means CUDA."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    q0 = f32([1.0, 0.0, 0.0, 0.0] if initial_q is None else initial_q)
    grav0 = f32([0.0, 0.0, 1.0] if tracker_grav is None else tracker_grav)
    omega0 = f32(np.zeros(3) if tracker_omega is None else tracker_omega)
    z3 = torch.zeros(3, dtype=torch.float32, device=dev)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    return FrontendState2D(
        older_t=f32(t0),
        older_xyz=z3,
        older_q=q0,
        newest_t=f32(t0),
        newest_xyz=z3,
        newest_q=q0,
        queue_len=i32(1),
        vel=z3,
        ang_vel=z3,
        tracker_ori=q0,
        tracker_grav=grav0,
        tracker_omega=omega0,
        tracker_last_acc_t=f32(tracker_last_acc_t),
        last_extrap_t=f32(t0),
        odo_t=torch.full((ODO_RING,), -1e30, dtype=torch.float32, device=dev),
        odo_xyz=torch.zeros((ODO_RING, 3), dtype=torch.float32, device=dev),
        odo_q=f32([1.0, 0.0, 0.0, 0.0]).repeat(ODO_RING, 1),
        odo_len=i32(0),
        lin_vel_odo=z3,
        ang_vel_odo=z3,
        odo_trk_ori=q0,
        odo_trk_grav=grav0,
        odo_trk_omega=omega0,
        odo_trk_t=f32(t0),
        odo_trk_last_acc_t=f32(tracker_last_acc_t),
        mf_valid=torch.tensor(False, device=dev),
        mf_t=f32(0.0),
        mf_xyz=z3,
        mf_q=f32([1.0, 0.0, 0.0, 0.0]),
        grids_lo=torch.zeros(
            (2, grid_size, grid_size), dtype=torch.float32, device=dev
        ),
        grids_known=torch.zeros(
            (2, grid_size, grid_size), dtype=torch.bool, device=dev
        ),
        grid_origin=torch.zeros((2, 2), dtype=torch.float32, device=dev),
        anchor=torch.zeros((2, 2), dtype=torch.float32, device=dev),
        counts=torch.zeros(2, dtype=torch.int32, device=dev),
        slot_valid=torch.zeros(2, dtype=torch.bool, device=dev),
    )


def state_from_numpy(d, device=None) -> FrontendState2D:
    """A state from numpy arrays keyed by field name — e.g. a JAX
    FrontendState2D as `{f.name: np.asarray(getattr(s, f.name))}` — so
    that both implementations can start a chunk from the same state."""
    dev = resolve_device(device)
    names = [f.name for f in dataclasses.fields(FrontendState2D)]
    missing = set(names) - set(d)
    if missing:
        raise KeyError(f"state fields missing: {sorted(missing)}")
    return FrontendState2D(
        **{k: torch.as_tensor(np.array(d[k]), device=dev) for k in names}
    )


def state_to_numpy(state: FrontendState2D) -> dict:
    """Numpy arrays keyed by field name (the inverse of state_from_numpy)."""
    return {
        f.name: getattr(state, f.name).cpu().numpy()
        for f in dataclasses.fields(state)
    }


@dataclasses.dataclass(frozen=True)
class FrontendConfig2D:
    """Static configuration, from TrajectoryBuilder2DOptions. The field
    names are the JAX FrontendConfig2D's, so configs convert field for
    field; see run_chunk for the values this port accepts."""

    grid_size: int
    resolution: float
    num_range_data: int
    hit_log_odds: float
    miss_log_odds: float
    insert_free_space: bool
    min_range: float
    max_range: float
    missing_data_ray_length: float
    min_z: float
    max_z: float
    voxel_filter_size: float
    avf_max_length: float
    avf_min_num_points: int
    avf_max_range: float
    occupied_space_weight: float
    translation_weight: float
    rotation_weight: float
    gn_iterations: int
    mf_max_time: float
    mf_max_distance: float
    mf_max_angle: float
    pose_queue_duration: float
    num_steps: int  # supercover crossings bound (unused by the dense inserter)
    # Static bound on the matching cloud handed to the LM matcher (excess
    # adaptive-filtered points are dropped from matching only).
    match_max_points: int = 512
    # IMU fusion (the ImuTracker fold over the scan's samples).
    use_imu: bool = False
    imu_gravity_time_constant: float = 10.0
    max_imu_per_scan: int = 16
    # Odometry fusion (the odometry queue fold before each scan).
    use_odometry: bool = False
    max_odom_per_scan: int = 4
    # Online correlative pre-match before the LM refinement; rtcsm_a_cap
    # is the STATIC bound on the data-dependent angle count.
    use_online_correlative: bool = False
    rtcsm_linear_search_window: float = 0.1
    rtcsm_angular_search_window: float = 0.35
    rtcsm_translation_weight: float = 1e-1
    rtcsm_rotation_weight: float = 1e-1
    rtcsm_num_linear: int = 2
    rtcsm_a_cap: int = 64
    # Kept for field-for-field conversion. The window sums run in the CUDA
    # kernel whenever the tensors lie on a CUDA device, whatever this says.
    use_pallas_rtcsm: bool = False
    # Whether any scan in the chunk has points beyond max_range; when False
    # all missing-echo processing and outputs are left out.
    has_misses: bool = True
    # Packed-transfer geometry: scans per chunk and padded points per scan.
    chunk_size: int = 0
    num_points: int = 0
    # Rows of the compacted filtered cloud in packed_out (inserted scans
    # only, in scan order; 0 = all chunk_size rows).
    max_packed_inserts: int = 0
    # Upload compression: xy-only int16 points plus a per-scan z constant,
    # and per-point times regenerated as the uniform uint8 ramp.
    planar_z: bool = False
    linear_times: bool = False
    # The JAX package's TPU band matcher; this port only has the direct
    # gather matcher (`False`).
    use_band_matcher: bool = False
    # The JAX package's debug stage stubs; this port accepts only "".
    disable: str = ""


# Per-scan scalar output layout in the packed [C, 20] array.
SCALARS = (
    "matched", "pose_x", "pose_y", "pose_yaw",
    "g_qw", "g_qx", "g_qy", "g_qz", "inserted",
    "created", "popped", "finished", "anchor_x", "anchor_y",
    "count0", "count1", "ga_origin_x", "ga_origin_y", "num_filtered",
    "oob_hits",
)
SIDX = {k: i for i, k in enumerate(SCALARS)}


def input_layout(cfg: FrontendConfig2D):
    """Byte offsets of the sections inside the packed input buffer:
    (points i16 [C,N,3] — or [C,N,2] under planar_z, times u8 [C,N] —
    absent under linear_times, meta f32 [C,8], imu f32 [C,M,8], odometry
    f32 [C,Mo,9] under use_odometry, total_bytes). Section starts are
    4-byte aligned when C*N is a multiple of 4."""
    c, n, m = cfg.chunk_size, cfg.num_points, cfg.max_imu_per_scan
    o_points = 0
    o_times = o_points + c * n * (4 if cfg.planar_z else 6)
    o_meta = o_times + (0 if cfg.linear_times else c * n)
    o_imu = o_meta + c * 32
    o_odom = o_imu + c * m * 32
    total = o_odom + (
        c * cfg.max_odom_per_scan * 36 if cfg.use_odometry else 0
    )
    return o_points, o_times, o_meta, o_imu, o_odom, total


def point_quantization_scale(cfg: FrontendConfig2D) -> float:
    """Meters per int16 step for the packed point transfers (ranges are
    clamped to 1.25x the relevant maximum on the host)."""
    bound = 1.5 * max(cfg.max_range, cfg.missing_data_ray_length)
    return bound / 32767.0


def _odometry_fold(cfg: FrontendConfig2D, state: FrontendState2D, odom):
    """Consume the scan's odometry samples in order: ring append,
    endpoint velocity updates, and the odometry tracker's rotation
    extrapolation (PoseExtrapolator::AddOdometryData,
    pose_extrapolator.cc:100-135; no-IMU fake-gravity tracker advance,
    :201-210). The JAX `lax.scan` over the Mo slots is a Python loop of
    selects. Returns the updated state."""
    odo_ts, odo_xyzs, odo_qs, odo_valid = odom  # [Mo], [Mo,3], [Mo,4], [Mo]
    k = ODO_RING
    dev = odo_ts.device
    ring = torch.arange(k, dtype=torch.int32, device=dev)
    # On overflow drop the SECOND-oldest (both endpoints — queue front and
    # latest — stay exact): gather slots 0, 2, 3, ..., k-1, k-1.
    shift_full = torch.clamp(
        torch.cat([ring[:1], torch.arange(2, k + 1, dtype=torch.int32, device=dev)]),
        max=k - 1,
    ).long()
    ez = fc._unit_z(state.tracker_grav)
    t, xyz, q, length = state.odo_t, state.odo_xyz, state.odo_q, state.odo_len
    lin_v, ang_v = state.lin_vel_odo, state.ang_vel_odo
    trk_ori, trk_grav = state.odo_trk_ori, state.odo_trk_grav
    trk_om, trk_t, trk_la = (
        state.odo_trk_omega, state.odo_trk_t, state.odo_trk_last_acc_t,
    )
    for i in range(odo_ts.shape[0]):
        t_o, xyz_o, q_o, valid = odo_ts[i], odo_xyzs[i], odo_qs[i], odo_valid[i]
        full = length >= k
        shift = torch.where(full, shift_full, ring.long())
        t2, xyz2, q2 = t[shift], xyz[shift], q[shift]
        at_w = ring == torch.clamp(length, max=k - 1)
        t2 = torch.where(at_w, t_o, t2)
        xyz2 = torch.where(at_w[:, None], xyz_o[None, :], xyz2)
        q2 = torch.where(at_w[:, None], q_o[None, :], q2)
        len2 = torch.clamp(length + 1, max=k)

        # Endpoint velocities (oldest = slot 0, newest = just written).
        have2 = len2 >= 2
        dt = t2[0] - t_o  # negative
        safe_dt = torch.where(torch.abs(dt) < 1e-9, -1e-9, dt)
        q_delta = fc.qnorm(fc.qmul(fc.qconj(q_o), q2[0]))
        ang_new = fc.qlog(q_delta) / safe_dt
        lin_tracking = fc.qrot(fc.qconj(q_o)[None], (xyz2[0] - xyz_o)[None])[0] / safe_dt
        # Advance the odometry tracker to the sample time. With IMU the
        # tracker copy was synced to the gyro-fed main tracker at the last
        # add_pose; it advances with the latest gyro rate and WITHOUT
        # fake-gravity observations (pose_extrapolator.cc:201-222).
        # Without IMU: fake gravity + odometry/pose angular velocity.
        if cfg.use_imu:
            om_used = trk_om
        else:
            om_used = torch.where(have2, ang_new, state.ang_vel)
        to_t = torch.maximum(t_o, trk_t)
        t1, ori1, grav1 = fc.tracker_advance(trk_t, trk_ori, trk_grav, om_used, to_t)
        if cfg.use_imu:
            ori2, grav2, la1 = ori1, grav1, trk_la
        else:
            ori2, grav2, la1 = fc.tracker_acc_obs(cfg, t1, ori1, grav1, trk_la, ez)
        # Orientation at the newest odometry time = newest_pose.q *
        # (conj(main tracker ori) * odometry tracker ori).
        rot = fc.qmul(fc.qconj(state.tracker_ori), ori2)
        ori_at_odo = fc.qnorm(fc.qmul(state.newest_q, rot))
        lin_new = fc.qrot(ori_at_odo[None], lin_tracking[None])[0]

        def sel(a, b):
            return torch.where(valid, a, b)

        t, xyz, q, length = sel(t2, t), sel(xyz2, xyz), sel(q2, q), sel(len2, length)
        lin_v = torch.where(valid & have2, lin_new, lin_v)
        ang_v = torch.where(valid & have2, ang_new, ang_v)
        trk_ori, trk_grav = sel(ori2, trk_ori), sel(grav2, trk_grav)
        trk_om, trk_t, trk_la = sel(om_used, trk_om), sel(t1, trk_t), sel(la1, trk_la)
    return state.replace(
        odo_t=t, odo_xyz=xyz, odo_q=q, odo_len=length,
        lin_vel_odo=lin_v, ang_vel_odo=ang_v,
        odo_trk_ori=trk_ori, odo_trk_grav=trk_grav,
        odo_trk_omega=trk_om, odo_trk_t=trk_t, odo_trk_last_acc_t=trk_la,
    )


def _scan_body(cfg: FrontendConfig2D, state: FrontendState2D, fin: dict, x):
    points, pmask, ptimes, t_scan, sensor_origin, imu, odom = x
    dev = points.device
    half = 0.5 * cfg.grid_size * cfg.resolution
    if cfg.use_odometry:
        state = _odometry_fold(cfg, state, odom)
    # Velocity source selection (extrapolate_pose /
    # _extrapolate_translation): odometry once two samples are queued.
    have_odo = state.odo_len >= 2
    vel_used = torch.where(have_odo, state.lin_vel_odo, state.vel)
    ang_used = torch.where(have_odo, state.ang_vel_odo, state.ang_vel)
    state_q = state.replace(vel=vel_used, ang_vel=ang_used)

    # -- skip gate: extrapolator still initializing
    # (local_trajectory_builder_2d.cc:131-137).
    active = ptimes[0] >= state.newest_t

    # -- ImuTracker to t_scan.
    (trk_t, trk_ori, trk_grav, trk_om, trk_la), (bp_t, bp_ori, bp_om) = (
        fc.tracker_fold(cfg, state_q, t_scan, imu)
    )
    g_quat = trk_ori  # estimate_gravity_orientation(t_scan)

    # -- per-point unwarp (ExtrapolatePosesBatch) -----------------------------
    rot_i, tr_i, pt = fc.unwarp_points(state_q, bp_t, bp_ori, bp_om, ptimes)

    origins_w = fc.qrot(rot_i, sensor_origin[None, :]) + tr_i  # [N, 3]
    hits_w = fc.qrot(rot_i, points[:, :3]) + tr_i
    delta = hits_w - origins_w
    ranges = torch.linalg.norm(delta, dim=1)
    keep = pmask & (ranges >= cfg.min_range)
    as_return = keep & (ranges <= cfg.max_range)
    if cfg.has_misses:
        as_miss = keep & (ranges > cfg.max_range)
        miss_w = origins_w + (
            cfg.missing_data_ray_length / torch.clamp(ranges, min=1e-12)
        )[:, None] * delta

    # -- gravity alignment at the last point's pose ---------------------------
    last_q = rot_i[-1]
    last_xyz = tr_i[-1]
    last_origin_w = origins_w[-1]
    # to_gravity = rot(g_quat) * inverse(last_pose)
    a_quat = fc.qnorm(fc.qmul(g_quat, fc.qconj(last_q)))

    def to_ga(p):
        return fc.qrot(a_quat[None, :], p - last_xyz[None, :])

    ga_hits = to_ga(hits_w)
    ga_origin_xy = to_ga(last_origin_w[None, :])[0, :2]

    # -- z-crop + voxel filter (range_data.crop + voxel_filter) ---------------
    crop_h = (ga_hits[:, 2] >= cfg.min_z) & (ga_hits[:, 2] <= cfg.max_z)
    ret_mask = voxel_first_mask(ga_hits, as_return & crop_h, cfg.voxel_filter_size)
    if cfg.has_misses:
        ga_miss = to_ga(miss_w)
        crop_m = (ga_miss[:, 2] >= cfg.min_z) & (ga_miss[:, 2] <= cfg.max_z)
        miss_mask = voxel_first_mask(
            ga_miss, as_miss & crop_m, cfg.voxel_filter_size
        )

    # -- pose prediction (project2d(extrapolate ∘ rot(gravity)^-1)) -----------
    dt_s = t_scan - state.newest_t
    pred_rot = fc.qnorm(
        fc.qmul(state.newest_q, fc.qmul(fc.qconj(state.tracker_ori), trk_ori))
    )
    pred = torch.stack(
        [
            state.newest_xyz[0] + vel_used[0] * dt_s,
            state.newest_xyz[1] + vel_used[1] * dt_s,
            fc.wrap_angle(fc.yaw_of(fc.qmul(pred_rot, fc.qconj(g_quat)))),
        ]
    )

    # -- adaptive voxel filter for the matching cloud --------------------------
    rr = torch.linalg.norm(ga_hits, dim=1)
    avf_valid = ret_mask & (rr <= cfg.avf_max_range)
    adaptive_mask = adaptive_voxel_mask(
        ga_hits, avf_valid, cfg.avf_max_length, cfg.avf_min_num_points
    )
    matched = active & torch.any(ret_mask) & torch.any(adaptive_mask)

    # -- scan match against the older active submap ---------------------------
    slot0_prob = torch.where(
        state.grids_known[0],
        1.0 / (1.0 + torch.exp(-state.grids_lo[0])),
        MIN_PROBABILITY,
    )
    slot0_origin = state.grid_origin[0]
    # Compact the matching cloud to the adaptive-filtered points, in scan
    # order (cumsum + scatter; the overflow row m_cap is cut off).
    m_cap = min(cfg.match_max_points, ga_hits.shape[0])
    pos = torch.cumsum(adaptive_mask.to(torch.int32), dim=0) - 1  # [N]
    dst = torch.where(adaptive_mask & (pos < m_cap), pos, m_cap)
    compacted = torch.zeros(
        (m_cap + 1, 3), dtype=ga_hits.dtype, device=dev
    ).index_copy(0, dst.long(), ga_hits)[:m_cap]
    num_filtered = torch.clamp(
        torch.sum(adaptive_mask.to(torch.int32)), max=m_cap
    ).to(torch.int32)
    match_points = compacted[:, :2]
    match_mask = torch.arange(m_cap, device=dev) < num_filtered
    if cfg.use_online_correlative:
        # RTCSM pre-match seeds the LM refinement; the LM target
        # translation stays the prediction (local_trajectory_builder_2d.cc
        # :255-265).
        rr_m = torch.where(
            match_mask, torch.linalg.norm(match_points, dim=1), 0.0
        )
        msr = torch.clamp(torch.max(rr_m), min=3.0 * cfg.resolution)
        # Python-scalar numerators divide as true divisions (a tensor's
        # __rtruediv__ multiplies by the reciprocal instead).
        res2 = torch.full_like(msr, cfg.resolution**2)
        step = (1.0 - 1e-3) * torch.arccos(1.0 - res2 / (2.0 * msr * msr))
        window = torch.full_like(step, cfg.rtcsm_angular_search_window)
        num_ang = torch.clamp(
            torch.ceil(window / step).to(torch.int32), max=cfg.rtcsm_a_cap
        )
        _, rtcsm_pose = correlative_2d.best_candidate_pose(
            slot0_prob,
            slot0_origin,
            match_points,
            match_mask,
            pred,
            num_ang,
            step,
            cfg.resolution,
            cfg.rtcsm_translation_weight,
            cfg.rtcsm_rotation_weight,
            cfg.rtcsm_num_linear,
            cfg.rtcsm_a_cap,
        )
        lm_init = torch.where(state.slot_valid[0] & matched, rtcsm_pose, pred)
    else:
        lm_init = pred
    gn_pose, _gn_cost = gauss_newton_2d.match(
        1.0 - slot0_prob,
        slot0_origin,
        lm_init,
        pred[:2],
        match_points,
        match_mask,
        cfg.resolution,
        cfg.occupied_space_weight,
        cfg.translation_weight,
        cfg.rotation_weight,
        cfg.gn_iterations,
    )
    pose2d = torch.where(state.slot_valid[0] & matched, gn_pose, pred)
    pose2d = torch.cat([pose2d[:2], fc.wrap_angle(pose2d[2:])])
    # pose_estimate = embed_3d(pose2d) * rotation(gravity_alignment).
    est_q = fc.qnorm(fc.qmul(fc.yaw_quat(pose2d[2]), g_quat))
    est_xyz = torch.cat([pose2d[:2], torch.zeros(1, dtype=torch.float32, device=dev)])

    # -- extrapolator add_pose -------------------------------------------------
    queue_delta = t_scan - state.newest_t
    do_update = (state.queue_len >= 1) & (queue_delta >= cfg.pose_queue_duration)
    safe_delta = torch.clamp(queue_delta, min=1e-12)
    vel_new = torch.where(
        do_update, (est_xyz - state.newest_xyz) / safe_delta, state.vel
    )
    ang_new = torch.where(
        do_update,
        fc.qlog(fc.qmul(fc.qconj(state.newest_q), est_q)) / safe_delta,
        state.ang_vel,
    )

    def upd(old, new):
        return torch.where(matched, new, old)

    # Without IMU, the tracker's next integration uses the UPDATED
    # pose-derived angular velocity (pose_extrapolator.cc AddPose advances
    # after UpdateVelocitiesFromPoses) — or the odometry-derived one once
    # two odometry samples are queued.
    if cfg.use_imu:
        trk_om_stored = trk_om
    elif cfg.use_odometry:
        trk_om_stored = torch.where(have_odo, state.ang_vel_odo, ang_new)
    else:
        trk_om_stored = ang_new
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
        tracker_omega=upd(state.tracker_omega, trk_om_stored),
        tracker_last_acc_t=upd(state.tracker_last_acc_t, trk_la),
        last_extrap_t=torch.where(active, pt[-1], state.last_extrap_t),
    )

    if cfg.use_odometry:
        # add_pose also trims the odometry queue (closed-form pop count
        # for monotone times) and re-copies the tracker
        # (odometry_imu_tracker_ = imu_tracker_).
        ring = torch.arange(ODO_RING, dtype=torch.int32, device=dev)
        le = torch.sum(
            (
                (state.odo_t <= t_scan) & (ring >= 1) & (ring < state.odo_len)
            ).to(torch.int32)
        )
        pops = torch.where(
            matched,
            torch.minimum(le, torch.clamp(state.odo_len - 2, min=0)),
            0,
        ).to(torch.int32)
        sidx = torch.clamp(ring + pops, max=ODO_RING - 1).long()
        state = state.replace(
            odo_t=state.odo_t[sidx],
            odo_xyz=state.odo_xyz[sidx],
            odo_q=state.odo_q[sidx],
            odo_len=state.odo_len - pops,
            odo_trk_ori=upd(state.odo_trk_ori, trk_ori),
            odo_trk_grav=upd(state.odo_trk_grav, trk_grav),
            odo_trk_omega=upd(state.odo_trk_omega, trk_om_stored),
            odo_trk_t=upd(state.odo_trk_t, t_scan),
            odo_trk_last_acc_t=upd(state.odo_trk_last_acc_t, trk_la),
        )

    # -- motion filter (on the SE(3) pose estimate) ----------------------------
    similar = (
        state.mf_valid
        & ((t_scan - state.mf_t) <= cfg.mf_max_time)
        & (torch.linalg.norm(est_xyz - state.mf_xyz) <= cfg.mf_max_distance)
        & (
            fc.quat_angle(fc.qmul(fc.qconj(state.mf_q), est_q))
            <= cfg.mf_max_angle
        )
    )
    insert = matched & ~similar
    state = state.replace(
        mf_valid=state.mf_valid | insert,
        mf_t=torch.where(insert, t_scan, state.mf_t),
        mf_xyz=torch.where(insert, est_xyz, state.mf_xyz),
        mf_q=torch.where(insert, est_q, state.mf_q),
    )

    # -- submap rotation (ActiveSubmaps2D::InsertRangeData) --------------------
    local_hits = fc.rot2(pose2d[2], ga_hits[:, :2]) + pose2d[None, :2]
    local_origin = fc.rot2(pose2d[2], ga_origin_xy[None, :])[0] + pose2d[:2]

    sv0, sv1 = state.slot_valid[0], state.slot_valid[1]
    newest_count = torch.where(sv1, state.counts[1], state.counts[0])
    need_first = insert & ~sv0
    need_new = insert & sv0 & (newest_count == cfg.num_range_data)
    pop = need_new & sv1
    created = need_first | need_new

    # Record the popped (finished) submap in the chunk's ring (one pop per
    # num_range_data inserts; once the ring is full no pop can follow, so
    # the clamped slot is then only rewritten with its own value).
    cnt = fin["count"]
    slot = torch.clamp(cnt, max=fin["lo"].shape[0] - 1).long().reshape(1)

    def ring_put(ring, value):
        old = ring.index_select(0, slot)
        return ring.index_copy(0, slot, torch.where(pop, value[None], old))

    fin = {
        "count": cnt + pop.to(torch.int32),
        "lo": ring_put(fin["lo"], state.grids_lo[0]),
        "known": ring_put(fin["known"], state.grids_known[0]),
        "origin": ring_put(fin["origin"], state.grid_origin[0]),
        "anchor": ring_put(fin["anchor"], state.anchor[0]),
    }

    new_origin = local_origin - half
    zero_lo = torch.zeros_like(state.grids_lo[0])
    zero_known = torch.zeros_like(state.grids_known[0])
    zero_i32 = torch.zeros((), dtype=torch.int32, device=dev)

    # pop: shift slot1 -> slot0, fresh slot1.
    g_lo, g_kn = state.grids_lo, state.grids_known
    g_or, anc, cts = state.grid_origin, state.anchor, state.counts
    g_lo = torch.where(pop, torch.stack([g_lo[1], zero_lo]), g_lo)
    g_kn = torch.where(pop, torch.stack([g_kn[1], zero_known]), g_kn)
    g_or = torch.where(pop, torch.stack([g_or[1], new_origin]), g_or)
    anc = torch.where(pop, torch.stack([anc[1], local_origin]), anc)
    cts = torch.where(pop, torch.stack([cts[1], zero_i32]), cts)
    # first submap in slot0 / second submap in slot1 (no pop).
    g_lo = torch.where(need_first, torch.stack([zero_lo, g_lo[1]]), g_lo)
    g_kn = torch.where(need_first, torch.stack([zero_known, g_kn[1]]), g_kn)
    g_or = torch.where(need_first, torch.stack([new_origin, g_or[1]]), g_or)
    anc = torch.where(need_first, torch.stack([local_origin, anc[1]]), anc)
    cts = torch.where(need_first, torch.stack([zero_i32, cts[1]]), cts)

    add_second = need_new & ~sv1
    g_or = torch.where(add_second, torch.stack([g_or[0], new_origin]), g_or)
    anc = torch.where(add_second, torch.stack([anc[0], local_origin]), anc)
    cts = torch.where(add_second, torch.stack([cts[0], zero_i32]), cts)
    slot_valid = torch.stack([sv0 | need_first, sv1 | need_new])

    # -- ray-cast insertion into all valid slots -------------------------------
    # Each point is EITHER a return or a missing echo, never both, so one
    # [N] endpoint array covers all rays.
    if cfg.has_misses:
        local_miss = fc.rot2(pose2d[2], ga_miss[:, :2]) + pose2d[None, :2]
        ends = torch.where(as_return[:, None], local_hits, local_miss)
        is_hit = ret_mask
        ray_valid = torch.where(as_return, ret_mask, miss_mask) & insert
    else:
        ends = local_hits
        is_hit = ret_mask
        ray_valid = ret_mask & insert

    origin_cell = (local_origin[None, :] - g_or) / cfg.resolution  # [2, 2]
    ends_cell = (ends[None, :, :] - g_or[:, None, :]) / cfg.resolution
    # Extent-overflow observability: HIT endpoints outside a slot's fixed
    # extent are dropped by the rasterizer — count the worst slot.
    ec = torch.floor(ends_cell)
    hit_oob = torch.any((ec < 0) | (ec >= cfg.grid_size), dim=-1)  # [2, N]
    oob_count = torch.max(
        torch.sum(
            hit_oob
            & (is_hit & ray_valid)[None, :]
            & (slot_valid & insert)[:, None],
            dim=1,
        )
    )
    new_lo, new_known = raycast_2d.insert_scan_dense(
        g_lo,
        g_kn,
        origin_cell,
        ends_cell,
        is_hit,
        ray_valid,
        cfg.hit_log_odds,
        cfg.miss_log_odds,
        cfg.insert_free_space,
    )
    slot_insert = slot_valid & insert
    g_lo = torch.where(slot_insert[:, None, None], new_lo, g_lo)
    g_kn = torch.where(slot_insert[:, None, None], new_known, g_kn)
    cts = cts + slot_insert.to(torch.int32)
    finished = slot_valid[0] & insert & (cts[0] == 2 * cfg.num_range_data)

    state = state.replace(
        grids_lo=g_lo,
        grids_known=g_kn,
        grid_origin=g_or,
        anchor=anc,
        counts=cts,
        slot_valid=slot_valid,
    )

    out = {
        "matched": matched,
        "pose2d": pose2d,
        "g_quat": g_quat,
        "inserted": insert,
        "created": created,
        "popped": pop,
        "finished": finished,
        "new_anchor": local_origin,
        "counts": cts,
        "ga_hits": ga_hits,
        "ret_mask": ret_mask,
        "adaptive_mask": adaptive_mask,
        "ga_origin": ga_origin_xy,
        # Compacted matching cloud (adaptive-filtered points first, scan
        # order) — becomes the node's filtered_gravity_aligned_point_cloud.
        "filtered_pts": compacted,
        "num_filtered": num_filtered,
        "oob_hits": oob_count,
    }
    if cfg.has_misses:
        out["ga_miss"] = ga_miss
        out["miss_mask"] = miss_mask
    return state, fin, out


def _check_supported(cfg: FrontendConfig2D) -> None:
    if cfg.use_band_matcher:
        raise NotImplementedError(
            "run_chunk: the TPU band matcher is not ported; "
            "set use_band_matcher=False"
        )
    if cfg.disable:
        raise NotImplementedError("run_chunk: debug stage stubs are not ported")


def run_chunk(
    cfg: FrontendConfig2D,
    state: FrontendState2D,
    epoch_shift,  # f32; subtracted from all state times
    packed_input,  # uint8 [input_layout(cfg).total] tensor or numpy array
):
    """Process a chunk of C scans on the state's device.

    `packed_input` holds every input in one flat uint8 buffer
    (input_layout(cfg) gives the section offsets: points i16 [C,N,3]
    quantized by point_quantization_scale, per-point times u8 fractions
    of the scan's [t0, t0+span], meta f32 [C,8] = (t_scan, origin xyz,
    count, t0, span, planar z), IMU f32 [C,M,8] = (time, acc xyz, gyro
    xyz, valid), and under use_odometry odometry f32 [C,Mo,9] = (time,
    xyz, quat wxyz, valid)).

    Returns (state, fin, out_points, packed_out), as the JAX function:
      fin: the ring of submaps finished in this chunk ({count, lo, known,
        origin, anchor}).
      out_points: f32 [C, N, 7] (ga_hit xyz, ga_miss xyz, mask code) when
        cfg.has_misses, else [C, N, 4]; mask code is 0 none / 1 return /
        2 return+adaptive / 3 miss.
      packed_out: uint8, scalars f32 [C, len(SCALARS)] followed by the
        compacted adaptive-filtered gravity-aligned cloud i16
        [rows, match_max, 3] quantized by point_quantization_scale.
    The input state is not modified."""
    _check_supported(cfg)
    dev = state.grids_lo.device
    shift = torch.as_tensor(np.float32(epoch_shift), device=dev)
    state = state.replace(
        older_t=state.older_t - shift,
        newest_t=state.newest_t - shift,
        last_extrap_t=state.last_extrap_t - shift,
        mf_t=state.mf_t - shift,
        odo_t=state.odo_t - shift,
        odo_trk_t=state.odo_trk_t - shift,
    )
    g = cfg.grid_size
    c, n, mi = cfg.chunk_size, cfg.num_points, cfg.max_imu_per_scan
    o_points, o_times, o_meta, o_imu, o_odom, total = input_layout(cfg)
    packed = torch.as_tensor(packed_input, device=dev)
    if packed.dtype != torch.uint8 or packed.shape != (total,):
        raise ValueError(
            f"packed_input: expected uint8 [{total}], got "
            f"{packed.dtype} {tuple(packed.shape)}"
        )
    packed = packed.contiguous()
    pdim = 2 if cfg.planar_z else 3
    scan_points = packed[o_points:o_times].view(torch.int16).reshape(c, n, pdim)
    scan_meta = packed[o_meta:o_imu].view(torch.float32).reshape(c, 8)
    imu_input = packed[o_imu:o_odom].view(torch.float32).reshape(c, mi, 8)
    q_scale = torch.tensor(point_quantization_scale(cfg), dtype=torch.float32, device=dev)
    # Ring of finished-submap snapshots: one pop per num_range_data inserts.
    r = c // cfg.num_range_data + 1
    fin = {
        "count": torch.zeros((), dtype=torch.int32, device=dev),
        "lo": torch.zeros((r, g, g), dtype=torch.float32, device=dev),
        "known": torch.zeros((r, g, g), dtype=torch.bool, device=dev),
        "origin": torch.zeros((r, 2), dtype=torch.float32, device=dev),
        "anchor": torch.zeros((r, 2), dtype=torch.float32, device=dev),
    }
    t_scan = scan_meta[:, 0]
    sensor_origin = scan_meta[:, 1:4]
    counts_in = scan_meta[:, 4].to(torch.int32)
    t0s = scan_meta[:, 5]
    spans = scan_meta[:, 6]
    delta = scan_points.to(torch.float32) * q_scale
    if cfg.planar_z:
        delta = torch.cat(
            [delta, scan_meta[:, 7, None, None].expand(c, n, 1)], dim=-1
        )
    points = sensor_origin[:, None, :] + delta
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
    if cfg.use_odometry:
        odom_input = packed[o_odom:total].view(torch.float32).reshape(
            c, cfg.max_odom_per_scan, 9
        )
        odom = (
            odom_input[:, :, 0],
            odom_input[:, :, 1:4],
            odom_input[:, :, 4:8],
            odom_input[:, :, 8] > 0.5,
        )

    per_scan = []
    for i in range(c):
        x = (
            points[i], pmask[i], ptimes[i], t_scan[i], sensor_origin[i],
            tuple(a[i] for a in imu),
            tuple(a[i] for a in odom) if cfg.use_odometry else None,
        )
        state, fin, out = _scan_body(cfg, state, fin, x)
        per_scan.append(out)
    outs = {k: torch.stack([o[k] for o in per_scan]) for k in per_scan[0]}

    mask_code = outs["ret_mask"].to(torch.float32) + outs["adaptive_mask"].to(
        torch.float32
    )
    if cfg.has_misses:
        mask_code = mask_code + 3.0 * outs["miss_mask"].to(torch.float32)
        out_points = torch.cat(
            [outs["ga_hits"], outs["ga_miss"], mask_code[..., None]], dim=-1
        )
    else:
        out_points = torch.cat([outs["ga_hits"], mask_code[..., None]], dim=-1)
    out_filtered = torch.clamp(
        torch.round(outs["filtered_pts"] / q_scale), -32767, 32767
    ).to(torch.int16)
    rcap = cfg.max_packed_inserts if cfg.max_packed_inserts > 0 else c
    if rcap < c:
        # Only the inserted scans' compacted clouds (scan order).
        order = torch.argsort((~outs["inserted"]).to(torch.int32), stable=True)
        out_filtered = out_filtered[order[:rcap]]

    def f(k):
        return outs[k].to(torch.float32)

    out_scalars = torch.stack(
        [
            f("matched"),
            outs["pose2d"][:, 0], outs["pose2d"][:, 1], outs["pose2d"][:, 2],
            outs["g_quat"][:, 0], outs["g_quat"][:, 1],
            outs["g_quat"][:, 2], outs["g_quat"][:, 3],
            f("inserted"), f("created"), f("popped"), f("finished"),
            outs["new_anchor"][:, 0], outs["new_anchor"][:, 1],
            outs["counts"][:, 0].to(torch.float32),
            outs["counts"][:, 1].to(torch.float32),
            outs["ga_origin"][:, 0], outs["ga_origin"][:, 1],
            f("num_filtered"),
            f("oob_hits"),
        ],
        dim=1,
    )
    packed_out = torch.cat(
        [
            out_scalars.contiguous().view(torch.uint8).reshape(-1),
            out_filtered.contiguous().view(torch.uint8).reshape(-1),
        ]
    )
    return state, fin, out_points, packed_out
