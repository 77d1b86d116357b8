"""Shared device helpers for the chunked local-SLAM frontend.

Port of cartographer_tpu/ops/frontend_common.py: voxel filters with static
shapes (sensor/internal/voxel_filter.cc:38-197 semantics), quaternion
helpers, and the ImuTracker / PoseExtrapolator fold
(mapping/imu_tracker.cc:30-74, mapping/pose_extrapolator.cc:35-262).

Every function works on tensors of any device and never synchronises with
the host: data-dependent choices are `torch.where` on device tensors, and
scalar indexing goes through `torch.take` / `index_select`.
"""

from __future__ import annotations

import torch

MIN_PROBABILITY = 0.1

_INT64_MAX = torch.iinfo(torch.int64).max


# -- device voxel filters -----------------------------------------------------


def _voxel_keys(points, valid, lengths):
    """One injective int64 key per (length, point) for the voxel of the
    point at that edge length: the JAX package's two int32 lanes
    (key_a = packed x/y low 16 bits, key_b = z) fused as
    (key_a - 2^31) * 2^32 + (key_b + 2^31). Invalid points get INT64_MAX,
    which no valid point reaches (that would need key_b == 2^31 - 1).
    points [N, 3], valid [N], lengths [K] -> [K, N]."""
    idx = torch.round(points[None, :, :] / lengths[:, None, None]).to(torch.int32)
    idx = idx.to(torch.int64)
    key_a = ((idx[..., 0] & 0xFFFF) << 16) | (idx[..., 1] & 0xFFFF)
    key = (key_a - 2**31) * 2**32 + (idx[..., 2] + 2**31)
    return torch.where(valid[None, :], key, _INT64_MAX)


def _lengths(length, like):
    """A float or 0-d tensor as a float32 [1] tensor beside `like` (a fill,
    not a host-to-device copy)."""
    if isinstance(length, torch.Tensor):
        return length.to(torch.float32).reshape(1)
    return torch.full((1,), length, dtype=torch.float32, device=like.device)


def voxel_first_mask(points, valid, length):
    """First-occurrence-per-voxel mask in scan order — the semantics of
    sensor/voxel_filter.voxel_filter_indices with static shapes. A stable
    sort keeps equal keys in scan order, as jnp.lexsort does. `length`
    is a float or a 0-d tensor. Returns bool [N]."""
    key = _voxel_keys(points, valid, _lengths(length, points))[0]
    sk, perm = torch.sort(key, stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    mask = torch.zeros_like(first).scatter(0, perm, first)
    return mask & valid


def voxel_unique_counts_batch(points, valid, lengths):
    """Occupied-voxel counts [K] for K candidate voxel sizes with one
    batched sort (keys only)."""
    key = _voxel_keys(points, valid, lengths)
    sk, _ = torch.sort(key, dim=1)
    first = sk[:, 1:] != sk[:, :-1]
    runs = 1 + torch.sum(first, dim=1)
    any_valid = torch.any(valid)
    any_invalid = ~torch.all(valid)
    # All-invalid rows have exactly one (invalid) run -> zero voxels.
    return torch.where(any_valid, runs - any_invalid.to(runs.dtype), 0)


def adaptive_voxel_mask(points, valid, max_length, min_num_points):
    """Device mirror of sensor/voxel_filter.adaptive_voxel_filter (minus
    its max_range pre-filter, which the caller folds into `valid`):
    halve the voxel edge until at least min_num_points survive, then
    binary-search the edge to within 10% (voxel_filter.cc:50-74).

    One batched count covers the 8 halving lengths and one the 15 dyadic
    midpoints the 4-deep bisection can visit. The lengths are float32
    tensors computed with the same 0.5*(low+high) arithmetic as the JAX
    package, so the chosen edge length is bit-identical."""
    dev = points.device
    n0 = torch.sum(valid)
    max_length = _lengths(max_length, points)[0]

    halving_lengths = max_length * torch.pow(
        2.0, -torch.arange(8, dtype=torch.float32, device=dev)
    )
    counts_h = voxel_unique_counts_batch(points, valid, halving_lengths)
    enough_h = counts_h >= min_num_points
    skip = enough_h[0]
    low_found = torch.any(enough_h[1:])
    k_star = 1 + torch.argmax(enough_h[1:].to(torch.int32))
    k_prev = k_star - 1
    take = torch.take
    low_f = torch.where(low_found, take(halving_lengths, k_star), halving_lengths[7])
    high_f = torch.where(low_found, take(halving_lengths, k_prev), halving_lengths[7])
    count_low = torch.where(low_found, take(counts_h, k_star), counts_h[7])
    count_high = torch.where(low_found, take(counts_h, k_prev), counts_h[7])
    run_bisect = low_found & ~skip

    # Dyadic midpoint tree (exact fp match with sequential 0.5*(low+high)).
    l = [None] * 17
    l[0], l[16] = low_f, high_f
    for step in (8, 4, 2, 1):
        for j in range(step, 16, 2 * step):
            l[j] = 0.5 * (l[j - step] + l[j + step])
    counts_b = voxel_unique_counts_batch(points, valid, torch.stack(l[1:16]))
    counts17 = torch.cat([count_low[None], counts_b, count_high[None]])
    lengths17 = torch.stack(l)

    lo_j = torch.zeros((), dtype=torch.int64, device=dev)
    hi_j = torch.full((), 16, dtype=torch.int64, device=dev)
    for _ in range(4):
        lo_len = take(lengths17, lo_j)
        active = run_bisect & ((take(lengths17, hi_j) - lo_len) / lo_len > 1e-1)
        mid_j = torch.div(lo_j + hi_j, 2, rounding_mode="floor")
        ok = take(counts17, mid_j) >= min_num_points
        lo_j = torch.where(active & ok, mid_j, lo_j)
        hi_j = torch.where(active & ~ok, mid_j, hi_j)

    low_b = torch.where(run_bisect, take(lengths17, lo_j), low_f)
    final_length = torch.where(
        skip, max_length, torch.where(low_found, low_b, low_f)
    )
    mask = voxel_first_mask(points, valid, final_length)
    # Sparse clouds are returned unfiltered (voxel_filter.cc:42-44).
    return torch.where(n0 <= min_num_points, valid, mask)


# -- small geometry helpers ---------------------------------------------------


def wrap_angle(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def rot2(yaw, xy):
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack(
        [c * xy[..., 0] - s * xy[..., 1], s * xy[..., 0] + c * xy[..., 1]],
        dim=-1,
    )


# Quaternion helpers [w, x, y, z] (transform/rigid3.py on tensors).
def qmul(a, b):
    w1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    w2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def qconj(q):
    return torch.stack([q[..., 0], -q[..., 1], -q[..., 2], -q[..., 3]], dim=-1)


def qnorm(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _unit_z(like):
    """[0, 0, 1] beside `like` (a fill, not a host-to-device copy)."""
    ez = torch.zeros(3, dtype=like.dtype, device=like.device)
    ez[2] = 1.0
    return ez


def qrot(q, v):
    """Rotate vectors v (..., 3) by quaternion q (..., 4)."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def qexp(aa):
    """Angle-axis vector -> quaternion (Taylor expansion near zero)."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-32))
    half = 0.5 * theta
    small = theta2 < 1e-16
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(
        small[..., 0], 1.0 - theta2[..., 0] / 8.0, torch.cos(half[..., 0])
    )
    return torch.cat([w[..., None], aa * k], dim=-1)


def qlog(q):
    """Quaternion -> angle-axis vector (RotationQuaternionToAngleAxisVector)."""
    sign = torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    q = q * sign
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    sin_half = torch.linalg.norm(q[..., 1:4], dim=-1)
    angle = 2.0 * torch.atan2(sin_half, w)
    scale = torch.where(
        sin_half < 1e-12, 2.0, angle / torch.clamp(sin_half, min=1e-32)
    )
    return q[..., 1:4] * scale[..., None]


def quat_from_two_vectors(a, b):
    """Shortest-arc rotation taking a to b (Eigen FromTwoVectors)."""
    a = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    c = _cross(a, b)
    d = torch.sum(a * b, dim=-1)
    w = 1.0 + d
    # Degenerate case (a == -b): rotate pi around any orthogonal axis.
    small = w < 1e-8
    zero = torch.zeros_like(a[..., 0])
    ortho = torch.stack([zero, a[..., 2], -a[..., 1]], dim=-1)  # a x e_x
    ortho2 = torch.stack([-a[..., 2], zero, a[..., 0]], dim=-1)  # a x e_y
    ortho_norm = torch.linalg.norm(ortho, dim=-1, keepdim=True)
    ortho = torch.where(ortho_norm < 1e-8, ortho2, ortho)
    q = torch.cat([w[..., None], c], dim=-1)
    q_degenerate = torch.cat([torch.zeros_like(w[..., None]), ortho], dim=-1)
    q = torch.where(small[..., None], q_degenerate, q)
    return qnorm(q)


def quat_angle(q):
    """Rotation angle magnitude (GetAngle)."""
    w = torch.abs(q[..., 0])
    s = torch.linalg.norm(q[..., 1:4], dim=-1)
    return 2.0 * torch.atan2(s, w)


def yaw_of(q):
    return torch.atan2(
        2.0 * (q[..., 0] * q[..., 3] + q[..., 1] * q[..., 2]),
        1.0 - 2.0 * (q[..., 2] ** 2 + q[..., 3] ** 2),
    )


def yaw_quat(yaw):
    half = 0.5 * yaw
    z = torch.zeros_like(half)
    return torch.stack([torch.cos(half), z, z, torch.sin(half)], dim=-1)


# -- device ImuTracker --------------------------------------------------------


def tracker_advance(time, ori, grav, omega, to_t):
    """ImuTracker::Advance (imu_tracker.cc:44-54)."""
    dt = to_t - time
    dq = qexp(omega * dt)
    ori2 = qnorm(qmul(ori, dq))
    grav2 = qrot(qconj(dq), grav)
    return to_t, ori2, grav2


def tracker_acc_obs(cfg, time, ori, grav, last_acc_t, acc):
    """AddImuLinearAccelerationObservation (imu_tracker.cc:56-77)."""
    dt = torch.where(last_acc_t > -1e29, time - last_acc_t, 1e30)
    alpha = 1.0 - torch.exp(-dt / cfg.imu_gravity_time_constant)
    grav2 = (1.0 - alpha) * grav + alpha * acc
    rot = quat_from_two_vectors(grav2, qrot(qconj(ori), _unit_z(grav)))
    ori2 = qnorm(qmul(ori, rot))
    return ori2, grav2, time


def tracker_fold(cfg, state, t_target, imu):
    """Advance the ImuTracker from its add_pose state (time == newest_t) to
    t_target, consuming the scan's IMU samples in order.

    Returns (final tracker tuple, breakpoint tensors (times [M+1],
    orientations [M+1, 4], angular velocities [M+1, 3])) — every query in
    (bp_t[i], bp_t[i+1]] extrapolates from breakpoint i."""
    t0 = state.newest_t
    ori0, grav0 = state.tracker_ori, state.tracker_grav
    om0, la0 = state.tracker_omega, state.tracker_last_acc_t

    if not cfg.use_imu:
        # Fake gravity + pose-derived angular velocity: one advance + one
        # observation pair at t_target (pose_extrapolator.cc:201-210).
        m = cfg.max_imu_per_scan
        bp_t = t0.expand(m + 1)
        bp_ori = ori0.expand(m + 1, 4)
        bp_om = state.ang_vel.expand(m + 1, 3)
        t1, ori1, grav1 = tracker_advance(t0, ori0, grav0, om0, t_target)
        ori2, grav2, la1 = tracker_acc_obs(
            cfg, t1, ori1, grav1, la0, _unit_z(grav0)
        )
        # The caller overwrites the stored omega with the updated
        # pose-derived angular velocity after the velocity update.
        return (t1, ori2, grav2, state.ang_vel, la1), (bp_t, bp_ori, bp_om)

    imu_t, imu_acc, imu_gyro, imu_valid = imu
    time, ori, grav, om, la = t0, ori0, grav0, om0, la0
    bt, bo, bw = [], [], []
    for i in range(imu_t.shape[0]):
        it, acc, gyro = imu_t[i], imu_acc[i], imu_gyro[i]
        use = imu_valid[i] & (it >= time) & (it < t_target)
        t_adv = torch.maximum(it, time)
        t1, ori1, grav1 = tracker_advance(time, ori, grav, om, t_adv)
        ori2, grav2, la1 = tracker_acc_obs(cfg, t1, ori1, grav1, la, acc)
        time = torch.where(use, t1, time)
        ori = torch.where(use, ori2, ori)
        grav = torch.where(use, grav2, grav)
        om = torch.where(use, gyro, om)
        la = torch.where(use, la1, la)
        bt.append(time)
        bo.append(ori)
        bw.append(om)
    bp_t = torch.stack([t0] + bt)
    bp_ori = torch.stack([ori0] + bo)
    bp_om = torch.stack([om0] + bw)
    t1, ori1, grav1 = tracker_advance(time, ori, grav, om, t_target)
    return (t1, ori1, grav1, om, la), (bp_t, bp_ori, bp_om)


def unwarp_points(state, bp_t, bp_ori, bp_om, ptimes):
    """Per-point pose extrapolation (ExtrapolatePosesBatch): monotonic-clamp
    the point times against the extrapolation frontier, locate each in the
    tracker breakpoint list, and compose rotation/translation from the
    newest pose + velocities. Returns (rot_i [N,4], tr_i [N,3], pt [N])."""
    pt = torch.maximum(ptimes, state.last_extrap_t)
    pt = torch.cummax(pt, dim=0).values
    idx = torch.clamp(
        torch.sum(bp_t[None, :] <= pt[:, None], dim=1) - 1, 0, bp_t.shape[0] - 1
    )
    q_bp = bp_ori[idx]  # [N, 4]
    w_bp = bp_om[idx]  # [N, 3]
    dt_bp = (pt - bp_t[idx])[:, None]
    q_t = qnorm(qmul(q_bp, qexp(w_bp * dt_bp)))
    # rotation_i = newest.q * (conj(main_tracker.ori) * tracker(t_i).ori)
    q_rel = qmul(qconj(state.tracker_ori)[None, :], q_t)
    rot_i = qnorm(qmul(state.newest_q[None, :], q_rel))  # [N, 4]
    dtp = pt - state.newest_t
    tr_i = state.newest_xyz[None, :] + state.vel[None, :] * dtp[:, None]
    return rot_i, tr_i, pt
