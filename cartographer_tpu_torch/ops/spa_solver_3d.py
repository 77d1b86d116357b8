"""SE(3) sparse pose adjustment with IMU residuals, on the device.

Port of cartographer_tpu/ops/spa_solver_3d.py. Reference:
internal/optimization/optimization_problem_3d.cc:150-633 with residuals
from spa_cost_function_3d.h (relative-pose error: rotated translation
delta + angle-axis of conj(q_end) q_start z, Huber on INTER),
acceleration_cost_function_3d.h (IMU preintegrated delta velocity against
the second difference of positions, with an optimizable gravity constant
and online IMU extrinsic calibration), rotation_cost_function_3d.h
(gyro-integrated relative rotation, vector part of the quaternion error),
landmark_cost_function_3d.h (interpolated node poses) and the fixed-frame
residuals (yaw-only origin, optional TolerantLoss).

Parameters are those of the JAX package: each pose is a base quaternion
q0 (fixed during the solve) composed with an exponential-map delta, plus
a translation delta; fixed-frame origins rotate about z only; each
trajectory has a gravity constant and a calibration delta. They live in
one table X [P + T, 6] (rows: submaps, nodes, landmarks, fixed frames,
then trajectories; columns: translation (the gravity constant in column
0 of a trajectory row) and rotation), with a 0/1 mask of the free
columns (fix_z, frozen poses, the yaw-only origin, calibration off).

The LM is the JAX package's: Ceres's trust-region dynamics with damping
(1/radius) I on the free dimensions, step quality from the linearized
model, optional nonmonotonic steps, and the damped normal equations
solved by unpreconditioned conjugate gradients with the stopping rule of
jax.scipy.sparse.linalg.cg (||r|| <= 1e-6 ||b||). Where the JAX code
differentiates with jax.jvp / jax.vjp, every residual family's Jacobian
is written out here as blocks per (row, parameter row): a perturbation
q -> q exp(w) of a quaternion moves each residual through closed forms
(d log(E exp(p)) = Jr^-1(log E) p, d R(q)v = -R(q)[v]x w, quaternion
product matrices for the IMU rotation's vector part), and the chain to
the parameters goes through the right Jacobian of exp at the current
rotation delta. J v is a batched product and J^T u an `index_add_`
scatter. One host synchronisation per LM iteration reads the stop flag;
CG runs its `cg_iterations` steps with the carry frozen once converged.
`index_add_` on CUDA is not deterministic, so a solve on the card agrees
with one on the CPU within a tolerance, not bit for bit.

With a `mesh` every residual table (constraints, node-node, IMU rotation
and acceleration rows, landmark and fixed-frame observations) holds this
rank's rows and the parameter tables are replicated; J^T u, the costs
and the model-change dots are all-reduced over the mesh, as in
ops/spa_solver.solve.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cartographer_tpu_torch.ops import frontend_common as fc
from cartographer_tpu_torch.ops.scan_matching.gauss_newton_2d import (
    nonmonotonic_accepted,
    nonmonotonic_init,
    nonmonotonic_quality,
)
from cartographer_tpu_torch.ops.spa_solver import _cg, _tables_to, mesh_sum


class SpaProblem3D(NamedTuple):
    # Poses: translations + base quaternions (fixed during the solve).
    submap_t: torch.Tensor  # f32 [S, 3]
    submap_q: torch.Tensor  # f32 [S, 4]
    node_t: torch.Tensor  # f32 [N, 3]
    node_q: torch.Tensor  # f32 [N, 4]
    free_submap: torch.Tensor  # bool [S]
    free_node: torch.Tensor  # bool [N]
    fix_z: torch.Tensor  # bool [] — optimization_problem fix_z_in_3d
    # Submap-node constraints.
    c_submap: torch.Tensor  # i32 [C]
    c_node: torch.Tensor  # i32 [C]
    c_z_t: torch.Tensor  # f32 [C, 3]
    c_z_q: torch.Tensor  # f32 [C, 4]
    c_weight: torch.Tensor  # f32 [C, 2] (translation, rotation)
    c_huber: torch.Tensor  # bool [C]
    c_mask: torch.Tensor  # bool [C]
    # Node-node constraints (odometry, local slam).
    n_a: torch.Tensor  # i32 [K]
    n_b: torch.Tensor
    n_z_t: torch.Tensor  # f32 [K, 3]
    n_z_q: torch.Tensor  # f32 [K, 4]
    n_weight: torch.Tensor  # f32 [K, 2]
    n_mask: torch.Tensor  # bool [K]
    # IMU rotation residuals between consecutive nodes.
    r_a: torch.Tensor  # i32 [R]
    r_b: torch.Tensor
    r_dq: torch.Tensor  # f32 [R, 4] gyro-integrated delta rotation (imu frame)
    r_weight: torch.Tensor  # f32 [R]
    r_traj: torch.Tensor  # i32 [R] trajectory index (for imu calibration)
    r_mask: torch.Tensor  # bool [R]
    # IMU acceleration residuals over node triples.
    a_first: torch.Tensor  # i32 [A]
    a_mid: torch.Tensor
    a_last: torch.Tensor
    a_dv: torch.Tensor  # f32 [A, 3] preintegrated delta velocity (imu frame)
    a_dt1: torch.Tensor  # f32 [A]
    a_dt2: torch.Tensor  # f32 [A]
    a_weight: torch.Tensor  # f32 [A]
    a_traj: torch.Tensor  # i32 [A]
    a_mask: torch.Tensor  # bool [A]
    # Per-trajectory IMU state.
    gravity: torch.Tensor  # f32 [T] gravity constant per trajectory
    calib_q: torch.Tensor  # f32 [T, 4] base imu calibration quaternion
    optimize_calibration: torch.Tensor  # bool []


class SpaExtras3D(NamedTuple):
    """Optional SE(3) landmark + fixed-frame (GPS) residual tables (see
    the JAX package's SpaExtras3D)."""

    # Landmarks: free SE(3) poses.
    l_t: torch.Tensor  # f32 [L, 3]
    l_q: torch.Tensor  # f32 [L, 4]
    l_free: torch.Tensor  # bool [L]
    o_node_a: torch.Tensor  # i32 [O] bracketing node indices
    o_node_b: torch.Tensor  # i32 [O]
    o_factor: torch.Tensor  # f32 [O] interpolation factor in [0, 1]
    o_landmark: torch.Tensor  # i32 [O]
    o_z_t: torch.Tensor  # f32 [O, 3] observed tracking->landmark translation
    o_z_q: torch.Tensor  # f32 [O, 4] observed tracking->landmark rotation
    o_weight: torch.Tensor  # f32 [O, 2] (translation, rotation)
    o_mask: torch.Tensor  # bool [O]
    # Fixed-frame origins (one per trajectory with GPS data).
    f_t: torch.Tensor  # f32 [F, 3]
    f_q: torch.Tensor  # f32 [F, 4] base quaternion (pure yaw at entry)
    f_free: torch.Tensor  # bool [F]
    g_node: torch.Tensor  # i32 [G]
    g_traj: torch.Tensor  # i32 [G] index into the fixed-frame tables
    g_z_t: torch.Tensor  # f32 [G, 3] fixed-frame observation of the node
    g_z_q: torch.Tensor  # f32 [G, 4]
    g_weight: torch.Tensor  # f32 [G, 2]
    g_mask: torch.Tensor  # bool [G]
    g_tolerant: torch.Tensor  # bool [] use TolerantLoss on GPS residuals
    g_loss_a: torch.Tensor  # f32 [] TolerantLoss a
    g_loss_b: torch.Tensor  # f32 [] TolerantLoss b


def problem_from_numpy(tables, device) -> SpaProblem3D:
    """SpaProblem3D from numpy tables (e.g. the JAX package's problem,
    field by field)."""
    return _tables_to(SpaProblem3D, tables, device)


def extras_from_numpy(tables, device) -> SpaExtras3D:
    return _tables_to(SpaExtras3D, tables, device)


# -- quaternion and SO(3) helpers (rows of quaternions [R, 4]) -------------


def _qexp(r):
    """The JAX package's _qexp (Taylor-safe)."""
    theta2 = torch.sum(r * r, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-32)
    half = 0.5 * theta
    small = theta2 < 1e-12
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w, r * k], dim=-1)


def _qlog(q):
    """Quaternion -> angle-axis vector (w kept positive), as the JAX
    package's _qlog (series below |v|^2 = 1e-10)."""
    q = torch.where(q[..., 0:1] < 0, -q, q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    s2 = torch.sum(q[..., 1:4] * q[..., 1:4], dim=-1)
    small = s2 < 1e-10
    s2_safe = torch.where(small, torch.ones_like(s2), s2)
    sin_half = torch.sqrt(s2_safe)
    angle_over_sin = 2.0 * torch.atan2(sin_half, w) / sin_half
    w_safe = torch.clamp(w, min=1e-6)
    series = 2.0 / w_safe * (1.0 - s2 / (3.0 * w_safe * w_safe))
    scale = torch.where(small, series, angle_over_sin)
    return q[..., 1:4] * scale[..., None]


def _skew(v):
    """[v]x as [R, 3, 3]."""
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [
            torch.stack([z, -w, y], -1),
            torch.stack([w, z, -x], -1),
            torch.stack([-y, x, z], -1),
        ],
        dim=-2,
    )


def _rotmat(q):
    """Rotation matrix [R, 3, 3] of unit quaternions."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def _lmat(q):
    """[R, 4, 4] with q * p = L(q) p."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([w, -x, -y, -z], -1),
            torch.stack([x, w, -z, y], -1),
            torch.stack([y, z, w, -x], -1),
            torch.stack([z, -y, x, w], -1),
        ],
        dim=-2,
    )


def _rmat(q):
    """[R, 4, 4] with p * q = R(q) p."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([w, -x, -y, -z], -1),
            torch.stack([x, w, z, -y], -1),
            torch.stack([y, -z, w, x], -1),
            torch.stack([z, y, -x, w], -1),
        ],
        dim=-2,
    )


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        like.shape[:-1] + (3, 3)
    )


def _so3_jacobian(phi, inverse: bool):
    """Right Jacobian of the SO(3) exponential at phi [R, 3] (d Exp(phi +
    d) = Exp(phi) Exp(Jr d)), or its inverse; Taylor series below
    |phi| = 0.1."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < 1e-2
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2)
    k = _skew(phi)
    if inverse:
        # Jr^-1 = I + 1/2 [phi]x + c [phi]x^2, c = 1/th^2 - (1+cos)/(2 th sin).
        sin_t = torch.sin(theta)
        sin_t = torch.where(sin_t.abs() < 1e-6, torch.full_like(sin_t, 1e-6), sin_t)
        c = torch.where(
            small,
            1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
            1.0 / t2 - (1.0 + torch.cos(theta)) / (2.0 * theta * sin_t),
        )
        a = torch.full_like(theta2, -0.5)
    else:
        # Jr = I - a [phi]x + b [phi]x^2.
        half = torch.sin(0.5 * theta)
        a = torch.where(
            small,
            0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
            2.0 * half * half / t2,
        )
        c = torch.where(
            small,
            1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
            (theta - torch.sin(theta)) / (t2 * theta),
        )
    return _eye3(phi) - a[:, None, None] * k + c[:, None, None] * (k @ k)


# -- residual families -----------------------------------------------------


def _relative(t_i, q_i, t_j, q_j, z_t, z_q, jac: bool):
    """cost_helpers_impl.h ComputeUnscaledError (3D): e [R, 6]; with the
    Jacobian also de/d(t_i, w_i) and de/d(t_j, w_j) [R, 6, 6] for
    perturbations q -> q exp(w)."""
    h = fc.qrot(fc.qconj(q_i), t_j - t_i)
    e_big = fc.qmul(fc.qmul(fc.qconj(q_j), q_i), z_q)
    e_r = _qlog(e_big)
    e = torch.cat([z_t - h, e_r], dim=-1)
    if not jac:
        return e
    ri_t = _rotmat(q_i).transpose(1, 2)
    jinv = _so3_jacobian(e_r, inverse=True)
    r = e.shape[0]
    a = e.new_zeros((r, 6, 6))
    b = e.new_zeros((r, 6, 6))
    a[:, :3, :3] = ri_t
    a[:, :3, 3:] = -_skew(h)
    a[:, 3:, 3:] = jinv @ _rotmat(z_q).transpose(1, 2)
    b[:, :3, :3] = -ri_t
    b[:, 3:, 3:] = -jinv @ _rotmat(e_big).transpose(1, 2)
    return e, a, b


def _interpolated(t_a, q_a, t_b, q_b, f, jac: bool):
    """InterpolateNodes3D (lerp translation, geodesic slerp rotation);
    with the Jacobian also the maps from the bracketing nodes'
    perturbations to the interpolated pose's: w_i = M_a w_a + M_b w_b."""
    g = fc.qmul(fc.qconj(q_a), q_b)
    d = _qlog(g)
    fd = f[:, None] * d
    e_f = _qexp(fd)
    q_i = fc.qmul(q_a, e_f)
    t_i = t_a + f[:, None] * (t_b - t_a)
    if not jac:
        return t_i, q_i
    m_b = f[:, None, None] * (
        _so3_jacobian(fd, inverse=False) @ _so3_jacobian(d, inverse=True)
    )
    m_a = _rotmat(e_f).transpose(1, 2) - m_b @ _rotmat(g).transpose(1, 2)
    return t_i, q_i, m_a, m_b


def _w6(weight, mask):
    w = torch.cat([weight[:, 0:1].expand(-1, 3), weight[:, 1:2].expand(-1, 3)], -1)
    return w * mask[:, None].to(w.dtype)


def _robust(r, factor, dfactor_ds, jac: bool):
    """Scale r by an IRLS factor(s = |r|^2); with the Jacobian also
    d(factor r)/dr [R, 6, 6]."""
    out = r * factor[:, None]
    if not jac:
        return out, None
    eye = torch.eye(r.shape[1], dtype=r.dtype, device=r.device)
    h = factor[:, None, None] * eye + 2.0 * dfactor_ds[:, None, None] * (
        r[:, :, None] * r[:, None, :]
    )
    return out, h


def _huber(r, huber_mask, huber_scale, jac: bool):
    """Ceres HuberLoss as an IRLS factor (safe-where, as in JAX)."""
    s = torch.sum(r * r, dim=-1)
    delta2 = huber_scale * huber_scale
    apply = huber_mask & (s > delta2)
    s_safe = torch.where(apply, s, torch.full_like(s, delta2))
    g = (2.0 * huber_scale * torch.sqrt(s_safe) - delta2) / s_safe
    factor = torch.where(apply, torch.sqrt(g), torch.ones_like(s))
    dg = -huber_scale * s_safe**-1.5 + delta2 / (s_safe * s_safe)
    dfactor = torch.where(apply, dg / (2.0 * factor), torch.zeros_like(s))
    return _robust(r, factor, dfactor, jac)


def _tolerant(r, apply, a, b, jac: bool):
    """Ceres TolerantLoss(a, b) as an IRLS factor sqrt(rho(s) / s)."""
    s = torch.sum(r * r, dim=-1)
    apply = apply & (s > 1e-12)
    s_safe = torch.where(apply, s, torch.ones_like(s))
    rho = b * (
        torch.nn.functional.softplus((s_safe - a) / b)
        - torch.nn.functional.softplus(-a / b)
    )
    rho_c = torch.clamp(rho, min=1e-20)
    g = rho_c / s_safe
    factor = torch.where(apply, torch.sqrt(g), torch.ones_like(s))
    drho = torch.where(rho > 1e-20, torch.sigmoid((s_safe - a) / b), torch.zeros_like(s))
    dg = (drho * s_safe - rho_c) / (s_safe * s_safe)
    dfactor = torch.where(apply, dg / (2.0 * factor), torch.zeros_like(s))
    return _robust(r, factor, dfactor, jac)


_MIN_TRUST_REGION_RADIUS = 1e-10


class _Model:
    """The residual families over the parameter table X [P + T, 6] (see
    the module docstring), with their written-out Jacobians."""

    def __init__(self, p: SpaProblem3D, extras: Optional[SpaExtras3D], huber_scale, dtype):
        cast = lambda t: t.to(dtype)  # noqa: E731
        self.p, self.extras = p, extras
        self.huber_scale = huber_scale
        s, n = p.submap_t.shape[0], p.node_t.shape[0]
        ts = [p.submap_t, p.node_t]
        qs = [p.submap_q, p.node_q]
        zs = torch.where(
            p.fix_z, p.submap_t.new_tensor([1.0, 1.0, 0.0]), p.submap_t.new_ones(3)
        ).to(dtype)
        ones3 = torch.ones(3, dtype=dtype, device=zs.device)
        masks = [
            torch.cat([fr[:, None].to(dtype) * zs, fr[:, None].to(dtype) * ones3], 1)
            for fr in (p.free_submap, p.free_node)
        ]
        self.node_off = s
        if extras is not None:
            self.lm_off = s + n
            self.ff_off = s + n + extras.l_t.shape[0]
            ts += [extras.l_t, extras.f_t]
            qs += [extras.l_q, extras.f_q]
            fl = extras.l_free[:, None].to(dtype)
            ff = extras.f_free[:, None].to(dtype)
            yaw = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=zs.device)
            masks += [torch.cat([fl * ones3, fl * ones3], 1), torch.cat([ff * ones3, ff * yaw], 1)]
        self.t0 = cast(torch.cat(ts))
        self.q0 = cast(torch.cat(qs))
        self.num_poses = self.t0.shape[0]
        self.traj_off = self.num_poses
        t = p.gravity.shape[0]
        # Trajectory rows: the gravity constant in column 0, the
        # calibration delta in columns 3-5 when it is optimized.
        traj_mask = torch.zeros(6, dtype=dtype, device=zs.device)
        traj_mask[0] = 1.0
        traj_mask[3:] = p.optimize_calibration.to(dtype)
        masks.append(traj_mask.expand(t, 6))
        self.mask = torch.cat(masks)
        self.calib0 = cast(p.calib_q)
        self.grav0 = cast(p.gravity)
        self.dtype = dtype

    def x0(self):
        x = self.mask.new_zeros(self.mask.shape)
        x[self.traj_off:, 0] = self.grav0
        return x

    def _state(self, x):
        """Poses (t, q), gravity and calibration at x."""
        dr = x[:, 3:6] * self.mask[:, 3:6]
        np_ = self.num_poses
        t = self.t0 + x[:np_, :3] * self.mask[:np_, :3]
        q = fc.qmul(self.q0, _qexp(dr[:np_]))
        grav = x[np_:, 0]
        calib = fc.qmul(self.calib0, _qexp(dr[np_:]))
        return t, q, grav, calib

    def chain(self, x):
        """Per parameter row, d(translation, rotation perturbation) /
        d(parameters): the column mask and the right Jacobian of exp at
        the row's rotation delta, as (mask [P+T, 3], JrM [P+T, 3, 3])."""
        m = self.mask
        jr = _so3_jacobian(x[:, 3:6] * m[:, 3:6], inverse=False)
        return m[:, :3], jr * m[:, None, 3:6]

    def families(self, x, jac: bool):
        """Residuals of every family [R, d] and, with `jac`, the blocks
        per family as [(parameter row [R], d residual / d(translation,
        rotation perturbation) [R, d, 6])]."""
        p, ex = self.p, self.extras
        long = torch.long
        t, q, grav, calib = self._state(x)
        no, to = self.node_off, self.traj_off
        out = []

        def pose_pose(start, end, z_t, z_q, w6, robust=None):
            i, j = start.to(long), end.to(long)
            res = _relative(t[i], q[i], t[j], q[j], self._c(z_t), self._c(z_q), jac)
            if not jac:
                r = res * w6
                if robust is not None:
                    r, _ = robust(r, False)
                return r, None
            e, a, b = res
            r = e * w6
            a, b = a * w6[:, :, None], b * w6[:, :, None]
            if robust is not None:
                r, h = robust(r, True)
                a, b = h @ a, h @ b
            return r, [(i, a), (j, b)]

        w_c = _w6(self._c(p.c_weight), p.c_mask)
        out.append(pose_pose(
            p.c_submap, p.c_node + no, p.c_z_t, p.c_z_q, w_c,
            lambda r, j: _huber(r, p.c_huber, self.huber_scale, j),
        ))
        out.append(pose_pose(
            p.n_a + no, p.n_b + no, p.n_z_t, p.n_z_q,
            _w6(self._c(p.n_weight), p.n_mask),
        ))
        out.append(self._imu_rotation(q, calib, jac))
        out.append(self._imu_acceleration(t, q, grav, calib, jac))
        if ex is not None:
            out.append(self._landmarks(t, q, jac))
            tol = lambda r, j: _tolerant(  # noqa: E731
                r, ex.g_tolerant, self._c(ex.g_loss_a), self._c(ex.g_loss_b), j
            )
            out.append(pose_pose(
                ex.g_traj + self.ff_off, ex.g_node + no, ex.g_z_t, ex.g_z_q,
                _w6(self._c(ex.g_weight), ex.g_mask), tol,
            ))
        return out

    def _c(self, t):
        return t.to(self.dtype)

    def _imu_rotation(self, q, calib, jac):
        """Vector part of conj(q_b) q_a c dq conj(c), times the weight."""
        p = self.p
        long = torch.long
        a = p.r_a.to(long) + self.node_off
        b = p.r_b.to(long) + self.node_off
        tr = p.r_traj.to(long)
        c = calib[tr]
        dq = self._c(p.r_dq)
        pq = fc.qmul(fc.qconj(q[b]), q[a])
        d = fc.qmul(fc.qmul(c, dq), fc.qconj(c))
        big_q = fc.qmul(pq, d)
        w = (self._c(p.r_weight) * p.r_mask.to(self.dtype))[:, None]
        r = big_q[:, 1:4] * w
        if not jac:
            return r, None
        half_w = 0.5 * w[:, :, None]
        d_a = (_lmat(pq) @ _rmat(d))[:, 1:, 1:] * half_w
        d_b = -_rmat(big_q)[:, 1:, 1:] * half_w
        d_c = (
            _lmat(pq)
            @ (
                _lmat(c) @ _rmat(fc.qmul(dq, fc.qconj(c)))
                - _lmat(fc.qmul(c, dq)) @ _rmat(fc.qconj(c))
            )
        )[:, 1:, 1:] * half_w
        zero = torch.zeros_like(d_a)
        return r, [
            (a, torch.cat([zero, d_a], -1)),
            (b, torch.cat([zero, d_b], -1)),
            (tr + self.traj_off, torch.cat([zero, d_c], -1)),
        ]

    def _imu_acceleration(self, t, q, grav, calib, jac):
        """acceleration_cost_function_3d.h: rotated preintegrated delta
        velocity minus gravity against the second difference of positions."""
        p = self.p
        long = torch.long
        no = self.node_off
        f_, m_, l_ = (i.to(long) + no for i in (p.a_first, p.a_mid, p.a_last))
        tr = p.a_traj.to(long)
        c = calib[tr]
        qm = fc.qmul(q[m_], c)
        dv = self._c(p.a_dv)
        dt1, dt2 = self._c(p.a_dt1)[:, None], self._c(p.a_dt2)[:, None]
        ez = torch.zeros_like(dv)
        ez[:, 2] = 1.0
        g_coef = 0.5 * (dt1 + dt2)
        imu_dv = fc.qrot(qm, dv) - grav[tr][:, None] * g_coef * ez
        start_v = (t[m_] - t[f_]) / dt1
        end_v = (t[l_] - t[m_]) / dt2
        w = (self._c(p.a_weight) * p.a_mask.to(self.dtype))[:, None]
        r = (imu_dv - (end_v - start_v)) * w
        if not jac:
            return r, None
        eye = _eye3(dv)
        wm = w[:, :, None]
        rot_c = -_rotmat(qm) @ _skew(dv)
        rot_m = rot_c @ _rotmat(c).transpose(1, 2)
        zero = torch.zeros_like(eye)
        d_g = torch.zeros_like(eye)
        d_g[:, :, 0] = -(g_coef * ez)
        return r, [
            (f_, torch.cat([-eye / dt1[:, :, None], zero], -1) * wm),
            (m_, torch.cat([eye * (1.0 / dt1 + 1.0 / dt2)[:, :, None], rot_m], -1) * wm),
            (l_, torch.cat([-eye / dt2[:, :, None], zero], -1) * wm),
            (tr + self.traj_off, torch.cat([d_g, rot_c], -1) * wm),
        ]

    def _landmarks(self, t, q, jac):
        """landmark_cost_function_3d.h: SPA error from the pose
        interpolated between the bracketing nodes to the landmark."""
        ex = self.extras
        long = torch.long
        na = ex.o_node_a.to(long) + self.node_off
        nb = ex.o_node_b.to(long) + self.node_off
        lm = ex.o_landmark.to(long) + self.lm_off
        f = self._c(ex.o_factor)
        w6 = _w6(self._c(ex.o_weight), ex.o_mask)
        z_t, z_q = self._c(ex.o_z_t), self._c(ex.o_z_q)
        if not jac:
            t_i, q_i = _interpolated(t[na], q[na], t[nb], q[nb], f, False)
            return _relative(t_i, q_i, t[lm], q[lm], z_t, z_q, False) * w6, None
        t_i, q_i, m_a, m_b = _interpolated(t[na], q[na], t[nb], q[nb], f, True)
        e, a, b = _relative(t_i, q_i, t[lm], q[lm], z_t, z_q, True)
        a, b = a * w6[:, :, None], b * w6[:, :, None]
        fa = (1.0 - f)[:, None, None]
        fb = f[:, None, None]
        block_a = torch.cat([a[:, :, :3] * fa, a[:, :, 3:] @ m_a], -1)
        block_b = torch.cat([a[:, :, :3] * fb, a[:, :, 3:] @ m_b], -1)
        return e * w6, [(na, block_a), (nb, block_b), (lm, b)]

    def residuals(self, x):
        return [r for r, _ in self.families(x, False)]

    def linearize(self, x):
        """Residuals and the Jacobian as [(parameter row [R], block [R, d,
        6])] per family, with respect to X."""
        mask_t, jrm = self.chain(x)
        res, blocks = [], []
        for r, fam in self.families(x, True):
            res.append(r)
            blocks.append([
                (idx, torch.cat([b[:, :, :3] * mask_t[idx][:, None, :], b[:, :, 3:] @ jrm[idx]], -1))
                for idx, b in fam
            ])
        return res, blocks

    def outputs(self, x):
        t, q, grav, calib = self._state(x)
        norm = lambda v: v / torch.linalg.norm(v, dim=-1, keepdim=True)  # noqa: E731
        s, n = self.p.submap_t.shape[0], self.p.node_t.shape[0]
        out = (
            t[:s], norm(q[:s]), t[s:s + n], norm(q[s:s + n]),
            torch.clamp(grav, min=1e-3), norm(calib),
        )
        if self.extras is not None:
            lo, fo = self.lm_off, self.ff_off
            out += (t[lo:fo], norm(q[lo:fo]), t[fo:], norm(q[fo:]))
        return out


def _jv(blocks, v):
    return [
        sum(torch.bmm(m, v[idx][:, :, None])[:, :, 0] for idx, m in fam)
        for fam in blocks
    ]


def _jtu(blocks, us, like, mesh=None):
    out = torch.zeros_like(like)
    for fam, u in zip(blocks, us):
        for idx, m in fam:
            out.index_add_(0, idx, torch.bmm(m.transpose(1, 2), u[:, :, None])[:, :, 0])
    return mesh_sum(out, mesh)


def _dot(us, vs, mesh=None):
    return mesh_sum(sum(torch.sum(u * v) for u, v in zip(us, vs)), mesh)


def _cost(residuals, mesh=None):
    return mesh_sum(0.5 * sum(torch.sum(r * r) for r in residuals), mesh)


def solve_3d(
    p: SpaProblem3D,
    huber_scale: float,
    max_iterations: int = 50,
    cg_iterations: int = 64,
    extras: Optional[SpaExtras3D] = None,
    use_nonmonotonic_steps: bool = False,
    mesh=None,
):
    """Returns (submap_t, submap_q, node_t, node_q, gravity, calib_q,
    cost) — plus, when `extras` is given, (landmark_t, landmark_q,
    fixed_t, fixed_q) before the cost — on the problem's device. With
    `mesh`, `p` and `extras` hold this rank's residual rows
    (parallel/sharded.shard_spa_problem_3d)."""
    model = _Model(p, extras, huber_scale, torch.float32)
    free = model.mask
    dev = free.device
    x = model.x0()
    cost = _cost(model.residuals(x), mesh)
    f32 = dict(dtype=torch.float32, device=dev)
    radius = torch.full((), 1e4, **f32)
    decrease_factor = torch.full((), 2.0, **f32)
    ev = nonmonotonic_init(cost)
    ones = torch.ones_like(x)
    for _ in range(max_iterations):
        r0, blocks = model.linearize(x)
        lam = 1.0 / radius
        grad = _jtu(blocks, r0, x, mesh)

        def hvp(v):
            pv_ = v * free
            # lam damping on the free dimensions, identity on the rest.
            return _jtu(blocks, _jv(blocks, pv_), x, mesh) + lam * pv_ + (v - pv_)

        dx = _cg(hvp, -grad, ones, cg_iterations) * free
        new_x = x + dx
        new_cost = _cost(model.residuals(new_x), mesh)
        # Ceres step quality: model cost change from r0 + J dx.
        jdx = _jv(blocks, dx)
        model_cost_change = -(_dot(r0, jdx, mesh) + 0.5 * _dot(jdx, jdx, mesh))
        valid = model_cost_change > 0.0
        mcc = torch.clamp(model_cost_change, min=1e-30)
        if use_nonmonotonic_steps:
            rho = nonmonotonic_quality(ev, cost, new_cost, mcc)
        else:
            rho = (cost - new_cost) / mcc
        accept = valid & (rho > 1e-3)  # Ceres min_relative_decrease
        if use_nonmonotonic_steps:
            ev = nonmonotonic_accepted(ev, new_cost, mcc, accept)
        radius_acc = torch.clamp(
            radius / torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
            max=1e16,
        )
        radius = torch.where(accept, radius_acc, radius / decrease_factor)
        decrease_factor = torch.where(
            accept, torch.full_like(decrease_factor, 2.0), decrease_factor * 2.0
        )
        converged = (accept & (torch.abs(cost - new_cost) <= 1e-7 * cost)) | (
            radius < _MIN_TRUST_REGION_RADIUS
        )
        x = torch.where(accept, new_x, x)
        cost = torch.where(accept, new_cost, cost)
        if bool(converged):  # the one host synchronisation per iteration
            break
    return model.outputs(x) + (cost,)
