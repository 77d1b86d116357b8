"""3D scan-match refinement: 6-DoF Levenberg-Marquardt on the device.

Port of `match_3d`, `match_3d_intensity`, `match_3d_batch`,
`interp_smoothstep_3d` and their helpers from
cartographer_tpu/ops/scan_matching/gauss_newton_3d.py.
Reference: internal/3d/scan_matching/ceres_scan_matcher_3d.cc with
residuals from occupied_space_cost_function_3d.h:34-77 (per point 1 - p,
p interpolated from the grid with the smoothstep tensor product of
interpolated_grid.h:36-151) over BOTH grids (weights occupied_space_weight
_0/1 / sqrt(N)), plus translation and rotation deltas from the initial
pose, and optionally intensity_cost_function_3d.cc's Huber residuals.

The pose is (t, q0 * exp(r)) over x = [t(3), r(3)]; `only_optimize_yaw`
keeps only r's z component. The eight interpolation corners are piecewise
constant in the pose, so the loop carries the corners gathered at the
accepted pose: one gather set per iteration, at the candidate pose. The
JAX package's byte-packed corner tables are a TPU gather-layout trick;
this port gathers the eight corners directly (one [8, N] gather per grid),
which gives the same corner values. The Jacobian is written out (the
smoothstep weights' derivative, the derivative of q0 * exp(r) applied to
each point, the yaw mask) where the JAX package uses jacfwd. The loop runs
`max_iterations` steps and freezes its carry once it converged, which
gives the JAX while_loop's result with no host synchronisation.

`match_3d_batch` runs the same LM over K lanes at once (a loop-closure
drain's refinements, the JAX package's vmap): every quantity carries a
leading lane axis, each lane reads its own volumes from one stack of the
drain's unique submap grids by index (no per-lane copies), and each lane
freezes on its own convergence.
"""

from __future__ import annotations

import functools

import torch

from cartographer_tpu_torch.mapping import probability_values as pv
from cartographer_tpu_torch.mapping.hybrid_grid import log_odds_to_probability
from cartographer_tpu_torch.mapping.paged_grid_3d import gather_probability_cells
from cartographer_tpu_torch.ops import frontend_common as fc
from cartographer_tpu_torch.ops.scan_matching.gauss_newton_2d import (
    nonmonotonic_accepted,
    nonmonotonic_init,
    nonmonotonic_quality,
)

@functools.lru_cache(maxsize=None)
def _corner_offsets(device) -> torch.Tensor:
    """The eight corners' (x, y, z) offsets, in the JAX package's (dz, dy,
    dx) order, as an i32 [8, 1, 3] tensor on `device` (copied there once)."""
    xyz = [(dx, dy, dz) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    return torch.tensor(xyz, dtype=torch.int32, device=device)[:, None, :]


def _gather_corners(vol, base):
    """Corner probabilities [8, N] around base cells [N, 3] (x, y, z)."""
    return gather_probability_cells(vol, base[None] + _corner_offsets(base.device))


def _quat_exp(r, with_jacobian: bool = False):
    """Exponential map: rotation vector [3] -> quaternion (Taylor-safe);
    with the Jacobian, also d q / d r [4, 3]."""
    theta2 = torch.sum(r * r)
    theta = torch.sqrt(theta2 + 1e-32)
    half = 0.5 * theta
    small = theta2 < 1e-12
    sin_h, cos_h = torch.sin(half), torch.cos(half)
    k = torch.where(small, 0.5 - theta2 / 48.0, sin_h / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, cos_h)
    q = torch.cat([w[None], r * k])
    if not with_jacobian:
        return q
    # d theta / d r = r / theta.
    dk_dtheta = (cos_h * 0.5 * theta - sin_h) / (theta * theta)
    dk = torch.where(small, -r / 24.0, dk_dtheta * r / theta)  # [3]
    dw = torch.where(small, -r / 4.0, -sin_h * 0.5 * r / theta)  # [3]
    dv = k * torch.eye(3, dtype=r.dtype, device=r.device) + r[:, None] * dk[None, :]
    return q, torch.cat([dw[None, :], dv], dim=0)


def _left_product_matrix(q):
    """The [..., 4, 4] matrix M(q) with q * p = M(q) p for quaternions p
    [..., 4]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([w, -x, -y, -z], dim=-1),
        torch.stack([x, w, -z, y], dim=-1),
        torch.stack([y, z, w, -x], dim=-1),
        torch.stack([z, -y, x, w], dim=-1),
    ], dim=-2)


def _solve_spd(a, b):
    """Solve a x = b for a small SPD a [n, n] by a column-wise Cholesky
    (diagonal clamped at 1e-20, as the JAX package's unrolled one) and two
    triangular solves: a few dozen device ops, no host synchronisation."""
    n = a.shape[-1]
    chol = torch.zeros_like(a)
    for j in range(n):
        s = a[j:, j]
        if j:
            s = s - chol[j:, :j] @ chol[j, :j]
        d = torch.sqrt(torch.clamp(s[0], min=1e-20))
        chol[j:, j] = torch.cat([d[None], s[1:] / d])
    y = torch.linalg.solve_triangular(chol, b[:, None], upper=False)
    return torch.linalg.solve_triangular(chol.T, y, upper=True)[:, 0]


def _rotate_jacobian(q, points):
    """d (q rotating each point) / d q: [N, 3, 4] (w, x, y, z), with
    rotate(q, p) = p + w t + v x t and t = 2 v x p."""
    qw, qv = q[0], q[1:4]
    t = 2.0 * fc._cross(qv, points)  # [N, 3]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    dt = 2.0 * fc._cross(eye[:, None, :], points[None])  # [3 (a), N, 3]
    d_v = qw * dt + fc._cross(eye[:, None, :], t[None]) + fc._cross(qv, dt)
    return torch.stack([t, d_v[0], d_v[1], d_v[2]], dim=-1)


def scaled(x, res):
    """x / res as the JAX package rounds it: a Python float resolution is a
    compile-time constant there, which XLA turns into a multiplication by
    its float32 reciprocal; a tensor resolution divides."""
    if isinstance(res, torch.Tensor):
        return x / res
    return x * (1.0 / res)


def _cell_coords(origin, res, points, t, q):
    """Fractional cell coordinates (u, v, w) of the points at pose (t, q)."""
    world = fc.qrot(q[None, :], points) + t[None, :]
    return scaled(world - origin[None, :], res)


def _smooth(f):
    return f * f * (3.0 - 2.0 * f)


def _interp(c, frac, with_gradient: bool = False):
    """Smoothstep trilinear interpolation of corners c [8, N] at fractional
    offsets frac [N, 3] (x, y, z), in the JAX package's operation order;
    with the gradient, also d value / d frac [N, 3]."""
    smooth = _smooth(frac)  # [N, 3], elementwise as per axis
    tx, ty, tz = smooth[:, 0], smooth[:, 1], smooth[:, 2]
    c00 = c[0] + (c[1] - c[0]) * tx
    c01 = c[2] + (c[3] - c[2]) * tx
    c10 = c[4] + (c[5] - c[4]) * tx
    c11 = c[6] + (c[7] - c[6]) * tx
    c0 = c00 + (c01 - c00) * ty
    c1 = c10 + (c11 - c10) * ty
    value = c0 + (c1 - c0) * tz
    if not with_gradient:
        return value
    d_tz = c1 - c0
    d_ty = (c01 - c00) * (1.0 - tz) + (c11 - c10) * tz
    dc0 = (c[1] - c[0]) * (1.0 - ty) + (c[3] - c[2]) * ty
    dc1 = (c[5] - c[4]) * (1.0 - ty) + (c[7] - c[6]) * ty
    d_tx = dc0 * (1.0 - tz) + dc1 * tz
    # Smoothstep derivative 6 f (1 - f): zero at voxel centers.
    ds = 6.0 * frac * (1.0 - frac)
    return value, torch.stack([d_tx, d_ty, d_tz], dim=1) * ds


def interp_smoothstep_3d(prob, u, v, w):
    """Smoothstep tensor-product interpolation of `prob` at fractional cell
    coordinates (u: x, v: y, w: z); voxel centers at integers; off-grid
    reads MIN_PROBABILITY (interpolated_grid.h's piecewise cubic). `prob`
    is a dense f32 volume, an int8 log-odds volume or a PagedGrid3D."""
    uvw = torch.stack([u, v, w], dim=-1)
    shape = uvw.shape[:-1]
    uvw = uvw.reshape(-1, 3)
    base = torch.floor(uvw).to(torch.int32)
    corners = _gather_corners(prob, base)
    return _interp(corners, uvw - base.to(uvw.dtype)).reshape(shape)


class _Grid:
    """One occupied-space (or intensity) residual block's fixed inputs."""

    def __init__(self, vol, origin, res, points, mask):
        self.vol, self.origin, self.res = vol, origin, res
        self.points, self.mask = points, mask

    def evaluate(self, t, q):
        """The corners gathered at pose (t, q) and the value there."""
        uvw = _cell_coords(self.origin, self.res, self.points, t, q)
        base = torch.floor(uvw).to(torch.int32)
        corners = _gather_corners(self.vol, base)
        return (base, corners), _interp(corners, uvw - base.to(uvw.dtype))

    def value(self, pack, t, q, with_gradient=False):
        """Interpolated value [N] at pose (t, q) from the carried corners;
        with the gradient, also d value / d world position [N, 3]."""
        base, corners = pack
        uvw = _cell_coords(self.origin, self.res, self.points, t, q)
        out = _interp(corners, uvw - base.to(uvw.dtype), with_gradient)
        if not with_gradient:
            return out
        value, grad = out
        return value, scaled(grad, self.res)


class _Residuals:
    """The LM's residuals over x = [t(3), r(3)]: the dual-grid occupied
    space blocks, the translation and rotation deltas, and optionally the
    intensity block, with their written-out Jacobian."""

    def __init__(
        self,
        grids,  # [_Grid high, _Grid low] (+ the intensity _Grid)
        initial_quat,
        target_translation,
        occupied_space_weight_0: float,
        occupied_space_weight_1: float,
        translation_weight: float,
        rotation_weight: float,
        only_optimize_yaw: bool,
        intensity=None,  # (measured [N0], weight, huber scale, threshold)
    ):
        dev = target_translation.device
        f32 = torch.float32
        high, low = grids[0], grids[1]
        n0 = torch.clamp(torch.sum(high.mask), min=1).to(f32)
        n1 = torch.clamp(torch.sum(low.mask), min=1).to(f32)
        self.grids = grids
        self.weights = [
            occupied_space_weight_0 / torch.sqrt(n0),
            occupied_space_weight_1 / torch.sqrt(n1),
        ]
        if intensity is not None:
            self.measured, i_weight, self.huber, threshold = intensity
            self.use_i = high.mask & (self.measured <= threshold)
            self.i_scale = i_weight / torch.sqrt(
                torch.clamp(torch.sum(self.use_i), min=1).to(f32)
            )
        self.rot_mask = torch.ones(3, dtype=f32, device=dev)
        if only_optimize_yaw:
            self.rot_mask = torch.zeros(3, dtype=f32, device=dev)
            self.rot_mask[2] = 1.0
        self.q0_left = _left_product_matrix(initial_quat.to(f32))
        self.target = target_translation
        self.translation_weight = translation_weight
        self.rotation_weight = rotation_weight
        # d(translation and rotation residuals) / dx, fixed.
        self.extra_jac = torch.zeros((6, 6), dtype=f32, device=dev)
        self.extra_jac[:3, :3] = translation_weight * torch.eye(3, dtype=f32, device=dev)
        self.extra_jac[3:, 3:] = torch.diag(rotation_weight * self.rot_mask)

    def decode(self, x, with_jacobian=False):
        """(t, unit q, masked r) and, on request, d q / d r [4, 3]."""
        t, r = x[:3], x[3:6] * self.rot_mask
        if not with_jacobian:
            raw = self.q0_left @ _quat_exp(r)
            return t, raw / torch.linalg.norm(raw), r
        e, de = _quat_exp(r, True)
        raw = self.q0_left @ e
        norm = torch.linalg.norm(raw)
        d_raw = self.q0_left @ de  # [4, 3]: q0 * de/dr_j
        dq = d_raw / norm - raw[:, None] * (raw @ d_raw)[None, :] / norm**3
        return t, raw / norm, r, dq * self.rot_mask[None, :]

    def _intensity(self, value, with_gradient):
        """Huber-robustified intensity residuals (IRLS factor), and their
        derivative with respect to the interpolated value."""
        huber = self.huber
        r = self.i_scale * (value - self.measured)
        s = r * r
        delta2 = huber * huber
        over = s > delta2
        s_safe = torch.where(over, s, delta2)
        factor = torch.where(
            over, torch.sqrt((2.0 * huber * torch.sqrt(s_safe) - delta2) / s_safe), 1.0
        )
        res = torch.where(self.use_i, r * factor, 0.0)
        if not with_gradient:
            return res
        # d (r * factor) / d r = huber / sqrt(2 huber |r| - huber^2) when
        # over the threshold, else 1.
        abs_r = torch.where(over, torch.abs(r), 1.0)
        d = torch.where(over, huber / (factor * abs_r), 1.0)
        return res, torch.where(self.use_i, d * self.i_scale, 0.0)

    def _assemble(self, t, r, values, grads=None, q=None, dq=None):
        """Residuals in the JAX package's order (high grid, low grid,
        translation and rotation deltas, then the intensity block) from the
        interpolated values; with their gradients, also the Jacobian."""
        parts, jacs = [], []
        for i, (g, value) in enumerate(zip(self.grids, values)):
            if i < 2:
                res = torch.where(g.mask, self.weights[i] * (1.0 - value), 0.0)
                d_value = torch.where(g.mask, -self.weights[i], 0.0)
            elif grads is None:
                res = self._intensity(value, False)
            else:
                res, d_value = self._intensity(value, True)
            parts.append(res)
            if grads is not None:
                # d world / d x = [I | d(q p)/d q . d q/d r].
                d_world_dr = _rotate_jacobian(q, g.points) @ dq  # [N, 3, 3]
                g_w = grads[i] * d_value[:, None]  # [N, 3]
                jacs.append(torch.cat(
                    [g_w, torch.einsum("nk,nkj->nj", g_w, d_world_dr)], dim=1
                ))
            if i == 1:
                parts.append(self.translation_weight * (t - self.target))
                parts.append(self.rotation_weight * r)
                jacs.append(self.extra_jac)
        if grads is None:
            return torch.cat(parts)
        return torch.cat(parts), torch.cat(jacs, dim=0)

    def evaluate(self, x):
        """The corners gathered at x and the cost there (one gather set)."""
        t, q, r = self.decode(x)
        packs, values = zip(*(g.evaluate(t, q) for g in self.grids))
        res = self._assemble(t, r, values)
        return list(packs), 0.5 * torch.sum(res * res)

    def residuals(self, x, packs):
        """Residuals at x with the corners frozen at `packs`."""
        t, q, r = self.decode(x)
        values = [g.value(p, t, q) for g, p in zip(self.grids, packs)]
        return self._assemble(t, r, values)

    def residuals_and_jacobian(self, x, packs):
        t, q, r, dq = self.decode(x, True)
        values, grads = zip(*(
            g.value(p, t, q, with_gradient=True) for g, p in zip(self.grids, packs)
        ))
        return self._assemble(t, r, values, grads, q, dq)


def _match_3d_impl(
    high_prob,
    high_origin,
    low_prob,
    low_origin,
    initial_translation,
    initial_quat,
    target_translation,
    high_points,
    high_mask,
    low_points,
    low_mask,
    high_resolution,
    low_resolution,
    occupied_space_weight_0: float,
    occupied_space_weight_1: float,
    translation_weight: float,
    rotation_weight: float,
    max_iterations: int,
    only_optimize_yaw: bool,
    intensity=None,
    use_nonmonotonic_steps: bool = False,
):
    """LM loop over the dual-grid residuals. `intensity` = (average
    intensity volume, measured intensities [N0], weight, huber scale,
    threshold) adds the intensity block over the high-resolution points.
    The resolutions are floats or 0-d tensors (see `scaled`). Returns the
    packed [8] result [t(3), q(4), cost]."""
    dev = high_points.device
    f32 = torch.float32
    grids = [
        _Grid(high_prob, high_origin, high_resolution, high_points, high_mask),
        _Grid(low_prob, low_origin, low_resolution, low_points, low_mask),
    ]
    if intensity is not None:
        grids.append(_Grid(intensity[0], high_origin, high_resolution, high_points, high_mask))
        intensity = intensity[1:]
    problem = _Residuals(
        grids, initial_quat, target_translation,
        occupied_space_weight_0, occupied_space_weight_1,
        translation_weight, rotation_weight, only_optimize_yaw, intensity,
    )
    evaluate = problem.evaluate
    residuals_and_jacobian = problem.residuals_and_jacobian
    x = torch.cat([initial_translation.to(f32), torch.zeros(3, dtype=f32, device=dev)])
    packs, cost = evaluate(x)
    lam = torch.full_like(cost, 1e-4)
    done = torch.zeros_like(cost, dtype=torch.bool)
    ev = nonmonotonic_init(cost)
    for _ in range(max_iterations):
        r, jac = residuals_and_jacobian(x, packs)
        jtj = jac.T @ jac
        jtr = jac.T @ r
        damped = jtj + lam * torch.diag(torch.diagonal(jtj) + 1e-9)
        delta = -_solve_spd(damped, jtr)
        new_x = x + delta
        new_packs, new_cost = evaluate(new_x)
        if use_nonmonotonic_steps:
            model_cost_change = -(jtr @ delta + 0.5 * delta @ (jtj @ delta))
            mcc = torch.clamp(model_cost_change, min=1e-30)
            quality = nonmonotonic_quality(ev, cost, new_cost, mcc)
            accept = (model_cost_change > 0.0) & (quality > 1e-3)
            new_ev = nonmonotonic_accepted(ev, new_cost, mcc, accept & ~done)
        else:
            accept = new_cost < cost
        # Ceres-style exit: relative cost change under the function
        # tolerance, or the trust region collapsed.
        converged = (accept & (torch.abs(cost - new_cost) <= 1e-6 * cost)) | (
            ~accept & (lam > 1e3)
        )
        accept = accept & ~done  # a converged loop's carry is frozen
        x = torch.where(accept, new_x, x)
        packs = [
            tuple(torch.where(accept, n, o) for n, o in zip(new_p, old_p))
            for new_p, old_p in zip(new_packs, packs)
        ]
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(
            done, lam, torch.where(accept, torch.clamp(lam * 0.5, min=1e-12), lam * 4.0)
        )
        if use_nonmonotonic_steps:
            ev = new_ev
        done = done | converged
    t, q, _ = problem.decode(x)
    return torch.cat([t, q, cost[None]])


def match_3d(
    high_prob,  # f32 / int8 [D, H, W] or PagedGrid3D
    high_origin,  # f32 [3]
    low_prob,
    low_origin,
    initial_translation,  # f32 [3]
    initial_quat,  # f32 [4]
    target_translation,  # f32 [3]
    high_points,  # f32 [N0, 3]
    high_mask,  # bool [N0]
    low_points,  # f32 [N1, 3]
    low_mask,  # bool [N1]
    high_resolution: float,
    low_resolution: float,
    occupied_space_weight_0: float,
    occupied_space_weight_1: float,
    translation_weight: float,
    rotation_weight: float,
    max_iterations: int = 12,
    only_optimize_yaw: bool = False,
    use_nonmonotonic_steps: bool = False,
):
    """Returns the packed [8] tensor [translation(3), quaternion(4), cost]."""
    return _match_3d_impl(
        high_prob, high_origin, low_prob, low_origin,
        initial_translation, initial_quat, target_translation,
        high_points, high_mask, low_points, low_mask,
        high_resolution, low_resolution,
        occupied_space_weight_0, occupied_space_weight_1,
        translation_weight, rotation_weight,
        max_iterations, only_optimize_yaw,
        use_nonmonotonic_steps=use_nonmonotonic_steps,
    )


def match_3d_intensity(
    high_prob,
    high_origin,
    low_prob,
    low_origin,
    intensity_avg,  # f32 [D, H, W] average intensity (0 unknown)
    initial_translation,
    initial_quat,
    target_translation,
    high_points,
    high_mask,
    high_intensities,  # f32 [N0]
    low_points,
    low_mask,
    high_resolution: float,
    low_resolution: float,
    occupied_space_weight_0: float,
    occupied_space_weight_1: float,
    intensity_weight: float,
    intensity_huber_scale: float,
    intensity_threshold: float,
    translation_weight: float,
    rotation_weight: float,
    max_iterations: int = 12,
    only_optimize_yaw: bool = False,
    use_nonmonotonic_steps: bool = False,
):
    """match_3d plus the intensity residual block
    (intensity_cost_function_3d.cc: the Huber-robustified difference
    between the interpolated average-intensity grid and the measured
    intensity, for points at or below the intensity threshold)."""
    return _match_3d_impl(
        high_prob, high_origin, low_prob, low_origin,
        initial_translation, initial_quat, target_translation,
        high_points, high_mask, low_points, low_mask,
        high_resolution, low_resolution,
        occupied_space_weight_0, occupied_space_weight_1,
        translation_weight, rotation_weight,
        max_iterations, only_optimize_yaw,
        intensity=(
            intensity_avg, high_intensities, intensity_weight,
            intensity_huber_scale, intensity_threshold,
        ),
        use_nonmonotonic_steps=use_nonmonotonic_steps,
    )


# -- K lanes at once (match_3d_batch) ---------------------------------------


def _quat_exp_lanes(r):
    """_quat_exp over lanes r [K, 3]: (q [K, 4], d q / d r [K, 4, 3])."""
    theta2 = torch.sum(r * r, dim=1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-32)
    half = 0.5 * theta
    small = theta2 < 1e-12
    sin_h, cos_h = torch.sin(half), torch.cos(half)
    k = torch.where(small, 0.5 - theta2 / 48.0, sin_h / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, cos_h)
    dk_dtheta = (cos_h * 0.5 * theta - sin_h) / (theta * theta)
    dk = torch.where(small, -r / 24.0, dk_dtheta * r / theta)  # [K, 3]
    dw = torch.where(small, -r / 4.0, -sin_h * 0.5 * r / theta)  # [K, 3]
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    dv = k[:, :, None] * eye + r[:, :, None] * dk[:, None, :]
    return torch.cat([w, r * k], dim=1), torch.cat([dw[:, None, :], dv], dim=1)


def _rotate_jacobian_lanes(q, points):
    """_rotate_jacobian over lanes: q [K, 4], points [K, N, 3] ->
    [K, N, 3, 4]."""
    qw, qv = q[:, None, 0:1], q[:, None, 1:4]
    t = 2.0 * fc._cross(qv, points)  # [K, N, 3]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    dt = 2.0 * fc._cross(eye[:, None, None, :], points[None])  # [3 (a), K, N, 3]
    d_v = qw * dt + fc._cross(eye[:, None, None, :], t[None]) + fc._cross(qv, dt)
    return torch.stack([t, d_v[0], d_v[1], d_v[2]], dim=-1)


def _solve_spd_lanes(a, b):
    """_solve_spd over lanes: a [K, n, n], b [K, n]."""
    n = a.shape[-1]
    chol = torch.zeros_like(a)
    for j in range(n):
        s = a[:, j:, j]
        if j:
            s = s - (chol[:, j:, :j] @ chol[:, j, :j, None])[:, :, 0]
        d = torch.sqrt(torch.clamp(s[:, 0], min=1e-20))
        chol[:, j:, j] = torch.cat([d[:, None], s[:, 1:] / d[:, None]], dim=1)
    y = torch.linalg.solve_triangular(chol, b[:, :, None], upper=False)
    return torch.linalg.solve_triangular(chol.transpose(1, 2), y, upper=True)[:, :, 0]


class _LaneGrid:
    """One occupied-space block's inputs for K lanes: the stacked volumes
    [G, D, H, W] (dense f32 probability or int8 log-odds) read by lane
    through `volume_index` [K], and each lane's origin [K, 3], resolution
    [K], points [K, N, 3] and mask [K, N]."""

    def __init__(self, vols, volume_index, origin, res, points, mask):
        _, d, h, w = vols.shape
        self.flat = vols.reshape(-1)
        self.int8 = vols.dtype == torch.int8
        self.lane_base = volume_index.to(torch.int64) * (d * h * w)
        self.upper = torch.tensor((w - 1, h - 1, d - 1), dtype=torch.int32, device=vols.device)
        self.strides = torch.tensor((1, w, w * h), dtype=torch.int64, device=vols.device)
        self.origin, self.res = origin, res
        self.points, self.mask = points, mask

    def coords(self, t, q):
        world = fc.qrot(q[:, None, :], self.points) + t[:, None, :]
        return scaled(world - self.origin[:, None, :], self.res[:, None, None])

    def corners(self, base):
        """Corner probabilities [8, K, N] around base cells [K, N, 3]."""
        cells = base[None] + _corner_offsets(base.device)[:, None]  # [8, K, N, 3]
        oob = torch.any((cells < 0) | (cells > self.upper), dim=-1)
        c = torch.clamp(cells, min=0).minimum(self.upper).long()
        flat = torch.sum(c * self.strides, dim=-1) + self.lane_base[None, :, None]
        vals = self.flat[flat]
        if self.int8:
            vals = log_odds_to_probability(vals)
        return torch.where(oob, pv.MIN_PROBABILITY, vals)

    def evaluate(self, t, q):
        uvw = self.coords(t, q)
        base = torch.floor(uvw).to(torch.int32)
        corners = self.corners(base)
        k, n = base.shape[:2]
        frac = (uvw - base.to(uvw.dtype)).reshape(-1, 3)
        return (base, corners), _interp(corners.reshape(8, -1), frac).reshape(k, n)

    def value(self, pack, t, q, with_gradient=False):
        base, corners = pack
        uvw = self.coords(t, q)
        k, n = base.shape[:2]
        frac = (uvw - base.to(uvw.dtype)).reshape(-1, 3)
        out = _interp(corners.reshape(8, -1), frac, with_gradient)
        if not with_gradient:
            return out.reshape(k, n)
        value, grad = out
        return value.reshape(k, n), scaled(grad.reshape(k, n, 3), self.res[:, None, None])


class _LaneResiduals:
    """_Residuals over K lanes (no intensity block)."""

    def __init__(self, grids, initial_quat, target_translation,
                 occupied_space_weight_0, occupied_space_weight_1,
                 translation_weight, rotation_weight, only_optimize_yaw):
        dev = target_translation.device
        f32 = torch.float32
        self.grids = grids
        self.weights = [
            weight / torch.sqrt(torch.clamp(torch.sum(g.mask, dim=1), min=1).to(f32))
            for g, weight in zip(grids, (occupied_space_weight_0, occupied_space_weight_1))
        ]
        self.rot_mask = torch.ones(3, dtype=f32, device=dev)
        if only_optimize_yaw:
            self.rot_mask = torch.zeros(3, dtype=f32, device=dev)
            self.rot_mask[2] = 1.0
        self.q0_left = _left_product_matrix(initial_quat.to(f32))  # [K, 4, 4]
        self.target = target_translation
        self.translation_weight = translation_weight
        self.rotation_weight = rotation_weight
        extra = torch.zeros((6, 6), dtype=f32, device=dev)
        extra[:3, :3] = translation_weight * torch.eye(3, dtype=f32, device=dev)
        extra[3:, 3:] = torch.diag(rotation_weight * self.rot_mask)
        self.extra_jac = extra.expand(target_translation.shape[0], 6, 6)

    def decode(self, x, with_jacobian=False):
        t, r = x[:, :3], x[:, 3:6] * self.rot_mask
        e, de = _quat_exp_lanes(r)
        raw = (self.q0_left @ e[:, :, None])[:, :, 0]
        norm = torch.linalg.norm(raw, dim=1, keepdim=True)
        if not with_jacobian:
            return t, raw / norm, r
        d_raw = self.q0_left @ de  # [K, 4, 3]
        dq = d_raw / norm[:, :, None] - raw[:, :, None] * (
            (raw[:, None, :] @ d_raw) / norm[:, :, None] ** 3
        )
        return t, raw / norm, r, dq * self.rot_mask

    def _assemble(self, t, r, values, grads=None, q=None, dq=None):
        parts, jacs = [], []
        for i, (g, value) in enumerate(zip(self.grids, values)):
            w = self.weights[i][:, None]
            parts.append(torch.where(g.mask, w * (1.0 - value), 0.0))
            if grads is not None:
                d_value = torch.where(g.mask, -w, 0.0)
                d_world_dr = _rotate_jacobian_lanes(q, g.points) @ dq[:, None]  # [K, N, 3, 3]
                g_w = grads[i] * d_value[:, :, None]  # [K, N, 3]
                jacs.append(torch.cat(
                    [g_w, torch.einsum("knc,kncj->knj", g_w, d_world_dr)], dim=2
                ))
        parts.append(self.translation_weight * (t - self.target))
        parts.append(self.rotation_weight * r)
        if grads is None:
            return torch.cat(parts, dim=1)
        return torch.cat(parts, dim=1), torch.cat(jacs + [self.extra_jac], dim=1)

    def evaluate(self, x):
        t, q, r = self.decode(x)
        packs, values = zip(*(g.evaluate(t, q) for g in self.grids))
        res = self._assemble(t, r, values)
        return list(packs), 0.5 * torch.sum(res * res, dim=1)

    def residuals_and_jacobian(self, x, packs):
        t, q, r, dq = self.decode(x, True)
        values, grads = zip(*(
            g.value(p, t, q, with_gradient=True) for g, p in zip(self.grids, packs)
        ))
        return self._assemble(t, r, values, grads, q, dq)


def match_3d_batch(
    high_prob,  # [G, D, H, W] volumes (f32 probability or int8 log-odds)
    high_origin,  # [K, 3]
    low_prob,  # [G, Dl, Hl, Wl]
    low_origin,  # [K, 3]
    initial_translation,  # [K, 3]
    initial_quat,  # [K, 4]
    target_translation,  # [K, 3]
    high_points,  # [K, N, 3]
    high_mask,  # [K, N]
    low_points,  # [K, Nl, 3]
    low_mask,  # [K, Nl]
    high_resolution,  # [K]
    low_resolution,  # [K]
    occupied_space_weight_0: float,
    occupied_space_weight_1: float,
    translation_weight: float,
    rotation_weight: float,
    max_iterations: int = 12,
    only_optimize_yaw: bool = False,
    use_nonmonotonic_steps: bool = False,
    volume_index=None,  # [K] lane -> volume; None: lane k reads volume k
):
    """The dual-grid LM refinement of a drain's accepted matches, all K
    lanes at once (the JAX package's vmap of _match_3d_impl). Returns [K,
    8] packed rows [t(3), q(4), cost]."""
    dev = high_points.device
    f32 = torch.float32
    k = high_points.shape[0]
    if volume_index is None:
        volume_index = torch.arange(k, device=dev)
    grids = [
        _LaneGrid(high_prob, volume_index, high_origin, high_resolution, high_points, high_mask),
        _LaneGrid(low_prob, volume_index, low_origin, low_resolution, low_points, low_mask),
    ]
    problem = _LaneResiduals(
        grids, initial_quat, target_translation,
        occupied_space_weight_0, occupied_space_weight_1,
        translation_weight, rotation_weight, only_optimize_yaw,
    )
    x = torch.cat([initial_translation.to(f32), torch.zeros((k, 3), dtype=f32, device=dev)], dim=1)
    packs, cost = problem.evaluate(x)
    lam = torch.full_like(cost, 1e-4)
    done = torch.zeros_like(cost, dtype=torch.bool)
    ev = nonmonotonic_init(cost)
    eye = torch.eye(6, dtype=f32, device=dev)
    for _ in range(max_iterations):
        r, jac = problem.residuals_and_jacobian(x, packs)
        jac_t = jac.transpose(1, 2)
        jtj = jac_t @ jac
        jtr = (jac_t @ r[:, :, None])[:, :, 0]
        diag = torch.diagonal(jtj, dim1=1, dim2=2)
        damped = jtj + lam[:, None, None] * (eye * (diag + 1e-9)[:, None, :])
        delta = -_solve_spd_lanes(damped, jtr)
        new_x = x + delta
        new_packs, new_cost = problem.evaluate(new_x)
        if use_nonmonotonic_steps:
            quad = (delta[:, None, :] @ jtj @ delta[:, :, None])[:, 0, 0]
            model_cost_change = -(torch.sum(jtr * delta, dim=1) + 0.5 * quad)
            mcc = torch.clamp(model_cost_change, min=1e-30)
            quality = nonmonotonic_quality(ev, cost, new_cost, mcc)
            accept = (model_cost_change > 0.0) & (quality > 1e-3)
            new_ev = nonmonotonic_accepted(ev, new_cost, mcc, accept & ~done)
        else:
            accept = new_cost < cost
        converged = (accept & (torch.abs(cost - new_cost) <= 1e-6 * cost)) | (
            ~accept & (lam > 1e3)
        )
        accept = accept & ~done  # a converged lane's carry is frozen
        x = torch.where(accept[:, None], new_x, x)
        packs = [
            (torch.where(accept[:, None, None], nb, ob),
             torch.where(accept[None, :, None], nc, oc))
            for (nb, nc), (ob, oc) in zip(new_packs, packs)
        ]
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(
            done, lam, torch.where(accept, torch.clamp(lam * 0.5, min=1e-12), lam * 4.0)
        )
        if use_nonmonotonic_steps:
            ev = new_ev
        done = done | converged
    t, q, _ = problem.decode(x)
    return torch.cat([t, q, cost[:, None]], dim=1)
