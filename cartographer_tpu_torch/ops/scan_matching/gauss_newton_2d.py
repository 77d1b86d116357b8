"""Scan-match refinement: Levenberg-Marquardt on the device.

Port of `match` and its helpers from
cartographer_tpu/ops/scan_matching/gauss_newton_2d.py. Reference:
internal/2d/scan_matching/ceres_scan_matcher_2d.cc:53-107 with residuals
from occupied_space_cost_function_2d.cc:30-117 (bicubic-interpolated
correspondence cost per point, scaled by occupied_space_weight/sqrt(N)),
translation_delta_cost_functor_2d.h and rotation_delta_cost_functor_2d.h.

The same residuals, analytic normal equations (J^T J is 3x3), and a
fixed-length LM loop with gain-based lambda control. Bicubic
interpolation is Catmull-Rom (ceres::BiCubicInterpolator); out-of-grid
reads return the max correspondence cost. The 4x4 patch is read with a
direct gather. The loop runs `max_iterations` steps and freezes its carry
once converged, which gives the JAX while_loop's result with no host
synchronisation.
"""

from __future__ import annotations

import torch

from cartographer_tpu_torch.mapping import probability_values as pv

# Ceres TrustRegionStepEvaluator (Conn/Gould/Toint Algorithm 10.1.2)
# state and transitions. The reference enables use_nonmonotonic_steps for
# the constraint builder's refinement matcher by default (pose_graph.lua:35).
_MAX_CONSECUTIVE_NONMONOTONIC_STEPS = 5


def nonmonotonic_init(cost0):
    """(minimum, reference, candidate costs; accumulated reference /
    candidate model cost changes; consecutive nonmonotonic steps)."""
    z = torch.zeros_like(cost0)
    n = torch.zeros((), dtype=torch.int32, device=cost0.device)
    return (cost0, cost0, cost0, z, z, n)


def nonmonotonic_quality(ev, cost, new_cost, mcc):
    """Step quality = max(current, historical relative decrease)."""
    _, reference_cost, _, acc_ref, _, _ = ev
    relative = (cost - new_cost) / mcc
    historical = (reference_cost - new_cost) / (acc_ref + mcc)
    return torch.maximum(relative, historical)


def nonmonotonic_accepted(ev, new_cost, mcc, accept):
    """Evaluator transition applied on accepted steps (no-op otherwise)."""
    minimum_cost, reference_cost, candidate_cost, acc_ref, acc_cand, n = ev
    improved = new_cost < minimum_cost
    n_new = torch.where(improved, 0, n + 1).to(n.dtype)
    reset_cand = improved | (new_cost > candidate_cost)
    cand_new = torch.where(reset_cand, new_cost, candidate_cost)
    acc_cand_new = torch.where(reset_cand, 0.0, acc_cand)
    promote = n_new == _MAX_CONSECUTIVE_NONMONOTONIC_STEPS
    ref_new = torch.where(promote, cand_new, reference_cost)
    acc_ref_new = torch.where(promote, acc_cand_new, acc_ref)
    return (
        torch.where(accept & improved, new_cost, minimum_cost),
        torch.where(accept, ref_new, reference_cost),
        torch.where(accept, cand_new, candidate_cost),
        torch.where(accept, acc_ref_new + mcc, acc_ref),
        torch.where(accept, acc_cand_new + mcc, acc_cand),
        torch.where(accept, n_new, n),
    )


def solve_spd_small(a, b):
    """Solve a x = b for a small SPD a ([n, n], n static) via unrolled
    Cholesky (the JAX package's formulation, so both round alike)."""
    n = a.shape[0]
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = torch.sqrt(torch.clamp(s, min=1e-20))
            else:
                l[i][j] = s / l[j][j]
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return torch.stack(x)


def _cubic_weights(t):
    """Catmull-Rom basis for samples at offsets (-1, 0, 1, 2)."""
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return torch.stack([w0, w1, w2, w3], dim=-1)


def _cubic_weights_d(t):
    """d/dt of the Catmull-Rom basis."""
    t2 = t * t
    w0 = -1.5 * t2 + 2.0 * t - 0.5
    w1 = 4.5 * t2 - 5.0 * t
    w2 = -4.5 * t2 + 4.0 * t + 0.5
    w3 = 1.5 * t2 - t
    return torch.stack([w0, w1, w2, w3], dim=-1)


def _extract_patches_gather(cost_grid, iv, iu):
    """4x4 patches [..., 4(rows), 4(cols)] at rows iv-1..iv+2, columns
    iu-1..iu+2; cells off the grid read MAX_CORRESPONDENCE_COST."""
    offs = torch.arange(-1, 3, dtype=iv.dtype, device=iv.device)
    rows = iv[..., None, None] + offs[:, None]  # [..., 4, 1]
    cols = iu[..., None, None] + offs[None, :]  # [..., 1, 4]
    rows, cols = torch.broadcast_tensors(rows, cols)
    h, w = cost_grid.shape
    oob = (rows < 0) | (rows >= h) | (cols < 0) | (cols >= w)
    flat = rows.clamp(0, h - 1).long() * w + cols.clamp(0, w - 1).long()
    patch = cost_grid.reshape(-1)[flat]
    return torch.where(oob, pv.MAX_CORRESPONDENCE_COST, patch)


def match(
    cost_grid,  # f32 [H, W] correspondence cost (unknown -> 0.9)
    origin,  # f32 [2]
    initial_pose,  # f32 [3]
    target_translation,  # f32 [2]
    points,  # f32 [N, 2]
    point_mask,  # bool [N]
    resolution: float,
    occupied_space_weight: float,
    translation_weight: float,
    rotation_weight: float,
    max_iterations: int = 20,
    use_nonmonotonic_steps: bool = False,
):
    """Returns (pose [3], final cost). LM with diagonal damping.

    The 4x4 bicubic patches are piecewise constant in the pose, so the
    loop carries the patch extracted at the accepted pose: one extraction
    per iteration (at the candidate), and the Jacobian at the carried
    patch, which is what jacfwd through the JAX stop_gradient computes."""
    num_points = torch.clamp(torch.sum(point_mask), min=1)
    osw = occupied_space_weight / torch.sqrt(num_points.to(torch.float32))
    inv_res = 1.0 / resolution
    px, py = points[:, 0], points[:, 1]

    def uv_of(pose):
        c, s = torch.cos(pose[2]), torch.sin(pose[2])
        wx = c * px - s * py + pose[0]
        wy = s * px + c * py + pose[1]
        u = (wx - origin[0]) / resolution - 0.5
        v = (wy - origin[1]) / resolution - 0.5
        return u, v, c, s

    def extract_at(pose):
        u, v, _, _ = uv_of(pose)
        iu = torch.floor(u).to(torch.int32)
        iv = torch.floor(v).to(torch.int32)
        return _extract_patches_gather(cost_grid, iv, iu), iu, iv

    def extra_res(pose):
        return torch.stack(
            [
                translation_weight * (pose[0] - target_translation[0]),
                translation_weight * (pose[1] - target_translation[1]),
                rotation_weight * (pose[2] - initial_pose[2]),
            ]
        )

    def res_given_patch(pose, patch, iu, iv):
        """Residuals with the grid read frozen at (patch, iu, iv)."""
        u, v, _, _ = uv_of(pose)
        wu = _cubic_weights(u - iu.to(torch.float32))
        wv = _cubic_weights(v - iv.to(torch.float32))
        occ = torch.einsum("ni,nij,nj->n", wv, patch, wu) * osw
        occ = torch.where(point_mask, occ, 0.0)
        return torch.cat([occ, extra_res(pose)])

    def jac_given_patch(pose, patch, iu, iv):
        """Analytic d(residuals)/d(pose) [N + 3, 3] at the frozen patch."""
        u, v, c, s = uv_of(pose)
        tu = u - iu.to(torch.float32)
        tv = v - iv.to(torch.float32)
        wu, wv = _cubic_weights(tu), _cubic_weights(tv)
        dwu, dwv = _cubic_weights_d(tu), _cubic_weights_d(tv)
        d_du = torch.einsum("ni,nij,nj->n", wv, patch, dwu) * osw
        d_dv = torch.einsum("ni,nij,nj->n", dwv, patch, wu) * osw
        du_dth = (-s * px - c * py) * inv_res
        dv_dth = (c * px - s * py) * inv_res
        occ_jac = torch.stack(
            [d_du * inv_res, d_dv * inv_res, d_du * du_dth + d_dv * dv_dth],
            dim=1,
        )
        occ_jac = torch.where(point_mask[:, None], occ_jac, 0.0)
        return torch.cat([occ_jac, extra_jac])

    def cost_of(r):
        return 0.5 * torch.sum(r * r)

    pose = initial_pose.to(torch.float32)
    # d(extra residuals)/d(pose) = diag(tw, tw, rw), built by fills.
    extra_jac = torch.zeros((3, 3), dtype=torch.float32, device=pose.device)
    extra_jac[0, 0] = translation_weight
    extra_jac[1, 1] = translation_weight
    extra_jac[2, 2] = rotation_weight
    patch, iu, iv = extract_at(pose)
    cost = cost_of(res_given_patch(pose, patch, iu, iv))
    lam = torch.full((), 1e-4, dtype=torch.float32, device=pose.device)
    done = torch.zeros((), dtype=torch.bool, device=pose.device)
    ev = nonmonotonic_init(cost)
    for _ in range(max_iterations):
        r = res_given_patch(pose, patch, iu, iv)
        jac = jac_given_patch(pose, patch, iu, iv)  # [R, 3]
        jtj = jac.T @ jac
        jtr = jac.T @ r
        damped = jtj + lam * torch.diag(torch.diag(jtj))
        delta = -solve_spd_small(damped, jtr)
        new_pose = pose + delta
        new_patch, new_iu, new_iv = extract_at(new_pose)
        new_cost = cost_of(res_given_patch(new_pose, new_patch, new_iu, new_iv))
        if use_nonmonotonic_steps:
            model_cost_change = -(jtr @ delta + 0.5 * delta @ (jtj @ delta))
            mcc = torch.clamp(model_cost_change, min=1e-30)
            quality = nonmonotonic_quality(ev, cost, new_cost, mcc)
            accept = (model_cost_change > 0.0) & (quality > 1e-3)
            new_ev = nonmonotonic_accepted(ev, new_cost, mcc, accept & ~done)
        else:
            accept = new_cost < cost
        # Ceres-style convergence: relative cost change below the
        # function tolerance, or the trust region collapsed (lambda huge).
        converged = (accept & (torch.abs(cost - new_cost) <= 1e-6 * cost)) | (
            ~accept & (lam > 1e3)
        )
        # Once converged the carry is frozen (the JAX while_loop exits).
        accept = accept & ~done
        pose = torch.where(accept, new_pose, pose)
        patch = torch.where(accept, new_patch, patch)
        iu = torch.where(accept, new_iu, iu)
        iv = torch.where(accept, new_iv, iv)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(
            done, lam, torch.where(accept, torch.clamp(lam * 0.5, min=1e-12), lam * 4.0)
        )
        if use_nonmonotonic_steps:
            ev = new_ev
        done = done | converged
    return pose, cost
