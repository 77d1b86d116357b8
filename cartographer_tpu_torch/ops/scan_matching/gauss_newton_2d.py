"""Scan-match refinement: Levenberg-Marquardt on the device.

Port of `match`, `match_log_odds`, `match_log_odds_batch_packed`,
`match_tsdf` and their helpers from
cartographer_tpu/ops/scan_matching/gauss_newton_2d.py.
Reference: internal/2d/scan_matching/ceres_scan_matcher_2d.cc:53-107 with
residuals from occupied_space_cost_function_2d.cc:30-117 (bicubic-
interpolated correspondence cost per point, scaled by
occupied_space_weight/sqrt(N)), translation_delta_cost_functor_2d.h and
rotation_delta_cost_functor_2d.h.

The same residuals, analytic normal equations (J^T J is 3x3), and a
fixed-length LM loop with gain-based lambda control, written once over a
leading lane axis (`match_lanes`): the frontend runs one lane, the
loop-closure refinement one lane per match. Bicubic interpolation is
Catmull-Rom (ceres::BiCubicInterpolator); out-of-grid reads return the
max correspondence cost. The 4x4 patch is read with a direct gather from
a shared grid stack by lane index. The loop runs `max_iterations` steps
and freezes each lane's carry once it converged, which gives the JAX
while_loop's result with no host synchronisation.

For CUDA tensors `match_lanes`, `match` and `match_log_odds_batch` launch
the hand-written kernel (kernels/lm_match_2d.py, one block per lane runs
the whole loop); for CPU tensors they run `match_lanes_plain`.
"""

from __future__ import annotations

import torch

from cartographer_tpu_torch.kernels import lm_match_2d
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
    """Solve a x = b for small SPD a ([..., n, n], n static) via unrolled
    Cholesky (the JAX package's formulation, so both round alike); leading
    axes are lanes."""
    n = a.shape[-1]
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = torch.sqrt(torch.clamp(s, min=1e-20))
            else:
                l[i][j] = s / l[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return torch.stack(x, dim=-1)


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


def _extract_patches_gather(cost_grid, iv, iu, grid_index=None):
    """4x4 patches [..., 4(rows), 4(cols)] at rows iv-1..iv+2, columns
    iu-1..iu+2; cells off the grid read MAX_CORRESPONDENCE_COST. With a
    stack of grids [S, H, W], `grid_index` [K] names each lane's grid
    (iv, iu are [K, ...]); the stack is indexed in place, never copied
    per lane."""
    offs = torch.arange(-1, 3, dtype=iv.dtype, device=iv.device)
    rows = iv[..., None, None] + offs[:, None]  # [..., 4, 1]
    cols = iu[..., None, None] + offs[None, :]  # [..., 1, 4]
    rows, cols = torch.broadcast_tensors(rows, cols)
    h, w = cost_grid.shape[-2:]
    oob = (rows < 0) | (rows >= h) | (cols < 0) | (cols >= w)
    flat = rows.clamp(0, h - 1).long() * w + cols.clamp(0, w - 1).long()
    if grid_index is not None:
        lane_base = grid_index.long() * (h * w)
        flat = flat + lane_base.reshape((-1,) + (1,) * (flat.dim() - 1))
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
    """Returns (pose [3], final cost): one lane of `match_lanes`. On CUDA
    one kernel launch, with the resolution and the grid as arguments (no
    per-call tensors but the output)."""
    if cost_grid.is_cuda:
        out = lm_match_2d.launch(
            cost_grid.contiguous(), origin, initial_pose, target_translation,
            points, point_mask, occupied_space_weight, translation_weight,
            rotation_weight, max_iterations, use_nonmonotonic_steps,
            resolution=resolution,
        )
        return out[0, :3], out[0, 3]
    dev = cost_grid.device
    pose, cost = match_lanes_plain(
        cost_grid[None],
        torch.zeros(1, dtype=torch.int32, device=dev),
        origin[None],
        initial_pose[None],
        target_translation[None],
        points[None],
        point_mask[None],
        torch.full((1,), resolution, dtype=torch.float32, device=dev),
        occupied_space_weight,
        translation_weight,
        rotation_weight,
        max_iterations,
        use_nonmonotonic_steps,
    )
    return pose[0], cost[0]


def match_lanes(
    cost_grids,  # f32 [S, H, W] correspondence costs (unknown -> 0.9)
    grid_index,  # i32 [K] each lane's grid in the stack
    origins,  # f32 [K, 2]
    initial_poses,  # f32 [K, 3]
    target_translations,  # f32 [K, 2]
    points,  # f32 [K, N, 2]
    point_masks,  # bool [K, N]
    resolutions,  # f32 [K]
    occupied_space_weight: float,
    translation_weight: float,
    rotation_weight: float,
    max_iterations: int = 20,
    use_nonmonotonic_steps: bool = False,
):
    """K independent LM refinements: returns (poses [K, 3], final costs
    [K]). The CUDA kernel for CUDA tensors, `match_lanes_plain` for CPU
    tensors."""
    if cost_grids.is_cuda:
        out = lm_match_2d.launch(
            cost_grids.contiguous(), origins, initial_poses, target_translations,
            points, point_masks, occupied_space_weight, translation_weight,
            rotation_weight, max_iterations, use_nonmonotonic_steps,
            grid_index=grid_index, resolutions=resolutions,
        )
        return out[:, :3], out[:, 3]
    return match_lanes_plain(
        cost_grids, grid_index, origins, initial_poses, target_translations,
        points, point_masks, resolutions, occupied_space_weight,
        translation_weight, rotation_weight, max_iterations,
        use_nonmonotonic_steps,
    )


def match_lanes_plain(
    cost_grids,  # f32 [S, H, W] correspondence costs (unknown -> 0.9)
    grid_index,  # i32 [K] each lane's grid in the stack
    origins,  # f32 [K, 2]
    initial_poses,  # f32 [K, 3]
    target_translations,  # f32 [K, 2]
    points,  # f32 [K, N, 2]
    point_masks,  # bool [K, N]
    resolutions,  # f32 [K]
    occupied_space_weight: float,
    translation_weight: float,
    rotation_weight: float,
    max_iterations: int = 20,
    use_nonmonotonic_steps: bool = False,
):
    """K independent LM refinements (the JAX `match` vmapped over lanes):
    returns (poses [K, 3], final costs [K]). LM with diagonal damping.

    The 4x4 bicubic patches are piecewise constant in the pose, so the
    loop carries the patch extracted at the accepted pose: one extraction
    per iteration (at the candidate), and the Jacobian at the carried
    patch, which is what jacfwd through the JAX stop_gradient computes.
    Each lane freezes its carry at its own convergence, as the vmapped
    JAX while_loop does."""
    dev = cost_grids.device
    num_points = torch.clamp(torch.sum(point_masks, dim=1), min=1)
    osw = (occupied_space_weight / torch.sqrt(num_points.to(torch.float32)))[:, None]
    res = resolutions.to(torch.float32)[:, None]
    inv_res = 1.0 / res
    px, py = points[..., 0], points[..., 1]

    def uv_of(pose):
        c, s = torch.cos(pose[:, 2:3]), torch.sin(pose[:, 2:3])
        wx = c * px - s * py + pose[:, 0:1]
        wy = s * px + c * py + pose[:, 1:2]
        u = (wx - origins[:, 0:1]) / res - 0.5
        v = (wy - origins[:, 1:2]) / res - 0.5
        return u, v, c, s

    def extract_at(pose):
        u, v, _, _ = uv_of(pose)
        iu = torch.floor(u).to(torch.int32)
        iv = torch.floor(v).to(torch.int32)
        return _extract_patches_gather(cost_grids, iv, iu, grid_index), iu, iv

    def extra_res(pose):
        return torch.stack(
            [
                translation_weight * (pose[:, 0] - target_translations[:, 0]),
                translation_weight * (pose[:, 1] - target_translations[:, 1]),
                rotation_weight * (pose[:, 2] - initial_poses[:, 2]),
            ],
            dim=1,
        )

    def res_given_patch(pose, patch, iu, iv):
        """Residuals [K, N + 3] with the grid read frozen at (patch, iu, iv)."""
        u, v, _, _ = uv_of(pose)
        wu = _cubic_weights(u - iu.to(torch.float32))
        wv = _cubic_weights(v - iv.to(torch.float32))
        occ = torch.einsum("kni,knij,knj->kn", wv, patch, wu) * osw
        occ = torch.where(point_masks, occ, 0.0)
        return torch.cat([occ, extra_res(pose)], dim=1)

    def jac_given_patch(pose, patch, iu, iv):
        """Analytic d(residuals)/d(pose) [K, N + 3, 3] at the frozen patch."""
        u, v, c, s = uv_of(pose)
        tu = u - iu.to(torch.float32)
        tv = v - iv.to(torch.float32)
        wu, wv = _cubic_weights(tu), _cubic_weights(tv)
        dwu, dwv = _cubic_weights_d(tu), _cubic_weights_d(tv)
        d_du = torch.einsum("kni,knij,knj->kn", wv, patch, dwu) * osw
        d_dv = torch.einsum("kni,knij,knj->kn", dwv, patch, wu) * osw
        du_dth = (-s * px - c * py) * inv_res
        dv_dth = (c * px - s * py) * inv_res
        occ_jac = torch.stack(
            [d_du * inv_res, d_dv * inv_res, d_du * du_dth + d_dv * dv_dth],
            dim=2,
        )
        occ_jac = torch.where(point_masks[:, :, None], occ_jac, 0.0)
        return torch.cat([occ_jac, extra_jac.expand(len(pose), 3, 3)], dim=1)

    def cost_of(r):
        return 0.5 * torch.sum(r * r, dim=1)

    pose = initial_poses.to(torch.float32)
    # d(extra residuals)/d(pose) = diag(tw, tw, rw), built by fills.
    extra_jac = torch.zeros((1, 3, 3), dtype=torch.float32, device=dev)
    extra_jac[0, 0, 0] = translation_weight
    extra_jac[0, 1, 1] = translation_weight
    extra_jac[0, 2, 2] = rotation_weight
    patch, iu, iv = extract_at(pose)
    cost = cost_of(res_given_patch(pose, patch, iu, iv))
    lam = torch.full_like(cost, 1e-4)
    done = torch.zeros_like(cost, dtype=torch.bool)
    ev = nonmonotonic_init(cost)
    for _ in range(max_iterations):
        r = res_given_patch(pose, patch, iu, iv)
        jac = jac_given_patch(pose, patch, iu, iv)  # [K, R, 3]
        jac_t = jac.transpose(1, 2)
        jtj = torch.bmm(jac_t, jac)
        jtr = torch.bmm(jac_t, r[:, :, None])[:, :, 0]
        damped = jtj + lam[:, None, None] * torch.diag_embed(
            torch.diagonal(jtj, dim1=1, dim2=2)
        )
        delta = -solve_spd_small(damped, jtr)
        new_pose = pose + delta
        new_patch, new_iu, new_iv = extract_at(new_pose)
        new_cost = cost_of(res_given_patch(new_pose, new_patch, new_iu, new_iv))
        if use_nonmonotonic_steps:
            jtj_delta = torch.bmm(jtj, delta[:, :, None])[:, :, 0]
            model_cost_change = -(
                torch.sum(jtr * delta, dim=1)
                + 0.5 * torch.sum(delta * jtj_delta, dim=1)
            )
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
        # Once converged a lane's carry is frozen (its while_loop exits).
        accept = accept & ~done
        pose = torch.where(accept[:, None], new_pose, pose)
        patch = torch.where(accept[:, None, None, None], new_patch, patch)
        iu = torch.where(accept[:, None], new_iu, iu)
        iv = torch.where(accept[:, None], new_iv, iv)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(
            done, lam, torch.where(accept, torch.clamp(lam * 0.5, min=1e-12), lam * 4.0)
        )
        if use_nonmonotonic_steps:
            ev = new_ev
        done = done | converged
    return pose, cost


def interp_bilinear_tsdf(tsd, weight, u, v, max_cost: float, with_gradient: bool = False):
    """Bilinear TSD + weight interpolation; any zero-weight corner yields
    (max_cost with zero gradient, weight 0) — InterpolatedTSDF2D
    semantics. Cells off the grid read (max_cost, 0). With
    `with_gradient`, also returns the (u, v) derivatives of both as
    (dcost_du, dcost_dv, dwt_du, dwt_dv)."""
    h, w = tsd.shape
    iu = torch.floor(u).to(torch.int32)
    iv = torch.floor(v).to(torch.int32)
    tu = u - iu.to(u.dtype)
    tv = v - iv.to(v.dtype)

    def corner(grid, dy, dx, fill):
        rows = iv + dy
        cols = iu + dx
        oob = (rows < 0) | (rows >= h) | (cols < 0) | (cols >= w)
        flat = rows.clamp(0, h - 1).long() * w + cols.clamp(0, w - 1).long()
        return torch.where(oob, fill, grid.reshape(-1)[flat])

    q11 = corner(tsd, 0, 0, max_cost)
    q12 = corner(tsd, 0, 1, max_cost)
    q21 = corner(tsd, 1, 0, max_cost)
    q22 = corner(tsd, 1, 1, max_cost)
    w11 = corner(weight, 0, 0, 0.0)
    w12 = corner(weight, 0, 1, 0.0)
    w21 = corner(weight, 1, 0, 0.0)
    w22 = corner(weight, 1, 1, 0.0)
    cost = (
        q11 * (1 - tu) * (1 - tv)
        + q12 * tu * (1 - tv)
        + q21 * (1 - tu) * tv
        + q22 * tu * tv
    )
    wt = (
        w11 * (1 - tu) * (1 - tv)
        + w12 * tu * (1 - tv)
        + w21 * (1 - tu) * tv
        + w22 * tu * tv
    )
    known = (w11 != 0) & (w12 != 0) & (w21 != 0) & (w22 != 0)
    cost = torch.where(known, cost, max_cost)
    wt = torch.where(known, wt, 0.0)
    if not with_gradient:
        return cost, wt

    def d(q11, q12, q21, q22):
        du = (q12 - q11) * (1 - tv) + (q22 - q21) * tv
        dv = (q21 - q11) * (1 - tu) + (q22 - q12) * tu
        return torch.where(known, du, 0.0), torch.where(known, dv, 0.0)

    return (cost, wt, *d(q11, q12, q21, q22), *d(w11, w12, w21, w22))


def match_tsdf(
    tsd,  # f32 [H, W]
    weight,  # f32 [H, W]
    origin,  # f32 [2]
    initial_pose,  # f32 [3]
    target_translation,  # f32 [2]
    points,  # f32 [N, 2]
    point_mask,  # bool [N]
    resolution: float,
    truncation_distance: float,
    occupied_space_weight: float,
    translation_weight: float,
    rotation_weight: float,
    max_iterations: int = 20,
    use_nonmonotonic_steps: bool = False,
):
    """TSDF refinement (tsdf_match_cost_function_2d.cc: weight-normalized
    interpolated TSD residuals + translation/rotation deltas); returns
    (pose [3], final cost). The Jacobian that the JAX function takes with
    jacfwd is written out (the weight normalization differentiated too);
    its while_loop is `max_iterations` steps that freeze the carry once
    converged, so nothing is read back to the host."""
    dev = tsd.device
    num_points = torch.clamp(torch.sum(point_mask), min=1).to(torch.float32)
    scale = num_points * (occupied_space_weight / torch.sqrt(num_points))
    initial_pose = initial_pose.to(torch.float32)
    px, py = points[:, 0], points[:, 1]

    def extra_res(pose):
        return torch.cat(
            [
                translation_weight * (pose[:2] - target_translation),
                rotation_weight * (pose[2:] - initial_pose[2:]),
            ]
        )

    def residuals(pose, with_jacobian=False):
        c, s = torch.cos(pose[2]), torch.sin(pose[2])
        wx = c * px - s * py + pose[0]
        wy = s * px + c * py + pose[1]
        u = (wx - origin[0]) / resolution - 0.5
        v = (wy - origin[1]) / resolution - 0.5
        out = interp_bilinear_tsdf(tsd, weight, u, v, truncation_distance, with_jacobian)
        cost, wt = out[0], torch.where(point_mask, out[1], 0.0)
        total = torch.sum(wt)
        summed = torch.clamp(total, min=1e-9)
        occ = torch.where(point_mask, scale * cost * wt / summed, 0.0)
        r = torch.cat([occ, extra_res(pose)])
        if not with_jacobian:
            return r
        dcost_du, dcost_dv, dwt_du, dwt_dv = out[2:]
        dwt_du = torch.where(point_mask, dwt_du, 0.0)
        dwt_dv = torch.where(point_mask, dwt_dv, 0.0)
        # d(u, v)/d(x, y, theta): u moves with x, v with y, both with theta.
        du_dth = (-s * px - c * py) / resolution
        dv_dth = (c * px - s * py) / resolution
        inv_res = 1.0 / resolution

        def d_pose(d_du, d_dv):  # [N] derivatives in u, v -> [N, 3]
            return torch.stack(
                [d_du * inv_res, d_dv * inv_res, d_du * du_dth + d_dv * dv_dth], dim=1
            )

        d_cost = d_pose(dcost_du, dcost_dv)
        d_wt = d_pose(dwt_du, dwt_dv)
        d_summed = torch.where(total > 1e-9, torch.sum(d_wt, dim=0), 0.0)  # [3]
        d_occ = scale * (
            (d_cost * wt[:, None] + cost[:, None] * d_wt) / summed
            - (cost * wt)[:, None] * d_summed[None, :] / (summed * summed)
        )
        d_occ = torch.where(point_mask[:, None], d_occ, 0.0)
        return r, torch.cat([d_occ, extra_jac], dim=0)

    def cost_of(r):
        return 0.5 * torch.sum(r * r)

    extra_jac = torch.zeros((3, 3), dtype=torch.float32, device=dev)
    extra_jac[0, 0] = translation_weight
    extra_jac[1, 1] = translation_weight
    extra_jac[2, 2] = rotation_weight
    pose = initial_pose
    cost = cost_of(residuals(pose))
    lam = torch.full_like(cost, 1e-4)
    done = torch.zeros_like(cost, dtype=torch.bool)
    ev = nonmonotonic_init(cost)
    for _ in range(max_iterations):
        r, jac = residuals(pose, with_jacobian=True)
        jtj = jac.T @ jac
        jtr = jac.T @ r
        damped = jtj + lam * torch.diag(torch.diagonal(jtj) + 1e-9)
        delta = -solve_spd_small(damped, jtr)
        new_pose = pose + delta
        new_cost = cost_of(residuals(new_pose))
        if use_nonmonotonic_steps:
            model_cost_change = -(jtr @ delta + 0.5 * delta @ (jtj @ delta))
            mcc = torch.clamp(model_cost_change, min=1e-30)
            quality = nonmonotonic_quality(ev, cost, new_cost, mcc)
            accept = (model_cost_change > 0.0) & (quality > 1e-3)
            ev = nonmonotonic_accepted(ev, new_cost, mcc, accept & ~done)
        else:
            accept = new_cost < cost
        # Ceres-style convergence: relative cost change below the
        # function tolerance, or the trust region collapsed (lambda huge).
        converged = (accept & (torch.abs(cost - new_cost) <= 1e-6 * cost)) | (
            ~accept & (lam > 1e3)
        )
        step = accept & ~done
        pose = torch.where(step, new_pose, pose)
        cost = torch.where(step, new_cost, cost)
        lam = torch.where(
            done, lam, torch.where(accept, torch.clamp(lam * 0.5, min=1e-12), lam * 4.0)
        )
        done = done | converged
    return pose, cost


def cost_grids_from_log_odds(log_odds, known):
    """Correspondence costs 1 - p, unknown cells at MAX_CORRESPONDENCE_COST
    (works on one grid or a stack)."""
    return 1.0 - torch.where(known, torch.sigmoid(log_odds), pv.MIN_PROBABILITY)


def match_log_odds(
    log_odds,  # f32 [H, W]
    known,  # bool [H, W]
    origin,
    initial_pose,
    target_translation,
    points,
    point_mask,
    resolution: float,
    occupied_space_weight: float,
    translation_weight: float,
    rotation_weight: float,
    max_iterations: int = 20,
    use_nonmonotonic_steps: bool = False,
):
    """match() on a log-odds grid (the conversion to correspondence costs
    done here)."""
    return match(
        cost_grids_from_log_odds(log_odds, known),
        origin,
        initial_pose,
        target_translation,
        points,
        point_mask,
        resolution,
        occupied_space_weight,
        translation_weight,
        rotation_weight,
        max_iterations,
        use_nonmonotonic_steps,
    )


def match_log_odds_batch(
    log_odds,  # f32 [S, H, W] stacked unique submap grids
    known,  # bool [S, H, W]
    cloud_pts,  # f32 [U, N, 2] stacked unique node clouds
    cloud_msk,  # bool [U, N]
    origins,  # f32 [K, 2]
    initial_poses,  # f32 [K, 3]
    target_translations,  # f32 [K, 2]
    resolutions,  # f32 [K]
    sidx,  # i32 [K] each match's grid in the stack
    rows,  # i32 [K] each match's cloud in the stack
    occupied_space_weight: float,
    translation_weight: float,
    rotation_weight: float,
    max_iterations: int = 20,
    use_nonmonotonic_steps: bool = False,
):
    """Port of `match_log_odds_batch_packed`: K loop-closure refinements in
    one batched LM. The small per-match arrays are plain tensors (the JAX
    version packed them into one uint8 upload for a remote-attached TPU);
    each lane reads its grid from the shared stack by index, while its
    cloud ([N, 2], small) is gathered (on CUDA the kernel reads it by
    index too). Returns [K, 4] rows (x, y, theta, cost)."""
    cost_grids = cost_grids_from_log_odds(log_odds, known)
    if cost_grids.is_cuda:
        return lm_match_2d.launch(
            cost_grids, origins, initial_poses, target_translations, cloud_pts,
            cloud_msk, occupied_space_weight, translation_weight,
            rotation_weight, max_iterations, use_nonmonotonic_steps,
            grid_index=sidx, cloud_rows=rows, resolutions=resolutions,
        )
    rows = rows.long()
    poses, costs = match_lanes_plain(
        cost_grids,
        sidx,
        origins,
        initial_poses,
        target_translations,
        cloud_pts[rows],
        cloud_msk[rows],
        resolutions,
        occupied_space_weight,
        translation_weight,
        rotation_weight,
        max_iterations,
        use_nonmonotonic_steps,
    )
    return torch.cat([poses, costs[:, None]], dim=1)
