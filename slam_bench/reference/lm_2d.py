"""Plain reference: the 2D scan matcher's Levenberg-Marquardt refinement.

A frozen copy of the port's plain version (`gauss_newton_2d
.match_lanes_plain` and its helpers: Catmull-Rom bicubic interpolation of
the correspondence-cost grid, the occupied-space, translation and
rotation residuals, LM with diagonal damping and Ceres-style
convergence), which the card's `lm_match_2d` kernel replaces on the
timed path. `match` takes the scan matcher's own inputs (the grid's
log-odds, the prediction, the point cloud) as the frontend hands them
over, and imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# probability_values.py: the probability clamp and its correspondence cost.
MIN_PROBABILITY = 0.1
MAX_CORRESPONDENCE_COST = 1.0 - MIN_PROBABILITY


class pv:  # the names the frozen functions use
    MIN_PROBABILITY = MIN_PROBABILITY
    MAX_CORRESPONDENCE_COST = MAX_CORRESPONDENCE_COST


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




def cost_grid(log_odds, known):
    """Correspondence costs 1 - p, unknown cells at the max cost."""
    return 1.0 - torch.where(known, torch.sigmoid(log_odds), MIN_PROBABILITY)


def match(log_odds, known, origin, resolution: float, target_translation,
          initial_pose, point_cloud, options: dict):
    """The frontend's refinement (CeresScanMatcher2D.match on a
    probability grid): returns the pose (x, y, theta) as float64 numpy,
    theta in (-pi, pi]. `options` is the configuration's
    ceres_scan_matcher dict."""
    dev = log_odds.device
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    points = np.asarray(point_cloud)[:, :2]
    solver = options["ceres_solver_options"]
    pose, _ = match_lanes_plain(
        cost_grid(log_odds, known)[None],
        torch.zeros(1, dtype=torch.int32, device=dev),
        origin.reshape(1, 2).to(torch.float32),
        f32(initial_pose)[None],
        f32(target_translation)[None],
        f32(points)[None],
        torch.ones((1, len(points)), dtype=torch.bool, device=dev),
        torch.full((1,), resolution, dtype=torch.float32, device=dev),
        options["occupied_space_weight"], options["translation_weight"],
        options["rotation_weight"], solver["max_num_iterations"],
        bool(solver["use_nonmonotonic_steps"]),
    )
    out = pose[0].cpu().numpy().astype(np.float64)
    out[2] = math.remainder(out[2], 2.0 * math.pi)
    return out
