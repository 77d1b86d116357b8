"""Plain reference: 2D sparse pose adjustment, solved to its minimum.

Written from the cost that cartographer's 2D optimization problem states
(`spa_cost_function_2d.h`, `cost_helpers_impl.h`), not from the port's
solver. Each row ties a start pose to an end pose through an observed
relative pose z: the error is z minus T_start^-1 T_end as (x, y, angle),
the angle wrapped into (-pi, pi], scaled per row by its translation and
rotation weights. Rows marked for it go through Ceres's HuberLoss: a row
of squared norm s costs s/2 up to a^2 and (2 a sqrt(s) - a^2)/2 above.
The rows are submap-to-node constraints and node-to-node local SLAM
consistency terms; poses that are not free stay where they are.

The minimum is found in float64 by damped Gauss-Newton on the dense
normal equations, each row's Jacobian taken by automatic differentiation
of the robustified residual, until the step is nought to rounding. It
reads the problem's tables by field name and imports nothing of the
program.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def _rows(p):
    """(start, end, z, weights [R, 3], huber [R]) of every row in use, as
    indices into the pose table [submaps; nodes]."""
    s = p.submap_poses.shape[0]
    cm, nm = p.c_mask.bool(), p.n_mask.bool()
    start = torch.cat([p.c_submap.long()[cm], p.n_a.long()[nm] + s])
    end = torch.cat([p.c_node.long()[cm] + s, p.n_b.long()[nm] + s])
    z = torch.cat([p.c_z[cm], p.n_z[nm]]).to(F64)
    w = torch.cat([p.c_weight[cm], p.n_weight[nm]]).to(F64)
    w3 = torch.stack([w[:, 0], w[:, 0], w[:, 1]], 1)
    huber = torch.cat([p.c_huber.bool()[cm], torch.zeros_like(nm[nm])])
    return start, end, z, w3, huber


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def residual(start, end, z, w3, huber, a: float):
    """One row's robustified residual [3]: its squared norm is twice the
    row's cost."""
    c, s = torch.cos(start[2]), torch.sin(start[2])
    dx, dy = end[0] - start[0], end[1] - start[1]
    rel = torch.stack([c * dx + s * dy, -s * dx + c * dy, end[2] - start[2]])
    e = z - rel
    r = w3 * torch.stack([e[0], e[1], _wrap(e[2])])
    sq = torch.sum(r * r)
    over = huber & (sq > a * a)
    safe = torch.where(over, sq, torch.ones_like(sq))
    scale = torch.where(over, torch.sqrt((2.0 * a * torch.sqrt(safe) - a * a) / safe),
                        torch.ones_like(sq))
    return r * scale


def cost(p, poses, a: float):
    """The problem's cost at poses [S + N, 3] (float64)."""
    start, end, z, w3, huber = _rows(p)
    r = torch.vmap(residual, in_dims=(0, 0, 0, 0, 0, None))(
        poses[start], poses[end], z, w3, huber, a)
    return 0.5 * float(torch.sum(r * r))


def solve(p, huber_scale: float, max_iterations: int = 200):
    """(submap poses [S, 3], node poses [N, 3], cost) at the problem's
    minimum near its initial poses, in float64."""
    a = float(huber_scale)
    x = torch.cat([p.submap_poses, p.node_poses]).to(F64)
    free = torch.cat([p.free_submap, p.free_node]).bool()
    start, end, z, w3, huber = _rows(p)
    n = x.shape[0]
    jac = torch.vmap(torch.func.jacrev(residual, argnums=(0, 1)), in_dims=(0, 0, 0, 0, 0, None))
    res = torch.vmap(residual, in_dims=(0, 0, 0, 0, 0, None))
    # Each row's six unknowns in the flat [3 n] vector.
    k3 = torch.arange(3, device=x.device)
    cols = torch.cat([3 * start[:, None] + k3, 3 * end[:, None] + k3], 1)  # [R, 6]
    keep = free.repeat_interleave(3)
    lam = 1e-6
    current = cost(p, x, a)
    for _ in range(max_iterations):
        r = res(x[start], x[end], z, w3, huber, a)  # [R, 3]
        ja, jb = jac(x[start], x[end], z, w3, huber, a)
        j = torch.cat([ja, jb], 2)  # [R, 3, 6]
        h = torch.zeros(3 * n, 3 * n, dtype=F64, device=x.device)
        jtj = torch.einsum("rki,rkj->rij", j, j)
        h.index_put_((cols[:, :, None].expand(-1, -1, 6), cols[:, None, :].expand(-1, 6, -1)),
                     jtj, accumulate=True)
        g = torch.zeros(3 * n, dtype=F64, device=x.device)
        g.index_put_((cols,), torch.einsum("rki,rk->ri", j, r), accumulate=True)
        hf, gf = h[keep][:, keep], g[keep]
        while True:
            damped = hf + lam * torch.diag(torch.diagonal(hf).clamp(min=1e-12))
            step = torch.zeros(3 * n, dtype=F64, device=x.device)
            step[keep] = -torch.linalg.solve(damped, gf)
            trial = x + step.reshape(n, 3)
            trial_cost = cost(p, trial, a)
            if trial_cost <= current:
                break
            lam *= 10.0
            if lam > 1e12:
                break
        if trial_cost > current:
            break
        done = float(step.abs().max()) < 1e-12 or current - trial_cost <= 1e-15 * current
        x, current = trial, trial_cost
        lam = max(lam * 0.1, 1e-12)
        if done:
            break
    x = torch.cat([x[:, :2], _wrap(x[:, 2:3])], 1)
    s = p.submap_poses.shape[0]
    return x[:s], x[s:], current
