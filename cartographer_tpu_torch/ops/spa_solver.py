"""Sparse pose adjustment (SPA) solver on the device.

Port of cartographer_tpu/ops/spa_solver.py. Reference:
internal/optimization/optimization_problem_2d.cc:204-470 — Ceres nonlinear
least squares over (x, y, theta) per submap and node with submap-node
constraints (spa_cost_function_2d.cc, Huber loss on INTER constraints),
consecutive-node local-SLAM and odometry residuals, optional landmark and
fixed-frame residuals, and fixed parameter blocks.

The same matrix-free Levenberg-Marquardt with Ceres's trust-region
dynamics: Jacobi-scaled damping D^T D / radius, step quality rho from the
linearized model, optional nonmonotonic steps, and the damped normal
equations solved by Jacobi-preconditioned conjugate gradients with the
stopping rule of jax.scipy.sparse.linalg.cg (||r|| <= 1e-6 ||b||).

Where the JAX code differentiates with jax.jvp / jax.vjp / jacfwd, the
Jacobian here is written out: every residual row depends on two poses
through three closed-form lines (`_spa_error`), so each row carries two
3x3 blocks (the Huber factor's derivative folded in), J v is a batched
3x3 product and J^T u an `index_add_` scatter. All poses live in one
[S + N + L + T, 3] table. One host synchronisation per LM iteration reads
the stop flag; CG runs its `cg_iterations` steps with the carry frozen
once converged, as the port's `gauss_newton_2d.match` does.

`solve` runs CUDA tensors without a mesh through the hand-written kernel
`kernels/spa_2d` (`csrc/spa_2d.cu`): one launch an LM iteration, the same
arithmetic, CG stopped where the plain loop freezes. `solve_plain`, the
eager version, runs CPU tensors and every solve with a mesh. Both set the
gauges `metrics.spa_lm_iterations` and `metrics.spa_cg_steps`. The
kernel's atomics and `index_add_` on CUDA are not deterministic, so a
solve on the card agrees with one on the CPU within a tolerance, not bit
for bit.

With a `mesh` (parallel/partition.Mesh) the residual tables are this
rank's rows and the pose tables are replicated: every sum over residual
rows (J^T u once per CG step and for the gradient, the Jacobi diagonal,
the costs and the model-change dots) is all-reduced over the mesh, so
every rank holds the same poses and takes the same branches. Sums over
pose vectors (the CG dots) stay local. Without a mesh no collective runs.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.kernels import spa_2d
from cartographer_tpu_torch.ops.scan_matching.gauss_newton_2d import (
    nonmonotonic_accepted,
    nonmonotonic_init,
    nonmonotonic_quality,
)
from cartographer_tpu_torch.parallel.partition import all_reduce


class SpaExtras(NamedTuple):
    """Optional landmark + fixed-frame (GPS) residual tables.

    Landmarks (landmark_cost_function_2d.h): each observation ties the
    landmark pose to the pose interpolated between two bracketing nodes.
    Fixed frame (optimization_problem_2d.cc:352-400): per-trajectory fixed
    frame origin optimized jointly, SPA residual against each node with an
    interpolated fixed-frame observation."""

    l_poses: torch.Tensor  # f32 [L, 3] initial landmark global poses
    l_free: torch.Tensor  # bool [L]
    o_node_a: torch.Tensor  # i32 [O] bracketing node indices
    o_node_b: torch.Tensor  # i32 [O]
    o_factor: torch.Tensor  # f32 [O] interpolation factor in [0, 1]
    o_landmark: torch.Tensor  # i32 [O]
    o_z: torch.Tensor  # f32 [O, 3] observed tracking->landmark (2D projection)
    o_weight: torch.Tensor  # f32 [O, 2]
    o_mask: torch.Tensor  # bool [O]
    f_pose: torch.Tensor  # f32 [T, 3] fixed frame origin in map, per trajectory
    f_free: torch.Tensor  # bool [T]
    g_node: torch.Tensor  # i32 [G]
    g_traj: torch.Tensor  # i32 [G]
    g_z: torch.Tensor  # f32 [G, 3] fixed-frame observation of the node
    g_weight: torch.Tensor  # f32 [G, 2]
    g_mask: torch.Tensor  # bool [G]


class SpaProblem(NamedTuple):
    """Masked problem tables (see optimization_problem_2d for construction)."""

    submap_poses: torch.Tensor  # f32 [S, 3]
    node_poses: torch.Tensor  # f32 [N, 3]
    free_submap: torch.Tensor  # bool [S] (False: held constant / padding)
    free_node: torch.Tensor  # bool [N]
    c_submap: torch.Tensor  # i32 [C]
    c_node: torch.Tensor  # i32 [C]
    c_z: torch.Tensor  # f32 [C, 3] observed T_submap^-1 T_node
    c_weight: torch.Tensor  # f32 [C, 2] (translation, rotation)
    c_huber: torch.Tensor  # bool [C] apply Huber (INTER constraints)
    c_mask: torch.Tensor  # bool [C]
    n_a: torch.Tensor  # i32 [K]
    n_b: torch.Tensor  # i32 [K]
    n_z: torch.Tensor  # f32 [K, 3]
    n_weight: torch.Tensor  # f32 [K, 2]
    n_mask: torch.Tensor  # bool [K]


def _tables_to(cls, tables, device):
    """Build `cls` from a mapping of field name -> array: floats become
    f32, integers i32 and booleans bool, all on `device`."""
    out = {}
    for name in cls._fields:
        arr = np.asarray(tables[name])
        if arr.dtype == bool:
            dtype = torch.bool
        elif np.issubdtype(arr.dtype, np.integer):
            dtype = torch.int32
        else:
            dtype = torch.float32
        out[name] = torch.as_tensor(arr).to(device=device, dtype=dtype)
    return cls(**out)


def problem_from_numpy(tables, device) -> SpaProblem:
    """SpaProblem from numpy tables (e.g. the JAX package's problem, field
    by field)."""
    return _tables_to(SpaProblem, tables, device)


def extras_from_numpy(tables, device) -> SpaExtras:
    return _tables_to(SpaExtras, tables, device)


def _normalize_angle(a):
    return a - 2.0 * math.pi * torch.ceil((a - math.pi) / (2.0 * math.pi))


def _error_and_blocks(start, end, z):
    """cost_helpers_impl.h ComputeUnscaledError (2D) and its derivatives
    with respect to the start and end poses: e [R, 3], A, B [R, 3, 3]."""
    c = torch.cos(start[:, 2])
    s = torch.sin(start[:, 2])
    dx = end[:, 0] - start[:, 0]
    dy = end[:, 1] - start[:, 1]
    h0 = c * dx + s * dy
    h1 = -s * dx + c * dy
    h2 = end[:, 2] - start[:, 2]
    e = torch.stack(
        [z[:, 0] - h0, z[:, 1] - h1, _normalize_angle(z[:, 2] - h2)], dim=-1
    )
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    a = torch.stack(
        [
            torch.stack([c, s, -h1], -1),
            torch.stack([-s, c, h0], -1),
            torch.stack([zero, zero, one], -1),
        ],
        dim=1,
    )
    b = torch.stack(
        [
            torch.stack([-c, -s, zero], -1),
            torch.stack([s, -c, zero], -1),
            torch.stack([zero, zero, -one], -1),
        ],
        dim=1,
    )
    return e, a, b


def _w3(weight, mask):
    """Per-row residual scales (translation, translation, rotation)."""
    return torch.stack([weight[:, 0], weight[:, 0], weight[:, 1]], -1) * mask[
        :, None
    ].to(weight.dtype)


# Ceres LevenbergMarquardtStrategy clamps diag(J^T J) into
# [min_diagonal=1e-6, max_diagonal=1e32] before damping with D^T D/radius.
_MIN_DIAGONAL = 1e-6
_MAX_DIAGONAL = 1e32
# Trust-region collapse termination (the JAX package's float32 stand-in
# for Ceres's min_trust_region_radius of 1e-32).
_MIN_TRUST_REGION_RADIUS = 1e-10
_CG_TOL = 1e-6


class _Layout:
    """Row families over one pose table X = [submaps; nodes; landmarks;
    fixed frames]: each family has a start and an end pose index per row
    (the landmark family's start is the interpolation of two nodes)."""

    def __init__(self, p: SpaProblem, extras: Optional[SpaExtras]):
        s, n = p.submap_poses.shape[0], p.node_poses.shape[0]
        long = torch.long
        self.families = [
            dict(
                start=p.c_submap.to(long), end=p.c_node.to(long) + s,
                z=p.c_z, w3=_w3(p.c_weight, p.c_mask), huber=p.c_huber,
                diag=True,
            ),
            dict(
                start=p.n_a.to(long) + s, end=p.n_b.to(long) + s,
                z=p.n_z, w3=_w3(p.n_weight, p.n_mask), huber=None, diag=True,
            ),
        ]
        tables = [p.submap_poses, p.node_poses]
        frees = [p.free_submap, p.free_node]
        if extras is not None:
            lo = s + n
            fo = lo + extras.l_poses.shape[0]
            self.families += [
                dict(
                    start=extras.o_node_a.to(long) + s,
                    start_b=extras.o_node_b.to(long) + s,
                    factor=extras.o_factor,
                    end=extras.o_landmark.to(long) + lo,
                    z=extras.o_z, w3=_w3(extras.o_weight, extras.o_mask),
                    huber=None, diag=False,
                ),
                dict(
                    start=extras.g_traj.to(long) + fo,
                    end=extras.g_node.to(long) + s,
                    z=extras.g_z, w3=_w3(extras.g_weight, extras.g_mask),
                    huber=None, diag=False,
                ),
            ]
            tables += [extras.l_poses, extras.f_pose]
            frees += [extras.l_free, extras.f_free]
        self.sizes = [t.shape[0] for t in tables]
        self.x0 = torch.cat(tables).to(torch.float32)
        self.free = torch.cat(frees)[:, None].to(torch.float32)

    def split(self, x):
        return list(torch.split(x, self.sizes))


def _start_pose(fam, x):
    if "start_b" not in fam:
        return x[fam["start"]]
    # Landmark rows: translation lerp + shortest-path angle lerp between
    # the bracketing nodes.
    pa, pb = x[fam["start"]], x[fam["start_b"]]
    f = fam["factor"]
    dth = _normalize_angle(pb[:, 2] - pa[:, 2])
    return torch.stack(
        [
            pa[:, 0] + f * (pb[:, 0] - pa[:, 0]),
            pa[:, 1] + f * (pb[:, 1] - pa[:, 1]),
            pa[:, 2] + f * dth,
        ],
        dim=-1,
    )


def _huber(r, huber_mask, huber_scale):
    """Huber IRLS factor so that ||factor r||^2 == rho(||r||^2) (Ceres
    HuberLoss with a = huber_scale), and d(factor r)/dr as [R, 3, 3]."""
    s = torch.sum(r * r, dim=-1)
    delta2 = huber_scale * huber_scale
    apply = huber_mask & (s > delta2)
    s_safe = torch.where(apply, s, torch.full_like(s, delta2))
    g = (2.0 * huber_scale * torch.sqrt(s_safe) - delta2) / s_safe
    factor = torch.where(apply, torch.sqrt(g), torch.ones_like(s))
    dg = -huber_scale * s_safe ** -1.5 + delta2 / (s_safe * s_safe)
    dfactor = torch.where(apply, dg / (2.0 * factor), torch.zeros_like(s))
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    h = factor[:, None, None] * eye + 2.0 * dfactor[:, None, None] * (
        r[:, :, None] * r[:, None, :]
    )
    return factor, h


def _residuals(layout, x, huber_scale):
    out = []
    for fam in layout.families:
        e, _, _ = _error_and_blocks(_start_pose(fam, x), x[fam["end"]], fam["z"])
        r = e * fam["w3"]
        if fam["huber"] is not None:
            factor, _ = _huber(r, fam["huber"], huber_scale)
            r = r * factor[:, None]
        out.append(r)
    return out


def mesh_sum(t, mesh):
    """`t` summed over the mesh's ranks (in place); `t` without a mesh."""
    return t if mesh is None else all_reduce(t, mesh)


def _cost(residuals, mesh):
    return mesh_sum(0.5 * sum(torch.sum(r * r) for r in residuals), mesh)


def _linearize(layout, x, huber_scale, mesh=None):
    """Residuals at x and the Jacobian as (pose index [R], block [R, 3, 3])
    pairs per family, plus diag(J^T J) of the unweighted-by-Huber
    constraint and node-node rows (the JAX package's Jacobi diagonal)."""
    res, blocks = [], []
    diag = torch.zeros_like(x)
    for fam in layout.families:
        e, a, b = _error_and_blocks(_start_pose(fam, x), x[fam["end"]], fam["z"])
        w3 = fam["w3"]
        r = e * w3
        wa = a * w3[:, :, None]
        wb = b * w3[:, :, None]
        if fam["diag"]:
            diag.index_add_(0, fam["start"], torch.sum(wa * wa, dim=1))
            diag.index_add_(0, fam["end"], torch.sum(wb * wb, dim=1))
        if fam["huber"] is not None:
            factor, h = _huber(r, fam["huber"], huber_scale)
            r = r * factor[:, None]
            wa = torch.bmm(h, wa)
            wb = torch.bmm(h, wb)
        if "start_b" in fam:
            f = fam["factor"][:, None, None]
            fam_blocks = [
                (fam["start"], wa * (1.0 - f)),
                (fam["start_b"], wa * f),
                (fam["end"], wb),
            ]
        else:
            fam_blocks = [(fam["start"], wa), (fam["end"], wb)]
        res.append(r)
        blocks.append(fam_blocks)
    return res, blocks, mesh_sum(diag, mesh)


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


def solve(
    p: SpaProblem,
    huber_scale: float,
    max_iterations: int = 50,
    cg_iterations: int = 64,
    extras: Optional[SpaExtras] = None,
    use_nonmonotonic_steps: bool = False,
    mesh=None,
):
    """Returns (submap_poses, node_poses, final_cost) — plus, when `extras`
    is given, landmark poses and fixed-frame poses before the cost — on
    the problem's device. With `mesh`, `p` and `extras` hold this rank's
    residual rows (parallel/sharded.shard_spa_problem). CUDA tensors
    without a mesh run the kernel (kernels/spa_2d), all else
    `solve_plain`."""
    if mesh is None and p.submap_poses.is_cuda:
        out, info = spa_2d.solve(
            p, extras, huber_scale, max_iterations, cg_iterations,
            use_nonmonotonic_steps,
        )
        _record(info["iterations"], info["cg_steps"])
        return out
    return solve_plain(
        p, huber_scale, max_iterations, cg_iterations, extras,
        use_nonmonotonic_steps, mesh,
    )


def _record(iterations, cg_steps):
    metrics.spa_lm_iterations.set(iterations)
    metrics.spa_cg_steps.set(cg_steps)


def solve_plain(
    p: SpaProblem,
    huber_scale: float,
    max_iterations: int = 50,
    cg_iterations: int = 64,
    extras: Optional[SpaExtras] = None,
    use_nonmonotonic_steps: bool = False,
    mesh=None,
):
    """`solve` as eager PyTorch on any device: the CPU's path, the mesh's,
    and the kernel's yardstick on the card."""
    layout = _Layout(p, extras)
    free = layout.free
    dev = free.device
    x = layout.x0
    cost = _cost(_residuals(layout, x, huber_scale), mesh)
    f32 = dict(dtype=torch.float32, device=dev)
    radius = torch.full((), 1e4, **f32)
    decrease_factor = torch.full((), 2.0, **f32)
    ev = nonmonotonic_init(cost)
    cg_steps = torch.zeros((), dtype=torch.int64, device=dev)
    iterations = 0
    for _ in range(max_iterations):
        iterations += 1
        r0, blocks, diag = _linearize(layout, x, huber_scale, mesh)
        # Ceres LM damping: D^T D / radius with D = clamped sqrt(diag).
        damp = torch.clamp(diag, _MIN_DIAGONAL, _MAX_DIAGONAL) / radius
        grad = _jtu(blocks, r0, x, mesh) * free

        def hvp(v):
            pv_ = v * free
            jtv = _jtu(blocks, _jv(blocks, pv_), x, mesh) * free
            # Identity on the fixed subspace keeps the operator SPD.
            return jtv + damp * pv_ + (v - pv_)

        pre = torch.where(free > 0, diag + damp, torch.ones_like(diag))
        dx = _cg(hvp, -grad, pre, cg_iterations, cg_steps) * free
        new_x = x + dx
        new_cost = _cost(_residuals(layout, new_x, huber_scale), mesh)
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
    x = torch.cat([x[:, :2], _normalize_angle(x[:, 2:3])], dim=1)
    _record(iterations, int(cg_steps))
    return tuple(layout.split(x)) + (cost,)


def _cg(apply_a, b, pre, maxiter, steps=None):
    """jax.scipy.sparse.linalg.cg (x0 = 0, tol = 1e-6, atol = 0, Jacobi
    preconditioner `pre`): stops once ||r||^2 <= tol^2 ||b||^2; here the
    carry freezes instead, so the loop runs `maxiter` steps without a
    host synchronisation. `steps`, a 0-d integer tensor when given, counts
    the steps taken before the stop in place."""
    atol2 = _CG_TOL * _CG_TOL * torch.sum(b * b)
    x = torch.zeros_like(b)
    r = b
    z = r / pre
    p = z
    gamma = torch.sum(r * z)
    for _ in range(maxiter):
        active = torch.sum(r * r) > atol2
        if steps is not None:
            steps += active
        ap = apply_a(p)
        alpha = gamma / torch.sum(p * ap)
        x = torch.where(active, x + alpha * p, x)
        r_new = r - alpha * ap
        z = r_new / pre
        gamma_new = torch.sum(r_new * z)
        p = torch.where(active, z + (gamma_new / gamma) * p, p)
        r = torch.where(active, r_new, r)
        gamma = torch.where(active, gamma_new, gamma)
    return x
