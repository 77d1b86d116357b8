"""The 3D scan matchers of the PyTorch port against the JAX package: the
6-DoF LM `match_3d` (dense and paged grids, `only_optimize_yaw` on and
off, nonmonotonic steps on and off) and `match_3d_intensity`, the
written-out Jacobian against a central difference, the 3D correlative
scorer `score_candidates_3d`, `interp_smoothstep_3d`, the host-facing
matchers of `mapping/scan_matching_3d`, and the rotational histograms."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.common import config as jconfig
from cartographer_tpu.mapping import hybrid_grid as jhg
from cartographer_tpu.mapping import paged_grid_3d as jpg
from cartographer_tpu.mapping import scan_matching_3d as jsm
from cartographer_tpu.ops.scan_matching import correlative_3d as jc3
from cartographer_tpu.ops.scan_matching import gauss_newton_3d as jgn
from cartographer_tpu.ops.scan_matching import rotational_histogram as jrh
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.mapping import paged_grid_3d as tpg
from cartographer_tpu_torch.mapping import scan_matching_3d as tsm
from cartographer_tpu_torch.ops.scan_matching import correlative_3d as tc3
from cartographer_tpu_torch.ops.scan_matching import gauss_newton_3d as tgn
from cartographer_tpu_torch.ops.scan_matching import rotational_histogram as trh
from tests.test_torch_backend_card import one_torch_thread  # noqa: F401

t = torch.from_numpy
HIGH_RES, LOW_RES = 0.1, 0.3


def room_volume(size, res):
    """int8 log-odds of a room centred on the volume: walls at |x| = 1.6 m
    and |y| = 1.2 m, a slanted pillar, and a floor at z = -0.8 m; free
    space inside."""
    c = (np.arange(size) - 0.5 * size) * res
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    inside = (np.abs(x) < 1.6) & (np.abs(y) < 1.2) & (z > -0.8)
    wall = (
        (np.abs(np.abs(x) - 1.6) < res) & (np.abs(y) < 1.2 + res)
        | (np.abs(np.abs(y) - 1.2) < res) & (np.abs(x) < 1.6 + res)
        | (np.abs(z + 0.8) < res) & (np.abs(x) < 1.6) & (np.abs(y) < 1.2)
        | (np.hypot(x - 0.6 - 0.2 * z, y + 0.4) < 1.5 * res)
    )
    values = np.zeros((size, size, size), np.int8)
    values[inside] = -60
    values[wall] = 100
    return values, np.full(3, -0.5 * size * res, np.float32)


def room_scan(rng, n=300):
    """Points on the room's surfaces, in the room frame."""
    th = rng.uniform(-np.pi, np.pi, n)
    r = np.minimum(1.6 / np.maximum(np.abs(np.cos(th)), 1e-6),
                   1.2 / np.maximum(np.abs(np.sin(th)), 1e-6))
    pts = np.stack([r * np.cos(th), r * np.sin(th), rng.uniform(-0.7, 1.0, n)], 1)
    floor = rng.uniform(size=n) < 0.25
    pts[floor, 0] *= rng.uniform(0.2, 0.9, floor.sum())
    pts[floor, 1] *= rng.uniform(0.2, 0.9, floor.sum())
    pts[floor, 2] = -0.8
    return pts.astype(np.float32)


def paged_of_dense(values, origin, res, block_bits=3):
    """The same grid as a paged one (every block allocated, slot = block
    index), for both packages."""
    b = 1 << block_bits
    tsize = values.shape[0] // b
    blocks = (values.reshape(tsize, b, tsize, b, tsize, b)
              .transpose(0, 2, 4, 1, 3, 5).reshape(tsize**3, b**3))
    table = np.arange(tsize**3, dtype=np.int32)
    # The paged origin is the virtual extent's corner: the dense one here.
    fields = dict(table=table, pool=blocks, num_blocks=np.int32(tsize**3),
                  dropped=np.int32(0), origin=origin, resolution=res,
                  block_bits=block_bits, table_size=tsize)
    j = jpg.PagedGrid3D(
        table=jnp.asarray(table), pool=jnp.asarray(blocks),
        num_blocks=jnp.int32(tsize**3), dropped=jnp.int32(0),
        origin=jnp.asarray(origin), resolution=res, block_bits=block_bits,
        table_size=tsize,
    )
    return j, tpg.paged_from_numpy(**fields, device="cpu")


def volumes(kind):
    """(jax high, torch high, jax low, torch low, high origin, low origin)."""
    hv, ho = room_volume(48, HIGH_RES)
    lv, lo = room_volume(16, LOW_RES)
    if kind == "paged":
        jh, th = paged_of_dense(hv, ho, HIGH_RES)
        jl, tl = paged_of_dense(lv, lo, LOW_RES)
        return jh, th, jl, tl, ho, lo
    return jnp.asarray(hv), t(hv), jnp.asarray(lv), t(lv), ho, lo


def padded(pts, n=512):
    out = np.zeros((n, 3), np.float32)
    out[: len(pts)] = pts
    return out, np.arange(n) < len(pts)


def match_case(seed=0):
    rng = np.random.default_rng(seed)
    hp, hm = padded(room_scan(rng))
    lp, lm = padded(room_scan(rng, 200))
    t0 = np.array([0.05, -0.04, 0.03], np.float32)
    yaw = 0.03
    q0 = np.array([math.cos(yaw / 2), 0.01, -0.008, math.sin(yaw / 2)], np.float32)
    q0 /= np.linalg.norm(q0)
    return hp, hm, lp, lm, t0, q0


def both_matches(kind, only_optimize_yaw, nonmonotonic, intensity=False):
    jh, th, jl, tl, ho, lo = volumes(kind)
    hp, hm, lp, lm, t0, q0 = match_case()
    weights = (1.0, 1.5, 0.2, 0.3)
    kw = dict(max_iterations=12, only_optimize_yaw=only_optimize_yaw,
              use_nonmonotonic_steps=nonmonotonic)
    if intensity:
        rng = np.random.default_rng(1)
        avg = rng.uniform(0.0, 60.0, (48, 48, 48)).astype(np.float32)
        meas = rng.uniform(0.0, 60.0, len(hm)).astype(np.float32)
        icost = (2.0, 0.3, 40.0)
        j = jgn.match_3d_intensity(
            jh, jnp.asarray(ho), jl, jnp.asarray(lo), jnp.asarray(avg),
            jnp.asarray(t0), jnp.asarray(q0), jnp.asarray(t0), jnp.asarray(hp),
            jnp.asarray(hm), jnp.asarray(meas), jnp.asarray(lp), jnp.asarray(lm),
            HIGH_RES, LOW_RES, weights[0], weights[1], *icost, weights[2], weights[3], **kw)
        res = torch.full((), HIGH_RES), torch.full((), LOW_RES)
        g = tgn.match_3d_intensity(
            th, t(ho), tl, t(lo), t(avg), t(t0), t(q0), t(t0), t(hp), t(hm),
            t(meas), t(lp), t(lm), *res, weights[0], weights[1], *icost,
            weights[2], weights[3], **kw)
        return np.asarray(j), g.numpy()
    j = jgn.match_3d(
        jh, jnp.asarray(ho), jl, jnp.asarray(lo), jnp.asarray(t0), jnp.asarray(q0),
        jnp.asarray(t0), jnp.asarray(hp), jnp.asarray(hm), jnp.asarray(lp),
        jnp.asarray(lm), HIGH_RES, LOW_RES, *weights, **kw)
    # The JAX matcher takes the resolutions as traced values: 0-d tensors.
    g = tgn.match_3d(
        th, t(ho), tl, t(lo), t(t0), t(q0), t(t0), t(hp), t(hm), t(lp), t(lm),
        torch.full((), HIGH_RES), torch.full((), LOW_RES), *weights, **kw)
    return np.asarray(j), g.numpy()


def assert_pose_close(got, want, atol_m=1e-4, atol_rad=1e-4):
    np.testing.assert_allclose(got[:3], want[:3], atol=atol_m, rtol=0)
    # Rotation angle between the two quaternions.
    dot = abs(float(np.dot(got[3:7], want[3:7])))
    assert 2.0 * math.acos(min(1.0, dot)) < atol_rad
    np.testing.assert_allclose(got[7], want[7], rtol=1e-4)


@pytest.mark.parametrize(
    "kind,only_optimize_yaw,nonmonotonic",
    [("dense", False, False), ("dense", True, True),
     ("paged", False, True), ("paged", True, False)],
    ids=["dense-6dof-monotonic", "dense-yaw-nonmonotonic",
         "paged-6dof-nonmonotonic", "paged-yaw-monotonic"],
)
def test_match_3d_matches_jax(kind, only_optimize_yaw, nonmonotonic):
    """Each grid kind, each option on and off (every JAX compile of the
    matcher costs seconds, so not every combination)."""
    want, got = both_matches(kind, only_optimize_yaw, nonmonotonic)
    assert np.all(np.isfinite(got))
    assert_pose_close(got, want)
    # The match moved off the initial pose and lowered the cost.
    assert np.linalg.norm(got[:3] - match_case()[4]) > 1e-3
    if only_optimize_yaw:
        # Roll and pitch stay those of the initial rotation.
        q0 = match_case()[5]
        ez = np.array([0.0, 0.0, 1.0])
        assert abs(float(quat_rotate(got[3:7], ez) @ quat_rotate(q0, ez)) - 1.0) < 1e-6


def quat_rotate(q, v):
    w, u = q[0], q[1:4]
    tt = 2.0 * np.cross(u, v)
    return v + w * tt + np.cross(u, tt)


def test_match_3d_intensity_matches_jax():
    want, got = both_matches("dense", False, False, intensity=True)
    assert_pose_close(got, want)


def residual_problem(kind, only_optimize_yaw, intensity):
    _, th, _, tl, ho, lo = volumes(kind)
    hp, hm, lp, lm, t0, q0 = match_case()
    grids = [tgn._Grid(th, t(ho), HIGH_RES, t(hp), t(hm)),
             tgn._Grid(tl, t(lo), LOW_RES, t(lp), t(lm))]
    extra = None
    if intensity:
        c = (np.arange(48) - 24) * HIGH_RES
        z, y, x = np.meshgrid(c, c, c, indexing="ij")
        avg = (30 + 20 * np.sin(x / 0.7) * np.cos(y / 0.9) + 5 * z).astype(np.float32)
        grids.append(tgn._Grid(t(avg), t(ho), HIGH_RES, t(hp), t(hm)))
        meas = np.random.default_rng(1).uniform(0.0, 60.0, len(hm)).astype(np.float32)
        extra = (t(meas), 2.0, 0.3, 40.0)
    return tgn._Residuals(grids, t(q0), t(t0), 1.0, 1.5, 0.2, 0.3,
                          only_optimize_yaw, extra), t0


@pytest.mark.parametrize(
    "kind,only_optimize_yaw,intensity",
    [("dense", False, False), ("paged", True, False), ("dense", False, True)],
    ids=["dense_6dof", "paged_yaw", "intensity"],
)
def test_jacobian_matches_central_difference(kind, only_optimize_yaw, intensity):
    """The written-out Jacobian (smoothstep weights, q0 * exp(r) on each
    point, the yaw mask, the Huber factor) against a central difference
    of the residuals with the corners frozen, away from x = 0 (r != 0).
    The intensity field is a smooth one here: on white noise at 10 cm the
    curvature makes a central difference inaccurate at any step float32
    resolves."""
    problem, t0 = residual_problem(kind, only_optimize_yaw, intensity)
    x = torch.tensor(np.r_[t0 + [0.02, -0.01, 0.015], [0.01, -0.02, 0.03]],
                     dtype=torch.float64)
    packs, _ = problem.evaluate(x.float())
    _, jac = problem.residuals_and_jacobian(x.float(), packs)
    eps = 1e-3
    numeric = []
    for k in range(6):
        step = torch.zeros(6, dtype=torch.float64)
        step[k] = eps
        plus = problem.residuals((x + step).float(), packs).double()
        minus = problem.residuals((x - step).float(), packs).double()
        numeric.append((plus - minus) / (2 * eps))
    numeric = torch.stack(numeric, dim=1).numpy()
    jac = jac.numpy()
    scale = np.abs(numeric).max()
    assert scale > 0.1
    np.testing.assert_allclose(jac, numeric, atol=2e-3 * scale, rtol=0)
    if only_optimize_yaw:
        assert not np.any(jac[:, 3:5])


@pytest.mark.parametrize("kind", ["dense_f32", "dense_int8", "paged"])
def test_score_candidates_3d_matches_jax(kind):
    """Scores at rtol 1e-5 and the same best candidate, with padded angles
    and points masked out."""
    jh, th, _, _, ho, _ = volumes("paged" if kind == "paged" else "dense")
    if kind == "dense_f32":
        prob = np.array(jhg.Grid3D(values=jh, origin=jnp.asarray(ho),
                                   resolution=HIGH_RES).probability())
        jh, th = jnp.asarray(prob), t(prob)
    rng = np.random.default_rng(2)
    pts, mask = padded(room_scan(rng, 200), 256)
    angles = np.zeros(16, np.float32)
    angles[:11] = np.linspace(-0.05, 0.05, 11)
    angle_mask = np.arange(16) < 11
    init = np.array([0.04, -0.03, 0.02], np.float32)
    args = (HIGH_RES, 0.1, 0.1, 2)
    js, jbest, jscore = jc3.score_candidates_3d(
        jh, jnp.asarray(ho), jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(angles),
        jnp.asarray(angle_mask), jnp.asarray(init), *args)
    ts, tbest, tscore = tc3.score_candidates_3d(
        th, t(ho), t(pts), t(mask), t(angles), t(angle_mask), t(init), *args)
    js = np.asarray(js)
    valid = np.isfinite(js)
    assert ts.shape == js.shape and np.array_equal(np.isfinite(ts.numpy()), valid)
    np.testing.assert_allclose(ts.numpy()[valid], js[valid], rtol=1e-5)
    assert int(tbest) == int(jbest)
    assert abs(float(tscore) - float(jscore)) <= 1e-5 * abs(float(jscore))


def test_interp_smoothstep_3d_matches_jax():
    jh, th, _, _, _, _ = volumes("dense")
    rng = np.random.default_rng(3)
    u, v, w = (rng.uniform(-3.0, 51.0, (5, 200)).astype(np.float32) for _ in range(3))
    want = np.asarray(jgn.interp_smoothstep_3d(jh, *map(jnp.asarray, (u, v, w))))
    got = tgn.interp_smoothstep_3d(th, t(u), t(v), t(w)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_solve_spd_matches_linalg():
    rng = np.random.default_rng(4)
    m = rng.normal(size=(6, 6))
    a = (m @ m.T + 0.5 * np.eye(6)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    got = tgn._solve_spd(t(a), t(b)).numpy()
    np.testing.assert_allclose(got, np.linalg.solve(a.astype(np.float64), b), rtol=1e-4)


def test_host_matchers_match_jax():
    """CeresScanMatcher3D.match and RealTimeCorrelativeScanMatcher3D.match
    through their padding and decoding, on paged grids."""
    jh, th, jl, tl, ho, lo = volumes("paged")
    rng = np.random.default_rng(5)
    high, low = room_scan(rng, 250), room_scan(rng, 180)
    pose = np.array([0.06, -0.05, 0.02, math.cos(0.02), 0.0, 0.0, math.sin(0.02)])
    jcsm = jsm.CeresScanMatcher3D(jconfig.CeresScanMatcherOptions3D())
    tcsm = tsm.CeresScanMatcher3D(tconfig.CeresScanMatcherOptions3D())
    j_pose, j_cost = jcsm.match(pose[:3], pose, high, jh, low, jl)
    t_pose, t_cost = tcsm.match(pose[:3], pose, high, th, low, tl)
    assert_pose_close(np.r_[t_pose, t_cost], np.r_[j_pose, j_cost])
    np.testing.assert_allclose(
        tsm.CeresScanMatcher3D.decode(
            tcsm.match_device(pose[:3], pose, high, th, low, tl).numpy())[0],
        t_pose, atol=0)

    opts = dict(linear_search_window=0.15, angular_search_window=math.radians(3.0))
    jr = jsm.RealTimeCorrelativeScanMatcher3D(
        jconfig.RealTimeCorrelativeScanMatcherOptions(**opts))
    tr = tsm.RealTimeCorrelativeScanMatcher3D(
        tconfig.RealTimeCorrelativeScanMatcherOptions(**opts))
    j_score, j_rt = jr.match(pose, high, jh)
    t_score, t_rt = tr.match(pose, high, th)
    assert abs(t_score - j_score) < 1e-5
    np.testing.assert_allclose(t_rt, j_rt, atol=1e-9)
    assert tsm.pad_points_3d(high)[0].shape == (256, 3)


def test_rotational_histogram_matches_jax():
    """The copied module gives the JAX package's results exactly:
    histograms (the native path of both packages, and both numpy walks),
    rotation, matching. On this room scan the JAX package's native
    histogram and its numpy walk differ (ROADMAP Queue C), so each path is
    held against its JAX counterpart."""
    rng = np.random.default_rng(6)
    pts = room_scan(rng, 600).astype(np.float64)
    pts[:, 2] = np.round(pts[:, 2] / 0.2) * 0.2 + rng.normal(0, 0.01, len(pts))
    np.testing.assert_array_equal(trh.compute_histogram_numpy(pts, 120),
                                  jrh.compute_histogram_numpy(pts, 120))
    got = trh.compute_histogram(pts, 120)
    want = jrh.compute_histogram(pts, 120)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0
    for angle in (0.0, 0.3, -2.1):
        np.testing.assert_array_equal(trh.rotate_histogram(got, angle),
                                      jrh.rotate_histogram(want, angle))
    other = trh.rotate_histogram(got, 0.4)
    assert trh.match_histograms(other, got) == jrh.match_histograms(other, got)
    angles = np.linspace(-0.5, 0.5, 21)
    np.testing.assert_array_equal(trh.match_angles(other, got, 0.1, angles),
                                  jrh.match_angles(other, got, 0.1, angles))
    assert trh.compute_histogram(np.zeros((0, 3)), 8).shape == (8,)
