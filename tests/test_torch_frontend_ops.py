"""PyTorch port of the frontend's device ops against the JAX package.

Voxel masks and the dense ray-cast insertion compare EXACTLY (same
float32 arithmetic, integer results); the LM matcher and the tracker
fold compare within float tolerances stated per test (transcendentals
and sum orders differ between XLA:CPU and PyTorch by ulps)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.ops import frontend_common as jfc
from cartographer_tpu.ops import raycast_2d as jray
from cartographer_tpu.ops.scan_matching import gauss_newton_2d as jgn
from cartographer_tpu.transform import rigid3
from cartographer_tpu_torch.ops import frontend_common as tfc
from cartographer_tpu_torch.ops import raycast_2d as tray
from cartographer_tpu_torch.ops.scan_matching import gauss_newton_2d as tgn


def t(x):
    return torch.from_numpy(np.asarray(x))


def wall_cloud(seed, n=700, invalid=0.1):
    """Points on a few walls plus scatter, z in [-0.4, 0.4]; ~10% invalid."""
    rng = np.random.default_rng(seed)
    k = n // 2
    a = rng.uniform(0, 2 * np.pi, k)
    r = rng.uniform(3.0, 6.0, 4)[rng.integers(0, 4, k)]
    wall = np.stack([r * np.cos(a), r * np.sin(a)], 1)
    scatter = rng.uniform(-8, 8, (n - k, 2))
    xy = np.concatenate([wall, scatter])
    z = rng.uniform(-0.4, 0.4, (n, 1))
    pts = np.concatenate([xy, z], 1).astype(np.float32)
    valid = rng.uniform(size=n) > invalid
    return pts, valid


class TestVoxelFilters:
    @pytest.mark.parametrize("length", [0.025, 0.05, 0.1, 0.37])
    def test_voxel_first_mask_equal(self, length):
        pts, valid = wall_cloud(int(length * 1000))
        want = np.asarray(jfc.voxel_first_mask(jnp.asarray(pts), jnp.asarray(valid), length))
        want_jit = np.asarray(
            jax.jit(jfc.voxel_first_mask, static_argnums=2)(
                jnp.asarray(pts), jnp.asarray(valid), length
            )
        )
        got = tfc.voxel_first_mask(t(pts), t(valid), length).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, want_jit)
        assert 0 < got.sum() < valid.sum()

    def test_voxel_unique_counts_equal(self):
        pts, valid = wall_cloud(3)
        lengths = np.float32(0.5) * 2.0 ** -np.arange(8, dtype=np.float32)
        want = np.asarray(
            jfc.voxel_unique_counts_batch(
                jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(lengths)
            )
        )
        got = tfc.voxel_unique_counts_batch(t(pts), t(valid), t(lengths)).numpy()
        np.testing.assert_array_equal(got, want)
        none = np.zeros_like(valid)
        zero = tfc.voxel_unique_counts_batch(t(pts), t(none), t(lengths))
        assert not zero.any()

    @pytest.mark.parametrize(
        "n,max_length,min_points",
        [
            (150, 0.5, 200),  # sparse: returned unfiltered
            (700, 0.05, 100),  # enough at max_length: skip
            (700, 0.5, 200),  # halving + bisection
            (1500, 2.0, 300),
        ],
    )
    def test_adaptive_voxel_mask_equal(self, n, max_length, min_points):
        pts, valid = wall_cloud(n, n=n)
        want = np.asarray(
            jax.jit(jfc.adaptive_voxel_mask, static_argnums=(2, 3))(
                jnp.asarray(pts), jnp.asarray(valid), max_length, min_points
            )
        )
        got = tfc.adaptive_voxel_mask(t(pts), t(valid), max_length, min_points)
        np.testing.assert_array_equal(got.numpy(), want)


def insert_case(seed, h=64, w=96, n=300):
    rng = np.random.default_rng(seed)
    log_odds = np.where(
        rng.uniform(size=(h, w)) < 0.3, rng.uniform(-2.0, 2.0, (h, w)), 0.0
    ).astype(np.float32)
    known = log_odds != 0.0
    origin = np.array([w * 0.4 + 0.37, h * 0.55 + 0.21], np.float32)
    ends = rng.uniform([-20, -20], [w + 20, h + 20], (n, 2)).astype(np.float32)
    # Horizontal rays (dy == 0: the near_zero branch), vertical rays, and
    # endpoints exactly on cell boundaries.
    ends[:20, 1] = origin[1]
    ends[20:30, 0] = origin[0]
    ends[30:40] = np.round(ends[30:40])
    is_hit = rng.uniform(size=n) < 0.7
    valid = rng.uniform(size=n) < 0.9
    return log_odds, known, origin, ends, is_hit, valid


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


class TestInsertScanDense:
    @pytest.mark.parametrize("insert_free_space", [True, False])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_bit_identical(self, seed, insert_free_space):
        lo, kn, origin, ends, is_hit, valid = insert_case(seed)
        j_lo, j_kn = jray.insert_scan_dense(
            jnp.asarray(lo), jnp.asarray(kn), jnp.asarray(origin),
            jnp.asarray(ends), jnp.asarray(is_hit), jnp.asarray(valid),
            0.2, -0.04, insert_free_space,
        )
        t_lo, t_kn = tray.insert_scan_dense(
            t(lo), t(kn), t(origin), t(ends), t(is_hit), t(valid),
            0.2, -0.04, insert_free_space,
        )
        np.testing.assert_array_equal(t_kn.numpy(), np.asarray(j_kn))
        np.testing.assert_array_equal(bits(t_lo.numpy()), bits(j_lo))
        assert (t_kn.numpy() & ~kn).sum() > 0  # the scan did touch new cells

    def test_batched_equals_per_grid_and_small_chunks(self, monkeypatch):
        cases = [insert_case(s) for s in (3, 4)]
        lo = torch.stack([t(c[0]) for c in cases])
        kn = torch.stack([t(c[1]) for c in cases])
        origin = torch.stack([t(c[2]) for c in cases])
        # Same rays (shared hit/valid masks), two grids at other origins.
        ends = torch.stack([t(cases[0][3]), t(cases[0][3]) + 1.5])
        is_hit, valid = t(cases[0][4]), t(cases[0][5])
        b_lo, b_kn = tray.insert_scan_dense(
            lo, kn, origin, ends, is_hit, valid, 0.2, -0.04, True
        )
        # Chunks of 7 rays: the OR over chunks equals the one-chunk OR.
        monkeypatch.setattr(tray, "_CHUNK_WORDS", 7 * 2 * 64 * 3)
        c_lo, c_kn = tray.insert_scan_dense(
            lo, kn, origin, ends, is_hit, valid, 0.2, -0.04, True
        )
        assert torch.equal(c_lo, b_lo) and torch.equal(c_kn, b_kn)
        for i in range(2):
            s_lo, s_kn = jray.insert_scan_dense(
                jnp.asarray(lo[i].numpy()), jnp.asarray(kn[i].numpy()),
                jnp.asarray(origin[i].numpy()), jnp.asarray(ends[i].numpy()),
                jnp.asarray(is_hit.numpy()), jnp.asarray(valid.numpy()),
                0.2, -0.04, True,
            )
            np.testing.assert_array_equal(b_kn[i].numpy(), np.asarray(s_kn))
            np.testing.assert_array_equal(bits(b_lo[i].numpy()), bits(s_lo))


def smooth_cost_grid(seed, h=64, w=64):
    """Correspondence cost of blurred random walls (smooth, so the LM has
    gradients to follow)."""
    rng = np.random.default_rng(seed)
    prob = np.full((h, w), 0.1, np.float64)
    for _ in range(5):
        y0, x0 = rng.integers(10, 54, 2)
        if rng.uniform() < 0.5:
            prob[y0, 6:58] = 0.9
        else:
            prob[6:58, x0] = 0.9
    k = np.array([0.25, 0.5, 0.25])
    for _ in range(2):
        prob = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, prob)
        prob = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, prob)
    prob = np.clip(prob, 0.1, 0.9)
    return (1.0 - prob).astype(np.float32), rng


class TestGaussNewtonMatch:
    @pytest.mark.parametrize("nonmonotonic", [False, True])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_jax_match(self, seed, nonmonotonic):
        cost, rng = smooth_cost_grid(seed)
        origin = np.array([-1.6, -1.6], np.float32)
        ys, xs = np.nonzero(cost < 0.5)
        world = np.stack([xs, ys], 1) * 0.05 + origin + 0.025
        n = 128
        pts = world[rng.integers(0, len(world), n)].astype(np.float32)
        pts += rng.normal(0, 0.01, pts.shape).astype(np.float32)
        mask = np.arange(n) < n - 10
        init = np.array([0.03, -0.02, 0.02], np.float32)
        target = np.array([0.01, 0.0], np.float32)
        args = (cost, origin, init, target, pts, mask)
        j_pose, j_cost = jgn.match(
            *[jnp.asarray(x) for x in args], 0.05, 1.0, 10.0, 40.0, 20, nonmonotonic
        )
        t_pose, t_cost = tgn.match(*[t(x) for x in args], 0.05, 1.0, 10.0, 40.0, 20, nonmonotonic)
        np.testing.assert_allclose(t_pose.numpy(), np.asarray(j_pose), atol=1e-4)
        np.testing.assert_allclose(float(t_cost), float(j_cost), rtol=1e-4)
        assert float(t_cost) < float(
            tgn.match(*[t(x) for x in args], 0.05, 1.0, 10.0, 40.0, 0)[1]
        )

    def test_patches_and_solver_match_jax(self):
        cost, rng = smooth_cost_grid(5)
        iv = rng.integers(-3, 67, 50).astype(np.int32)
        iu = rng.integers(-3, 67, 50).astype(np.int32)
        want = np.asarray(
            jgn._extract_patches_gather(jnp.asarray(cost), jnp.asarray(iv), jnp.asarray(iu))
        )
        got = tgn._extract_patches_gather(t(cost), t(iv), t(iu)).numpy()
        np.testing.assert_array_equal(got, want)
        m = rng.normal(size=(3, 3)).astype(np.float32)
        a = m @ m.T + np.eye(3, dtype=np.float32)
        b = rng.normal(size=3).astype(np.float32)
        np.testing.assert_allclose(
            tgn.solve_spd_small(t(a), t(b)).numpy(),
            np.asarray(jgn.solve_spd_small(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-5, atol=1e-6,
        )
        tt = np.linspace(0, 1, 11, dtype=np.float32)
        np.testing.assert_allclose(
            tgn._cubic_weights_d(t(tt)).numpy(),
            np.asarray(jgn._cubic_weights_d(jnp.asarray(tt))), atol=1e-6,
        )


class TestQuaternionsAndTracker:
    def test_quaternion_helpers_match_rigid3(self):
        rng = np.random.default_rng(0)
        q = rng.normal(size=(20, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        aa = rng.normal(size=(20, 3)) * np.array([[1.0]] * 19 + [[1e-9]])
        v = rng.normal(size=(20, 3))
        f = lambda x: t(np.asarray(x, np.float32))  # noqa: E731
        tol = dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tfc.qrot(f(q), f(v)).numpy(), rigid3.quat_rotate(q, v), **tol)
        np.testing.assert_allclose(tfc.qexp(f(aa)).numpy(), rigid3.quat_from_angle_axis(aa), **tol)
        np.testing.assert_allclose(tfc.qlog(f(q)).numpy(), rigid3.quat_to_angle_axis(q), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tfc.quat_angle(f(q)).numpy(), rigid3.quat_angle(q), rtol=1e-4, atol=1e-5)
        a, b = v[:10], np.concatenate([v[10:19], -v[:1]])  # last pair antiparallel
        np.testing.assert_allclose(
            tfc.quat_from_two_vectors(f(a), f(b)).numpy(),
            rigid3.quat_from_two_vectors(a, b), rtol=1e-4, atol=1e-5,
        )

    @pytest.mark.parametrize("use_imu", [False, True])
    def test_tracker_fold_and_unwarp_match_jax(self, use_imu):
        rng = np.random.default_rng(1)
        cfg = types.SimpleNamespace(
            use_imu=use_imu, imu_gravity_time_constant=10.0, max_imu_per_scan=6
        )
        q0 = rng.normal(size=4)
        q0 /= np.linalg.norm(q0)
        fields = dict(
            newest_t=np.float32(0.1), newest_q=q0, newest_xyz=rng.normal(size=3),
            tracker_ori=q0, tracker_grav=np.array([0.05, -0.02, 1.0]),
            tracker_omega=np.array([0.01, 0.02, 0.3]),
            tracker_last_acc_t=np.float32(0.05), ang_vel=np.array([0.0, 0.0, 0.2]),
            vel=np.array([0.5, -0.1, 0.0]), last_extrap_t=np.float32(0.12),
        )
        imu = (
            np.sort(rng.uniform(0.1, 0.25, 6)).astype(np.float32),
            (rng.normal(size=(6, 3)) * 0.1 + [0, 0, 9.8]).astype(np.float32),
            (rng.normal(size=(6, 3)) * 0.2).astype(np.float32),
            np.array([True, True, False, True, True, True]),
        )
        ptimes = np.sort(rng.uniform(0.1, 0.2, 40)).astype(np.float32)
        t_target = np.float32(0.2)
        js = types.SimpleNamespace(**{k: jnp.asarray(np.asarray(v, np.float32)) for k, v in fields.items()})
        ts = types.SimpleNamespace(**{k: t(np.asarray(v, np.float32)) for k, v in fields.items()})
        j_trk, j_bp = jfc.tracker_fold(cfg, js, jnp.float32(t_target), tuple(jnp.asarray(x) for x in imu))
        t_trk, t_bp = tfc.tracker_fold(cfg, ts, t(t_target), tuple(t(x) for x in imu))
        for a, b in zip(list(t_trk) + list(t_bp), list(j_trk) + list(j_bp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
        j_un = jfc.unwarp_points(js, *j_bp, jnp.asarray(ptimes))
        t_un = tfc.unwarp_points(ts, *t_bp, t(ptimes))
        for a, b in zip(t_un, j_un):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
