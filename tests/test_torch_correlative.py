"""PyTorch port of the RTCSM window scorer against the JAX package.

The port's plain window sums (the CPU side of
cartographer_tpu_torch.ops.scan_matching.correlative_2d.window_sums) are
held against JAX `_window_sums_xla` and against the Pallas kernel in
interpret mode, on random points and on a real scan. Sums run in a
different order on each side, so they agree to rtol 1e-5 (f32 sums of
<= 128 terms in [0.1, 0.9]). The CUDA kernel itself runs only on the
card (the `cuda` test below and chip_smoke.py): it is held against the
plain version at the edges of its design (D up to 35, ragged and short
point counts, one angle, all points masked or off the grid, a grid
smaller than the window) and must give the same sums on every run."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.ops import pallas_kernels
from cartographer_tpu.ops.scan_matching import correlative_2d as jcorr
from cartographer_tpu_torch.kernels import correlative_window
from cartographer_tpu_torch.ops.scan_matching import correlative_2d as tcorr
from cartographer_tpu_torch.testing import synthetic
from cartographer_tpu_torch.transform import rigid3


def make_case(seed, h=64, w=256, a=5, n=48, outside=3):
    rng = np.random.default_rng(seed)
    prob = rng.uniform(0.1, 0.9, (h, w)).astype(np.float32)
    ix = rng.integers(-outside, w + outside, (a, n)).astype(np.int32)
    iy = rng.integers(-outside, h + outside, (a, n)).astype(np.int32)
    mask = rng.uniform(size=n) > 0.2
    return prob, ix, iy, mask


def torch_args(*arrays):
    return [torch.from_numpy(np.asarray(x)) for x in arrays]


class TestWindowSums:
    @pytest.mark.parametrize("num_linear", [0, 2, 5])
    def test_plain_matches_jax_xla(self, num_linear):
        prob, ix, iy, mask = make_case(num_linear)
        want = np.asarray(
            jcorr._window_sums_xla(
                jnp.asarray(prob), jnp.asarray(ix), jnp.asarray(iy),
                jnp.asarray(mask), num_linear,
            )
        )
        got = tcorr.window_sums(*torch_args(prob, ix, iy, mask), num_linear)
        d = 2 * num_linear + 1
        assert got.shape == (5, d, d) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)

    def test_plain_matches_pallas_interpret(self):
        prob, ix, iy, mask = make_case(7)
        want = np.asarray(
            pallas_kernels.correlative_score_windows(
                jnp.asarray(prob), jnp.asarray(ix), jnp.asarray(iy),
                jnp.asarray(mask), 2, interpret=True,
            )
        )
        got = tcorr.window_sums(*torch_args(prob, ix, iy, mask), 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        """The wrapper launches the kernel or raises; it never falls back."""
        prob, ix, iy, mask = make_case(1)
        before = correlative_window.LAUNCHES
        with pytest.raises(ValueError, match="CUDA"):
            correlative_window.window_sums(*torch_args(prob, ix, iy, mask), 2)
        assert correlative_window.LAUNCHES == before

    def test_plain_matches_jax_on_a_real_scan(self):
        """The windows of a loop-world scan, rotated over the candidate
        angles and discretized over a map of the scans before it: points
        cluster on walls, as on the slice's path."""
        prob, ix, iy, mask = real_scan_case(11)
        jargs = [jnp.asarray(x) for x in (prob, ix, iy, mask)]
        want_xla = np.asarray(jcorr._window_sums_xla(*jargs, 2))
        want_pallas = np.asarray(
            pallas_kernels.correlative_score_windows(*jargs, 2, interpret=True)
        )
        got = tcorr.window_sums(*torch_args(prob, ix, iy, mask), 2).numpy()
        assert got.shape == (ix.shape[0], 5, 5)
        assert np.ptp(got) > 1.0  # the walls show in the window sums
        np.testing.assert_allclose(got, want_xla, rtol=1e-5)
        np.testing.assert_allclose(got, want_pallas, rtol=1e-5)

    @pytest.mark.cuda
    @pytest.mark.parametrize(
        "h,w,a,n,num_linear,outside,points",
        [
            pytest.param(1024, 1024, 169, 512, 2, 3, "random", id="main"),
            pytest.param(1024, 1024, 169, 512, 0, 3, "random", id="d1"),
            pytest.param(64, 256, 5, 48, 3, 3, "random", id="d7"),
            # D > 7: one window row per block, 11 rows along blockIdx.y.
            pytest.param(37, 300, 7, 100, 5, 6, "random", id="d11"),
            # D > 32: each row in two column chunks of 32 and 3.
            pytest.param(64, 256, 3, 48, 17, 18, "random", id="d35"),
            pytest.param(64, 256, 5, 545, 2, 3, "random", id="n_ragged"),
            pytest.param(64, 256, 5, 7, 2, 3, "random", id="n_below_warp"),
            pytest.param(64, 256, 1, 48, 2, 3, "random", id="a1"),
            pytest.param(64, 256, 5, 48, 2, 3, "masked", id="all_masked"),
            pytest.param(64, 256, 5, 48, 2, 3, "off_grid", id="all_off_grid"),
            pytest.param(3, 2, 4, 40, 3, 4, "random", id="grid_below_window"),
        ],
    )
    def test_kernel_matches_plain_on_card(
        self, h, w, a, n, num_linear, outside, points
    ):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        prob, ix, iy, mask = make_case(3, h, w, a, n, outside)
        if points == "masked":
            mask[:] = False
        elif points == "off_grid":  # every window cell left of the grid
            ix = -ix - 1 - outside - num_linear
        args = [t.cuda() for t in torch_args(prob, ix, iy, mask)]
        before = correlative_window.LAUNCHES
        got = correlative_window.window_sums(*args, num_linear)
        again = correlative_window.window_sums(*args, num_linear)
        want = correlative_window.window_sums_plain(*args, num_linear)
        torch.cuda.synchronize()
        assert correlative_window.LAUNCHES == before + 2
        assert torch.equal(got, again)  # the same sum on every run
        got = got.cpu().numpy()
        np.testing.assert_allclose(got, want.cpu().numpy(), rtol=1e-5)
        if points == "masked":
            assert not got.any()
        elif points == "off_grid":
            np.testing.assert_allclose(got, 0.1 * mask.sum(), rtol=1e-5)


def real_scan_case(seed, a=9, n=128, res=0.1, size=256):
    """prob [size, size] from the hits of 10 loop-world scans, and the
    11th scan's points rotated by `a` candidate angles about its pose and
    discretized: ix/iy [a, n]; the first 80% of the points are valid."""
    rng = np.random.default_rng(seed)
    measurements, poses = synthetic.generate_loop_world(
        laps=0.01, num_beams=360, seed=seed
    )
    origin = rigid3.trans(poses[10])[:2] - 0.5 * size * res
    prob = np.full((size, size), 0.1, np.float32)
    for m, pose in zip(measurements[:10], poses[:10]):
        cells = np.floor(
            (rigid3.apply(pose, m.ranges.points)[:, :2] - origin) / res
        ).astype(int)
        ok = np.all((cells >= 0) & (cells < size), axis=1)
        cy, cx = cells[ok, 1], cells[ok, 0]
        prob[cy, cx] = rng.uniform(0.55, 0.9, len(cy)).astype(np.float32)
    pts = measurements[10].ranges.points
    pts = pts[rng.choice(len(pts), n, replace=False)]
    world = rigid3.apply(poses[10], pts)[:, :2]
    center = rigid3.trans(poses[10])[:2]
    angles = (np.arange(a) - a // 2) * 0.01
    c, s = np.cos(angles)[:, None], np.sin(angles)[:, None]
    dx, dy = world[:, 0] - center[0], world[:, 1] - center[1]
    wx = c * dx - s * dy + center[0] + 0.02  # the prediction is 2 cm off
    wy = s * dx + c * dy + center[1]
    ix = np.floor((wx - origin[0]) / res).astype(np.int32)
    iy = np.floor((wy - origin[1]) / res).astype(np.int32)
    mask = np.arange(n) < int(0.8 * n)
    return prob, ix, iy, mask


def match_case(seed):
    """A structured grid (random walls) and a scan of its wall cells seen
    from a pose near the grid centre, in the local frame."""
    rng = np.random.default_rng(seed)
    h = w = 64
    res = 0.05
    prob = np.full((h, w), 0.1, np.float32)
    for _ in range(6):
        y0, x0 = rng.integers(8, 56, 2)
        if rng.uniform() < 0.5:
            prob[y0, 8:56] = rng.uniform(0.6, 0.9)
        else:
            prob[8:56, x0] = rng.uniform(0.6, 0.9)
    origin = np.array([-1.6, -1.6], np.float32)
    ys, xs = np.nonzero(prob > 0.5)
    world = np.stack([xs, ys], 1) * res + origin + 0.5 * res
    true_pose = np.array([0.03, -0.02, 0.02])
    c, s = np.cos(true_pose[2]), np.sin(true_pose[2])
    d = world - true_pose[:2]
    local = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]], 1)
    n = 96
    pts = np.zeros((n, 2), np.float32)
    m = min(n - 8, len(local))
    pts[:m] = local[rng.permutation(len(local))[:m]]
    mask = np.arange(n) < m
    return prob, origin, pts, mask


class TestCandidateSearch:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_best_candidate_pose_matches_jax(self, seed):
        prob, origin, pts, mask = match_case(seed)
        init = np.array([0.0, 0.0, 0.0], np.float32)
        a_cap, num_ang, step = 8, 6, np.float32(0.01)
        args = (prob, origin, pts, mask, init)
        j_score, j_pose = jcorr.best_candidate_pose(
            *[jnp.asarray(x) for x in args], jnp.int32(num_ang),
            jnp.float32(step), 0.05, 0.1, 0.1, 2, a_cap,
        )
        t_score, t_pose = tcorr.best_candidate_pose(
            *torch_args(*args), torch.tensor(num_ang, dtype=torch.int32),
            torch.tensor(step), 0.05, 0.1, 0.1, 2, a_cap,
        )
        np.testing.assert_allclose(t_pose.numpy(), np.asarray(j_pose), atol=1e-5)
        np.testing.assert_allclose(float(t_score), float(j_score), rtol=1e-5)

    def test_score_candidates_matches_jax(self):
        prob, origin, pts, mask = match_case(2)
        angles = (np.arange(9, dtype=np.float32) - 4) * np.float32(0.01)
        angle_mask = np.abs(np.arange(9) - 4) <= 3
        init_xy = np.array([0.01, -0.01], np.float32)
        args = (prob, origin, pts, mask, angles, angle_mask, init_xy)
        j_scores, j_best, j_val = jcorr.score_candidates(
            *[jnp.asarray(x) for x in args], 0.05, 0.1, 0.1, 2
        )
        t_scores, t_best, t_val = tcorr.score_candidates(
            *torch_args(*args), 0.05, 0.1, 0.1, 2
        )
        assert int(t_best) == int(j_best)
        np.testing.assert_allclose(
            t_scores.numpy(), np.asarray(j_scores), rtol=1e-5
        )
        np.testing.assert_allclose(float(t_val), float(j_val), rtol=1e-5)

    def test_compute_angular_step_matches_jax(self):
        for res, r in [(0.05, 12.0), (0.05, 0.01), (0.1, 30.0)]:
            assert tcorr.compute_angular_step(res, r) == jcorr.compute_angular_step(res, r)
