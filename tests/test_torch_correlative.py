"""PyTorch port of the RTCSM window scorer against the JAX package.

The port's plain window sums (the CPU side of
cartographer_tpu_torch.ops.scan_matching.correlative_2d.window_sums) are
held against JAX `_window_sums_xla` and against the Pallas kernel in
interpret mode. Sums run in a different order on each side, so they
agree to rtol 1e-5 (f32 sums of <= 48 terms in [0.1, 0.9]). The CUDA
kernel itself runs only on the card (the `cuda` test below and
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.ops import pallas_kernels
from cartographer_tpu.ops.scan_matching import correlative_2d as jcorr
from cartographer_tpu_torch.kernels import correlative_window
from cartographer_tpu_torch.ops.scan_matching import correlative_2d as tcorr


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

    @pytest.mark.cuda
    @pytest.mark.parametrize(
        "h,w,a,n,num_linear,outside",
        [(1024, 1024, 169, 512, 2, 3), (37, 300, 7, 100, 5, 6),
         (64, 256, 5, 48, 0, 3)],
    )
    def test_kernel_matches_plain_on_card(self, h, w, a, n, num_linear, outside):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        prob, ix, iy, mask = make_case(3, h, w, a, n, outside)
        args = [t.cuda() for t in torch_args(prob, ix, iy, mask)]
        before = correlative_window.LAUNCHES
        got = correlative_window.window_sums(*args, num_linear)
        want = correlative_window.window_sums_plain(*args, num_linear)
        torch.cuda.synchronize()
        assert correlative_window.LAUNCHES == before + 1
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5)


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
