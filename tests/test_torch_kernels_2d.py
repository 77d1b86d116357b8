"""The 2D main path's kernels on the CPU: dispatch (CPU tensors take the
plain versions and launch nothing), the wrappers' checks (they raise
before any launch), and the plain versions against the JAX functions at
the edge cases the kernels must cover. The kernels themselves run only
on the card (tests/test_torch_kernels_2d_card.py).

Tolerances: the insertions bit for bit; the LM within 1e-4 m / rad and
rel 1e-4 in cost (transcendentals and sum orders differ between XLA:CPU
and PyTorch by ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.ops import raycast_2d as jray
from cartographer_tpu.ops.scan_matching import gauss_newton_2d as jgn
from cartographer_tpu_torch.kernels import lm_match_2d, supercover_2d
from cartographer_tpu_torch.ops import raycast_2d as tray
from cartographer_tpu_torch.ops.scan_matching import gauss_newton_2d as tgn
from cartographer_tpu_torch.testing.kernel_cases_2d import num_steps_for
from test_torch_kernels_2d_card import insert_case, lm_case, to

WEIGHTS = (1.0, 10.0, 40.0)
CPU = torch.device("cpu")


@pytest.fixture
def no_launch(monkeypatch):
    """The kernels' ctypes functions raise if anything reaches them."""

    def refuse(*_):
        raise AssertionError("a kernel was launched")

    monkeypatch.setattr(lm_match_2d, "_function", refuse)
    monkeypatch.setattr(supercover_2d, "_function", refuse)
    counts = (lm_match_2d.LAUNCHES, supercover_2d.DENSE_LAUNCHES,
              supercover_2d.SCATTER_LAUNCHES)
    yield
    assert counts == (lm_match_2d.LAUNCHES, supercover_2d.DENSE_LAUNCHES,
                      supercover_2d.SCATTER_LAUNCHES)


def test_cpu_tensors_take_the_plain_lm(no_launch):
    c = lm_case(1)
    args = to(CPU, c["grids"], c["grid_index"], c["origins"], c["initial"],
              c["targets"], c["points"], c["masks"], c["resolutions"])
    pose, cost = tgn.match_lanes(*args, *WEIGHTS, 10, True)
    want = tgn.match_lanes_plain(*args, *WEIGHTS, 10, True)
    assert torch.equal(pose, want[0]) and torch.equal(cost, want[1])
    one = tgn.match(*to(CPU, c["grids"][1], c["origins"][3], c["initial"][3],
                        c["targets"][3], c["points"][3], c["masks"][3]),
                    0.05, *WEIGHTS, 10, True)
    np.testing.assert_allclose(one[0].numpy(), pose[3].numpy(), atol=1e-6)


def test_cpu_tensors_take_the_plain_insertions(no_launch):
    lo, kn, origin, ends, is_hit, valid = insert_case(2, b=2)
    args = to(CPU, lo, kn, origin, ends, is_hit, valid)
    got = tray.insert_scan_dense(*args, 0.2, -0.04)
    want = tray.insert_scan_dense_plain(*args, 0.2, -0.04)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    one = [args[0][0], args[1][0], args[2][0], args[3][0], *args[4:]]
    got = tray.insert_scan(*one, 0.2, -0.04, 512)
    want = tray.insert_scan_plain(*one, 0.2, -0.04, 512)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _lm_args(fault):
    c = lm_case(1)
    grids, origins, initial, targets, points, masks = to(
        CPU, c["grids"], c["origins"], c["initial"], c["targets"], c["points"],
        c["masks"])
    if fault == "dtype":
        points = points.double()
    elif fault == "shape":
        masks = masks[:, :-1]
    return (grids, origins, initial, targets, points, masks, *WEIGHTS, 10, False)


def _insert_args(fault, dense):
    lo, kn, origin, ends, is_hit, valid = to(CPU, *insert_case(2, b=2))
    if not dense:
        lo, kn, origin, ends = lo[0], kn[0], origin[0], ends[0]
    if fault == "dtype":
        kn = kn.to(torch.uint8)
    elif fault == "shape":
        valid = valid[:-1]
    return lo, kn, origin, ends, is_hit, valid, 0.2, -0.04


@pytest.mark.parametrize("fault,error", [
    ("cpu", "needs CUDA tensors"), ("dtype", "expected"), ("shape", "do not match"),
])
@pytest.mark.parametrize("kernel", ["lm", "dense", "scatter"])
def test_wrappers_raise_before_launching(no_launch, kernel, fault, error):
    if kernel == "lm":
        call = lambda: lm_match_2d.launch(*_lm_args(fault), resolution=0.05)  # noqa: E731
    elif kernel == "dense":
        call = lambda: supercover_2d.insert_scan_dense(*_insert_args(fault, True))  # noqa: E731
    else:
        call = lambda: supercover_2d.insert_scan(*_insert_args(fault, False), 512)  # noqa: E731
    if kernel != "lm" and fault == "shape":
        error = r"valid: expected bool \[400\]"
    with pytest.raises((TypeError, ValueError), match=error):
        call()


def _jax_lanes(c, nonmonotonic, iterations=10):
    """The JAX `match` on each lane's own grid."""
    out = []
    for lane in range(len(c["grid_index"])):
        pose, cost = jgn.match(
            jnp.asarray(c["grids"][c["grid_index"][lane]]), jnp.asarray(c["origins"][lane]),
            jnp.asarray(c["initial"][lane]), jnp.asarray(c["targets"][lane]),
            jnp.asarray(c["points"][lane]), jnp.asarray(c["masks"][lane]),
            float(c["resolutions"][lane]), *WEIGHTS, iterations, nonmonotonic,
        )
        out.append([*np.asarray(pose), float(cost)])
    return np.array(out)


@pytest.mark.parametrize("nonmonotonic", [False, True])
def test_plain_lm_lanes_match_jax(nonmonotonic):
    """K = 5 lanes on two shared grids, N = 100: a lane with every point
    masked, a lane partly off the grid."""
    c = lm_case(2)
    pose, cost = tgn.match_lanes_plain(
        *to(CPU, c["grids"], c["grid_index"], c["origins"], c["initial"],
            c["targets"], c["points"], c["masks"], c["resolutions"]),
        *WEIGHTS, 10, nonmonotonic)
    want = _jax_lanes(c, nonmonotonic)
    np.testing.assert_allclose(pose.numpy(), want[:, :3], atol=1e-4)
    np.testing.assert_allclose(cost.numpy(), want[:, 3], rtol=1e-4)
    assert np.abs(pose.numpy()[2:] - c["initial"][2:]).max() > 1e-3  # it moved
    # The masked lane only pulls towards its target and initial yaw.
    np.testing.assert_allclose(pose.numpy()[0, :2], c["targets"][0], atol=1e-4)


def test_plain_lm_edge_shapes():
    """K = 0, and the frontend's K = 1 at N = 37 with 20 iterations."""
    c = lm_case(4, k=1, n=37, s=1)
    want = _jax_lanes(c, False, 20)
    pose, cost = tgn.match(
        *to(CPU, c["grids"][0], c["origins"][0], c["initial"][0], c["targets"][0],
            c["points"][0], c["masks"][0]), 0.05, *WEIGHTS, 20)
    np.testing.assert_allclose(pose.numpy(), want[0, :3], atol=1e-4)
    np.testing.assert_allclose(float(cost), want[0, 3], rtol=1e-4)
    c = lm_case(4)
    args = to(CPU, c["grids"], c["grid_index"][:0], c["origins"][:0], c["initial"][:0],
              c["targets"][:0], c["points"][:0], c["masks"][:0], c["resolutions"][:0])
    pose, cost = tgn.match_lanes(*args, *WEIGHTS, 10, True)
    assert pose.shape == (0, 3) and cost.shape == (0,)


def test_plain_lm_batch_matches_jax_packed():
    """match_log_odds_batch (clouds by row, grids by index) against the
    JAX package's packed batch: 6 lanes over 3 clouds of 45 points (one
    cloud all masked) and two grids."""
    c = lm_case(5, k=3, n=45)
    rng = np.random.default_rng(5)
    known = rng.uniform(size=c["grids"].shape) < 0.8
    log_odds = np.log((1.0 - c["grids"]) / c["grids"]).astype(np.float32)
    k = 6
    sidx = np.array([0, 1, 0, 1, 1, 0], np.int32)
    rows = np.array([1, 2, 0, 2, 1, 1], np.int32)
    origins = np.tile(c["origins"][0], (k, 1))
    initial = rng.uniform(-0.03, 0.03, (k, 3)).astype(np.float32)
    target = initial[:, :2].copy()
    res = np.full(k, 0.05, np.float32)
    buf = np.concatenate([x.ravel().view(np.uint8) for x in
                          (origins, initial, target, res, sidx, rows)])
    want = np.asarray(jgn.match_log_odds_batch_packed(
        jnp.asarray(log_odds), jnp.asarray(known), jnp.asarray(c["points"]),
        jnp.asarray(c["masks"]), jnp.asarray(buf), k, *WEIGHTS, 10, True))
    got = tgn.match_log_odds_batch(
        *to(CPU, log_odds, known, c["points"], c["masks"], origins, initial,
            target, res, sidx, rows), *WEIGHTS, 10, True).numpy()
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=1e-4)
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=1e-4)


@pytest.mark.parametrize("b,free_space", [(1, True), (2, True), (1, False)])
def test_plain_dense_insertion_matches_jax(b, free_space):
    """W = 300 (not a multiple of 32): horizontal and vertical rays, ends
    on lattice corners, rays leaving the grid; B grids under shared rays
    equal the JAX function grid by grid."""
    lo, kn, origin, ends, is_hit, valid = insert_case(10 + b, b=b)
    got = tray.insert_scan_dense_plain(
        *to(CPU, lo if b > 1 else lo[0], kn if b > 1 else kn[0],
            origin if b > 1 else origin[0], ends if b > 1 else ends[0],
            is_hit, valid), 0.2, -0.04, free_space)
    for i in range(b):
        j_lo, j_kn = jray.insert_scan_dense(
            *[jnp.asarray(x) for x in (lo[i], kn[i], origin[i], ends[i], is_hit, valid)],
            0.2, -0.04, free_space)
        t_lo, t_kn = [x[i] if b > 1 else x for x in got]
        np.testing.assert_array_equal(t_kn.numpy(), np.asarray(j_kn))
        np.testing.assert_array_equal(t_lo.numpy().view(np.uint32),
                                      np.asarray(j_lo).view(np.uint32))
        assert (t_kn.numpy() & ~kn[i]).sum() > 0


@pytest.mark.parametrize("free_space", [True, False])
def test_plain_scatter_insertion_matches_jax(free_space):
    """Rays with d = 0 on one axis (horizontal and vertical), ends on
    lattice corners, crossings and ends off the grid (the dummy cell)."""
    lo, kn, origin, ends, is_hit, valid = insert_case(20)
    steps = num_steps_for(origin[0], ends[0])
    args = (lo[0], kn[0], origin[0], ends[0], is_hit, valid)
    j_lo, j_kn = jray.insert_scan(*[jnp.asarray(x) for x in args], 0.2, -0.04,
                                  steps, free_space)
    t_lo, t_kn = tray.insert_scan_plain(*to(CPU, *args), 0.2, -0.04, steps, free_space)
    np.testing.assert_array_equal(t_kn.numpy(), np.asarray(j_kn))
    np.testing.assert_array_equal(t_lo.numpy().view(np.uint32),
                                  np.asarray(j_lo).view(np.uint32))
    assert (t_kn.numpy() & ~kn[0]).sum() > 0
