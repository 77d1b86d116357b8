"""The 2D SPA solve's routing and counts on the CPU: CPU tensors take the
plain solve and never reach the kernel (kernels/spa_2d, which runs only on
the card: tests/test_torch_spa_2d_card.py), the kernel's wrapper raises
before any launch on what it does not take, and both gauges read the
plain solve's LM iterations and CG steps, held against a count made
independently of the solver (a CG loop that stops instead of freezing).
"""

import numpy as np
import pytest
import torch

from cartographer_tpu_torch import kernels, metrics
from cartographer_tpu_torch.kernels import spa_2d
from cartographer_tpu_torch.ops import spa_solver
from cartographer_tpu_torch.testing import spa_cases_2d as cases

CPU = torch.device("cpu")
HUBER_SCALE = 10.0


@pytest.fixture
def no_launch(monkeypatch):
    """The kernel's ctypes function raises if anything reaches it."""

    def refuse(*_):
        raise AssertionError("the SPA kernel was launched")

    monkeypatch.setattr(spa_2d, "_function", refuse)
    before = spa_2d.LAUNCHES
    yield
    assert spa_2d.LAUNCHES == before


@pytest.fixture
def gauges():
    registry = metrics.enable_collection().registry()

    def read():
        return (registry["mapping_pose_graph_spa_lm_iterations"].value(),
                registry["mapping_pose_graph_spa_cg_steps"].value())

    yield read
    metrics.register_family_factory(metrics.FamilyFactory())


def stopping_cg(apply_a, b, pre, maxiter):
    """jax.scipy.sparse.linalg.cg's loop as written there: it stops at the
    first step with ||r||^2 <= tol^2 ||b||^2. Returns (x, steps)."""
    atol2 = spa_solver._CG_TOL * spa_solver._CG_TOL * torch.sum(b * b)
    x = torch.zeros_like(b)
    r = b
    z = r / pre
    p = z
    gamma = torch.sum(r * z)
    steps = 0
    while steps < maxiter and bool(torch.sum(r * r) > atol2):
        ap = apply_a(p)
        alpha = gamma / torch.sum(p * ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = r / pre
        gamma_new = torch.sum(r * z)
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
        steps += 1
    return x, steps


LOOPS = {
    "loop": (0, None, dict(max_iterations=30)),
    "loop-nonmonotonic": (1, None, dict(max_iterations=30, use_nonmonotonic_steps=True)),
    "landmark-fixed-frame-free": (2, "free", dict(max_iterations=3)),
}
NAMES = [*LOOPS, "trajectory"]


def problem(name):
    """(tables, extras tables, solve keywords): the JAX parity test's loop
    graphs, and a small replay-shaped graph with a frozen trajectory."""
    if name in LOOPS:
        seed, extras, kw = LOOPS[name]
        return (*cases.loop_graph(seed, extras=extras), kw)
    small, _ = cases.trajectory_graph(5, num_nodes=120, nodes_per_submap=30,
                                      frozen_nodes=30, inter=60, outliers=3)
    return small, None, dict(max_iterations=8, cg_iterations=32)


@pytest.mark.parametrize("name", NAMES)
def test_cpu_tensors_take_the_plain_solve(no_launch, name):
    tables, ex, kw = problem(name)
    p = spa_solver.problem_from_numpy(tables, CPU)
    x = None if ex is None else spa_solver.extras_from_numpy(ex, CPU)
    before = kernels.launch_counts()["spa_2d"]
    got = spa_solver.solve(p, HUBER_SCALE, extras=x, **kw)
    want = spa_solver.solve_plain(p, HUBER_SCALE, extras=x, **kw)
    assert kernels.launch_counts()["spa_2d"] == before
    for g, w in zip(got, want):
        assert g.device == CPU and torch.equal(g, w)


@pytest.mark.parametrize("name", NAMES)
def test_gauges_read_the_plain_solves_counts(monkeypatch, gauges, name):
    """Each LM iteration runs the CG once; the frozen CG gives what the
    stopping loop gives, after the steps the CG-step gauge sums."""
    tables, ex, kw = problem(name)
    cg = spa_solver._cg
    counted = []

    def counting_cg(apply_a, b, pre, maxiter, steps=None):
        x = cg(apply_a, b, pre, maxiter, steps)
        y, n = stopping_cg(apply_a, b, pre, maxiter)
        assert torch.equal(x, y)
        counted.append(n)
        return x

    monkeypatch.setattr(spa_solver, "_cg", counting_cg)
    p = spa_solver.problem_from_numpy(tables, CPU)
    x = None if ex is None else spa_solver.extras_from_numpy(ex, CPU)
    spa_solver.solve(p, HUBER_SCALE, extras=x, **kw)
    assert gauges() == (len(counted), sum(counted))
    assert 0 < len(counted) <= kw["max_iterations"]
    assert sum(counted) > len(counted)


def test_cg_counts_the_steps_before_its_stop():
    d = torch.tensor([1.0, 1.0, 4.0, 4.0, 9.0, 9.0])
    b = torch.tensor([1.0, -2.0, 0.5, 3.0, -1.0, 2.0])

    def apply_a(v):
        return d * v

    for pre, want in ((torch.ones(6), 3), (d, 1)):
        steps = torch.zeros((), dtype=torch.int64)
        x = spa_solver._cg(apply_a, b, pre, 10, steps)
        assert int(steps) == want
        torch.testing.assert_close(x, b / d)
    steps = torch.zeros((), dtype=torch.int64)
    spa_solver._cg(apply_a, torch.zeros(6), torch.ones(6), 10, steps)
    assert int(steps) == 0


def test_trajectory_graph_is_a_replays_graph():
    """The cell-sized problem: its sizes, a held first submap and a frozen
    trajectory, local SLAM's rows agreeing with the start and the loop
    closures with the truth; the plain solve moves the start toward the
    truth."""
    t, truth = cases.trajectory_graph(3)
    s, n = t["submap_poses"].shape[0], t["node_poses"].shape[0]
    assert (s, n, len(t["c_z"]), len(t["n_z"])) == (17, 1120, 3000, 999)
    assert t["c_mask"].all() and t["n_mask"].all() and t["c_huber"].sum() == 900
    assert not t["free_submap"][0] and not t["free_submap"][15:].any()
    assert t["free_node"][:1000].all() and not t["free_node"][1000:].any()
    small, truth = cases.trajectory_graph(6, num_nodes=150, nodes_per_submap=30,
                                          frozen_nodes=30, inter=100, outliers=0)
    p = spa_solver.problem_from_numpy(small, CPU)
    got = spa_solver.solve(p, HUBER_SCALE, max_iterations=20)[1].numpy()
    before = np.abs(small["node_poses"][:, :2] - truth[:, :2]).max()
    after = np.abs(got[:, :2] - truth[:, :2]).max()
    assert after < 0.5 * before, (before, after)


@pytest.mark.parametrize(
    "fault,error",
    [
        (lambda p, x: (p, x), "needs CUDA"),
        (lambda p, x: (p._replace(c_z=p.c_z.double()), x), "c_z: expected"),
        (lambda p, x: (p._replace(c_weight=p.c_weight[:-1]), x), "c_weight: shape"),
        (lambda p, x: (p._replace(node_poses=p.node_poses.t().contiguous().t()), x),
         "must be contiguous"),
        (lambda p, x: (p, x._replace(o_factor=x.o_factor[:2])), "o_factor: shape"),
        (lambda p, x: (p, x._replace(g_traj=x.g_traj.long())), "g_traj: expected"),
    ],
    ids=["cpu", "dtype", "shape", "strides", "extras-shape", "extras-dtype"],
)
def test_wrapper_raises_before_launching(no_launch, fault, error):
    tables, ex = cases.loop_graph(2, extras="held")
    p, x = fault(spa_solver.problem_from_numpy(tables, CPU),
                 spa_solver.extras_from_numpy(ex, CPU))
    with pytest.raises((TypeError, ValueError), match=error):
        spa_2d.solve(p, x, HUBER_SCALE, 10, 64, False)
