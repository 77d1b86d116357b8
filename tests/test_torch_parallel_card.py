"""The multi-rank backend on the card (one rank over NCCL; two ranks
refused by NCCL on one card), and the rank programs and worlds that the
CPU tests (test_torch_parallel.py) spawn. Nothing here imports the JAX
package: `python -m pytest tests/test_torch_parallel_card.py -m cuda`."""

import time

import numpy as np
import pytest
import torch

from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.common.config import OptimizationProblemOptions
from cartographer_tpu_torch.mapping.constraint_builder_2d import (
    INTER_SUBMAP,
    INTRA_SUBMAP,
    Constraint,
    ConstraintPose,
)
from cartographer_tpu_torch.mapping.grid_2d import grid_from_numpy
from cartographer_tpu_torch.mapping.hybrid_grid import grid3d_from_numpy
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.optimization_problem_2d import (
    NodeSpec2D,
    OptimizationProblem2D,
)
from cartographer_tpu_torch.mapping.optimization_problem_3d import (
    NodeSpec3D,
    OptimizationProblem3D,
)
from cartographer_tpu_torch.ops.scan_matching import fast_correlative_2d as tfc
from cartographer_tpu_torch.ops.scan_matching import fast_correlative_3d as tfc3
from cartographer_tpu_torch.parallel import multihost, partition, sharded
from cartographer_tpu_torch.testing import production_dryrun
from cartographer_tpu_torch.transform import rigid3

from test_torch_backend_3d_card import wall_world as wall_world_3d
from test_torch_backend_card import TFastOptions, searches, wall_world


# -- worlds, built alike by the ranks and by the tests ----------------------

def spa_2d_problem(mesh, device="cpu"):
    """test_sharded_production._spa_2d_problem on the port: a noisy pose
    chain of 24 nodes with INTRA and INTER constraints (seed 7)."""
    rng = np.random.default_rng(7)
    problem = OptimizationProblem2D(OptimizationProblemOptions(), device=device, mesh=mesh)
    problem.add_submap(0, np.zeros(3))
    constraints = []
    for i in range(24):
        true = np.array([0.1 * i, 0.05 * i, 0.0])
        noisy = true + rng.normal(0, 0.03, 3)
        problem.add_trajectory_node(0, NodeSpec2D(
            time=float(i), local_pose_2d=true, global_pose_2d=noisy,
            gravity_alignment=np.array([1.0, 0, 0, 0]),
        ))
        constraints.append(Constraint(
            SubmapId(0, 0), NodeId(0, i), ConstraintPose(true, 50.0, 60.0),
            INTRA_SUBMAP if i % 2 == 0 else INTER_SUBMAP,
        ))
    return problem, constraints


def spa_2d_poses(mesh, device="cpu", iterations=None):
    """The solved node poses; `iterations` caps the LM iterations (the
    options' 50 by default)."""
    problem, constraints = spa_2d_problem(mesh, device)
    if iterations is not None:
        problem.set_max_num_iterations(iterations)
    problem.solve(constraints, set())
    return np.stack([problem.node_data.at(NodeId(0, i)).global_pose_2d for i in range(24)])


SPA_3D_TRUES = [rigid3.make([0.2 * i, 0.1 * i, 0.02 * i], [1, 0, 0, 0]) for i in range(16)]


def spa_3d_positions(mesh, device="cpu"):
    """test_sharded_production's 3D problem on the port: 16 nodes with
    position noise (seed 3); the solved node positions."""
    noise = np.random.default_rng(3).normal(0, 0.05, (16, 3))
    problem = OptimizationProblem3D(OptimizationProblemOptions(), device=device, mesh=mesh)
    problem.add_submap(0, rigid3.identity())
    constraints = []
    for i, true in enumerate(SPA_3D_TRUES):
        noisy = np.array(true, np.float64)
        noisy[:3] += noise[i]
        problem.add_trajectory_node(0, NodeSpec3D(time=float(i), local_pose=true, global_pose=noisy))
        constraints.append(Constraint(
            SubmapId(0, 0), NodeId(0, i), ConstraintPose(np.asarray(true), 40.0, 40.0),
            INTRA_SUBMAP if i % 2 == 0 else INTER_SUBMAP,
        ))
    problem.solve(constraints, set())
    return np.stack([problem.node_data.at(NodeId(0, i)).global_pose[:3] for i in range(16)])


def score_inputs(seed=5, h=40, w=48, a=6, n=33, c=37):
    """score_level's inputs: a uint8 pool, scans that leave the grid, a
    point mask with holes and an odd number of candidates, some invalid."""
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 256, (h, w)).astype(np.uint8),
        rng.integers(-4, w + 4, (a, n)).astype(np.int32),
        rng.integers(-4, h + 4, (a, n)).astype(np.int32),
        rng.uniform(size=n) < 0.8,
        rng.integers(0, a, c).astype(np.int32),
        rng.integers(-6, 6, c).astype(np.int32),
        rng.integers(-6, 6, c).astype(np.int32),
        rng.uniform(size=c) < 0.9,
    )


def bnb_2d_searches(device="cpu"):
    """Five windowed and full-submap searches on two submaps, beam 256:
    some overflow and are widened (test_torch_backend_ops)."""
    grids, scans, centers = [], [], []
    for seed in (2, 3):
        lo, kn, scan, center = wall_world(seed, size=96, radius=1.6, num_points=200)
        grids.append(grid_from_numpy(lo, kn, np.array([0.1, -0.2]), 0.05, device))
        scans.append(scan)
        centers.append(center + [0.1, -0.2])
    return searches(tfc, grids, TFastOptions, 256, scans, centers, list(range(5)))


def bnb_3d_preps(device="cpu"):
    """Three 3D searches at depth 4 with a beam of 4, which binds: the
    widening passes run (test_torch_fast_correlative_3d)."""
    grids, hist, cloud = wall_world_3d()
    options = tconfig.FastCorrelativeScanMatcherOptions3D(
        branch_and_bound_depth=4, full_resolution_depth=3,
        linear_xy_search_window=0.8, linear_z_search_window=0.4,
        angular_search_window=np.radians(10.0), min_rotational_score=0.1,
        min_low_resolution_score=0.1, beam_width=4,
    )
    matcher = tfc3.FastCorrelativeScanMatcher3D(
        grid3d_from_numpy(*grids[0], device), grid3d_from_numpy(*grids[1], device),
        hist, options,
    )
    rng = np.random.default_rng(12)
    preps = []
    for _ in range(3):
        pose = rigid3.make(
            rng.normal(0, 0.15, 3),
            rigid3.quat_from_angle_axis(np.array([0.0, 0.0, rng.normal(0, 0.04)])),
        )
        preps.append(matcher._prepare(pose, hist, 0.0, cloud, cloud[::3].copy(), 0.3))
    return preps


# -- rank programs (run by multihost.run_ranks) -----------------------------

def cpu_cases(ctx):
    """Every sharded path on this rank's mesh: both SPA problems, sharded
    scoring, both search drains, a gather of uneven shards and the 2D
    production drain. Returns numpy results."""
    mesh = ctx.mesh
    inputs = [torch.from_numpy(a) for a in score_inputs()]
    table = np.arange(7 * 3, dtype=np.float32).reshape(7, 3) - 4.5
    return {
        "rank": mesh.rank,
        "spa_3d": spa_3d_positions(mesh),
        "spa_2d": spa_2d_poses(mesh),
        "spa_2d_5": spa_2d_poses(mesh, iterations=5),
        "scores": sharded.make_sharded_score_level(mesh)(*inputs).numpy(),
        "bnb_2d": tfc.batch_match_device(bnb_2d_searches(), mesh=mesh)[0],
        "bnb_3d": tfc3.batch_match_device_3d(bnb_3d_preps(), mesh=mesh)[0],
        "fetch": partition.fetch(
            partition.put(table, partition.batch_sharding(mesh)), mesh, len(table)
        ),
        "global_batch": multihost.make_global_batch(ctx, table[: 2 + 3 * mesh.rank]).numpy(),
        "global_sharded": multihost.make_global_sharded(ctx, table).numpy(),
        "drain_2d": production_dryrun.run_production_drain_2d(mesh),
        "collectives": dict(mesh.collectives),
    }


def mismatch_rank(ctx):
    """Rank 0 waits in a collective that rank 1 never joins."""
    if ctx.mesh.rank == 0:
        partition.all_reduce(torch.ones(3), ctx.mesh)
    else:
        time.sleep(6.0)


def noop_rank(ctx):
    return ctx.mesh.rank


# -- card tests ---------------------------------------------------------------

def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_one_rank_nccl_runs_sharded_spa_on_card():
    """initialize(device="cuda", backend="nccl") at one rank: both sharded
    SPA solves run on cuda tensors through NCCL collectives and agree with
    the unsharded solves on the card."""
    need_card()
    ctx = multihost.initialize(device="cuda", backend="nccl")
    try:
        mesh = ctx.mesh
        assert ctx.backend == "nccl" and mesh.device.type == "cuda"
        got_2d = spa_2d_poses(mesh, device=mesh.device)
        got_3d = spa_3d_positions(mesh, device=mesh.device)
        assert set(mesh.collectives) == {"cuda"} and mesh.collectives["cuda"] > 0
    finally:
        multihost.shutdown()
    np.testing.assert_allclose(got_2d, spa_2d_poses(None, "cuda"), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_3d, spa_3d_positions(None, "cuda"), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_two_ranks_nccl_on_one_card_raise():
    """Two ranks asking for NCCL on one card fail with the error that names
    backend="gloo", on every rank, instead of hanging in NCCL."""
    need_card()
    with pytest.raises(RuntimeError, match='backend="gloo"'):
        multihost.run_ranks(noop_rank, 2, backend="nccl", device="cuda:0", timeout=120.0)
