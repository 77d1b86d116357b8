"""The port's multi-rank backend (cartographer_tpu_torch/parallel) on the
CPU against the JAX package's sharded paths: real `gloo` ranks, spawned
by multihost.run_ranks or started as worker processes, each with a hard
timeout. The sharded SPA 2D/3D against JAX's on the conftest's 8-device
mesh (rtol 1e-4, atol 1e-5), score_level against JAX's _score_level
(1e-6) and its sharded form exactly, both search drains bit for bit
against the one-rank drain, the 2D production drain with the JAX test's
checks (test_multihost_distributed.py), the worker at the JAX test's
sizes, and the refusals: no CUDA, NCCL off cuda, a mesh on another
device, a rank that never joins a collective."""

import concurrent.futures
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.common.config import OptimizationProblemOptions as JOptions
from cartographer_tpu.mapping.constraint_builder_2d import (
    INTER_SUBMAP as J_INTER,
    INTRA_SUBMAP as J_INTRA,
    Constraint as JConstraint,
    ConstraintPose as JConstraintPose,
)
from cartographer_tpu.mapping.id import NodeId as JNodeId
from cartographer_tpu.mapping.id import SubmapId as JSubmapId
from cartographer_tpu.mapping.optimization_problem_3d import (
    NodeSpec3D as JNodeSpec3D,
    OptimizationProblem3D as JOptimizationProblem3D,
)
from cartographer_tpu.ops.scan_matching import fast_correlative_2d as jfc
from cartographer_tpu.parallel import partition as jpartition
from cartographer_tpu.parallel import sharded as jsharded
from cartographer_tpu.transform import rigid3 as jrigid3
from cartographer_tpu_torch import metrics as tmetrics
from cartographer_tpu_torch.common.config import (
    MapBuilderOptions,
    OptimizationProblemOptions,
    PoseGraphOptions,
)
from cartographer_tpu_torch.common.task import ThreadPool
from cartographer_tpu_torch.mapping.map_builder import MapBuilder
from cartographer_tpu_torch.mapping.optimization_problem_2d import OptimizationProblem2D
from cartographer_tpu_torch.mapping.pose_graph_2d import PoseGraph2D
from cartographer_tpu_torch.ops.scan_matching import fast_correlative_2d as tfc
from cartographer_tpu_torch.ops.scan_matching import fast_correlative_3d as tfc3
from cartographer_tpu_torch.parallel import multihost, partition

from test_sharded_production import _spa_2d_problem as jax_spa_2d_problem
from test_torch_backend_card import one_torch_thread  # noqa: F401
from test_torch_parallel_card import (
    SPA_3D_TRUES,
    bnb_2d_searches,
    bnb_3d_preps,
    cpu_cases,
    mismatch_rank,
    score_inputs,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def two_ranks():
    """cpu_cases on two gloo ranks, started at the first request and run
    beside the tests' own JAX references: a future of the rank results."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(
        multihost.run_ranks, cpu_cases, 2, backend="gloo", device="cpu",
        timeout=300.0, num_threads=1,
    )
    yield future
    future.result(timeout=300.0)
    pool.shutdown()


def both(two_ranks, key):
    results = two_ranks.result(timeout=300.0)
    assert [r["rank"] for r in results] == [0, 1]
    return [r[key] for r in results]


# -- partition ----------------------------------------------------------------

def test_partition_split_put_fetch_pad_match_jax():
    """Rank r's rows are the rows of JAX's r-th shard on an 8-device mesh;
    fetch of a one-rank table and pad_to_mesh equal JAX's; uneven shards
    cover every row once."""
    jmesh = jsharded.make_mesh()
    table = np.arange(24 * 3, dtype=np.float32).reshape(24, 3)
    jput = jpartition.put(table, jpartition.batch_sharding(jmesh))
    devices = list(jmesh.devices.reshape(-1))
    for shard in jput.addressable_shards:
        rank = devices.index(shard.device)
        mesh = partition.Mesh(None, rank, len(devices), CPU)
        got = partition.put(table, partition.batch_sharding(mesh))
        np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
        np.testing.assert_array_equal(
            partition.put(table, partition.replicated_sharding(mesh)).numpy(), table
        )
    np.testing.assert_array_equal(jpartition.fetch(jput), table)
    one = partition.Mesh(None, 0, 1, CPU)
    np.testing.assert_array_equal(partition.fetch(torch.from_numpy(table), one, 24), table)
    for n in (0, 1, 5, 8, 9, 100):
        assert partition.pad_to_mesh(n, partition.Mesh(None, 0, 8, CPU)) == (
            jpartition.pad_to_mesh(n, jmesh)
        )
        assert partition.pad_to_mesh(n, None) == jpartition.pad_to_mesh(n, None)
    rows = [partition.row_range(7, partition.Mesh(None, r, 3, CPU)) for r in range(3)]
    assert rows == [(0, 2), (2, 4), (4, 7)]


# -- no fallback ----------------------------------------------------------------

def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the CPU-only refusal")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        partition.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.initialize()


@pytest.mark.parametrize("case", ["nccl_on_cpu", "two_ranks_no_address", "mesh_larger_than_group"])
def test_initialize_refuses(case):
    with pytest.raises(ValueError):
        if case == "nccl_on_cpu":
            multihost.initialize(device="cpu", backend="nccl")
        elif case == "two_ranks_no_address":
            multihost.initialize(num_processes=2, process_id=0, device="cpu")
        else:
            partition.make_mesh(n_devices=2, devices=["cpu"])


def test_no_collective_moves_a_tensor():
    """A collective on a tensor off the mesh's device raises before any
    copy; a module built on a mesh of another device raises."""
    mesh = partition.Mesh(object(), 0, 2, torch.device("meta"))
    with pytest.raises(ValueError, match="mesh device"):
        partition.all_reduce(torch.ones(3), mesh)
    with pytest.raises(ValueError, match="differs from the mesh"):
        OptimizationProblem2D(OptimizationProblemOptions(), device="cpu", mesh=mesh)
    assert mesh.collectives == {}


# -- sharded SPA against the JAX package's sharded SPA ---------------------------

def test_sharded_spa_3d_matches_jax(two_ranks, one_torch_thread):  # noqa: F811
    jmesh = jsharded.make_mesh()
    noise = np.random.default_rng(3).normal(0, 0.05, (16, 3))
    problem = JOptimizationProblem3D(JOptions(), mesh=jmesh)
    problem.add_submap(0, jrigid3.identity())
    constraints = []
    for i, true in enumerate(SPA_3D_TRUES):
        noisy = np.array(true, np.float64)
        noisy[:3] += noise[i]
        problem.add_trajectory_node(0, JNodeSpec3D(time=float(i), local_pose=true, global_pose=noisy))
        constraints.append(JConstraint(
            JSubmapId(0, 0), JNodeId(0, i), JConstraintPose(np.asarray(true), 40.0, 40.0),
            J_INTRA if i % 2 == 0 else J_INTER,
        ))
    problem.solve(constraints, set())
    want = np.stack([problem.node_data.at(JNodeId(0, i)).global_pose[:3] for i in range(16)])
    ranks = both(two_ranks, "spa_3d")
    np.testing.assert_array_equal(ranks[0], ranks[1])
    np.testing.assert_allclose(ranks[0], want, rtol=1e-4, atol=1e-5)
    err = np.linalg.norm(ranks[0] - np.stack([t[:3] for t in SPA_3D_TRUES]), axis=1)
    assert err.max() < 0.04


@pytest.mark.parametrize("iterations", [5, 50])
def test_sharded_spa_2d_matches_jax(iterations, two_ranks, one_torch_thread):  # noqa: F811
    """TestShardedSpaParity's 2D problem. Its node-node weights (1e5
    against 50) make it stiff: the LM stops on f32 rounding with cost
    ~1e-3 (50 iterations or more), where the CG's stopping step depends
    on the order of the sums. The port's solve (one rank or two) and
    JAX's then differ by up to 2.2e-4 in position; JAX's sharded and
    unsharded solves agree only because XLA's sums are bit-identical. So
    the first 5 LM iterations are held at rtol 1e-4, atol 1e-5, and the
    options' 50 at the port's SPA parity with JAX (1e-3,
    test_torch_backend_ops.test_spa_solve_matches_jax)."""
    problem, constraints = jax_spa_2d_problem(jsharded.make_mesh())
    if iterations != 50:
        problem.set_max_num_iterations(iterations)
    problem.solve(constraints, set())
    want = np.stack([problem.node_data.at(JNodeId(0, i)).global_pose_2d for i in range(24)])
    ranks = both(two_ranks, "spa_2d" if iterations == 50 else f"spa_2d_{iterations}")
    np.testing.assert_array_equal(ranks[0], ranks[1])
    tolerance = dict(rtol=1e-4, atol=1e-5) if iterations == 5 else dict(rtol=0, atol=1e-3)
    np.testing.assert_allclose(ranks[0], want, **tolerance)


def test_fetch_and_global_batches_over_two_ranks(two_ranks):
    """fetch gathers uneven shards exactly; make_global_batch joins each
    rank's rows in rank order (2 and 5 rows); make_global_sharded keeps
    this rank's rows."""
    table = np.arange(7 * 3, dtype=np.float32).reshape(7, 3) - 4.5
    for got in both(two_ranks, "fetch"):
        np.testing.assert_array_equal(got, table)
    for got in both(two_ranks, "global_batch"):
        np.testing.assert_array_equal(got, np.concatenate([table[:2], table[:5]]))
    rows = both(two_ranks, "global_sharded")
    np.testing.assert_array_equal(rows[0], table[:3])
    np.testing.assert_array_equal(rows[1], table[3:])


# -- candidate scoring and the search drains -------------------------------------

def test_score_level_matches_jax_and_sharded_is_exact(two_ranks):
    inputs = score_inputs()
    want = np.asarray(jfc._score_level(*(jnp.asarray(a) for a in inputs)))
    got = tfc.score_level(*(torch.from_numpy(a) for a in inputs)).numpy()
    assert np.isneginf(want).sum() > 0
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=1e-6)
    for scores in both(two_ranks, "scores"):
        np.testing.assert_array_equal(scores, got)


def test_sharded_drains_equal_one_rank_bitwise(two_ranks, one_torch_thread):  # noqa: F811
    """Both search drains over two ranks (uneven shares, sharded widening
    passes) give the one-rank drain's packed rows bit for bit."""
    collected = tmetrics.enable_collection()
    try:
        want_2d, _ = tfc.batch_match_device(bnb_2d_searches())
        want_3d, _ = tfc3.batch_match_device_3d(bnb_3d_preps())
    finally:
        tmetrics.register_family_factory(tmetrics.FamilyFactory())
    registry = collected.registry()
    assert registry["mapping_constraint_builder_beam_overflow_retries"].value() > 0
    assert registry["parallel_sharded_constraint_batches"].value() == 0
    assert np.any(want_2d[:, 1] >= 0) and np.any(want_3d[:, 2] >= 0)
    for name, want in (("bnb_2d", want_2d), ("bnb_3d", want_3d)):
        for got in both(two_ranks, name):
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# -- the production drain and the worker -----------------------------------------

def test_production_drain_2d_over_two_ranks(two_ranks):
    """test_multihost_distributed.py's checks of the 2D production drain,
    and both ranks agree on the pose digest."""
    drains = both(two_ranks, "drain_2d")
    for d in drains:
        assert d["sharded_search_batches"] > 0
        assert d["sharded_spa_solves"] > 0
        assert d["inter_constraints"] > 0
        assert d["max_node_error_m"] < 0.15 * d["travel_m"]
        assert d["tensor_devices"] == ["cpu"]
    assert drains[0]["pose_digest"] == pytest.approx(drains[1]["pose_digest"], abs=1e-6)
    for collectives in both(two_ranks, "collectives"):
        assert set(collectives) == {"cpu"} and collectives["cpu"] > 0


def test_several_ranks_drain_synchronously():
    """MapBuilder ignores async_pose_graph on a mesh of two ranks (no
    thread pool) and keeps it on a one-rank mesh; a pose graph given a
    thread pool and a mesh of two ranks raises."""
    two = partition.Mesh(object(), 0, 2, CPU)
    one = partition.Mesh(None, 0, 1, CPU)
    options = MapBuilderOptions(use_trajectory_builder_2d=True)
    assert options.async_pose_graph
    assert MapBuilder(options, mesh=two)._thread_pool is None
    mb = MapBuilder(options, mesh=one)
    try:
        assert mb._thread_pool is not None
    finally:
        mb._thread_pool.shutdown()
    pool = ThreadPool(1)
    try:
        with pytest.raises(ValueError, match="synchronous drains"):
            PoseGraph2D(PoseGraphOptions(), pool, device="cpu", mesh=two)
    finally:
        pool.shutdown()


def test_rank_mismatch_ends_in_timeout(one_torch_thread):  # noqa: F811
    """Rank 0 waits in an all_reduce that rank 1 never joins: the rank
    fails with the process group's timeout instead of hanging."""
    with pytest.raises(RuntimeError, match="rank 0 failed") as err:
        multihost.run_ranks(
            mismatch_rank, 2, backend="gloo", device="cpu", timeout=60.0,
            collective_timeout=3.0, num_threads=1,
        )
    assert "imed out" in str(err.value) or "imeout" in str(err.value)


def _start_workers(num_processes):
    port = multihost.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for pid in range(num_processes):
        args = [
            sys.executable, "-m", "cartographer_tpu_torch.tools.multihost_worker",
            "--device", "cpu", "--candidates_per_device", "64", "--spa_nodes", "256",
            "--lm_iterations", "4", "--cg_iterations", "8",
        ]
        if num_processes > 1:
            args += ["--coordinator_address", f"127.0.0.1:{port}",
                     "--num_processes", str(num_processes), "--process_id", str(pid),
                     "--backend", "gloo"]
        procs.append(subprocess.Popen(args, cwd=REPO, env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    return procs


def _reports(procs):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
            outs.append({r["metric"]: r for r in lines})
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_worker_two_ranks_match_one():
    """The worker at the JAX test's sizes: two ranks against one at rel
    1e-3 on the final SPA cost, the ranks against each other at rel 1e-6,
    and the sharded scores equal to the unsharded ones."""
    single_procs = _start_workers(1)
    duo_procs = _start_workers(2)
    (single,) = _reports(single_procs)
    duo = _reports(duo_procs)
    assert single["sharded_spa_solve"]["num_devices"] == 1
    costs = []
    for pid, reports in enumerate(duo):
        score, spa = reports["sharded_candidate_scores"], reports["sharded_spa_solve"]
        assert score["num_processes"] == 2 and score["num_devices"] == 2
        assert score["backend"] == "gloo" and score["device"] == "cpu"
        assert score["max_abs_err_vs_unsharded"] == 0.0
        assert spa["process_id"] == pid
        assert spa["final_cost"] == pytest.approx(
            single["sharded_spa_solve"]["final_cost"], rel=1e-3
        )
        costs.append(spa["final_cost"])
    assert costs[0] == pytest.approx(costs[1], rel=1e-6)
