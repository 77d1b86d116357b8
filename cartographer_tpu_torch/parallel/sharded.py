"""Multi-rank sharding for the scalable backend workloads.

Port of cartographer_tpu/parallel/sharded.py onto torch.distributed. The
reference scales by threads (ThreadPool constraint search,
constraint_builder_2d.cc:102-136) and a single gRPC server for the shared
pose graph. Here, as in the JAX package, two workloads are split over the
ranks of a mesh (parallel/partition.Mesh, one device per rank):

* Loop-closure candidate scoring: the production drain
  (constraint_builder_2d.run_pending -> fast_correlative_2d
  .batch_match_device, and the 3D twin) splits the SEARCH batch over the
  ranks; each rank runs whole branch-and-bound searches and the packed
  rows are gathered exactly.
* SPA solve: the residual tables are split by rows and the pose tables
  replicated; the J^T J products, gradients, costs and the Jacobi
  diagonal are all-reduced (ops/spa_solver.solve and
  ops/spa_solver_3d.solve_3d with `mesh`). Both production solvers
  (optimization_problem_{2d,3d}.solve) take this path when the pose graph
  owns a mesh.

Construction: pass a mesh to MapBuilder (or PoseGraph2D/3D directly); a
one-rank mesh computes what the unsharded path does.
"""

from __future__ import annotations

from cartographer_tpu_torch.ops import spa_solver, spa_solver_3d
from cartographer_tpu_torch.ops.scan_matching import fast_correlative_2d
from cartographer_tpu_torch.parallel.partition import (
    WORKER_AXIS,
    Mesh,
    batch_sharding as shard_candidates,
    gather_rows,
    make_mesh,
    put,
    replicated_sharding as replicated,
    shard_namedtuple,
)

__all__ = [
    "WORKER_AXIS",
    "make_mesh",
    "shard_candidates",
    "replicated",
    "shard_spa_problem",
    "shard_spa_extras",
    "shard_spa_problem_3d",
    "shard_spa_extras_3d",
    "make_sharded_score_level",
    "make_sharded_spa_solve",
    "make_sharded_spa_solve_3d",
]


# Field partitioning of the SPA problem tables: residual rows split over
# the ranks, pose/parameter tables replicated (ops/spa_solver.SpaProblem).
_SPA2D_SHARDED = frozenset(
    {
        "c_submap", "c_node", "c_z", "c_weight", "c_huber", "c_mask",
        "n_a", "n_b", "n_z", "n_weight", "n_mask",
    }
)
_SPA2D_EXTRAS_SHARDED = frozenset(
    {
        "o_node_a", "o_node_b", "o_factor", "o_landmark", "o_z",
        "o_weight", "o_mask",
        "g_node", "g_traj", "g_z", "g_weight", "g_mask",
    }
)
_SPA3D_SHARDED = frozenset(
    {
        "c_submap", "c_node", "c_z_t", "c_z_q", "c_weight", "c_huber",
        "c_mask",
        "n_a", "n_b", "n_z_t", "n_z_q", "n_weight", "n_mask",
        "r_a", "r_b", "r_dq", "r_weight", "r_traj", "r_mask",
        "a_first", "a_mid", "a_last", "a_dv", "a_dt1", "a_dt2",
        "a_weight", "a_traj", "a_mask",
    }
)
_SPA3D_EXTRAS_SHARDED = frozenset(
    {
        "o_node_a", "o_node_b", "o_factor", "o_landmark", "o_z_t",
        "o_z_q", "o_weight", "o_mask",
        "g_node", "g_traj", "g_z_t", "g_z_q", "g_weight", "g_mask",
    }
)


def shard_spa_problem(mesh: Mesh, problem):
    return shard_namedtuple(mesh, problem, _SPA2D_SHARDED)


def shard_spa_extras(mesh: Mesh, extras):
    return shard_namedtuple(mesh, extras, _SPA2D_EXTRAS_SHARDED)


def shard_spa_problem_3d(mesh: Mesh, problem):
    return shard_namedtuple(mesh, problem, _SPA3D_SHARDED)


def shard_spa_extras_3d(mesh: Mesh, extras):
    return shard_namedtuple(mesh, extras, _SPA3D_EXTRAS_SHARDED)


def make_sharded_score_level(mesh: Mesh):
    """Candidate scoring (fast_correlative_2d.score_level) with the
    candidate axis split over the ranks: each rank scores its share of
    the candidates and the scores [C] are gathered on every rank."""
    cand = shard_candidates(mesh)
    rep = replicated(mesh)

    def score(pool, ix, iy, point_mask, angle_idx, xoff, yoff, cand_mask):
        local = fast_correlative_2d.score_level(
            *(put(a, rep) for a in (pool, ix, iy, point_mask)),
            *(put(a, cand) for a in (angle_idx, xoff, yoff, cand_mask)),
        )
        return gather_rows(local, mesh, len(angle_idx))

    return score


def make_sharded_spa_solve(mesh: Mesh, max_iterations: int = 20, cg_iterations: int = 32):
    """SPA solve with the constraint tables split over the ranks and the
    poses replicated; gradient and Hessian-vector sums cross ranks.
    Returns (submap_poses, node_poses, cost), the same on every rank."""

    def solve(problem, huber_scale):
        return spa_solver.solve(
            shard_spa_problem(mesh, problem), huber_scale, max_iterations,
            cg_iterations, mesh=mesh,
        )

    return solve


def make_sharded_spa_solve_3d(
    mesh: Mesh, max_iterations: int = 20, cg_iterations: int = 32
):
    """SE(3) SPA solve (ops/spa_solver_3d.solve_3d) with every residual
    table — constraints, node-node, IMU rotation and acceleration rows —
    split over the ranks and pose/calibration tables replicated."""

    def solve(problem, huber_scale):
        return spa_solver_3d.solve_3d(
            shard_spa_problem_3d(mesh, problem), huber_scale, max_iterations,
            cg_iterations, mesh=mesh,
        )

    return solve
