"""Multi-rank worker: run one per rank (same command line, its own rank).

Port of cartographer_tpu/tools/multihost_worker.py. Measures the sharded
constraint-scoring and SPA workloads over the mesh of all ranks and
prints one JSON line per workload with a per-rank scaling report:

    python -m cartographer_tpu_torch.tools.multihost_worker \
        --coordinator_address=127.0.0.1:1234 --num_processes=2 \
        --process_id=I [--backend gloo] [--device cpu]

Without a coordinator it runs as one rank without a process group.
`--device` defaults to cuda (cuda:{rank % cards}); `--backend` to nccl on
cuda and gloo on the CPU; two ranks on one card need `--backend gloo`.
The problems are drawn in the JAX worker's order, so every rank scores
and solves the same numbers: the scoring inputs from default_rng(0), the
SPA problem from default_rng(1). The JAX worker draws both from one
generator, so its SPA problem depends on its candidate count (per device
times devices); here runs with different rank counts solve one problem.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--coordinator_address", default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    parser.add_argument("--device", default=None,
                        help="this rank's device (default cuda:{rank % cards})")
    parser.add_argument("--candidates_per_device", type=int, default=4096)
    parser.add_argument("--spa_nodes", type=int, default=10000)
    parser.add_argument("--lm_iterations", type=int, default=20)
    parser.add_argument("--cg_iterations", type=int, default=50)
    parser.add_argument(
        "--production",
        action="store_true",
        help="also drive the PRODUCTION pose-graph drain (MapBuilder -> "
        "PoseGraph2D -> sharded constraint batch + SPA) over the mesh — "
        "the same entry dryrun_multichip drives",
    )
    parser.add_argument(
        "--production_3d",
        action="store_true",
        help="also drive the 3D production drain (PoseGraph3D) over the mesh",
    )
    args = parser.parse_args(argv)

    import torch

    from cartographer_tpu_torch.ops import spa_solver
    from cartographer_tpu_torch.ops.scan_matching import fast_correlative_2d
    from cartographer_tpu_torch.parallel import multihost, sharded

    ctx = multihost.initialize(
        args.coordinator_address, args.num_processes, args.process_id,
        backend=args.backend, device=args.device,
    )
    mesh = ctx.mesh
    dev = mesh.device
    n_dev = mesh.world_size
    # Every rank draws the same global values; each keeps its rows of the
    # sharded tables.
    rng = np.random.default_rng(0)

    # -- sharded candidate scoring -------------------------------------------
    score = sharded.make_sharded_score_level(mesh)
    H = W = 1024
    A, N = 64, 512
    C = args.candidates_per_device * n_dev
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    pool = t(rng.uniform(0.1, 0.9, (H, W)).astype(np.float32))
    ix = t(rng.integers(0, W, (A, N)).astype(np.int32))
    iy = t(rng.integers(0, H, (A, N)).astype(np.int32))
    pmask = t(np.ones((N,), bool))
    cand_args = tuple(
        t(a)
        for a in (
            rng.integers(0, A, C).astype(np.int32),
            rng.integers(-64, 64, C).astype(np.int32),
            rng.integers(-64, 64, C).astype(np.int32),
            np.ones((C,), bool),
        )
    )
    scores = score(pool, ix, iy, pmask, *cand_args)
    _sync(dev)
    t0 = time.perf_counter()
    reps = 10
    for _ in range(reps):
        scores = score(pool, ix, iy, pmask, *cand_args)
    _sync(dev)
    dt = (time.perf_counter() - t0) / reps
    unsharded = fast_correlative_2d.score_level(pool, ix, iy, pmask, *cand_args)
    report = multihost.scaling_report(ctx, C, dt)
    report["metric"] = "sharded_candidate_scores"
    report["scores_device"] = str(scores.device)
    report["max_abs_err_vs_unsharded"] = float(torch.max(torch.abs(scores - unsharded)))
    print(json.dumps(report), flush=True)

    # -- sharded SPA ----------------------------------------------------------
    # The row split needs no padding: n_odo rows exactly (the JAX worker
    # pads the node-node table to a multiple of its devices with masked
    # rows, which add 0 to every sum).
    rng = np.random.default_rng(1)
    n_nodes = args.spa_nodes
    n_submaps = max(2, n_nodes // 90)
    n_con = n_nodes * 3
    n_odo = n_nodes - 1
    solve = sharded.make_sharded_spa_solve(
        mesh, max_iterations=args.lm_iterations, cg_iterations=args.cg_iterations
    )
    tables = dict(
        submap_poses=rng.normal(0, 5, (n_submaps, 3)).astype(np.float32),
        node_poses=rng.normal(0, 5, (n_nodes, 3)).astype(np.float32),
        free_submap=np.array([False] + [True] * (n_submaps - 1)),
        free_node=np.ones((n_nodes,), bool),
        c_submap=rng.integers(0, n_submaps, n_con).astype(np.int32),
        c_node=rng.integers(0, n_nodes, n_con).astype(np.int32),
        c_z=rng.normal(0, 1, (n_con, 3)).astype(np.float32),
        c_weight=np.ones((n_con, 2), np.float32) * 1e4,
        c_huber=np.ones((n_con,), bool),
        c_mask=np.ones((n_con,), bool),
        n_a=(np.arange(n_odo) % (n_nodes - 1)).astype(np.int32),
        n_b=(np.arange(n_odo) % (n_nodes - 1) + 1).astype(np.int32),
        n_z=rng.normal(0, 0.1, (n_odo, 3)).astype(np.float32),
        n_weight=np.ones((n_odo, 2), np.float32) * 1e5,
        n_mask=np.ones((n_odo,), bool),
    )
    problem = spa_solver.problem_from_numpy(tables, dev)
    sp, npo, cost = solve(problem, 1e3)
    _sync(dev)
    t0 = time.perf_counter()
    sp, npo, cost = solve(problem, 1e3)
    _sync(dev)
    dt = time.perf_counter() - t0
    report = multihost.scaling_report(ctx, n_con, dt)
    report["metric"] = "sharded_spa_solve"
    report["seconds"] = dt
    report["final_cost"] = float(cost)
    report["poses_device"] = str(npo.device)
    report["collectives"] = dict(mesh.collectives)
    print(json.dumps(report), flush=True)

    # -- production pose-graph drains (the entry dryrun_multichip drives) ----
    from cartographer_tpu_torch.testing import production_dryrun

    drains = []
    if args.production:
        drains.append(("production_drain_2d", production_dryrun.run_production_drain_2d))
    if args.production_3d:
        drains.append(("production_drain_3d", production_dryrun.run_production_drain_3d))
    for name, run in drains:
        t0 = time.perf_counter()
        stats = run(mesh)
        stats["seconds"] = time.perf_counter() - t0
        stats["metric"] = name
        stats["num_processes"] = ctx.num_processes
        stats["process_id"] = ctx.process_id
        stats["num_devices"] = n_dev
        print(json.dumps(stats), flush=True)
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
