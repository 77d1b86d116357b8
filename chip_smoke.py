#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cartographer_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --refine-study SECONDS
    python3 chip_smoke.py --spa-2d

The third form runs only the device, build and spa_2d phases. The second
runs only the backend phase and then `refine_study`:
the backend drain's card-against-CPU replay on perturbed searches, each
round's drain refinement also held at 1e-4 three ways (the LM kernel
against the plain version on the card and on the CPU, the plain version
on the card against it on the CPU), and a BnB score mismatch diagnosed.

Phases, each printed as one JSON line; any failure raises and the script
exits non-zero:

1. device: the card's name and power limit (nvidia-smi).
2. build: every source under cartographer_tpu_torch/csrc (the CUDA
   kernels with nvcc, the native loop-closure searches and host kernels
   with the host C++ compiler), one compiler per source, all started
   together, with ptxas's registers and spills per kernel.
3. kernel: each kernel against its plain PyTorch version on the card at
   the main path's shapes and at edge shapes; device times from CUDA
   graphs of 20 calls, single-call times with launch latency, an empty
   kernel's time on the same launch shape (the launch floor), and the
   bound from the whole grid and from the grid sectors the inputs touch.
   kernel_2d: the 2D main path's device loops the same way: the LM scan
   match (lm_match_2d) at the frontend's shape, a 69-lane drain's and an
   edge case (a masked lane, a lane off the grid, N = 37, shared grids,
   K = 0), every lane within 1e-4 m / rad and rel 1e-4 in cost or else
   one run that branched at one accept test (lm_stop_explained's rule
   on the kernel's and the plain version's iterates; counted); both
   supercover insertions bit for bit (the chunked frontend's two 1024^2
   slots and the per-scan builder's 1024^2 grid, and edge grids 64 x
   300 with horizontal, vertical and off-grid rays and corner ends, B 1
   and 2, free space off); two launches equal; bounds from the bytes the
   function must move (for the LM the distinct grid sectors that its
   patches cover along the accepted poses) and the operations counted
   from the sources.
   spa_2d: the 2D SPA kernel (kernels/spa_2d) against the plain solve
   (ops/spa_solver.solve_plain) on the card, on testing/spa_cases_2d's
   problems: three loop graphs (nonmonotonic; a landmark and a fixed
   frame), a graph the benchmark cell's size (1,120 nodes, 17 submaps,
   3,000 constraints, one frozen trajectory) at 50 and at 200
   iterations, and one of 5,120 nodes.
   Per solve: one launch an LM iteration; the first two iterations (4 CG
   steps each) with the plain solve's counts and poses within 1e-5; a
   solve that converges
   with poses within 1e-3 m / rad, cost within rel 1e-3 and stopping
   before the cap where the plain one does (the card tests' rules); device
   time (torch.profiler), host wall time, launches, LM iterations and CG
   steps of both, and the bound of a CG step from its bytes and
   operations.
4. slice: the chunked 2D local-SLAM frontend
   (ChunkedLocalTrajectoryBuilder2D on cuda) over the first 200 of the
   synthetic loop world's 300 scans, with online correlative matching
   on: each kernel's launches from that run only (window sums, the LM
   and the dense insertion at least once per matched scan, the scatter
   none), the error against ground
   truth, every scan of the first two chunks rerun on the CPU from the
   GPU's state before it (identical flags, poses within 1e-3), and one
   chunk under torch.profiler for the device's busy share. The inputs of
   the run's first window-sum, LM and dense-insertion calls of the third
   chunk (cloned once by the recording wrapper) become the kernel
   phases' "real" cases; the backend phase's drain refinement with the
   most lanes is the LM's "real_refine" case, and the per-scan path's
   11th scatter insertion the scatter's "real" case.
5. backend: MapBuilder on cuda over half a lap of bench.py's scaled world
   (500 scans of 1024 beams) with bench.py's backend settings and the
   asynchronous pose graph: the frontend, loop-closure searches through
   the device branch-and-bound, their batched LM refinement, SPA, and
   the final optimization. Launch counts from that run only, node error
   and aligned ATE against ground truth, per-drain search and refine
   times, SPA times; then one drain's searches rerun on the CPU and
   through the native search, and the last SPA problem re-solved on the
   CPU.
6. sensors: the slice's world with IMU at 100 Hz and odometry at 50 Hz
   (made from the figure-eight's ground truth) through four paths on
   cuda: the chunked frontend (128 scans; its first two chunks rerun scan
   by scan on the CPU), the per-scan LocalTrajectoryBuilder2D on a
   probability grid (100 scans) and on a TSDF (60 scans), each with its
   first 8 scans rerun by a CPU copy of the builder, and MapBuilder with
   the default 2D options (per-scan, IMU) plus odometry and the
   pure-localization trimmer (150 scans, synchronous pose graph): scans/s,
   real-time ratio, error against ground truth, launches per path. The
   inputs of each per-scan path's first window-sum call (the angle rows
   padded to a power of two; the TSDF path's grid is the TSDF's
   probability view) become the kernel phase's "per_scan" and
   "per_scan_tsdf" cases.
7. local_slam_3d: bench.py:_bench_3d's world (300 scans of the
   semicircle wall, 1,575 points a scan, 10 Hz, 5 m of travel; IMU at
   50 Hz) through both 3D local builders on cuda, with paged grids of 256
   cells at 0.10 m and 128 at 0.45 m and 40 range data per submap: the
   chunked frontend (chunk 16, the first 120 scans, the bench's filters and motion
   filter; its first chunk rerun scan by scan on the CPU from the GPU's
   state) and the per-scan LocalTrajectoryBuilder3D with the default
   options (100 scans; its first 8 scans rerun by a CPU copy): scans/s,
   real-time ratio, final and max position error against ground truth
   (limit 0.5 m), dropped grid writes (must be 0), a profile over warm
   scans, and launches of the four 2D kernels (0: none runs on a 3D
   path).
8. backend_3d: MapBuilder's 3D route on cuda (per-scan builder, PoseGraph3D
   with asynchronous drains, the native 3D branch-and-bound, the batched
   dual-grid LM refinement, SPA 3D) over the first 150 scans of the
   local_slam_3d world with the default PoseGraphOptions
   (testing/bench_3d.backend_3d_options): nodes, submaps, constraints by
   tag, searches, solves, feed and catch-up times, node error after the
   final optimization (limit 0.5 m); then drains at bench.py:_bench_bnb3's
   shapes on a submap the run finished (native 16 x 8 and 64 x 8, device
   2 x 8), device against native on the same searches, one device drain
   on the card against the CPU, the run's first SPA problem re-solved on
   the CPU (the final
   one as a record), and profiles of a drain of each backend and of the
   final solve.
   No hand-written kernel runs there: launches of the four 2D kernels 0.
   The backend and backend_3d phases end by serializing their maps
   (MapBuilder.serialize_state, timed) for the next phase.
9. persist: saved maps on cuda. The backend phase's 2D state is loaded
   frozen into a fresh MapBuilder on cuda (trajectory 0 frozen, node poses
   within 1e-6, every grid equal bit for bit, the same constraints),
   re-serialized and compared record by record after decompression (only
   the trajectory and submap states change with freezing), and loaded on
   the CPU too (the same records). In that loaded map a new trajectory
   (the backend phase's chunked frontend with online correlative
   matching and the pure-localization trimmer keeping 3 submaps) is fed
   the world's first 150 scans again, 100 s later: node error against the
   truth in the frozen map's frame (limit 0.3 m from node 8), INTER
   constraints to the map, submaps kept, scans/s, launches (window
   sums, the LM and the dense insertion at least once a new node);
   the inputs of its first window-sum call become the kernel phase's
   "localization" case. The backend_3d phase's state is loaded on cuda
   and on the CPU (poses within 1e-6, dense grids equal to to_dense of the
   originals, the same records). LocalTrajectoryBuilder3D with the
   IMU-based extrapolator runs 40 scans of the local_slam_3d world
   (error limit 0.5 m, the first 4 scans rerun by a CPU copy within 1e-3,
   the kernels of one extrapolator solve). The native host kernels
   (csrc/native.cc) are timed against numpy on the phases' clouds: the
   voxel filter on a 1024-beam 2D scan and a 1,575-point 3D scan (masks
   equal), the rotational histogram on a 3D node's cloud.
10. cloud: the SLAM server on cuda over real gRPC on localhost (the
   transport and the grpc and protobuf versions are printed). A
   MapBuilderServer (backend_options' asynchronous pose graph, Prometheus
   on a free port) takes a {range, imu, odometry} trajectory with the
   sensors phase's per-scan options from a MapBuilderStub, which
   subscribes to local-SLAM results and optimization events and streams
   the first 200 scans of the sensors phase's world (with its IMU and
   odometry) through the per-sensor streaming RPCs, unpaced, then calls
   FinishTrajectory and RunFinalOptimization. Checks: launches (window
   sums, the LM and the scatter insertion),
   node poses over the wire equal to the server's, node error from node 8
   (limit 0.3 m), a local-SLAM result for every node, an optimization
   event, WriteState's records equal to the server's own state,
   GetSubmapData of submap 0 equal to compute_cropped of it, and the
   optimization counter on /metrics. Printed: scans/s and the real-time
   ratio from the first write to the last local-SLAM result, and the
   round trips of FinishTrajectory, RunFinalOptimization and
   GetTrajectoryNodePoses. The inputs of the path's first window-sum call
   become the kernel phase's "cloud" case. Then a robot server uploads to
   a second server on the card, which is shut down after 30 scans and
   restarted on its port after 20 more (30 more follow); and
   tools/map_builder_server_main runs as a subprocess on written Lua
   files, builds nodes from 40 scans sent over the wire and exits 0 on
   SIGINT.
11. multigpu: the multi-rank backend (parallel/) through
   tools/multihost_worker at its full width, each rank a process started
   after the build: (a) one rank over NCCL; (b) two ranks sharing the card
   over gloo on CUDA tensors (NCCL refuses two ranks on one card), each
   also driving the 2D production drain (testing/production_dryrun) and
   (c) the 3D one. Checks: equal costs (rel 1e-6) and pose digests (abs
   1e-6) across the ranks, (b)'s cost within rel 1e-3 of (a)'s, sharded
   scores equal to unsharded ones on the card (1e-6), the dryrun's
   checks, every reported tensor on cuda. Printed: backend and world size
   of each run, candidates/s per rank, SPA s per solve, the drains'
   nodes, inter constraints and node errors, and each rank's launches:
   the 2D drain (the per-scan builder) the LM kernel at least once a node
   but the first and the scatter insertion once a node, no dense
   insertion; the 3D drain none of the four 2D kernels.
12. seconds: each phase's wall seconds.
13. kernels: one line with every kernel's numbers (the main case), each
   kernel's launches on each path above, and every case. Every 2D
   probability-grid path launches the LM kernel, every chunked 2D path
   the dense insertion and every per-scan 2D path the scatter; the TSDF
   and 3D paths launch none of the three (checked where each runs).

The last line is {"ok": true, "device": {...}}. Without CUDA, or without
the package beside it, the script fails before printing a result. It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM rate and f32 rate outside the
# tensor cores, for the kernels' lower bounds.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def call_time_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median over `reps` single calls, each between two CUDA events: the
    device time of one call from the host, launch latency included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_time_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one call: `calls` calls captured in a CUDA graph,
    replayed `reps` times between CUDA events (median), divided by
    `calls`. Host launch latency is out of the measurement."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def window_sums_case(rng, h, w, a, n, num_linear, outside, device, keep=0.8):
    """prob f32 [h, w], ix/iy i32 [a, n] reaching `outside` cells past the
    grid, a share `keep` of the points unmasked."""
    import torch

    prob = rng.uniform(0.1, 0.9, (h, w)).astype(np.float32)
    ix = rng.integers(-outside, w + outside, (a, n)).astype(np.int32)
    iy = rng.integers(-outside, h + outside, (a, n)).astype(np.int32)
    mask = rng.uniform(size=n) > 1.0 - keep
    t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    return t(prob), t(ix), t(iy), t(mask), num_linear


def ptxas_usage(log: str):
    """Registers, stack and spills per kernel from nvcc's -Xptxas -v
    output."""
    usage = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            usage.append({"kernel": m.group(1)})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and usage:
            usage[-1].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and usage:
            usage[-1]["registers"] = int(m.group(1))
    return usage


def touched_sectors(prob, ix, iy, mask, num_linear) -> int:
    """Distinct 32-byte sectors of the grid that the windows of the masked
    points cover (cells off the grid read nothing)."""
    import torch

    h, w = prob.shape
    offs = torch.arange(-num_linear, num_linear + 1, device=prob.device)
    y = iy[:, mask].long()[:, :, None, None] + offs[:, None]
    x = ix[:, mask].long()[:, :, None, None] + offs[None, :]
    y, x = torch.broadcast_tensors(y, x)
    inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
    flat = (y * w + x)[inside]
    return int(torch.unique(flat // (32 // prob.element_size())).numel())


def empty_launch_fn(args):
    """An empty kernel on the window-sum kernel's launch shape for `args`."""
    import torch

    from cartographer_tpu_torch.kernels import _build

    fn = _build.load("correlative_window").correlative_window_empty
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    a, n = args[1].shape

    def launch():
        rc = fn(a, n, args[4], torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"empty kernel launch failed: cuda error {rc}")

    return launch


def kernel_case(name, args):
    """correlative_window against its plain version on one case: errors,
    determinism, device and call times, the empty-kernel floor, and the
    bounds from the whole grid and from the sectors these inputs touch."""
    import torch

    from cartographer_tpu_torch.kernels import correlative_window as cw

    prob, ix, iy, mask, num_linear = args
    (h, w), (a, n) = prob.shape, ix.shape
    d = 2 * num_linear + 1
    got = cw.window_sums(*args)
    want = cw.window_sums_plain(*args)
    again = cw.window_sums(*args)
    torch.cuda.synchronize()
    got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got_np, want_np, rtol=1e-5, atol=0)
    if not torch.equal(again, got):  # the same sums in the same order
        raise AssertionError(f"{name}: a second run gave other sums")
    err = np.abs(got_np - want_np)
    nonzero = want_np != 0
    r = {
        "phase": "kernel", "name": "correlative_window", "case": name,
        "h": h, "w": w, "a": a, "n": n, "num_linear": num_linear,
        "max_abs_err": float(err.max()),
        "max_rel_err": float(np.max(err[nonzero] / np.abs(want_np[nonzero]),
                                    initial=0.0)),
    }
    r["kernel_ms"] = device_time_ms(lambda: cw.window_sums(*args))
    r["kernel_call_ms"] = call_time_ms(lambda: cw.window_sums(*args))
    r["empty_kernel_ms"] = device_time_ms(empty_launch_fn(args))
    r["plain_ms"] = device_time_ms(lambda: cw.window_sums_plain(*args))
    r["plain_call_ms"] = call_time_ms(lambda: cw.window_sums_plain(*args))

    n_valid = int(mask.sum().item())
    sectors = touched_sectors(*args)
    index_bytes = 2 * a * n * 4 + n + a * d * d * 4
    grid_bytes = h * w * 4 + index_bytes
    touched_bytes = sectors * 32 + index_bytes
    ops = a * d * d * n_valid
    ops_ms = ops / F32_OPS_PER_S * 1e3
    # Both byte bounds price the grid at the HBM rate, as if it were cold;
    # the timed calls replay the same inputs, so it is hot in L2 there.
    r.update(
        bytes_grid=grid_bytes, bound_grid_ms=grid_bytes / HBM_BYTES_PER_S * 1e3,
        sectors_touched=sectors, bytes_touched=touched_bytes,
        bound_touched_ms=touched_bytes / HBM_BYTES_PER_S * 1e3,
        ops=ops,
    )
    r["bound_ms"] = max(r["bound_touched_ms"], ops_ms)
    r["bound_by"] = "bytes" if r["bound_touched_ms"] >= ops_ms else "operations"
    emit(r)
    return r


def kernel_phase(device):
    """correlative_window against its plain version at four cases."""
    rng = np.random.default_rng(0)
    cases = {
        # The slice's shape: grid 1024, a_cap 84 at max_range 12 m, the
        # 512-point matching cloud, L = 2.
        "main": dict(h=1024, w=1024, a=169, n=512, num_linear=2, outside=3),
        "edge": dict(h=37, w=300, a=7, n=100, num_linear=5, outside=6),
        "l0": dict(h=1024, w=1024, a=169, n=512, num_linear=0, outside=3),
        # Every point masked: the kernel's cost beyond the launch when it
        # loads no cell (indices, reduction, output).
        "masked": dict(h=1024, w=1024, a=169, n=512, num_linear=2, outside=3,
                       keep=0.0),
    }
    return {
        name: kernel_case(name, window_sums_case(rng, device=device, **shape))
        for name, shape in cases.items()
    }


# -- the 2D main path's device loops: lm_match_2d and supercover_2d

# Agreement of the LM kernel with its plain version, per lane: metres and
# radians, and relative in cost (the sums run in another order).
LM_TOL = 1e-4
# Floating-point operations the kernels do, counted from their sources:
# the LM per valid point and patch read (the Jacobian's weights and
# contractions at the accepted pose, the candidate's cost), the dense
# insertion per (grid, ray, row), the scatter per (ray, crossing step).
LM_OPS_PER_POINT = 220
DENSE_OPS_PER_ROW = 12
SCATTER_OPS_PER_STEP = 24
# The 2D frontend's insertion probabilities (hit 0.55, miss 0.49).
HIT_LOG_ODDS = float(np.log(0.55 / 0.45))
MISS_LOG_ODDS = float(np.log(0.49 / 0.51))
LM_LAUNCH_ARGS = (
    "cost_grids", "origins", "initial_poses", "target_translations", "points",
    "point_masks", "occupied_space_weight", "translation_weight",
    "rotation_weight", "max_iterations", "use_nonmonotonic_steps",
)


def lm_inputs(case, device, weights, iterations, nonmonotonic):
    """lm_match_2d.launch's arguments by name on `device` for one
    testing/kernel_cases_2d.lm_case."""
    import torch

    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    c = case
    return dict(
        zip(LM_LAUNCH_ARGS, (
            t(c["grids"]), t(c["origins"]), t(c["initial"]), t(c["targets"]),
            t(c["points"]), t(c["masks"]), *weights, iterations, nonmonotonic)),
        grid_index=t(c["grid_index"]), resolutions=t(c["resolutions"]),
    )


def lm_plain(inp, max_iterations=None):
    """The plain version on the kernel's arguments: [K, 4] rows."""
    import torch

    from cartographer_tpu_torch.ops.scan_matching import gauss_newton_2d as gn

    grids = inp["cost_grids"]
    grids = grids if grids.dim() == 3 else grids[None]
    lanes = lambda x, width: x.reshape(-1, width)  # noqa: E731
    initial = lanes(inp["initial_poses"], 3)
    k, dev = initial.shape[0], grids.device
    points, masks = inp["points"], inp["point_masks"]
    points = points if points.dim() == 3 else points[None]
    masks = masks if masks.dim() == 2 else masks[None]
    rows = inp.get("cloud_rows")
    if rows is not None:
        points, masks = points[rows.long()], masks[rows.long()]
    grid_index = inp.get("grid_index")
    if grid_index is None:
        grid_index = torch.zeros(k, dtype=torch.int32, device=dev)
    resolutions = inp.get("resolutions")
    if resolutions is None:
        resolutions = torch.full((k,), inp["resolution"], dtype=torch.float32, device=dev)
    pose, cost = gn.match_lanes_plain(
        grids, grid_index, lanes(inp["origins"], 2), initial,
        lanes(inp["target_translations"], 2), points, masks, resolutions,
        inp["occupied_space_weight"], inp["translation_weight"], inp["rotation_weight"],
        inp["max_iterations"] if max_iterations is None else max_iterations,
        inp["use_nonmonotonic_steps"],
    )
    return torch.cat([pose, cost[:, None]], dim=1)


def branched_at(a, b, tol):
    """Where two runs of one LM lane part. `a` and `b` are the lane's
    iterates on either side, rows (x, y, theta, ...) after 0, 1, ...,
    max iterations. At the first count where their poses differ by more
    than `tol` (m or rad), exactly one side must have stayed where it was
    (its step was rejected or its lane had stopped) while the other
    moved: up to there both ran the same iterates, after it the damping
    and the nonmonotonic reference differ. Returns (that count, the side
    that stayed: 0 or 1); raises AssertionError for iterates that never
    part, part from the start, or part with both or neither staying."""
    apart = [i for i in range(len(a)) if max(_pose_diff(a[i], b[i])) > tol]
    if not apart:
        raise AssertionError("the iterates agree, the results do not")
    i = apart[0]
    if i == 0:
        raise AssertionError(f"the runs start {_pose_diff(a[0], b[0])} apart")
    stayed = [bool(np.array_equal(x[i, :3], x[i - 1, :3])) for x in (a, b)]
    if stayed[0] == stayed[1]:
        raise AssertionError(
            f"at LM iteration {i} the two part by {_pose_diff(a[i], b[i])} with "
            f"{'both' if stayed[0] else 'neither'} staying put")
    return i, 0 if stayed[0] else 1


def lm_kernel_iterates(inp):
    """The kernel's rows [I + 1, K, 4] on the card after 0, 1, ..., I =
    max_iterations iterations."""
    import torch

    from cartographer_tpu_torch.kernels import lm_match_2d as lm

    return torch.stack([lm.launch(**{**inp, "max_iterations": i})
                        for i in range(inp["max_iterations"] + 1)])


def lm_lanes_compare(inp, got, want, plain_inp=None, got_iterates=None):
    """Each lane of the kernel's rows `got` against the plain version's
    `want` (run on `plain_inp`, by default `inp`): within LM_TOL (m, rad,
    relative cost), or else one LM run that branched at one accept test
    (branched_at on the two versions' iterates at LM_TOL; `got_iterates()`
    gives `got`'s, by default the kernel's on `inp`). Returns the
    worst errors of the lanes within LM_TOL, the count beyond it, the
    branched lanes and the unexplained ones (with how far apart the
    iterates stand after each iteration); the caller decides what an
    unexplained lane means."""
    plain_inp = inp if plain_inp is None else plain_inp
    g = got.cpu().numpy().astype(np.float64)
    p = want.cpu().numpy().astype(np.float64)
    m = np.max(np.abs(g[:, :2] - p[:, :2]), axis=1, initial=0.0)
    rad = np.abs((g[:, 2] - p[:, 2] + np.pi) % (2 * np.pi) - np.pi)
    # Relative in cost, against at least 1e-6 (a lane whose points are all
    # masked ends on its prior with a cost of 0 up to rounding).
    rel = np.abs(g[:, 3] - p[:, 3]) / np.maximum(np.abs(p[:, 3]), 1e-6)
    bad = np.nonzero((m > LM_TOL) | (rad > LM_TOL) | (rel > LM_TOL))[0]
    branched, unexplained = [], []
    if len(bad):
        its = inp["max_iterations"]
        on_card = (got_iterates or (lambda: lm_kernel_iterates(inp)))().cpu().numpy()
        plain = np.stack([lm_plain(plain_inp, i).cpu().numpy() for i in range(its + 1)])
        for lane in bad:
            a, b = on_card[:, lane].astype(np.float64), plain[:, lane].astype(np.float64)
            row = {"lane": int(lane), "m": float(m[lane]), "rad": float(rad[lane]),
                   "cost_rel": float(rel[lane]), "cost_kernel": float(g[lane, 3]),
                   "cost_plain": float(p[lane, 3])}
            try:
                i, side = branched_at(a, b, LM_TOL)
            except AssertionError as e:
                unexplained.append({**row, "why": str(e), "apart_by_iteration": [
                    max(_pose_diff(a[j], b[j])) for j in range(its + 1)]})
                continue
            branched.append({**row, "iteration_apart": i, "stayed": ("kernel", "plain")[side]})
    good = np.setdiff1d(np.arange(len(g)), bad)
    return {
        "max_abs_err": float(max(np.max(m[good], initial=0.0), np.max(rad[good], initial=0.0))),
        "max_m": float(np.max(m[good], initial=0.0)),
        "max_rad": float(np.max(rad[good], initial=0.0)),
        "max_cost_rel_err": float(np.max(rel[good], initial=0.0)),
        "max_cost_rel_err_all": float(np.max(rel, initial=0.0)),
        "lanes_beyond_tol": len(bad),
        "branched_lanes": len(branched),
        "branched": branched,
        "unexplained": unexplained,
    }


def lm_path_sectors(inp, rows):
    """Distinct 32-byte sectors of the cost grids that the lanes' 4 x 4
    patches cover at every pose the run accepted (`rows` [I + 1, K, 4]:
    the kernel after 0, 1, ..., I iterations) over their masked points.
    A rejected candidate's patches are not counted, so the count errs
    low."""
    import torch

    grids = inp["cost_grids"]
    h, w = grids.shape[-2:]
    dev, k = grids.device, rows.shape[1]
    n = inp["points"].shape[-2]
    points, masks = inp["points"].reshape(-1, n, 2), inp["point_masks"].reshape(-1, n)
    if inp.get("cloud_rows") is not None:
        points, masks = points[inp["cloud_rows"].long()], masks[inp["cloud_rows"].long()]
    origins = inp["origins"].reshape(-1, 2)
    res = inp.get("resolutions")
    res = (torch.full((k,), inp["resolution"], device=dev) if res is None
           else res.reshape(-1))
    gi = inp.get("grid_index")
    gi = torch.zeros(k, dtype=torch.int64, device=dev) if gi is None else gi.reshape(-1).long()
    pose = rows[..., :3].to(torch.float32)[:, :, None, :]  # [I + 1, K, 1, 3]
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    px, py = points[None, ..., 0], points[None, ..., 1]
    u = (c * px - s * py + pose[..., 0] - origins[None, :, 0:1]) / res[None, :, None] - 0.5
    v = (s * px + c * py + pose[..., 1] - origins[None, :, 1:2]) / res[None, :, None] - 0.5
    offs = torch.arange(-1, 3, device=dev)
    row = torch.floor(v).long()[..., None, None] + offs[:, None]
    col = torch.floor(u).long()[..., None, None] + offs[None, :]
    row, col = torch.broadcast_tensors(row, col)
    keep = ((row >= 0) & (row < h) & (col >= 0) & (col < w)
            & masks[None, :, :, None, None])
    flat = (gi[None, :, None, None, None] * h + row) * w + col
    return int(torch.unique(flat[keep] // (32 // grids.element_size())).numel())


def timings(r, kernel, plain):
    """The kernel's device time (CUDA graphs) and call time; the plain
    version's device time as the sum of its kernels' times over one call
    under torch.profiler (the plain LM copies Python scalars into tensors,
    which a CUDA graph cannot capture), its kernels and its call time."""
    r["kernel_ms"] = device_time_ms(kernel)
    r["kernel_call_ms"] = call_time_ms(kernel)
    plain()
    profile = device_profile(plain, 1)
    r["plain_ms"] = profile["device_busy_ms"]
    r["plain_kernels"] = profile["kernels"]
    r["plain_call_ms"] = call_time_ms(plain, warmup=1, reps=5)


def bound(r, nbytes, ops):
    """The least time for the work: bytes at the HBM rate or f32
    operations at the card's peak, the larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    r.update(bytes=nbytes, ops=ops, bound_ms=max(bytes_ms, ops_ms),
             bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def lm_case(name, inp):
    """lm_match_2d against its plain version on one case (every lane by
    lm_lanes_compare, an unexplained lane fails; two launches bit-equal),
    with times and the bound: the grid sectors that the patches along
    the run's accepted poses cover (lm_path_sectors), every other input
    read once and the rows written once; the operations of the valid
    points' (iterations run + 1) patch evaluations."""
    import torch

    from cartographer_tpu_torch.kernels import lm_match_2d as lm

    k = inp["initial_poses"].reshape(-1, 3).shape[0]
    its = torch.zeros(k, dtype=torch.int32, device=inp["cost_grids"].device)
    got = lm.launch(**inp, iterations=its)
    again = lm.launch(**inp)
    want = lm_plain(inp)
    rows = lm_kernel_iterates(inp)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"lm_match_2d {name}: a second launch gave other rows")
    if not torch.isfinite(got).all():
        raise AssertionError(f"lm_match_2d {name}: non-finite rows")
    compared = lm_lanes_compare(inp, got, want, got_iterates=lambda: rows)
    for u in compared["unexplained"]:
        raise AssertionError(
            f"lm_match_2d {name}: lane {u['lane']}: kernel and plain differ "
            f"({u['m']:.2e} m, {u['rad']:.2e} rad, rel cost {u['cost_rel']:.2e}) "
            f"and {u['why']}")
    n = inp["points"].shape[-2]
    masks = inp["point_masks"].reshape(-1, n)
    if inp.get("cloud_rows") is not None:
        masks = masks[inp["cloud_rows"].long()]
    valid = masks.sum(dim=1).cpu().numpy().astype(np.int64)
    runs = its.cpu().numpy().astype(np.int64)
    r = {"phase": "kernel", "name": "lm_match_2d", "case": name,
         "grid": list(inp["cost_grids"].shape), "k": k, "n": n,
         "max_iterations": inp["max_iterations"],
         "nonmonotonic": bool(inp["use_nonmonotonic_steps"]),
         "iterations_run_mean": float(runs.mean()), **compared}
    timings(r, lambda: lm.launch(**inp), lambda: lm_plain(inp))
    r["sectors"] = lm_path_sectors(inp, rows)
    others = sum(x.numel() * x.element_size() for key, x in inp.items()
                 if isinstance(x, torch.Tensor) and key != "cost_grids")
    bound(r, r["sectors"] * 32 + others + k * 16,
          int(np.sum(valid * (runs + 1))) * LM_OPS_PER_POINT)
    emit(r)
    return r


def insert_inputs(rng, device, b, h, w, n, reach, edge=False):
    """testing/kernel_cases_2d.insert_case's arrays as tensors on
    `device`."""
    import torch

    from cartographer_tpu_torch.testing import kernel_cases_2d as cases

    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in cases.insert_case(rng, b, h, w, n, reach, edge)]


def insertion_case(name, kind, args):
    """A supercover kernel against its plain version: both outputs equal
    bit for bit, two launches equal; times, and the bound from the grids
    read and written once (5 B a cell each way) and the rays."""
    import torch

    from cartographer_tpu_torch.kernels import supercover_2d as sc
    from cartographer_tpu_torch.ops import raycast_2d

    kernel = sc.insert_scan_dense if kind == "dense" else sc.insert_scan
    plain = (raycast_2d.insert_scan_dense_plain if kind == "dense"
             else raycast_2d.insert_scan_plain)
    got, again, want = kernel(*args), kernel(*args), plain(*args)
    torch.cuda.synchronize()
    for g, a, p, what in zip(got, again, want, ("log_odds", "known")):
        if not torch.equal(g, p):
            diff = int((g != p).sum())
            raise AssertionError(f"{kind} {name}: {what} differs from the plain version in {diff} cells")
        if not torch.equal(g, a):
            raise AssertionError(f"{kind} {name}: a second launch gave another {what}")
    lo, _, _, ends, is_hit = args[:5]
    cells, n = lo.numel(), is_hit.shape[0]
    r = {"phase": "kernel", "name": f"supercover_{kind}_2d", "case": name,
         "grid": list(lo.shape), "rays": n, "max_abs_err": 0.0,
         "bit_identical": True,
         "touched": int((want[1] & ~args[1]).sum()) + int(((want[0] != lo) & args[1]).sum())}
    timings(r, lambda: kernel(*args), lambda: plain(*args))
    nbytes = cells * 5 * 2 + ends.numel() * 4 + 2 * n + args[2].numel() * 4
    if kind == "dense":
        rows = (lo.shape[0] if lo.dim() == 3 else 1) * n * lo.shape[-2]
        ops = rows * DENSE_OPS_PER_ROW
        r["free_space"] = bool(args[8])
    else:
        r["num_steps"] = args[8]
        ops = n * args[8] * SCATTER_OPS_PER_STEP
    bound(r, nbytes, ops)
    emit(r)
    return r


def kernel_phase_2d(device):
    """lm_match_2d and both supercover insertions against their plain
    versions on the card, at the main path's shapes and at edge shapes."""
    from cartographer_tpu_torch.kernels import lm_match_2d
    from cartographer_tpu_torch.testing import kernel_cases_2d as cases

    rng = np.random.default_rng(1)
    frontend = (1.0, 10.0, 40.0)  # the 2D frontend's CeresScanMatcherOptions2D
    refine = (20.0, 10.0, 1.0)  # the constraint builder's
    lm = {
        # The chunked frontend's solve: one 1024^2 grid, 512 points, 20
        # iterations, monotonic.
        "main": lm_inputs(cases.lm_case(rng, 1, 1024, 1024, 1, 512), device,
                          frontend, 20, False),
        # A loop-closure drain: 69 lanes (the mean of a refine study's
        # drains: 2,070 lanes over 30 rounds) on 8 submaps,
        # nonmonotonic, 10 iterations.
        "refine": lm_inputs(cases.lm_case(rng, 8, 1024, 1024, 69, 512), device,
                            refine, 10, True),
        # A masked lane, a lane off the grid, N not a multiple of 32,
        # lanes sharing grids.
        "edge": lm_inputs(cases.lm_case(rng, 2, 96, 300, 5, 37, edge=True), device,
                          refine, 10, True),
    }
    out = {"lm_match_2d": {name: lm_case(name, inp) for name, inp in lm.items()}}
    per_lane = ("origins", "initial_poses", "target_translations", "points",
                "point_masks", "grid_index", "resolutions")
    empty = {k: v[:0] if k in per_lane else v for k, v in lm["edge"].items()}
    if lm_match_2d.launch(**empty).shape != (0, 4):
        raise AssertionError("lm_match_2d: K = 0 did not give [0, 4]")

    def dense(name, b, h, w, n, reach, free=True, edge=False):
        args = insert_inputs(rng, device, b, h, w, n, reach, edge)
        if b == 1:
            args = [args[0][0], args[1][0], args[2][0], args[3][0], *args[4:]]
        return insertion_case(name, "dense", [*args, HIT_LOG_ODDS, MISS_LOG_ODDS, free])

    def scatter(name, h, w, n, reach, steps, free=True, edge=False):
        args = insert_inputs(rng, device, 1, h, w, n, reach, edge)
        args = [args[0][0], args[1][0], args[2][0], args[3][0], *args[4:]]
        return insertion_case(
            name, "scatter", [*args, HIT_LOG_ODDS, MISS_LOG_ODDS, steps, free])

    out["supercover_dense_2d"] = {
        # The chunked frontend: two 1024^2 slots, 1,024 rays of up to 12 m.
        "main": dense("main", 2, 1024, 1024, 1024, 240.0),
        "edge_b1": dense("edge_b1", 1, 64, 300, 400, 400.0, edge=True),
        "edge_b2": dense("edge_b2", 2, 64, 300, 400, 400.0, edge=True),
        "edge_no_free_space": dense("edge_no_free_space", 2, 64, 300, 400, 400.0,
                                    free=False, edge=True),
    }
    out["supercover_scatter_2d"] = {
        # The per-scan builder, per submap: 1024^2, 1,024 rays, 256 steps.
        "main": scatter("main", 1024, 1024, 1024, 240.0, 256),
        "edge": scatter("edge", 64, 300, 400, 400.0, 512, edge=True),
        "edge_no_free_space": scatter("edge_no_free_space", 64, 300, 400, 400.0, 512,
                                      free=False, edge=True),
    }
    return out


SPA_HUBER_SCALE = 10.0
# A CG step reads each row's two 3 x 3 blocks and three indices once (84
# bytes) and each pose's p, diagonal, r, x and free flag (52 bytes), and
# writes its x, r and p (36 bytes); u = J_row p and J_row^T u take 72
# flops each a row, the vector updates about 20 a pose coordinate.
SPA_STEP_BYTES_PER_ROW = 84
SPA_STEP_BYTES_PER_POSE = 88
SPA_STEP_OPS_PER_ROW = 144
SPA_STEP_OPS_PER_POSE = 60


def spa_cases():
    """The spa_2d phase's problems: (numpy tables, extras tables, solve
    keywords, whether the whole solve is held to the plain one) by name.
    The cell's graph at 50 iterations has not converged, and two f32
    solves in different sum orders part by up to 7e-3 m there: it and the
    5,120-node graph are held by their first two iterations only (the
    card tests' rules, tests/test_torch_spa_2d_card.py)."""
    from cartographer_tpu_torch.testing import spa_cases_2d as cases

    cell, _ = cases.trajectory_graph(3)
    large, _ = cases.trajectory_graph(4, num_nodes=5000, inter=4000, outliers=100)
    return {
        "loop": (*cases.loop_graph(0), dict(max_iterations=100), True),
        "loop_nonmonotonic": (*cases.loop_graph(1),
                              dict(max_iterations=100, use_nonmonotonic_steps=True), True),
        "landmark_fixed_frame": (*cases.loop_graph(2, extras="held"),
                                 dict(max_iterations=100), True),
        "main": (cell, None, dict(max_iterations=50), False),
        "final_200": (cell, None, dict(max_iterations=200), True),
        "large": (large, None, dict(max_iterations=50), False),
    }


def spa_gap(got, want):
    """Largest pose difference of two solves' results, m or rad."""
    gap = 0.0
    for g, w in zip(got[:-1], want[:-1]):
        g, w = g.cpu().double().numpy(), w.cpu().double().numpy()
        d = np.abs((g[:, 2] - w[:, 2] + np.pi) % (2 * np.pi) - np.pi)
        gap = max(gap, float(np.max(np.abs(g[:, :2] - w[:, :2]), initial=0.0)),
                  float(np.max(d, initial=0.0)))
    return gap


def spa_solve_case(name, tables, ex, kw, whole, device, gauges):
    """One problem through the kernel and through the plain solve on the
    card: times and counts of both; the failures against the card tests'
    tolerances (tests/test_torch_spa_2d_card.py)."""
    import torch

    from cartographer_tpu_torch.kernels import spa_2d
    from cartographer_tpu_torch.ops import spa_solver

    p = spa_solver.problem_from_numpy(tables, device)
    x = None if ex is None else spa_solver.extras_from_numpy(ex, device)

    def kernel(**over):
        return spa_solver.solve(p, SPA_HUBER_SCALE, extras=x, **{**kw, **over})

    def plain(**over):
        return spa_solver.solve_plain(p, SPA_HUBER_SCALE, extras=x, **{**kw, **over})

    r = {"phase": "spa_2d", "case": name, "poses": sum(t.shape[0] for t in (
        p.submap_poses, p.node_poses, *(() if x is None else (x.l_poses, x.f_pose)))),
        "rows": int(p.c_mask.sum()) + int(p.n_mask.sum()) + (
            0 if x is None else int(x.o_mask.sum()) + int(x.g_mask.sum())),
        **kw}
    failed = []
    # The first two iterations of 4 CG steps: the plain solve's steps.
    two, two_counts = kernel(max_iterations=2, cg_iterations=4), gauges()
    r["two_iterations_gap"] = spa_gap(two, plain(max_iterations=2, cg_iterations=4))
    if r["two_iterations_gap"] > 1e-5 or two_counts != gauges():
        failed.append(f"two iterations part by {r['two_iterations_gap']:.2e} "
                      f"(counts {two_counts}, {gauges()})")
    torch.cuda.synchronize()
    before = spa_2d.LAUNCHES
    t0 = time.perf_counter()
    got = kernel()
    torch.cuda.synchronize()
    r["kernel_wall_ms"] = (time.perf_counter() - t0) * 1e3
    r["launches"] = spa_2d.LAUNCHES - before
    r["lm_iterations"], r["cg_steps"] = gauges()
    prof = device_profile(kernel, 1)
    r["kernel_device_ms"] = prof["device_busy_ms"]
    t0 = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    r["plain_wall_ms"] = (time.perf_counter() - t0) * 1e3
    r["plain_lm_iterations"], r["plain_cg_steps"] = gauges()
    prof = device_profile(plain, 1)
    r["plain_device_ms"] = prof["device_busy_ms"]
    r["plain_kernels"] = prof["kernels"]
    r["max_abs_err"] = spa_gap(got, want)
    r["cost"], r["plain_cost"] = float(got[-1]), float(want[-1])
    step_bytes = SPA_STEP_BYTES_PER_ROW * r["rows"] + SPA_STEP_BYTES_PER_POSE * r["poses"]
    step_ops = SPA_STEP_OPS_PER_ROW * r["rows"] + SPA_STEP_OPS_PER_POSE * r["poses"]
    step = {}
    bound(step, step_bytes, step_ops)
    r["cg_step_bound_us"] = step["bound_ms"] * 1e3
    r["cg_step_bound_by"] = step["bound_by"]
    r["kernel_us_per_cg_step"] = r["kernel_device_ms"] * 1e3 / max(r["cg_steps"], 1)
    # The kernel table's units: one launch (an LM iteration).
    its = max(r["lm_iterations"], 1)
    r["kernel_ms"] = r["kernel_device_ms"] / max(r["launches"], 1)
    r["plain_ms"] = r["plain_device_ms"] / max(r["plain_lm_iterations"], 1)
    r["bound_ms"] = step["bound_ms"] * r["cg_steps"] / its
    r["bound_by"] = step["bound_by"]
    emit(r)
    if r["launches"] != r["lm_iterations"]:
        failed.append(f"{r['launches']} launches for {r['lm_iterations']} iterations")
    if whole:
        cap = kw["max_iterations"]
        if (r["lm_iterations"] < cap) != (r["plain_lm_iterations"] < cap):
            failed.append(f"{r['lm_iterations']} LM iterations against "
                          f"{r['plain_lm_iterations']} (one stopped at the cap)")
        if r["max_abs_err"] > 1e-3:
            failed.append(f"poses part by {r['max_abs_err']:.2e}")
        if abs(r["cost"] - r["plain_cost"]) > 1e-3 * max(abs(r["plain_cost"]), 1e-6):
            failed.append(f"costs {r['cost']} and {r['plain_cost']}")
    return r, failed


def spa_2d_phase(device):
    """The 2D SPA kernel against the plain solve on the card (module
    docstring, phase 3); raises after every case ran if one failed."""
    from cartographer_tpu_torch import metrics

    registry = metrics.enable_collection().registry()

    def gauges():
        return (int(registry["mapping_pose_graph_spa_lm_iterations"].value()),
                int(registry["mapping_pose_graph_spa_cg_steps"].value()))

    out, failed = {}, []
    try:
        for name, (tables, ex, kw, whole) in spa_cases().items():
            out[name], why = spa_solve_case(name, tables, ex, kw, whole, device, gauges)
            failed += [f"{name}: {w}" for w in why]
    finally:
        metrics.register_family_factory(metrics.FamilyFactory())
    if failed:
        raise AssertionError("spa_2d: " + "; ".join(failed))
    return out


def loop_world_options():
    from cartographer_tpu_torch.common.config import (
        GridOptions2D,
        SubmapsOptions2D,
        TrajectoryBuilder2DOptions,
    )

    # The cartographer_ros no-IMU 2D setting with online correlative
    # matching (revo_lds.lua); the 1024 grid at 5 cm holds the hall.
    return TrajectoryBuilder2DOptions(
        use_imu_data=False,
        max_range=12.0,
        use_online_correlative_scan_matching=True,
        submaps=SubmapsOptions2D(
            num_range_data=40,
            grid_options_2d=GridOptions2D(resolution=0.05, grid_size=1024),
        ),
    )


def range_events(measurements):
    return [("range", m.time, m) for m in measurements]


def feed(builder, events, flush=True):
    """Feed time-sorted (kind, time, payload) events to a local trajectory
    builder; returns its matching results (a chunked builder returns lists
    and is flushed at the end unless `flush` is false, a per-scan one
    returns one or None)."""
    results = []
    for kind, _, payload in events:
        if kind == "imu":
            builder.add_imu_data(payload)
        elif kind == "odometry":
            builder.add_odometry_data(payload)
        else:
            out = builder.add_range_data("range", payload)
            if isinstance(out, list):
                results.extend(out)
            elif out is not None:
                results.append(out)
    if flush and hasattr(builder, "flush"):
        results.extend(builder.flush())
    return results


FLAGS = ("matched", "inserted", "created", "popped", "finished", "num_filtered")


def per_scan_parity(events, options=None):
    """Drive the chunked frontend on cuda one scan per chunk and rerun each
    scan on the CPU from a copy of the GPU state before it, with the same
    packed input. Flags must be identical and poses within 1e-3 m and
    1e-3 rad."""
    import torch

    from cartographer_tpu_torch.mapping.chunked_frontend_2d import (
        ChunkedLocalTrajectoryBuilder2D,
    )
    from cartographer_tpu_torch.ops import frontend_2d as tf

    n_sc = len(tf.SCALARS)
    S = tf.SIDX
    worst = {"m": 0.0, "rad": 0.0, "known": 1.0}
    steps = []
    run = tf.run_chunk

    def scalars(packed):
        return packed.cpu().numpy()[: n_sc * 4].view(np.float32).reshape(1, n_sc)[0]

    def checked(cfg, state, shift, buf):
        out = run(cfg, state, shift, buf)
        cpu_state = tf.state_from_numpy(tf.state_to_numpy(state), device="cpu")
        cpu_out = run(cfg, cpu_state, shift, buf.cpu())
        g, c = scalars(out[3]), scalars(cpu_out[3])
        for k in FLAGS:
            if g[S[k]] != c[S[k]]:
                raise AssertionError(
                    f"scan {len(steps)}: GPU/CPU {k} differ: {g[S[k]]} vs {c[S[k]]}"
                )
        d_m = float(np.max(np.abs(g[[S["pose_x"], S["pose_y"]]] - c[[S["pose_x"], S["pose_y"]]])))
        d_rad = float(abs(g[S["pose_yaw"]] - c[S["pose_yaw"]]))
        if d_m > 1e-3 or d_rad > 1e-3:
            raise AssertionError(
                f"scan {len(steps)}: GPU/CPU pose differ by {d_m:.2e} m, {d_rad:.2e} rad"
            )
        known = float(
            (out[0].grids_known.cpu() == cpu_out[0].grids_known).float().mean()
        )
        worst["m"] = max(worst["m"], d_m)
        worst["rad"] = max(worst["rad"], d_rad)
        worst["known"] = min(worst["known"], known)
        steps.append(bool(g[S["inserted"]] > 0.5))
        return out

    builder = ChunkedLocalTrajectoryBuilder2D(
        options or loop_world_options(), {"range"}, chunk_size=1, device="cuda"
    )
    tf.run_chunk = checked
    try:
        feed(builder, events)
    finally:
        tf.run_chunk = run
    torch.cuda.synchronize()
    if worst["known"] < 0.999:
        raise AssertionError(f"GPU/CPU known grids agree on {worst['known']:.5f} only")
    return {
        "cpu_parity_scans": len(steps),
        "cpu_parity_inserted": sum(steps),
        "cpu_parity_max_m": worst["m"],
        "cpu_parity_max_rad": worst["rad"],
        "cpu_parity_min_known_agreement": worst["known"],
    }


def profile_phase(measurements, chunk):
    """One warm chunk of the chunked frontend under torch.profiler."""
    from cartographer_tpu_torch.mapping.chunked_frontend_2d import (
        ChunkedLocalTrajectoryBuilder2D,
    )

    builder = ChunkedLocalTrajectoryBuilder2D(
        loop_world_options(), {"range"}, chunk_size=chunk, device="cuda"
    )
    return profiled(builder, range_events(measurements[:chunk]),
                    range_events(measurements[chunk : 2 * chunk]), chunk)


def profiled(builder, warm_events, events, scans):
    """Feed `warm_events` untimed, then `events` under torch.profiler:
    the device's busy share (sum of kernel times over wall time), kernels
    per scan, and the kernels that take the most time. Only device
    activity is recorded: host op events add nothing these numbers read
    and cost more profiler time than the window itself."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    feed(builder, warm_events, flush=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        feed(builder, events, flush=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "scans": scans,
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3 if kernels else None,
        "device_idle_share": 1.0 - busy_us / wall_us if kernels else None,
        "kernels_per_scan": len(kernels) / scans,
        "top_kernels_ms": [[name[:80], us / 1e3] for name, us in top],
        "correlative_window_ms": sum(
            us for name, us in by_name.items() if "window_sums" in name
        ) / 1e3,
    }


@contextlib.contextmanager
def kernel_inputs(module, name, keep):
    """Within the block, `module.name` keeps a copy (tensors cloned) of the
    arguments of the call for which keep(args, kwargs) is largest (None or
    False: not a candidate; the first of equals wins), as (args, kwargs),
    in the list it yields. Raises after the block if no call was kept."""
    import torch

    launch = getattr(module, name)
    kept, best, calls = [], [None], [0]

    def clone(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def recording(*args, **kwargs):
        value = keep(args, kwargs)
        if value is not None and value is not False and (best[0] is None or value > best[0]):
            best[0] = value
            kept[:] = [(tuple(map(clone, args)), {k: clone(v) for k, v in kwargs.items()})]
        calls[0] += 1
        return launch(*args, **kwargs)

    setattr(module, name, recording)
    try:
        yield kept
    finally:
        setattr(module, name, launch)
    if not kept:
        raise AssertionError(f"none of {calls[0]} {name} calls was kept")


def nth_call(index):
    """A `keep` for kernel_inputs: the index-th call (from 0)."""
    count = [-1]

    def keep(args, kwargs):
        count[0] += 1
        return count[0] == index

    return keep


def window_sums_inputs(index):
    """kernel_inputs of the window-sum kernel's `index`-th call."""
    from cartographer_tpu_torch.kernels import correlative_window as cw

    return kernel_inputs(cw, "window_sums", nth_call(index))


def lm_call_inputs(kept):
    """A kept lm_match_2d.launch call as its arguments by name."""
    args, kwargs = kept[0]
    return {**dict(zip(LM_LAUNCH_ARGS, args)), **kwargs}


# The slice's world: a quarter lap of the loop world, 300 scans of 1024
# beams at 20 Hz.
SLICE_WORLD = dict(laps=0.25, time_step=0.05, num_beams=1024, max_range=12.0)

# Depth cuts for the script's time limit, in scans of that world: the
# slice run, and the sensors phase's four paths.
SLICE_SCANS = 200
SENSORS_SCANS = dict(chunked=128, per_scan=100, per_scan_tsdf=60, map_builder=150)


def max_position_error(results, true_poses, time_step, limit=0.3):
    """Max local-SLAM position error against ground truth, relative to the
    first matched scan; raises past `limit` or on a non-finite pose."""
    from cartographer_tpu_torch.testing.synthetic import FAKE_START_TIME
    from cartographer_tpu_torch.transform import rigid3

    if not np.all(np.isfinite([r.local_pose for r in results])):
        raise AssertionError("non-finite pose")
    k0 = int(round((results[0].time - FAKE_START_TIME) / time_step))
    est0_inv = rigid3.inverse(results[0].local_pose)
    true0_inv = rigid3.inverse(true_poses[k0])
    errs = []
    for r in results:
        k = int(round((r.time - FAKE_START_TIME) / time_step))
        est = rigid3.compose(est0_inv, r.local_pose)
        true = rigid3.compose(true0_inv, true_poses[k])
        errs.append(float(np.linalg.norm(est[:2] - true[:2])))
    max_err = max(errs)
    if max_err > limit:
        raise AssertionError(f"max position error {max_err:.3f} m > {limit} m")
    return max_err


def slice_phase(device, smi):
    import torch

    from cartographer_tpu_torch.kernels import launch_counts, lm_match_2d, reset_launch_counts
    from cartographer_tpu_torch.kernels import supercover_2d
    from cartographer_tpu_torch.testing.synthetic import generate_loop_world

    time_step, chunk = SLICE_WORLD["time_step"], 32
    measurements, true_poses = generate_loop_world(**SLICE_WORLD)
    measurements = measurements[:SLICE_SCANS]
    num_scans = len(measurements)

    from cartographer_tpu_torch.mapping.chunked_frontend_2d import (
        ChunkedLocalTrajectoryBuilder2D,
    )

    builder = ChunkedLocalTrajectoryBuilder2D(
        loop_world_options(), {"range"}, chunk_size=chunk, device=device
    )
    results = []
    t_first = None  # end of the first chunk (CUDA and allocator warm-up)
    # The inputs of each kernel's first call in the third chunk.
    with window_sums_inputs(2 * chunk) as kept, kernel_inputs(
        lm_match_2d, "launch", nth_call(2 * chunk)
    ) as kept_lm, kernel_inputs(
        supercover_2d, "insert_scan_dense", nth_call(2 * chunk)
    ) as kept_dense:
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for m in measurements:
            results.extend(builder.add_range_data("range", m))
            if t_first is None and results:
                torch.cuda.synchronize()
                t_first = time.perf_counter()
        results.extend(builder.flush())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steady_wall = time.perf_counter() - t_first
        launches = launch_counts()

    if not results:
        raise AssertionError("no scan was matched")
    for name in ("correlative_window", "lm_match_2d", "supercover_dense_2d"):
        require_launches(launches, name, len(results), "matched scans")
    require_launches(launches, "supercover_scatter_2d", 0, "", exactly=True)
    # (b) Local-SLAM error against ground truth, relative to the first node.
    max_err = max_position_error(results, true_poses, time_step)

    # (c) Every scan of the first two chunks again, on the CPU, from the
    # GPU's state before it and the same packed input.
    step = per_scan_parity(range_events(measurements[: 2 * chunk]))
    profile = profile_phase(measurements[: 2 * chunk], chunk)
    real = {"correlative_window": kept[0][0], "lm_match_2d": lm_call_inputs(kept_lm),
            "supercover_dense_2d": list(kept_dense[0][0])}

    r = {
        "phase": "slice",
        "scans": num_scans,
        "matched": len(results),
        "inserted": sum(x.insertion_result is not None for x in results),
        "chunk": chunk,
        "wall_s": wall,
        "scans_per_s": num_scans / wall,
        "real_time_ratio": num_scans * time_step / wall,
        "steady_scans_per_s": (num_scans - chunk) / steady_wall,
        "steady_real_time_ratio": (num_scans - chunk) * time_step / steady_wall,
        "launches": launches,
        "max_position_error_m": max_err,
        **step,
        "profile": profile,
        "card": smi,
    }
    emit(r)
    return r, real


# The backend phase's world: half a lap of bench.py's scaled world (a
# figure-eight through the pillared hall, 500 scans of 1024 beams; a depth
# cut from bench.py's 2 laps, to keep the script inside its time limit).
BACKEND_WORLD = dict(
    laps=0.5, duration_per_lap=50.0, time_step=0.05, num_beams=1024,
    max_range=12.0, noise_std=0.01,
)


# Nodes of the frontend's startup transient (bench.py's
# aligned_ate_max_excl_startup_m window).
STARTUP_NODES = 8


def node_errors(pg, true_poses, time_step, first):
    """Node position errors against ground truth, estimate and truth each
    re-anchored at node `first`; returns (errors, estimated xy, true xy)
    from that node on. Raises for too few nodes or a non-finite pose."""
    from cartographer_tpu_torch.mapping.id import NodeId
    from cartographer_tpu_torch.testing.synthetic import FAKE_START_TIME
    from cartographer_tpu_torch.transform import rigid3

    nodes = [n for _, n in pg.get_trajectory_nodes().items(NodeId)]
    if len(nodes) <= 2 * STARTUP_NODES:
        raise AssertionError(f"only {len(nodes)} nodes")
    est = [np.asarray(n.global_pose, np.float64) for n in nodes]
    true = [true_poses[int(round((n.constant_data.time - FAKE_START_TIME) / time_step))]
            for n in nodes]
    if not np.all(np.isfinite(est)):
        raise AssertionError("non-finite node pose")
    est0_inv, true0_inv = rigid3.inverse(est[first]), rigid3.inverse(true[first])
    est_xy = np.stack([rigid3.compose(est0_inv, p)[:2] for p in est[first:]])
    true_xy = np.stack([rigid3.compose(true0_inv, p)[:2] for p in true[first:]])
    return np.linalg.norm(est_xy - true_xy, axis=1), est_xy, true_xy


def backend_options():
    """bench.py's scaled-world backend (_bench_scaled_world) behind the
    slice's frontend (loop_world_options), with the search on the device."""
    from cartographer_tpu_torch.common.config import (
        FastCorrelativeScanMatcherOptions2D,
        MapBuilderOptions,
        MotionFilterOptions,
        PoseGraphOptions,
        TrajectoryBuilderOptions,
    )

    pose_graph = PoseGraphOptions(optimize_every_n_nodes=40)
    cb = pose_graph.constraint_builder
    cb.sampling_ratio = 0.4
    cb.min_score = 0.55
    cb.max_constraint_distance = 10.0
    cb.loop_closure_backend = "device"
    cb.fast_correlative_scan_matcher = FastCorrelativeScanMatcherOptions2D(
        linear_search_window=4.0, angular_search_window=np.radians(30.0),
        branch_and_bound_depth=6, beam_width=4096,
    )
    frontend = loop_world_options()
    frontend.motion_filter = MotionFilterOptions(
        max_distance_meters=0.15, max_angle_radians=0.08
    )
    return (
        MapBuilderOptions(
            use_trajectory_builder_2d=True, pose_graph=pose_graph,
            async_pose_graph=True,
        ),
        TrajectoryBuilderOptions(
            trajectory_builder_2d=frontend, use_chunked_device_frontend=True,
            device_frontend_chunk_size=32,
        ),
    )


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def replay_drain(searches, source, options, backend, device):
    """A fresh ConstraintBuilder2D on `device` with `backend`, fed `searches`
    against the grids and submap poses of the builder `source` (no sampling,
    no distance gate, so it runs exactly these searches)."""
    import copy

    from cartographer_tpu_torch.mapping.constraint_builder_2d import (
        ConstraintBuilder2D,
    )

    opts = copy.deepcopy(options)
    opts.sampling_ratio = 1.0
    opts.max_constraint_distance = 1e9
    opts.loop_closure_backend = backend
    cb = ConstraintBuilder2D(opts, device=device)
    for s in searches:
        cb.set_submap_local_pose(s.submap_id, source._submap_local_pose(s.submap_id))
        grid = source._submap_grids[s.submap_id]
        if s.initial_relative_pose is None:
            cb.maybe_add_global_constraint(s.submap_id, grid, s.node_id, s.constant_data)
        else:
            cb.maybe_add_constraint(
                s.submap_id, grid, s.node_id, s.constant_data, s.initial_relative_pose
            )
    return cb


def _zbar_by_pair(constraints):
    return {(c.submap_id, c.node_id): np.asarray(c.pose.zbar_ij) for c in constraints}


def _angle_diff(a, b):
    return float(abs((a - b + np.pi) % (2 * np.pi) - np.pi))


def _pose_diff(a, b):
    """(metres, radians) between two (x, y, theta) poses."""
    return float(np.max(np.abs(a[:2] - b[:2]))), _angle_diff(a[2], b[2])


def _zbar(cb, submap_id, pose):
    """A refined pose (the LM's frame) as the constraint's zbar_ij, as
    ConstraintBuilder2D.run_pending writes it."""
    sub = np.asarray(cb._submap_local_pose(submap_id), np.float64)
    ct, st = np.cos(-sub[2]), np.sin(-sub[2])
    dx, dy = pose[0] - sub[0], pose[1] - sub[1]
    return np.array([ct * dx - st * dy, st * dx + ct * dy, pose[2] - sub[2]])


def lm_iterates(cb, found, lane):
    """The batched refinement of a drain's BnB results `found` on `cb`'s
    device, re-run with 0, 1, ..., max_num_iterations LM iterations:
    lane `lane`'s iterates as rows (zbar_ij, cost) [I + 1, 4]."""
    jobs = [(s, r) for s, r in found if r is not None]
    search = jobs[lane][0]
    solver = cb._options.ceres_scan_matcher.ceres_solver_options
    its = solver.max_num_iterations
    out = []
    try:
        for k in range(its + 1):
            solver.max_num_iterations = k
            row = cb._batch_refine_dispatch(jobs)[lane].cpu().numpy().astype(np.float64)
            out.append(np.append(_zbar(cb, search.submap_id, row[:3]), row[3]))
    finally:
        solver.max_num_iterations = its
    return np.stack(out)


def lm_stop_explained(card, cpu, card_found, cpu_found, lane, card_zbar, cpu_zbar):
    """A refined pose that the card and the CPU put more than 1e-3 apart
    is accepted only as one LM run that branched at one accept test: the
    two BnB results are the same pose; re-running the drain's refinement
    with 0, 1, ..., max iterations ends on each device at its own refined
    pose (1e-3 m / 1e-3 rad); and the two devices' iterates part as
    `branched_at` requires at 1e-3, one device staying put. An LM that
    has not settled (it cycles or wanders: see each side's cost beside
    the least it reached) then ends elsewhere. Returns the lane's stats,
    or raises."""
    (search, g), (_, c) = [
        [(s, r) for s, r in found if r is not None][lane] for found in (card_found, cpu_found)
    ]
    where = f"drain replay: {search.submap_id}/{search.node_id}"
    if _pose_diff(g.pose, c.pose) != (0.0, 0.0):
        raise AssertionError(
            f"{where}: the BnB poses differ ({g.pose} on the card, {c.pose} on the CPU)"
        )
    on_card = lm_iterates(card, card_found, lane)
    on_cpu = lm_iterates(cpu, cpu_found, lane)
    for name, its, z in (("card", on_card, card_zbar), ("CPU", on_cpu, cpu_zbar)):
        if max(_pose_diff(its[-1], z)) > 1e-3:
            raise AssertionError(f"{where}: the {name}'s re-run ends at {its[-1]}, not {z}")
    try:
        k, side = branched_at(on_card, on_cpu, 1e-3)
    except AssertionError as e:
        raise AssertionError(f"{where}: {e}") from None
    m, rad = _pose_diff(card_zbar, cpu_zbar)
    return {
        "m": m, "rad": rad, "iteration_apart": k,
        "stayed": ("card", "cpu")[side],
        "cost_card": float(on_card[-1, 3]), "least_cost_card": float(np.min(on_card[:, 3])),
        "cost_cpu": float(on_cpu[-1, 3]), "least_cost_cpu": float(np.min(on_cpu[:, 3])),
    }


@contextlib.contextmanager
def bnb_passes():
    """Within the block, every lane chunk that the device BnB searches
    (fast_correlative_2d._bnb_lanes) as (its _Search, best (angle, x, y)
    [K, 3]), in the list it yields."""
    from cartographer_tpu_torch.ops.scan_matching import fast_correlative_2d as fc

    bnb, seen = fc._bnb_lanes, []

    def recording(lanes, *args):
        got = bnb(lanes, *args)
        seen.append((lanes, got[1]))
        return got

    fc._bnb_lanes = recording
    try:
        yield seen
    finally:
        fc._bnb_lanes = bnb


def scan_cells_survey(card_passes, cpu_passes):
    """The discretized scans (_Search.ix, iy) of the same lane chunks on
    the card and the CPU: valid (angle, point) cells in all, cells that
    differ between the devices, and those of them at each lane's best
    angle on the card (where they change the winning score; lanes that
    found a candidate). Chunks are
    paired in order while their shapes agree."""
    import torch

    out = {"cells": 0, "differ": 0, "differ_at_best_angle": 0, "lanes_with_differ_at_best": 0}
    for (card, best), (cpu, _) in zip(card_passes, cpu_passes):
        if card.ix.shape != cpu.ix.shape:
            break
        mask = cpu.pmask[:, None, :]
        differ = ((card.ix.cpu() != cpu.ix) | (card.iy.cpu() != cpu.iy)) & mask
        angle = best[:, 0].long().cpu()  # -1: no candidate passed the score gate
        at_best = differ[torch.arange(len(best)), angle.clamp(min=0)] & (angle >= 0)[:, None]
        out["cells"] += int(mask.sum()) * differ.shape[1]
        out["differ"] += int(differ.sum())
        out["differ_at_best_angle"] += int(at_best.sum())
        out["lanes_with_differ_at_best"] += int(at_best.any(dim=1).sum())
    return out


def bnb_mismatch(card, cpu, search):
    """Why the device BnB's best score for `search` differs between the
    card's constraint builder `card` and the CPU's `cpu`: which pyramid
    levels differ, each side's best candidate (angle, x, y), how many
    (angle, point) cells of the discretized scan differ between the
    devices (in all, and at each best's angle), and both bests' integer
    level-0 sums on either side's discretization (equal sums of two
    candidates: a tie)."""
    import torch

    pyramids = [b._matcher(search.submap_id)._pyramid.cpu() for b in (card, cpu)]
    out = {"search": f"{search.submap_id}/{search.node_id}",
           "pyramid_levels_differ": [
               lvl for lvl in range(pyramids[0].shape[0])
               if not torch.equal(pyramids[0][lvl], pyramids[1][lvl])]}
    runs = {}
    for side, b in (("card", card), ("cpu", cpu)):
        with bnb_passes() as seen:
            b._run_searches_device([search])
        lanes, best = seen[-1]  # the widest pass
        runs[side] = lanes, best[0].cpu()
        out[side] = {"best_angle_x_y": best[0].tolist()}
    (s_card, _), (s_cpu, _) = runs["card"], runs["cpu"]
    mask = s_cpu.pmask[0]
    differ = ((s_card.ix[0].cpu() != s_cpu.ix[0]) | (s_card.iy[0].cpu() != s_cpu.iy[0])) & mask
    out["scan_cells_differ"] = int(differ.sum())
    out["scan_cells"] = int(mask.sum()) * differ.shape[0]
    for side, (_, best) in runs.items():
        out[side]["scan_cells_differ_at_its_angle"] = int(differ[max(int(best[0]), 0)].sum())
        for name, (lanes, _) in runs.items():
            if best[0] < 0:  # no candidate passed the score gate
                continue
            a, x, y = (best[i].reshape(1, 1).to(lanes.ix.device) for i in range(3))
            sums, _ = lanes.score(0, a.long(), x, y, torch.ones_like(a, dtype=torch.bool))
            out[side][f"level0_sum_on_{name}"] = int(sums[0, 0])
    return out


def drain_checks(drain, source, options, resolution, device, survey=None):
    """One drain's searches again: through the CPU port (the same found
    set, BnB scores within 1e-5, refined poses within 1e-3 m / 1e-3 rad
    of the card's drain, or else one LM run that branched at one accept
    test: `lm_stop_explained`), and through the native backend (poses
    within one cell and 0.01 rad of the device search). With a dict
    `survey`, scan_cells_survey's counts of the two searches are added
    to it."""
    searches = drain["searches"]
    card = replay_drain(searches, source, options, "device", device)
    with bnb_passes() as card_passes:
        card_found = card._run_searches_device(searches)
    cpu = replay_drain(searches, source, options, "device", "cpu")
    t0 = time.perf_counter()
    cpu_zbar = _zbar_by_pair(cpu.run_pending())
    cpu_s = time.perf_counter() - t0
    with bnb_passes() as cpu_passes:
        cpu_found = cpu._run_searches_device(searches)
    if survey is not None:
        for key, n in scan_cells_survey(card_passes, cpu_passes).items():
            survey[key] = survey.get(key, 0) + n
    card_zbar = _zbar_by_pair(drain["constraints"])
    if set(cpu_zbar) != set(card_zbar):
        raise AssertionError(
            f"drain replay: CPU found {len(cpu_zbar)} constraints, the card "
            f"{len(card_zbar)}; they differ in {len(set(cpu_zbar) ^ set(card_zbar))}"
        )
    score_err, worst = 0.0, None
    for (s, g), (_, c) in zip(card_found, cpu_found):
        if (g is None) != (c is None):
            raise AssertionError("drain replay: CPU and card BnB found different sets")
        if g is not None and abs(g.score - c.score) > score_err:
            score_err, worst = abs(g.score - c.score), s
    if score_err > 1e-5:
        raise AssertionError(f"drain replay: BnB scores differ by {score_err:.2e}: "
                             + json.dumps(bnb_mismatch(card, cpu, worst)))
    pose_m = pose_rad = 0.0
    lanes = [(s.submap_id, s.node_id) for s, g in card_found if g is not None]
    unsettled = []
    for key, z in card_zbar.items():
        m, rad = _pose_diff(cpu_zbar[key], z)
        if m > 1e-3 or rad > 1e-3:
            unsettled.append(lm_stop_explained(
                card, cpu, card_found, cpu_found, lanes.index(key), z, cpu_zbar[key]))
            continue
        pose_m, pose_rad = max(pose_m, m), max(pose_rad, rad)

    native = replay_drain(searches, source, options, "native", device)
    t0 = time.perf_counter()
    native_found = native._run_searches_native(searches)
    native_s = time.perf_counter() - t0
    native_m = native_rad = 0.0
    differ = near_gate = 0
    for (s, g), (_, n) in zip(card_found, native_found):
        if (g is None) != (n is None):
            differ += 1
            score = (g or n).score
            gate = options.global_localization_min_score if (
                s.initial_relative_pose is None) else options.min_score
            near_gate += abs(score - gate) < 0.01
            continue
        if g is not None:
            native_m = max(native_m, float(np.max(np.abs(n.pose[:2] - g.pose[:2]))))
            native_rad = max(native_rad, _angle_diff(n.pose[2], g.pose[2]))
    if differ != near_gate:
        raise AssertionError(
            f"native and device searches disagree on {differ - near_gate} "
            "found flags away from the score gate"
        )
    if native_m > resolution + 1e-6 or native_rad >= 0.01:
        raise AssertionError(
            f"native and device poses differ by {native_m:.3f} m, {native_rad:.4f} rad"
        )
    return {
        "replay_searches": len(searches),
        "replay_found": len(card_zbar),
        "replay_cpu_s": cpu_s,
        "replay_cpu_max_score_err": score_err,
        "replay_cpu_max_m": pose_m,
        "replay_cpu_max_rad": pose_rad,
        # Lanes held by lm_stop_explained instead of the 1e-3 bound.
        "replay_cpu_unsettled_lanes": unsettled,
        "replay_native_s": native_s,
        "replay_native_max_m": native_m,
        "replay_native_max_rad": native_rad,
        "replay_native_found_differ_at_gate": differ,
    }


def spa_check(solve, call):
    """The run's last SPA problem re-solved on the CPU: poses within
    1e-3 m / 1e-3 rad of the card's solve."""
    import torch

    def to_cpu(tables):
        return None if tables is None else type(tables)(*[t.cpu() for t in tables])

    t0 = time.perf_counter()
    got = solve(to_cpu(call["problem"]), **{**call["kw"], "extras": to_cpu(call["kw"].get("extras"))})
    cpu_s = time.perf_counter() - t0
    worst_m = worst_rad = 0.0
    for g, c in zip(call["out"][:-1], got[:-1]):
        g, c = g.cpu().numpy(), c.numpy()
        worst_m = max(worst_m, float(np.max(np.abs(g[:, :2] - c[:, :2]), initial=0.0)))
        d = np.abs((g[:, 2] - c[:, 2] + np.pi) % (2 * np.pi) - np.pi)
        worst_rad = max(worst_rad, float(np.max(d, initial=0.0)))
    if worst_m > 1e-3 or worst_rad > 1e-3:
        raise AssertionError(
            f"SPA card/CPU poses differ by {worst_m:.2e} m, {worst_rad:.2e} rad"
        )
    return {
        "spa_nodes": int(call["problem"].node_poses.shape[0]),
        "spa_submaps": int(call["problem"].submap_poses.shape[0]),
        "spa_constraints": int(torch.sum(call["problem"].c_mask).item()),
        "spa_cpu_s": cpu_s,
        "spa_cpu_max_m": worst_m,
        "spa_cpu_max_rad": worst_rad,
        "spa_cost_card": float(call["out"][-1]),
        "spa_cost_cpu": float(got[-1]),
    }


def refine_lanes(args, kwargs):
    """A `keep` for kernel_inputs: a drain refinement's lane count."""
    return args[2].shape[0] if kwargs.get("cloud_rows") is not None else None


def backend_phase(device, smi):
    """MapBuilder on `device` over BACKEND_WORLD: the frontend, the pose
    graph with asynchronous drains, loop closure through the device BnB and
    the batched LM, SPA, and the final optimization; then one drain and the
    last SPA problem checked against the CPU and the native search. Also
    returns the map builder, its serialized state (timed) and the world,
    for the persist phase."""
    from cartographer_tpu_torch import metrics
    from cartographer_tpu_torch.evaluation.trajectory_metrics import aligned_ate
    from cartographer_tpu_torch.kernels import launch_counts, lm_match_2d, reset_launch_counts
    from cartographer_tpu_torch.mapping import optimization_problem_2d as op2d
    from cartographer_tpu_torch.mapping.id import SubmapId
    from cartographer_tpu_torch.mapping.map_builder import MapBuilder
    from cartographer_tpu_torch.testing.synthetic import generate_loop_world

    measurements, true_poses = generate_loop_world(**BACKEND_WORLD)
    time_step = BACKEND_WORLD["time_step"]
    mb_options, traj_options = backend_options()
    collected = metrics.enable_collection()
    mb = MapBuilder(mb_options, device=device)
    pg = mb.pose_graph
    cb = pg._constraint_builder
    drains = []
    run_pending = cb.run_pending

    feed_end = [None]

    def recorded_run_pending():
        started = time.perf_counter()
        out = run_pending()
        if cb.last_drain_searches:
            drains.append(dict(
                searches=cb.last_drain_searches, constraints=out,
                timings=dict(cb.last_drain_timings),
                during_feed=feed_end[0] is None or started < feed_end[0],
            ))
        return out

    solve = op2d.solve
    last_solve = {}

    def recorded_solve(problem, **kw):
        out = solve(problem, **kw)
        last_solve.update(problem=problem, kw=kw, out=out)
        return out

    cb.run_pending = recorded_run_pending
    op2d.solve = recorded_solve
    try:
        tid = mb.add_trajectory_builder({"range"}, traj_options)
        builder = mb.get_trajectory_builder(tid)
        # The inputs of the drain refinement with the most lanes.
        with kernel_inputs(lm_match_2d, "launch", refine_lanes) as kept_refine:
            sync(device)
            reset_launch_counts()
            t0 = time.perf_counter()
            for m in measurements:
                builder.add_sensor_data("range", m)
            sync(device)
            feed_end[0] = time.perf_counter()
            feed_s = feed_end[0] - t0
            t0 = time.perf_counter()
            mb.finish_trajectory(tid)
            sync(device)
            catch_up_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            pg.run_final_optimization()
            sync(device)
            final_s = time.perf_counter() - t0
            launches = launch_counts()
        mb.shutdown()
        # The map as it stands, for the persist phase (no scan is fed
        # again there).
        t0 = time.perf_counter()
        state = mb.serialize_state()
        serialize_s = time.perf_counter() - t0
    finally:
        op2d.solve = solve
        metrics.register_family_factory(metrics.FamilyFactory())
    registry = collected.registry()
    searched = int(registry["mapping_constraint_builder_constraints_searched"].value())
    retries = int(registry["mapping_constraint_builder_beam_overflow_retries"].value())

    # Accuracy: node errors relative to a first node, and SE(2)-aligned
    # ATE. The first STARTUP_NODES nodes carry the frontend's startup
    # transient (the platform starts at full speed with no velocity
    # estimate, so the first scans unwarp wrongly; bench.py's
    # aligned_ate_max_excl_startup_m), so the asserted error is taken
    # relative to the first node after them.
    errs, _, _ = node_errors(pg, true_poses, time_step, STARTUP_NODES)
    errs_all, est_xy, true_xy = node_errors(pg, true_poses, time_step, 0)
    ate = aligned_ate(est_xy, true_xy)
    inter = [c for c in pg.constraints if c.tag == "INTER_SUBMAP"]
    if not inter:
        raise AssertionError("no INTER_SUBMAP constraint")
    if searched <= 0:
        raise AssertionError("no device BnB search")
    for name in ("correlative_window", "lm_match_2d", "supercover_dense_2d"):
        require_launches(launches, name, len(errs_all), "nodes")
    require_launches(launches, "spa_2d", len(pg.solve_seconds), "SPA solves")
    if errs.max() > 0.3:
        raise AssertionError(
            f"max node error {errs.max():.3f} m > 0.3 m (relative to node {STARTUP_NODES})"
        )

    resolution = traj_options.trajectory_builder_2d.submaps.grid_options_2d.resolution
    # The drain with the most constraints among those of at most 80
    # searches (the CPU reruns them at about one search per 0.1-0.5 s).
    small = [d for d in drains if d["constraints"] and len(d["searches"]) <= 80]
    if not small:
        raise AssertionError("no drain of at most 80 searches found a constraint")
    drain = max(small, key=lambda d: len(d["constraints"]))
    replay = drain_checks(
        drain, cb, mb_options.pose_graph.constraint_builder, resolution, device
    )
    spa = spa_check(solve, last_solve)

    per_drain = []
    for d in drains:
        t = d["timings"]
        refine_s = t["refine_dispatch_s"] + t["refine_wait_s"]
        per_drain.append({
            "searches": t["searches"], "matches": t["matches"],
            "search_s": t["search_s"], "searches_per_s": t["searches"] / t["search_s"],
            "refine_s": refine_s, "total_s": t["total_s"],
            "during_feed": d["during_feed"],
        })
    r = {
        "phase": "backend",
        "scans": len(measurements),
        "nodes": len(errs_all),
        "submaps": len(list(pg.get_all_submap_data().items(SubmapId))),
        "searches": searched,
        "beam_overflow_retries": retries,
        "constraints_found": len(inter),
        "constraints_intra": len(pg.constraints) - len(inter),
        "drains": per_drain,
        "searches_per_s_all_drains": sum(d["searches"] for d in per_drain)
        / sum(d["search_s"] for d in per_drain),
        "refine_s_per_drain_mean": float(np.mean([d["refine_s"] for d in per_drain])),
        "spa_s_last": pg.solve_seconds[-2] if len(pg.solve_seconds) > 1 else None,
        "spa_s_final": pg.solve_seconds[-1],
        "spa_solves": len(pg.solve_seconds),
        "max_node_error_m": float(errs.max()),
        "max_node_error_from_node_0_m": float(errs_all.max()),
        "aligned_ate_mean_m": float(np.mean(ate)),
        "aligned_ate_max_m": float(np.max(ate)),
        "aligned_ate_max_excl_startup_m": float(np.max(ate[STARTUP_NODES:])),
        "feed_s": feed_s,
        "feed_scans_per_s": len(measurements) / feed_s,
        "catch_up_s": catch_up_s,
        "final_optimization_s": final_s,
        "launches": launches,
        **replay,
        **spa,
        "state_mb": len(state) / 1e6,
        "serialize_s": serialize_s,
        "card": smi,
    }
    emit(r)
    saved = dict(map_builder=mb, state=state, serialize_s=serialize_s,
                 refine_inputs=lm_call_inputs(kept_refine),
                 measurements=measurements, true_poses=true_poses, drains=drains,
                 constraint_builder=cb, resolution=resolution,
                 constraint_options=mb_options.pose_graph.constraint_builder)
    return r, saved


def lm_three_ways(inp, totals, round_):
    """One drain refinement's lanes held at LM_TOL three ways by
    lm_lanes_compare: the kernel against the plain version on the card
    (kernel_2d's real_refine check), the kernel against the plain version
    on the CPU, and the plain version on the card against it on the CPU.
    Adds to `totals` per way: lanes, the worst within LM_TOL (m), the
    worst relative cost error of any lane, lanes beyond LM_TOL, branched
    lanes, and the unexplained ones (with `round_`, and for the first way
    the plain versions' own difference on that lane)."""
    import torch

    from cartographer_tpu_torch.kernels import lm_match_2d as lm

    on_cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in inp.items()}
    kernel, plain_card, plain_cpu = lm.launch(**inp), lm_plain(inp), lm_plain(on_cpu)
    its = inp["max_iterations"]
    ways = {
        "kernel_vs_plain_card": lm_lanes_compare(inp, kernel, plain_card),
        "kernel_vs_plain_cpu": lm_lanes_compare(inp, kernel, plain_cpu, plain_inp=on_cpu),
        "plain_card_vs_plain_cpu": lm_lanes_compare(
            inp, plain_card, plain_cpu, plain_inp=on_cpu, got_iterates=lambda: torch.stack(
                [lm_plain(inp, i) for i in range(its + 1)])),
    }
    # The plain version against itself across the devices on each lane
    # that the kernel's comparison on the card leaves unexplained.
    pc, pu = (x.cpu().numpy().astype(np.float64) for x in (plain_card, plain_cpu))
    for u in ways["kernel_vs_plain_card"]["unexplained"]:
        a, b = pc[u["lane"]], pu[u["lane"]]
        u["plain_card_vs_cpu"] = {"m": max(_pose_diff(a, b)),
                                  "cost_rel": abs(a[3] - b[3]) / max(abs(b[3]), 1e-6)}
    for way, c in ways.items():
        t = totals.setdefault(way, {"lanes": 0, "max_m_within_tol": 0.0,
                                    "max_cost_rel_all": 0.0, "beyond_tol": 0,
                                    "branched": 0, "unexplained": []})
        t["lanes"] += len(kernel)
        t["max_m_within_tol"] = max(t["max_m_within_tol"], c["max_m"])
        t["max_cost_rel_all"] = max(t["max_cost_rel_all"], c["max_cost_rel_err_all"])
        t["beyond_tol"] += c["lanes_beyond_tol"]
        t["branched"] += c["branched_lanes"]
        t["unexplained"] += [dict(u, round=round_) for u in c["unexplained"]]


def refine_study(device, saved, seconds, seed=1):
    """`drain_checks` again and again for `seconds` on the backend run's
    searches, each search's initial pose moved by up to 1 m and 0.2 rad
    (seeded), the card's own drain of them standing for the run's: how
    many refined lanes the card and the CPU put within 1e-3 of each
    other, and each lane that only `lm_stop_explained` accepts (a BnB
    score mismatch carries bnb_mismatch's diagnosis, and every round adds
    scan_cells_survey's counts); and each round's drain refinement held
    three ways at LM_TOL (lm_three_ways). A round that fails is recorded,
    not raised."""
    import dataclasses

    from cartographer_tpu_torch.kernels import lm_match_2d

    cb, options = saved["constraint_builder"], saved["constraint_options"]
    searches = [s for d in saved["drains"] for s in d["searches"]
                if s.initial_relative_pose is not None]
    rng = np.random.default_rng(seed)
    out = {"phase": "refine_study", "seed": seed, "searches_per_round": len(searches),
           "rounds": 0, "lanes": 0, "max_m_within_bound": 0.0, "unsettled": [],
           "failed": [], "lm_at_tol": {}, "scan_cells": {}}
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        moved = []
        for s in searches:
            p = np.array(s.initial_relative_pose, np.float64)
            p[:2] += rng.uniform(-1.0, 1.0, 2)
            p[2] += rng.uniform(-0.2, 0.2)
            moved.append(dataclasses.replace(s, initial_relative_pose=p))
        try:
            with kernel_inputs(lm_match_2d, "launch", refine_lanes) as kept:
                card = replay_drain(moved, cb, options, "device", device)
                drain = {"searches": moved, "constraints": card.run_pending()}
            lm_three_ways(lm_call_inputs(kept), out["lm_at_tol"], out["rounds"])
            res = drain_checks(drain, cb, options, saved["resolution"], device,
                               survey=out["scan_cells"])
            out["lanes"] += res["replay_found"]
            out["max_m_within_bound"] = max(out["max_m_within_bound"],
                                            res["replay_cpu_max_m"])
            out["unsettled"] += [dict(u, round=out["rounds"])
                                 for u in res["replay_cpu_unsettled_lanes"]]
        except AssertionError as e:
            out["failed"].append({"round": out["rounds"], "why": str(e)})
        out["rounds"] += 1
    emit(out)
    return out

# -- sensors: IMU and odometry, the per-scan path, TSDF, MapBuilder's default


def sensor_events(measurements, seed=0):
    """The slice world's scans with IMU at 100 Hz (angular velocity z the
    figure-eight's yaw rate by central difference, linear acceleration
    (0, 0, 9.8)) and odometry at 50 Hz (the true pose plus N(0, 1e-3) m in
    x and y), both from 0.05 s before the first scan; time-sorted (kind,
    time, payload) events, IMU before odometry before range at equal
    times."""
    from cartographer_tpu_torch.sensor.data import ImuData, OdometryData
    from cartographer_tpu_torch.testing.synthetic import (
        FAKE_START_TIME,
        _figure_eight_pose,
    )
    from cartographer_tpu_torch.transform import rigid3

    # generate_loop_world's defaults: half width 8 m, half height 6 m,
    # 60 s per lap.
    def pose(t):
        return _figure_eight_pose(2.0 * np.pi * (t - FAKE_START_TIME) / 60.0, 8.0, 6.0)

    t_end = measurements[-1].time
    events = []
    h = 1e-3
    for t in np.arange(FAKE_START_TIME - 0.05, t_end, 0.01):
        d_yaw = pose(t + h)[1] - pose(t - h)[1]
        yaw_rate = float(np.arctan2(np.sin(d_yaw), np.cos(d_yaw))) / (2.0 * h)
        events.append(("imu", float(t), ImuData(
            time=float(t), linear_acceleration=np.array([0.0, 0.0, 9.8]),
            angular_velocity=np.array([0.0, 0.0, yaw_rate]),
        )))
    rng = np.random.default_rng(seed)
    for t in np.arange(FAKE_START_TIME - 0.05, t_end, 0.02):
        pos, yaw = pose(t)
        xyz = np.array([pos[0], pos[1], 0.0])
        xyz[:2] += rng.normal(0.0, 1e-3, 2)
        events.append(("odometry", float(t), OdometryData(
            time=float(t),
            pose=rigid3.make(xyz, rigid3.quat_from_angle_axis(np.array([0.0, 0.0, yaw]))),
        )))
    events += range_events(measurements)
    order = {"imu": 0, "odometry": 1, "range": 2}
    events.sort(key=lambda e: (e[1], order[e[0]]))
    return events


def first_scans(events, num):
    """The events up to and including the num-th scan."""
    seen = 0
    for i, (kind, _, _) in enumerate(events):
        seen += kind == "range"
        if seen == num:
            return events[: i + 1]
    return events


def sensor_options(grid_type="PROBABILITY_GRID"):
    """The slice's frontend (loop_world_options) with IMU on."""
    opts = loop_world_options()
    opts.use_imu_data = True
    opts.submaps.grid_options_2d.grid_type = grid_type
    return opts


def per_scan_builder_parity(events, options, num_scans=8):
    """The per-scan builder on cuda over the first `num_scans` scans; each
    scan is also run by a CPU copy of the builder as it stood before it.
    The same result kinds, poses within 1e-3 m and 1e-3 rad. Also returns
    the inputs of the run's first window-sum call."""
    from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (
        LocalTrajectoryBuilder2D,
    )
    from cartographer_tpu_torch.transform import rigid3

    builder = LocalTrajectoryBuilder2D(options, {"range"}, device="cuda")
    worst_m = worst_rad = 0.0
    compared = 0
    with window_sums_inputs(0) as kept:
        for kind, _, payload in first_scans(events, num_scans):
            if kind == "imu":
                builder.add_imu_data(payload)
                continue
            if kind == "odometry":
                builder.add_odometry_data(payload)
                continue
            twin = builder.to("cpu")
            g = builder.add_range_data("range", payload)
            c = twin.add_range_data("range", payload)
            if (g is None) != (c is None) or (g is not None and (
                    g.insertion_result is None) != (c.insertion_result is None)):
                raise AssertionError(
                    f"scan {compared}: GPU/CPU per-scan results differ in kind")
            if g is None:
                continue
            gp, cp = rigid3.project_2d(g.local_pose), rigid3.project_2d(c.local_pose)
            worst_m = max(worst_m, float(np.max(np.abs(gp[:2] - cp[:2]))))
            worst_rad = max(worst_rad, _angle_diff(gp[2], cp[2]))
            compared += 1
    if worst_m > 1e-3 or worst_rad > 1e-3:
        raise AssertionError(
            f"per-scan GPU/CPU poses differ by {worst_m:.2e} m, {worst_rad:.2e} rad"
        )
    return {"cpu_parity_scans": compared, "cpu_parity_max_m": worst_m,
            "cpu_parity_max_rad": worst_rad}, kept[0][0]


def require_launches(launches, name: str, needed: int, what: str,
                     exactly: bool = False) -> None:
    """Kernel `name` ran at least `needed` times (exactly, with `exactly`)
    in a path's run; `launches` is that run's kernels.launch_counts()."""
    got = launches[name]
    if got < needed or (exactly and got != needed):
        raise AssertionError(
            f"{name} launched {got} times for {needed} {what}".rstrip()
        )


NEW_2D_KERNELS = ("lm_match_2d", "supercover_dense_2d", "supercover_scatter_2d")


def require_none(launches, names, what: str) -> None:
    """None of the kernels `names` ran on a path that must not use them."""
    for name in names:
        require_launches(launches, name, 0, f"({what} launches none)", exactly=True)


def timed_run(make_builder, events, num_scans, time_step, true_poses, device):
    """Feed `events` to a fresh builder with the launch count set to 0:
    scans/s, real-time ratio, error against ground truth, launches."""
    from cartographer_tpu_torch.kernels import launch_counts, reset_launch_counts

    builder = make_builder()
    sync(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    results = feed(builder, events)
    sync(device)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if not results:
        raise AssertionError("no scan was matched")
    return results, {
        "scans": num_scans,
        "matched": len(results),
        "inserted": sum(r.insertion_result is not None for r in results),
        "wall_s": wall,
        "scans_per_s": num_scans / wall,
        "real_time_ratio": num_scans * time_step / wall,
        "max_position_error_m": max_position_error(results, true_poses, time_step),
        "launches": launches,
    }


def per_scan_part(events, true_poses, options, num_scans, time_step, device):
    """The per-scan builder on `device` over the first `num_scans` scans, then
    its GPU/CPU parity and a profile. The correlative match runs once for
    every matched scan that has a submap to match against (all but the
    first). Also returns the inputs of the parity run's first window-sum
    call."""
    from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (
        LocalTrajectoryBuilder2D,
    )

    from cartographer_tpu_torch.kernels import supercover_2d

    head = first_scans(events, num_scans)
    tsdf = options.submaps.grid_options_2d.grid_type == "TSDF"
    # A probability grid's 11th insertion (a submap some scans old) is
    # the scatter kernel's "real" case.
    recording = contextlib.nullcontext([None]) if tsdf else kernel_inputs(
        supercover_2d, "insert_scan", nth_call(10))
    with recording as kept_scatter:
        results, r = timed_run(
            lambda: LocalTrajectoryBuilder2D(options, {"range"}, device=device),
            head, num_scans, time_step, true_poses, device,
        )
    launches = r["launches"]
    require_launches(launches, "correlative_window", len(results) - 1,
                     "matched scans with a submap")
    if tsdf:  # match_tsdf and insert_scan_tsdf stay plain PyTorch
        require_none(launches, NEW_2D_KERNELS, "the TSDF path")
    else:
        require_launches(launches, "lm_match_2d", len(results) - 1,
                         "matched scans with a submap")
        require_launches(launches, "supercover_scatter_2d", r["inserted"], "insertions")
        require_none(launches, ["supercover_dense_2d"], "the per-scan path")
    r["scatter_inputs"] = None if tsdf else list(kept_scatter[0][0])
    parity, window_sums_args = per_scan_builder_parity(events, options)
    r.update(parity)
    # Scans 11-20 of a fresh run under the profiler.
    warm = first_scans(events, 10)
    r["profile"] = profiled(
        LocalTrajectoryBuilder2D(options, {"range"}, device=device),
        warm, first_scans(events, 20)[len(warm):], 10,
    )
    return r, window_sums_args


def map_builder_part(events, num_scans, time_step, device):
    """MapBuilder on `device` with the default 2D TrajectoryBuilderOptions
    (per-scan builder, IMU) plus odometry, num_range_data 10 and the
    pure-localization trimmer keeping 3 submaps, behind the backend
    phase's pose graph drained synchronously."""
    from cartographer_tpu_torch.common.config import (
        PureLocalizationTrimmerOptions,
        TrajectoryBuilderOptions,
    )
    from cartographer_tpu_torch.kernels import launch_counts, reset_launch_counts
    from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
    from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (
        LocalTrajectoryBuilder2D,
    )
    from cartographer_tpu_torch.mapping.map_builder import MapBuilder

    mb_options, _ = backend_options()
    mb_options.async_pose_graph = False
    options = TrajectoryBuilderOptions(
        pure_localization_trimmer=PureLocalizationTrimmerOptions(max_submaps_to_keep=3)
    )
    options.trajectory_builder_2d.submaps.num_range_data = 10
    mb = MapBuilder(mb_options, device=device)
    tid = mb.add_trajectory_builder({"range", "imu", "odometry"}, options)
    builder = mb.get_trajectory_builder(tid)
    if not isinstance(builder._wrapped._local_trajectory_builder, LocalTrajectoryBuilder2D):
        raise AssertionError("the default options did not route to the per-scan builder")
    sync(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    for kind, _, payload in first_scans(events, num_scans):
        builder.add_sensor_data(kind, payload)
    mb.finish_trajectory(tid)
    mb.pose_graph.run_final_optimization()
    sync(device)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    mb.shutdown()
    pg = mb.pose_graph
    left = [sid.submap_index for sid, _ in pg.get_all_submap_data().items(SubmapId)
            if sid.trajectory_id == tid]
    nodes = [n for nid, n in pg.get_trajectory_nodes().items(NodeId)
             if nid.trajectory_id == tid]
    if not nodes or not np.all(np.isfinite([n.global_pose for n in nodes])):
        raise AssertionError("no or non-finite node poses")
    if len(left) > 3:
        raise AssertionError(f"{len(left)} submaps remain, the trimmer keeps 3")
    created = max(left) + 1
    if created - len(left) < 1:
        raise AssertionError("the pure-localization trimmer removed no submap")
    # Every node but the first was matched, and every node inserted; the
    # default options match without the online correlative search.
    require_launches(launches, "lm_match_2d", len(nodes) - 1, "nodes")
    require_launches(launches, "supercover_scatter_2d", len(nodes), "nodes")
    require_none(launches, ["supercover_dense_2d"], "the per-scan path")
    return {
        "scans": num_scans,
        "nodes": len(nodes),
        "submaps_created": created,
        "submaps_left": len(left),
        "constraints": len(pg.constraints),
        "wall_s": wall,
        "scans_per_s": num_scans / wall,
        "real_time_ratio": num_scans * time_step / wall,
        "launches": launches,
    }


def sensors_phase(device, smi):
    """The slice's world with IMU and odometry through four paths on
    `device`: the chunked frontend, the per-scan builder on a probability
    grid and on a TSDF, and MapBuilder with the default 2D options. Also
    returns the inputs of each per-scan path's first window-sum call."""
    from cartographer_tpu_torch.mapping.chunked_frontend_2d import (
        ChunkedLocalTrajectoryBuilder2D,
    )
    from cartographer_tpu_torch.testing.synthetic import generate_loop_world

    time_step, chunk = SLICE_WORLD["time_step"], 32
    measurements, true_poses = generate_loop_world(**SLICE_WORLD)
    events = sensor_events(measurements)
    t_phase = time.perf_counter()

    n = SENSORS_SCANS
    results, chunked = timed_run(
        lambda: ChunkedLocalTrajectoryBuilder2D(
            sensor_options(), {"range"}, chunk_size=chunk, device=device),
        first_scans(events, n["chunked"]), n["chunked"], time_step, true_poses, device,
    )
    for name in ("correlative_window", "lm_match_2d", "supercover_dense_2d"):
        require_launches(chunked["launches"], name, len(results), "matched scans")
    require_none(chunked["launches"], ["supercover_scatter_2d"], "the chunked path")
    chunked["chunk"] = chunk
    chunked.update(per_scan_parity(first_scans(events, 2 * chunk), sensor_options()))

    per_scan, per_scan_args = per_scan_part(
        events, true_poses, sensor_options(), n["per_scan"], time_step, device)
    tsdf, tsdf_args = per_scan_part(
        events, true_poses, sensor_options("TSDF"), n["per_scan_tsdf"], time_step, device)
    map_builder = map_builder_part(events, n["map_builder"], time_step, device)
    scatter_args = per_scan.pop("scatter_inputs")
    tsdf.pop("scatter_inputs")
    r = {
        "phase": "sensors",
        "imu_hz": 100, "odometry_hz": 50,
        "chunked": chunked,
        "per_scan": per_scan,
        "per_scan_tsdf": tsdf,
        "map_builder": map_builder,
        "phase_s": time.perf_counter() - t_phase,
        "card": smi,
    }
    emit(r)
    return r, {"per_scan": per_scan_args, "per_scan_tsdf": tsdf_args,
               "scatter_per_scan": scatter_args}


# -- local_slam_3d: the 3D frontends at the JAX package's 3D bench setting


def rotation_angle(a, b) -> float:
    """The angle of the rotation between unit quaternions a and b, exact
    near 0 (arccos of a float32 dot product is not: a quaternion against
    itself reads up to 5e-4 rad)."""
    from cartographer_tpu_torch.transform import rigid3

    a, b = (rigid3.quat_normalize(np.asarray(q, np.float64)) for q in (a, b))
    d = rigid3.quat_multiply(rigid3.quat_conjugate(a), b)
    return 2.0 * float(np.arctan2(np.linalg.norm(d[1:]), abs(d[0])))


def position_errors_3d(results, true_position, limit=0.5):
    """Final and max position error of the local poses against ground
    truth (no alignment: both start at the origin); raises past `limit`
    (0.1 x the 5 m travel, as tests/test_chunked_frontend_3d.py holds) or
    on a non-finite pose."""
    poses = np.array([r.local_pose for r in results])
    if not np.all(np.isfinite(poses)):
        raise AssertionError("non-finite 3D pose")
    errs = [float(np.linalg.norm(r.local_pose[:3] - true_position(r.time)))
            for r in results]
    if max(errs) > limit:
        raise AssertionError(f"3D max position error {max(errs):.3f} m > {limit} m")
    return errs[-1], max(errs)


def chunk_3d_parity(events, num_scans, device="cuda"):
    """The chunked 3D frontend on `device` one scan per chunk; each scan is
    rerun on the CPU from a copy of the GPU state before it, with the same
    packed input. Insert flags identical, poses within 1e-3 m / 1e-3 rad."""
    from cartographer_tpu_torch.mapping.chunked_frontend_3d import (
        ChunkedLocalTrajectoryBuilder3D,
    )
    from cartographer_tpu_torch.ops import frontend_3d as tf
    from cartographer_tpu_torch.testing.bench_3d import bench_3d_options

    n_sc, S = len(tf.SCALARS), tf.SIDX
    flags = ("matched", "inserted", "created", "popped", "finished", "count0", "count1")
    worst = {"m": 0.0, "rad": 0.0}
    steps = []
    run = tf.run_chunk

    def scalars(packed):
        return packed.cpu().numpy()[: n_sc * 4].view(np.float32)

    def checked(cfg, state, shift, buf):
        out = run(cfg, state, shift, buf)
        cpu_state = tf.state_from_numpy(tf.state_to_numpy(state), device="cpu")
        cpu_out = run(cfg, cpu_state, shift, buf.cpu())
        g, c = scalars(out[2]), scalars(cpu_out[2])
        for k in flags:
            if g[S[k]] != c[S[k]]:
                raise AssertionError(
                    f"3D scan {len(steps)}: GPU/CPU {k} differ: {g[S[k]]} vs {c[S[k]]}")
        xyz = slice(S["est_x"], S["est_z"] + 1)
        quat = slice(S["est_qw"], S["est_qz"] + 1)
        d_m = float(np.max(np.abs(g[xyz] - c[xyz])))
        d_rad = rotation_angle(g[quat], c[quat])
        if d_m > 1e-3 or d_rad > 1e-3:
            raise AssertionError(
                f"3D scan {len(steps)}: GPU/CPU poses differ by {d_m:.2e} m, {d_rad:.2e} rad")
        worst["m"], worst["rad"] = max(worst["m"], d_m), max(worst["rad"], d_rad)
        steps.append(bool(g[S["inserted"]] > 0.5))
        return out

    builder = ChunkedLocalTrajectoryBuilder3D(
        bench_3d_options(), {"range"}, chunk_size=1, device=device)
    tf.run_chunk = checked
    try:
        feed(builder, first_scans(events, num_scans))
    finally:
        tf.run_chunk = run
    return {"cpu_parity_scans": len(steps), "cpu_parity_inserted": sum(steps),
            "cpu_parity_max_m": worst["m"], "cpu_parity_max_rad": worst["rad"]}


def per_scan_3d_parity(events, options, num_scans=8, device="cuda"):
    """The per-scan 3D builder on `device` over the first `num_scans` scans;
    each scan is also run by a CPU copy of the builder as it stood before
    it. The same result kinds, poses within 1e-3 m and 1e-3 rad."""
    from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
        LocalTrajectoryBuilder3D,
    )

    builder = LocalTrajectoryBuilder3D(options, {"range"}, device=device)
    worst_m = worst_rad = 0.0
    compared = 0
    for kind, _, payload in first_scans(events, num_scans):
        if kind == "imu":
            builder.add_imu_data(payload)
            continue
        twin = builder.to("cpu")
        g = builder.add_range_data("range", payload)
        c = twin.add_range_data("range", payload)
        if (g is None) != (c is None) or (g is not None and (
                g.insertion_result is None) != (c.insertion_result is None)):
            raise AssertionError(f"3D scan {compared}: GPU/CPU results differ in kind")
        if g is None:
            continue
        worst_m = max(worst_m, float(np.max(np.abs(g.local_pose[:3] - c.local_pose[:3]))))
        worst_rad = max(worst_rad, rotation_angle(g.local_pose[3:7], c.local_pose[3:7]))
        compared += 1
    if worst_m > 1e-3 or worst_rad > 1e-3:
        raise AssertionError(
            f"per-scan 3D GPU/CPU poses differ by {worst_m:.2e} m, {worst_rad:.2e} rad")
    return {"cpu_parity_scans": compared, "cpu_parity_max_m": worst_m,
            "cpu_parity_max_rad": worst_rad}


def run_3d_path(make_builder, events, num_scans, true_position, device):
    """Feed `events` to a fresh builder with the launch count and the
    dropped-write counter set to 0: scans/s, real-time ratio at 10 Hz,
    final and max position error, dropped grid writes, kernel launches
    (none: the 3D paths use no 2D kernel)."""
    from cartographer_tpu_torch import metrics
    from cartographer_tpu_torch.kernels import launch_counts, reset_launch_counts

    builder = make_builder()
    collected = metrics.enable_collection()
    try:
        sync(device)
        reset_launch_counts()
        t0 = time.perf_counter()
        results = feed(builder, events)
        sync(device)
        wall = time.perf_counter() - t0
        launches = launch_counts()
        # Dropped writes: counted per chunk by the chunked frontend, and by
        # the per-scan builder's submaps when they finish; the per-scan
        # builder's live paged grids hold the rest.
        dropped = collected.registry()["mapping_grid_out_of_extent_points"].value()
        if hasattr(builder, "_active_submaps"):
            dropped += sum(
                int(getattr(s, name).dropped)
                for s in builder._active_submaps.submaps()
                for name in ("high_resolution_grid", "low_resolution_grid")
                if hasattr(getattr(s, name), "dropped")
            )
    finally:
        metrics.register_family_factory(metrics.FamilyFactory())
    if not results:
        raise AssertionError("no 3D scan was matched")
    require_none(launches, ["correlative_window", *NEW_2D_KERNELS, "spa_2d"], "a 3D path")
    final_err, max_err = position_errors_3d(results, true_position)
    if dropped:
        raise AssertionError(f"{dropped} grid writes dropped on the 3D path")
    return builder, results, {
        "scans": num_scans,
        "matched": len(results),
        "inserted": sum(r.insertion_result is not None for r in results),
        "wall_s": wall,
        "scans_per_s": num_scans / wall,
        "real_time_ratio": num_scans * 0.1 / wall,
        "final_position_error_m": final_err,
        "max_position_error_m": max_err,
        "dropped_writes": dropped,
        "launches": launches,
    }


def local_slam_3d_phase(device, smi):
    """bench.py:_bench_3d's world and options (testing/bench_3d.py)
    through both 3D local builders on `device`: the chunked frontend
    (chunk 16, 120 scans; its first chunk rerun scan by scan on the CPU)
    and the per-scan builder with the default options and the bench's
    grids (100 scans; its first 8 scans rerun by a CPU copy); each with a
    profile over warm scans."""
    from cartographer_tpu_torch.mapping.chunked_frontend_3d import (
        ChunkedLocalTrajectoryBuilder3D,
    )
    from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
        LocalTrajectoryBuilder3D,
    )
    from cartographer_tpu_torch.testing import bench_3d
    from cartographer_tpu_torch.testing.bench_3d import bench_3d_options

    events, num_scans, true_position = bench_3d.bench_3d_world()
    chunk = 16
    t_phase = time.perf_counter()

    def chunked_builder():
        return ChunkedLocalTrajectoryBuilder3D(
            bench_3d_options(), {"range"}, chunk_size=chunk, device=device)

    # 120 of the world's 300 scans: a depth cut for the script's time limit.
    builder, _, chunked = run_3d_path(
        chunked_builder, first_scans(events, 120), 120, true_position, device)
    chunked["chunk"] = chunk
    chunked["pool_blocks_used"] = builder._state.pg_nblocks.tolist()
    t0 = time.perf_counter()
    chunked.update(chunk_3d_parity(events, chunk, device))
    chunked["cpu_parity_s"] = time.perf_counter() - t0
    warm = first_scans(events, chunk)
    t0 = time.perf_counter()
    chunked["profile"] = profiled(
        chunked_builder(), warm, first_scans(events, 2 * chunk)[len(warm):], chunk)
    chunked["profile_s"] = time.perf_counter() - t0

    options = bench_3d_options(per_scan=True)

    def per_scan_builder():
        return LocalTrajectoryBuilder3D(options, {"range"}, device=device)

    _, _, per_scan = run_3d_path(
        per_scan_builder, first_scans(events, 100), 100, true_position, device)
    t0 = time.perf_counter()
    per_scan.update(per_scan_3d_parity(events, options, device=device))
    per_scan["cpu_parity_s"] = time.perf_counter() - t0
    warm = first_scans(events, 10)
    t0 = time.perf_counter()
    per_scan["profile"] = profiled(
        per_scan_builder(), warm, first_scans(events, 20)[len(warm):], 10)
    per_scan["profile_s"] = time.perf_counter() - t0
    r = {
        "phase": "local_slam_3d",
        "world": "bench.py:_bench_3d (300 scans, 1,575 points, 10 Hz, 5 m; IMU 50 Hz)",
        "grids": "256 x 0.10 m, 128 x 0.45 m, 40 range data per submap, paged",
        "chunked": chunked,
        "per_scan": per_scan,
        "phase_s": time.perf_counter() - t_phase,
        "card": smi,
    }
    emit(r)
    return r


# -- backend_3d: MapBuilder's 3D route and the 3D loop-closure drains

# Scans of the local_slam_3d phase's world that the 3D MapBuilder is fed
# (a depth cut from 300, to keep the phase within its time budget).
BACKEND_3D_SCANS = 150


def device_profile(fn, units):
    """Run `fn()` under torch.profiler (device activity only): kernels per
    unit, device busy and idle share over the wall time, the costliest
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {
        "units": units,
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "kernels": len(kernels),
        "kernels_per_unit": len(kernels) / units,
        "top_kernels_ms": [[name[:80], us / 1e3] for name, us in top],
    }


def map_builder_3d_part(device):
    """MapBuilder's 3D route on `device` (testing/bench_3d.backend_3d_options)
    over the first BACKEND_3D_SCANS scans of the local_slam_3d world:
    node error against the truth after the final optimization (limit 0.5
    m, 0.1 x the world's 5 m travel), constraints by tag, searches,
    solves. Returns the line, the pose graph, the recorded solves and,
    for the persist phase, the map builder with its serialized state
    (timed) and the world's events."""
    from cartographer_tpu_torch import metrics
    from cartographer_tpu_torch.kernels import launch_counts, reset_launch_counts
    from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
    from cartographer_tpu_torch.mapping.map_builder import MapBuilder
    from cartographer_tpu_torch.mapping.pose_graph_3d import PoseGraph3D
    from cartographer_tpu_torch.ops import spa_solver_3d
    from cartographer_tpu_torch.testing import bench_3d

    events, num_scans, true_position = bench_3d.bench_3d_world(BACKEND_3D_SCANS)
    mb_options, traj_options = bench_3d.backend_3d_options()
    solve = spa_solver_3d.solve_3d
    solves = []

    def recorded_solve(problem, **kw):
        out = solve(problem, **kw)
        solves.append(dict(problem=problem, kw=kw, out=out))
        return out

    collected = metrics.enable_collection()
    spa_solver_3d.solve_3d = recorded_solve
    try:
        mb = MapBuilder(mb_options, device=device)
        pg = mb.pose_graph
        if not isinstance(pg, PoseGraph3D):
            raise AssertionError("MapBuilder's 3D route did not build a PoseGraph3D")
        drains = []
        cb = pg._constraint_builder
        run_pending = cb.run_pending

        def recorded_run_pending():
            out = run_pending()
            if cb.last_drain_timings:
                drains.append(dict(cb.last_drain_timings))
            return out

        cb.run_pending = recorded_run_pending
        tid = mb.add_trajectory_builder({"range", "imu"}, traj_options)
        builder = mb.get_trajectory_builder(tid)
        sync(device)
        reset_launch_counts()
        t0 = time.perf_counter()
        for kind, _, payload in events:
            builder.add_sensor_data(kind, payload)
        sync(device)
        feed_s = time.perf_counter() - t0
        solves_in_feed = len(pg.solve_seconds)
        t0 = time.perf_counter()
        mb.finish_trajectory(tid)
        sync(device)
        catch_up_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pg.run_final_optimization()
        sync(device)
        final_s = time.perf_counter() - t0
        launches = launch_counts()
        mb.shutdown()
        t0 = time.perf_counter()
        state = mb.serialize_state()
        serialize_s = time.perf_counter() - t0
    finally:
        spa_solver_3d.solve_3d = solve
        metrics.register_family_factory(metrics.FamilyFactory())
    registry = collected.registry()
    searched = int(registry["mapping_constraint_builder_constraints_searched"].value())
    nodes = list(pg.get_trajectory_nodes().items(NodeId))
    poses = np.array([n.global_pose for _, n in nodes])
    if not nodes or not np.all(np.isfinite(poses)):
        raise AssertionError("no or non-finite 3D node poses")
    errs = [float(np.linalg.norm(n.global_pose[:3] - true_position(n.constant_data.time)))
            for _, n in nodes]
    if max(errs) > 0.5:
        raise AssertionError(f"3D max node error {max(errs):.3f} m > 0.5 m")
    tags = {}
    for c in pg.constraints:
        tags[c.tag] = tags.get(c.tag, 0) + 1
    if not tags.get("INTRA_SUBMAP"):
        raise AssertionError("no INTRA_SUBMAP constraint")
    if searched < 1:
        raise AssertionError("the 3D constraint builder ran no loop-closure search")
    if len(pg.solve_seconds) < 3:
        raise AssertionError(f"only {len(pg.solve_seconds)} SPA solves")
    require_none(launches, ["correlative_window", *NEW_2D_KERNELS, "spa_2d"], "the 3D backend")
    line = {
        "scans": num_scans,
        "nodes": len(nodes),
        "submaps": len(list(pg.get_all_submap_data().items(SubmapId))),
        "constraints": tags,
        "searches": searched,
        "search_backend": mb_options.pose_graph.constraint_builder.loop_closure_backend,
        "drains": [{k: d[k] for k in ("searches", "matches", "search_s", "refine_wait_s", "total_s")}
                   for d in drains],
        "solves": len(pg.solve_seconds),
        "solves_done_by_feed_end": solves_in_feed,
        "solve_seconds": pg.solve_seconds,
        "feed_s": feed_s,
        "feed_scans_per_s": num_scans / feed_s,
        "catch_up_s": catch_up_s,
        "final_optimization_s": final_s,
        "max_node_error_m": max(errs),
        "final_node_error_m": errs[-1],
        "launches": launches,
    }
    saved = dict(map_builder=mb, state=state, serialize_s=serialize_s, events=events)
    return line, pg, solves, saved


def drain_query(pg):
    """bench.py:_bench_bnb3's search: the first finished submap of the run
    and a node inserted into it, from its true relative pose perturbed by
    (0.8, -0.5, 0.15) m and 0.06 rad of yaw."""
    from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
    from cartographer_tpu_torch.mapping.pose_graph_2d import SubmapState
    from cartographer_tpu_torch.transform import rigid3

    for _, data in pg.get_all_submap_data().items(SubmapId):
        if data.state == SubmapState.FINISHED:
            break
    else:
        raise AssertionError("no finished 3D submap")
    node_ids = sorted(data.node_ids, key=lambda n: n.node_index)
    node = pg.get_trajectory_nodes().at(node_ids[len(node_ids) // 2]).constant_data
    rel = rigid3.relative(np.asarray(data.submap.local_pose), np.asarray(node.local_pose))
    perturb = rigid3.make(
        np.array([0.8, -0.5, 0.15]),
        rigid3.quat_from_angle_axis(np.array([0.0, 0.0, 0.06])),
    )
    return data.submap, node, rigid3.compose(rel, perturb)


def drain_builder(backend, device, submap, node, initial, n_nodes, n_submaps, cb=None):
    """A ConstraintBuilder3D on `device` with bench.py's drain options (or
    `cb` again) and n_nodes x n_submaps pending searches of `node` against
    `submap`."""
    from cartographer_tpu_torch.mapping.constraint_builder_3d import ConstraintBuilder3D
    from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
    from cartographer_tpu_torch.testing.bench_3d import bnb3_drain_options

    if cb is None:
        cb = ConstraintBuilder3D(bnb3_drain_options(backend), device=device)
    for s in range(n_submaps):
        for k in range(n_nodes):
            cb.maybe_add_constraint(SubmapId(0, s), submap, NodeId(0, k), node, initial, 0.0)
    return cb


def timed_drains(backend, device, query, n_nodes, n_submaps):
    """bench.py's drain timing: a warm drain (pyramids, caches), then the
    best of two drains of the same builder."""
    batch = n_nodes * n_submaps
    cb = drain_builder(backend, device, *query, n_nodes, n_submaps)
    found = cb.run_pending()
    best = None
    for _ in range(2):
        drain_builder(backend, device, *query, n_nodes, n_submaps, cb=cb)
        sync(device)
        t0 = time.perf_counter()
        found = cb.run_pending()
        sync(device)
        dt = time.perf_counter() - t0
        if best is None or dt < best[0]:
            best = (dt, dict(cb.last_drain_timings))
    dt, timings = best
    return {
        "shape": f"{n_nodes} nodes x {n_submaps} submaps",
        "matches_per_s": batch / dt,
        "drain_s": dt,
        "search_s": timings["search_s"],
        "refine_wait_s": timings["refine_wait_s"],
        "constraints_found": len(found),
    }, cb


def exact_tie(cb, search, pose_a, pose_b) -> bool:
    """True if two best poses of one search are candidates (a, x, y, z)
    of equal full-resolution score that both pass the low-resolution
    veto, as the device search scores them: the best score is not unique,
    and the native DFS and the device beam each keep the first they meet.
    Raises otherwise."""
    from cartographer_tpu_torch.ops.scan_matching import fast_correlative_3d as fc3
    from cartographer_tpu_torch.transform import rigid3

    cd = search.constant_data
    matcher = cb._matcher(search.submap_id)
    prep = matcher._prepare(
        search.global_node_pose, cd.rotational_scan_matcher_histogram,
        search.gravity_yaw, cd.high_resolution_point_cloud,
        cd.low_resolution_point_cloud, cb._options.min_score,
    )
    initial = prep["ctx"][2]

    def candidate(pose):
        xyz = np.round((pose[:3] - initial[:3]) / matcher._resolution).astype(int)
        qa = rigid3.quat_multiply(pose[3:7], rigid3.quat_conjugate(rigid3.quat(initial)))
        yaw = 2.0 * np.arctan2(qa[3], qa[0])
        return (int(np.argmin(np.abs(prep["angles_kept"] - yaw))), *xyz.tolist())

    scores, lows = fc3.candidate_scores(prep, [candidate(pose_a), candidate(pose_b)])
    min_low = matcher._options.min_low_resolution_score
    if scores[0] != scores[1] or min(lows) < min_low:
        raise AssertionError(
            f"3D searches disagree: scores {scores.tolist()}, low scores {lows.tolist()}")
    return True


def moved_submap(submap, device):
    """A copy of a finished Submap3D with its grids on `device`."""
    import dataclasses

    return dataclasses.replace(submap, **{
        name: dataclasses.replace(
            getattr(submap, name),
            values=getattr(submap, name).values.to(device),
            origin=getattr(submap, name).origin.to(device),
        )
        for name in ("high_resolution_grid", "low_resolution_grid")
    })


def drains_3d_part(pg, device):
    """Drains at bench.py:_bench_bnb3's shapes on a submap this run's 3D
    frontend finished: native 16 x 8 and 64 x 8, device 2 x 8 (matches/s,
    search_s, refine_wait_s); device against native on the same 16
    searches (the same candidate, scores within 1e-6); one device drain on
    the card against the same drain on the CPU (refined poses within 1e-4
    m / rad); a profile of one drain of each backend."""
    query = drain_query(pg)
    line, warm = {}, {}
    for backend, n_nodes in (("native", 16), ("native", 64), ("device", 2)):
        line[f"{backend}_{n_nodes}x8"], warm[backend] = timed_drains(
            backend, device, query, n_nodes, 8)
    native = drain_builder("native", device, *query, 2, 8)
    card = drain_builder("device", device, *query, 2, 8)
    pending = list(card._pending)
    by_native = native._run_searches_native(list(native._pending))
    by_device = card._run_searches_device(pending)
    score_err = 0.0
    found = same = ties = 0
    for s, (_, n), (_, d) in zip(pending, by_native, by_device):
        if (n is None) != (d is None):
            raise AssertionError("native and device 3D searches found different sets")
        if n is None:
            continue
        found += 1
        score_err = max(score_err, abs(n.score - d.score), abs(
            n.low_resolution_score - d.low_resolution_score))
        # One cell is 0.1 m and one angular step about 0.01 rad: a pose
        # within 1e-6 is the same candidate (a, x, y, z).
        if float(np.max(np.abs(n.pose - d.pose))) <= 1e-6:
            same += 1
            continue
        ties += exact_tie(card, s, n.pose, d.pose)
    if not found or score_err > 1e-6 or same + ties != found:
        raise AssertionError(
            f"native vs device 3D search: {found} found, {same} the same candidate, "
            f"{ties} exact ties, scores differ by {score_err:.2e}")
    line["device_vs_native"] = {"searches": len(pending), "found": found,
                                "same_candidate": same, "exact_ties": ties,
                                "max_score_err": score_err}

    submap, node, initial = query
    card = drain_builder("device", device, submap, node, initial, 2, 1)
    cpu = drain_builder("device", "cpu", moved_submap(submap, "cpu"), node, initial, 2, 1)
    card_z = {c.node_id: c.pose.zbar_ij for c in card.run_pending()}
    t0 = time.perf_counter()
    cpu_z = {c.node_id: c.pose.zbar_ij for c in cpu.run_pending()}
    cpu_s = time.perf_counter() - t0
    if not card_z or set(card_z) != set(cpu_z):
        raise AssertionError("card and CPU 3D drains found different constraints")
    worst_m = max(float(np.max(np.abs(card_z[k][:3] - cpu_z[k][:3]))) for k in card_z)
    worst_rad = max(rotation_angle(card_z[k][3:7], cpu_z[k][3:7]) for k in card_z)
    if worst_m > 1e-4 or worst_rad > 1e-4:
        raise AssertionError(
            f"card/CPU 3D drain poses differ by {worst_m:.2e} m, {worst_rad:.2e} rad")
    line["card_vs_cpu_drain"] = {"searches": 2, "found": len(card_z), "cpu_s": cpu_s,
                                 "max_m": worst_m, "max_rad": worst_rad}
    for backend, n_nodes in (("native", 16), ("device", 2)):
        cb = drain_builder(backend, device, *query, n_nodes, 8, cb=warm[backend])
        line[f"profile_{backend}_{n_nodes}x8"] = device_profile(cb.run_pending, 1)
    return line


def spa_3d_re_solve(call):
    """Re-solve one recorded SPA 3D call on the CPU: (largest translation
    difference m, largest rotation difference rad, CPU seconds, the card's
    and the CPU's outputs as numpy)."""
    from cartographer_tpu_torch.ops import spa_solver_3d

    def to_cpu(tables):
        return None if tables is None else type(tables)(*[t.cpu() for t in tables])

    t0 = time.perf_counter()
    got = spa_solver_3d.solve_3d(
        to_cpu(call["problem"]),
        **{**call["kw"], "extras": to_cpu(call["kw"].get("extras"))},
    )
    cpu_s = time.perf_counter() - t0
    card = [t.cpu().numpy() for t in call["out"]]
    got = [t.numpy() for t in got]
    worst_m = max(float(np.max(np.abs(card[i] - got[i]), initial=0.0)) for i in (0, 2))
    worst_rad = max(
        (rotation_angle(a, b) for i in (1, 3) for a, b in zip(card[i], got[i])),
        default=0.0,
    )
    return worst_m, worst_rad, cpu_s, card, got


def spa_3d_part(solves):
    """The run's first SPA 3D problem (before loop closures: it converges
    to one point) re-solved on the CPU, poses within 1e-4 m / rad of the
    card's solve. The final optimization's problem is re-solved on the CPU
    and again on the card as a record: once loop closures pull against
    local SLAM its termination (relative cost change 1e-7, as in JAX)
    moves with rounding noise, so card and CPU differ there by up to a few
    1e-4 m and so do two card solves. The final solve runs once more under
    the profiler."""
    import torch

    from cartographer_tpu_torch.ops import spa_solver_3d

    first_m, first_rad, first_cpu_s, _, _ = spa_3d_re_solve(solves[0])
    if first_m > 1e-4 or first_rad > 1e-4:
        raise AssertionError(
            f"SPA 3D card/CPU poses differ by {first_m:.2e} m, {first_rad:.2e} rad")
    call = solves[-1]
    final_m, final_rad, final_cpu_s, card, got = spa_3d_re_solve(call)
    again = []
    profile = device_profile(
        lambda: again.extend(spa_solver_3d.solve_3d(call["problem"], **call["kw"])), 1)
    repeat_m = max(float(np.max(np.abs(card[i] - again[i].cpu().numpy()), initial=0.0))
                   for i in (0, 2))
    first, problem = solves[0]["problem"], call["problem"]
    return {
        "held": {
            "nodes": int(first.node_t.shape[0]),
            "constraints": int(torch.sum(first.c_mask).item()),
            "cpu_s": first_cpu_s, "cpu_max_m": first_m, "cpu_max_rad": first_rad,
        },
        "final": {
            "nodes": int(problem.node_t.shape[0]),
            "submaps": int(problem.submap_t.shape[0]),
            "constraints": int(torch.sum(problem.c_mask).item()),
            "imu_rows": int(torch.sum(problem.r_mask).item() + torch.sum(problem.a_mask).item()),
            "cpu_s": final_cpu_s, "cpu_max_m": final_m, "cpu_max_rad": final_rad,
            "card_repeat_max_m": repeat_m,
            "cost_card": float(card[-1]), "cost_cpu": float(got[-1]),
            "profile": profile,
        },
    }


def backend_3d_phase(device, smi):
    """MapBuilder's 3D route end to end on `device`, then the 3D
    loop-closure drains at bench.py's shapes and one SPA 3D solve against
    the CPU."""
    t_phase = time.perf_counter()
    line, pg, solves, saved = map_builder_3d_part(device)
    t0 = time.perf_counter()
    drains = drains_3d_part(pg, device)
    drains["part_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spa = spa_3d_part(solves)
    spa["part_s"] = time.perf_counter() - t0
    r = {
        "phase": "backend_3d",
        "world": f"local_slam_3d's world, first {BACKEND_3D_SCANS} of 300 scans",
        "state_mb": len(saved["state"]) / 1e6,
        "serialize_s": saved["serialize_s"],
        "options": "default PoseGraphOptions (BnB depth 8, 5 m / 1 m / 15 deg, native "
                   "search), async, optimize_every_n_nodes 15; per-scan builder, bench "
                   "grids, 20 range data per submap, motion filter 0.2 s / 0.05 m / 0.1 rad",
        "map_builder": line,
        "drains": drains,
        "spa": spa,
        "phase_s": time.perf_counter() - t_phase,
        "card": smi,
    }
    emit(r)
    return r, saved


# -- persist: saved maps, pure localization, the IMU-based extrapolator,
# the native host kernels

# The localization trajectory: the first scans of BACKEND_WORLD again,
# LOCALIZATION_SHIFT seconds later (tests/test_serialization.py's
# pure-localization scenario).
LOCALIZATION_SCANS = 150
LOCALIZATION_SHIFT = 100.0
# Scans of the local_slam_3d world through the IMU-based 3D builder, and
# how many of them a CPU copy reruns.
IMU_BASED_SCANS = 40
IMU_BASED_PARITY_SCANS = 4


def state_records(state):
    """The decompressed records of a serialized state (the container's
    gzip headers hold the time of writing, the records do not)."""
    import io

    from cartographer_tpu_torch.io.proto_stream import ProtoStreamReader

    return list(ProtoStreamReader(io.BytesIO(state)))


def compare_reloaded_records(original, reloaded):
    """A frozen load re-serialized against the state it loaded: every
    record equal, except that the pose graph's trajectory states read
    FROZEN and every submap's search state FINISHED."""
    from cartographer_tpu_torch.io.serialization import _decode_record

    a, b = state_records(original), state_records(reloaded)
    if len(a) != len(b):
        raise AssertionError(f"{len(b)} records re-serialized from {len(a)}")
    changed = {}
    for ra, rb in zip(a, b):
        if ra == rb:
            continue
        (ka, ma, xa), (kb, mb, xb) = _decode_record(ra), _decode_record(rb)
        if ka != kb or xa.keys() != xb.keys() or any(
                xa[k].dtype != xb[k].dtype or not np.array_equal(xa[k], xb[k]) for k in xa):
            raise AssertionError(f"a re-serialized {ka} record differs in its arrays")
        if ka == "pose_graph":
            if set(mb.pop("trajectory_states").values()) != {"FROZEN"}:
                raise AssertionError("the loaded trajectories are not frozen")
            ma.pop("trajectory_states")
        elif ka.startswith("submap"):
            if mb.pop("state") != "FINISHED":
                raise AssertionError("a frozen submap is open to search")
            ma.pop("state")
        if ma != mb:
            raise AssertionError(f"a re-serialized {ka} record differs: {ma} / {mb}")
        changed[ka] = changed.get(ka, 0) + 1
    return {"records": len(a), "records_equal": len(a) - sum(changed.values()),
            "records_changed_by_freezing": changed}


def load_checked(options, state, device, original_pg, grids_equal):
    """Load `state` frozen into a fresh MapBuilder on `device` (timed) and
    hold it against the pose graph it was saved from: trajectory 0
    frozen, node poses within 1e-6, every submap's grids on `device` and
    equal (`grids_equal(original submap, loaded submap)`), the same
    constraints."""
    import torch

    from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
    from cartographer_tpu_torch.mapping.map_builder import MapBuilder

    mb = MapBuilder(options, device=device)
    sync(device)
    t0 = time.perf_counter()
    remap = mb.load_state(state, load_frozen_state=True)
    sync(device)
    load_s = time.perf_counter() - t0
    pg = mb.pose_graph
    if remap != {0: 0} or not pg.is_trajectory_frozen(0):
        raise AssertionError(f"loaded remap {remap}, frozen {pg.is_trajectory_frozen(0)}")
    nodes = pg.get_trajectory_nodes()
    worst = 0.0
    for node_id, node in original_pg.get_trajectory_nodes().items(NodeId):
        worst = max(worst, float(np.max(np.abs(
            nodes.at(node_id).global_pose - node.global_pose))))
    if nodes.size() != original_pg.get_trajectory_nodes().size() or worst > 1e-6:
        raise AssertionError(f"loaded node poses differ by {worst:.2e}")
    submaps = pg.get_all_submap_data()
    for submap_id, data in original_pg.get_all_submap_data().items(SubmapId):
        loaded = submaps.at(submap_id).submap
        grids = [getattr(loaded, n) for n in ("grid", "high_resolution_grid",
                                               "low_resolution_grid") if hasattr(loaded, n)]
        devices = {t.device.type for g in grids for t in vars(g).values()
                   if isinstance(t, torch.Tensor)}
        if devices != {torch.device(device).type}:
            raise AssertionError(f"submap {submap_id}: loaded grids on {devices}")
        if not grids_equal(data.submap, loaded):
            raise AssertionError(f"submap {submap_id}: loaded grids differ")
    if [(c.submap_id, c.node_id, c.tag) for c in pg.constraints] != [
            (c.submap_id, c.node_id, c.tag) for c in original_pg.constraints]:
        raise AssertionError("loaded constraints differ")
    return mb, load_s


def tensors_equal(a, b) -> bool:
    """Equal bit for bit, wherever each lies."""
    import torch

    return torch.equal(a.cpu(), b.cpu())


def grids_2d_equal(original, loaded) -> bool:
    a, b = original.grid, loaded.grid
    return all(tensors_equal(getattr(a, k), getattr(b, k))
               for k in ("log_odds", "known", "origin"))


def grids_3d_equal(original, loaded) -> bool:
    """The loaded dense grids equal the originals through to_dense."""
    from cartographer_tpu_torch.mapping.paged_grid_3d import as_dense

    for name in ("high_resolution_grid", "low_resolution_grid"):
        a, b = as_dense(getattr(original, name)), getattr(loaded, name)
        if not (tensors_equal(a.values, b.values) and tensors_equal(a.origin, b.origin)):
            return False
    return np.array_equal(original.rotational_scan_matcher_histogram,
                          loaded.rotational_scan_matcher_histogram)


def persist_2d_part(saved, device):
    """The backend phase's map: its state loaded frozen on `device` and
    on the CPU, each held against the map it was saved from; the card
    load re-serialized record by record against the state and the CPU
    load's records."""
    mb_options, _ = backend_options()
    state, original = saved["state"], saved["map_builder"].pose_graph
    loaded, load_s = load_checked(mb_options, state, device, original, grids_2d_equal)
    t0 = time.perf_counter()
    again = loaded.serialize_state()
    reserialize_s = time.perf_counter() - t0
    records = compare_reloaded_records(state, again)
    cpu, cpu_load_s = load_checked(mb_options, state, "cpu", original, grids_2d_equal)
    if state_records(cpu.serialize_state()) != state_records(again):
        raise AssertionError("the CPU load re-serializes to other records than the card's")
    return loaded, {
        "state_mb": len(state) / 1e6,
        "serialize_s": saved["serialize_s"],
        "load_s": load_s,
        "reserialize_s": reserialize_s,
        "cpu_load_s": cpu_load_s,
        "cpu_load_records_equal": True,
        **records,
    }


def localization_part(loaded, saved, device):
    """A new trajectory in the loaded frozen map: the backend phase's
    frontend (chunked, online correlative matching) with the
    pure-localization trimmer keeping 3 submaps, started at the frozen
    trajectory's origin and fed the world's first LOCALIZATION_SCANS
    scans again, LOCALIZATION_SHIFT seconds later; then the final
    optimization. Node error against the truth in the frozen map's frame
    (limit 0.3 m from node STARTUP_NODES), INTER constraints to the frozen
    trajectory, submaps kept, kernel launches. Also returns the inputs
    of the path's first window-sum call."""
    import copy

    from cartographer_tpu_torch.common.config import PureLocalizationTrimmerOptions
    from cartographer_tpu_torch.kernels import launch_counts, reset_launch_counts
    from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
    from cartographer_tpu_torch.testing.synthetic import FAKE_START_TIME
    from cartographer_tpu_torch.transform import rigid3

    _, traj_options = backend_options()
    options = copy.deepcopy(traj_options)
    options.pure_localization_trimmer = PureLocalizationTrimmerOptions(max_submaps_to_keep=3)
    time_step = BACKEND_WORLD["time_step"]
    true_poses = saved["true_poses"]
    pg = loaded.pose_graph
    tid = loaded.add_trajectory_builder({"range"}, options)
    pg.set_initial_trajectory_pose(
        tid, 0, rigid3.identity(), FAKE_START_TIME + LOCALIZATION_SHIFT)
    builder = loaded.get_trajectory_builder(tid)
    measurements = copy.deepcopy(saved["measurements"][:LOCALIZATION_SCANS])
    for m in measurements:
        m.time += LOCALIZATION_SHIFT
    with window_sums_inputs(0) as kept:
        sync(device)
        reset_launch_counts()
        t0 = time.perf_counter()
        for m in measurements:
            builder.add_sensor_data("range", m)
        sync(device)
        feed_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded.finish_trajectory(tid)
        pg.run_final_optimization()
        sync(device)
        catch_up_s = time.perf_counter() - t0
        launches = launch_counts()
    loaded.shutdown()

    def index(node):
        t = node.constant_data.time - FAKE_START_TIME
        return int(round((t - (LOCALIZATION_SHIFT if t >= LOCALIZATION_SHIFT else 0.0)) / time_step))

    nodes = pg.get_trajectory_nodes()
    frozen = [n for nid, n in nodes.items(NodeId) if nid.trajectory_id == 0]
    new = [n for nid, n in nodes.items(NodeId) if nid.trajectory_id == tid]
    if len(new) <= 2 * STARTUP_NODES:
        raise AssertionError(f"only {len(new)} localization nodes")
    # The truth in the frozen map's frame, anchored at the frozen
    # trajectory's node STARTUP_NODES (past the startup transient).
    anchor = frozen[STARTUP_NODES]
    map_from_truth = rigid3.compose(
        anchor.global_pose, rigid3.inverse(true_poses[index(anchor)]))
    errs = np.array([
        np.linalg.norm(n.global_pose[:2] - rigid3.compose(
            map_from_truth, true_poses[index(n)])[:2]) for n in new])
    if not np.all(np.isfinite(errs)):
        raise AssertionError("non-finite localization pose")
    if errs[STARTUP_NODES:].max() > 0.3:
        raise AssertionError(
            f"localization node error {errs[STARTUP_NODES:].max():.3f} m > 0.3 m")
    inter = [c for c in pg.constraints if c.tag == "INTER_SUBMAP"
             and c.node_id.trajectory_id == tid and c.submap_id.trajectory_id == 0]
    if not inter:
        raise AssertionError("no INTER_SUBMAP constraint from the new trajectory to the map")
    kept_submaps = [sid for sid, _ in pg.get_all_submap_data().items(SubmapId)
                    if sid.trajectory_id == tid]
    if len(kept_submaps) > 3:
        raise AssertionError(f"{len(kept_submaps)} localization submaps kept, the trimmer keeps 3")
    for name in ("correlative_window", "lm_match_2d", "supercover_dense_2d"):
        require_launches(launches, name, len(new), "localization nodes")
    return {
        "scans": LOCALIZATION_SCANS,
        "nodes": len(new),
        "inter_constraints_to_map": len(inter),
        "submaps_kept": len(kept_submaps),
        "submaps_created": max(sid.submap_index for sid in kept_submaps) + 1,
        "feed_s": feed_s,
        "scans_per_s": LOCALIZATION_SCANS / feed_s,
        "real_time_ratio": LOCALIZATION_SCANS * time_step / feed_s,
        "catch_up_s": catch_up_s,
        "max_node_error_m": float(errs[STARTUP_NODES:].max()),
        "max_node_error_all_nodes_m": float(errs.max()),
        "launches": launches,
    }, kept[0][0]


def persist_3d_part(saved, device):
    """The backend_3d phase's map: its state loaded frozen on `device` and
    on the CPU, each held against the map it was saved from (poses within
    1e-6, dense grids equal to to_dense of the originals); the CPU load
    re-serializes to the card load's records."""
    from cartographer_tpu_torch.testing import bench_3d

    mb_options, _ = bench_3d.backend_3d_options()
    state, original = saved["state"], saved["map_builder"].pose_graph
    loaded, load_s = load_checked(mb_options, state, device, original, grids_3d_equal)
    cpu, cpu_load_s = load_checked(mb_options, state, "cpu", original, grids_3d_equal)
    t0 = time.perf_counter()
    again = loaded.serialize_state()
    reserialize_s = time.perf_counter() - t0
    records = compare_reloaded_records(state, again)
    if state_records(cpu.serialize_state()) != state_records(again):
        raise AssertionError("the CPU 3D load re-serializes to other records than the card's")
    return loaded, {
        "state_mb": len(state) / 1e6,
        "serialize_s": saved["serialize_s"],
        "load_s": load_s,
        "reserialize_s": reserialize_s,
        "cpu_load_s": cpu_load_s,
        **records,
    }


def imu_based_part(device):
    """LocalTrajectoryBuilder3D with the IMU-based extrapolator (its window
    solved by SPA 3D on `device`) over the first IMU_BASED_SCANS scans of
    the local_slam_3d world, the per-scan defaults with the bench's grids:
    scans/s, error against the truth (limit 0.5 m), the first
    IMU_BASED_PARITY_SCANS scans rerun by a CPU copy, and the kernels of
    one extrapolator solve."""
    from cartographer_tpu_torch.mapping.imu_based_pose_extrapolator import (
        ImuBasedPoseExtrapolator,
    )
    from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
        LocalTrajectoryBuilder3D,
    )
    from cartographer_tpu_torch.testing import bench_3d

    events, num_scans, true_position = bench_3d.bench_3d_world(IMU_BASED_SCANS)
    options = bench_3d.bench_3d_options(per_scan=True)
    options.pose_extrapolator.use_imu_based = True
    builder, results, line = run_3d_path(
        lambda: LocalTrajectoryBuilder3D(options, {"range"}, device=device),
        events, num_scans, true_position, device)
    extrapolator = builder._extrapolator
    if not isinstance(extrapolator, ImuBasedPoseExtrapolator) or (
            extrapolator.device != builder._device):
        raise AssertionError("the 3D builder did not solve with the IMU-based extrapolator")
    line.update(per_scan_3d_parity(events, options, IMU_BASED_PARITY_SCANS, device))
    query = results[-1].time + 0.1
    line["solve_profile"] = device_profile(
        lambda: extrapolator.extrapolate_poses_with_gravity([query]), 1)
    return line


def host_us(fn, min_s: float = 0.2) -> float:
    """Microseconds per call of a host function (repeated for at least
    `min_s` seconds after one warm call)."""
    fn()
    calls, t0 = 0, time.perf_counter()
    while True:
        fn()
        calls += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= min_s:
            return elapsed / calls * 1e6


def native_host_part(saved_2d, saved_3d):
    """The native host kernels (csrc/native.cc) against the numpy paths on
    this host, on the phases' clouds: the voxel filter on a 1024-beam 2D
    scan and on a 1,575-point 3D scan (the masks equal), the rotational
    histogram on a 3D node's gravity-aligned cloud (within 1e-5 of the
    numpy walk, tests/test_native.py's tolerance)."""
    from cartographer_tpu_torch import native
    from cartographer_tpu_torch.mapping.id import NodeId
    from cartographer_tpu_torch.ops.scan_matching import rotational_histogram as rh
    from cartographer_tpu_torch.sensor import voxel_filter as vf
    from cartographer_tpu_torch.testing import bench_3d
    from cartographer_tpu_torch.transform import rigid3

    def numpy_mask(points, resolution):
        keys = vf._voxel_keys(points, resolution)
        mask = np.zeros(len(points), bool)
        mask[np.unique(keys, return_index=True)[1]] = True
        return mask

    _, traj_2d = backend_options()
    scan_2d = np.asarray(saved_2d["measurements"][0].ranges.points, np.float32)
    scan_3d = next(p for k, _, p in saved_3d["events"] if k == "range")
    scan_3d = np.asarray(scan_3d.ranges.points, np.float32)
    node = next(iter(saved_3d["map_builder"].pose_graph.get_trajectory_nodes().items(NodeId)))[1]
    cloud = rigid3.quat_rotate(
        np.asarray(node.constant_data.gravity_alignment)[None, :],
        np.asarray(node.constant_data.high_resolution_point_cloud, np.float64))
    out = {}
    for name, points, resolution in (
            ("voxel_filter_2d", scan_2d, traj_2d.trajectory_builder_2d.voxel_filter_size),
            # The 3D builder's pre-filter: half its voxel filter size.
            ("voxel_filter_3d", scan_3d,
             0.5 * bench_3d.bench_3d_options(per_scan=True).voxel_filter_size)):
        mask = native.voxel_filter_indices(points, resolution)
        if not np.array_equal(mask, numpy_mask(points, resolution)):
            raise AssertionError(f"{name}: native and numpy masks differ")
        out[name] = {
            "points": len(points), "kept": int(mask.sum()), "resolution": resolution,
            "native_us": host_us(lambda: native.voxel_filter_indices(points, resolution)),
            "numpy_us": host_us(lambda: numpy_mask(points, resolution)),
        }
    size = 120
    hist = native.rotational_histogram(cloud, size)
    oracle = rh.compute_histogram_numpy(cloud, size)
    diff = float(np.max(np.abs(hist - oracle)))
    if diff > 1e-5 or not np.any(hist):
        raise AssertionError(f"rotational histogram: native and numpy differ by {diff:.2e}")
    out["rotational_histogram"] = {
        "points": len(cloud), "size": size, "max_abs_diff": diff,
        "native_us": host_us(lambda: native.rotational_histogram(cloud, size)),
        "numpy_us": host_us(lambda: rh.compute_histogram_numpy(cloud, size), min_s=1.0),
    }
    for line in out.values():
        line["speedup"] = line["numpy_us"] / line["native_us"]
    return out


def persist_phase(device, smi, saved_2d, saved_3d):
    """Saved maps on `device`: the backend phases' maps saved, loaded and
    re-serialized (2D and 3D, each also loaded on the CPU), pure
    localization in the loaded 2D map, the IMU-based 3D builder, and the
    native host kernels against numpy. Also returns the inputs of the
    localization path's first window-sum call."""
    t_phase = time.perf_counter()
    loaded, persist_2d = persist_2d_part(saved_2d, device)
    t0 = time.perf_counter()
    localization, localization_args = localization_part(loaded, saved_2d, device)
    localization["part_s"] = time.perf_counter() - t0
    _, persist_3d = persist_3d_part(saved_3d, device)
    t0 = time.perf_counter()
    imu_based = imu_based_part(device)
    imu_based["part_s"] = time.perf_counter() - t0
    native_host = native_host_part(saved_2d, saved_3d)
    r = {
        "phase": "persist",
        "save_load_2d": persist_2d,
        "localization": localization,
        "save_load_3d": persist_3d,
        "imu_based_3d": imu_based,
        "native_host": native_host,
        "phase_s": time.perf_counter() - t_phase,
        "card": smi,
    }
    emit(r)
    return r, localization_args


# -- cloud: the SLAM server over gRPC, the uplink, the server main

# Scans of the sensors phase's world streamed to the server; the uplink's
# three legs (upstream up, down, up again); scans sent to the server main.
CLOUD_SCANS = 200
UPLINK_LEGS = (30, 20, 30)
SERVER_MAIN_SCANS = 40


def grpc_transport():
    """The transport the cloud phase drives: gRPC where it imports, and
    the version it reports."""
    import grpc
    import google.protobuf

    return {"transport": "grpc", "grpc": grpc.__version__,
            "protobuf": google.protobuf.__version__}


def stream_events(stub_builder, events) -> None:
    """Write (kind, time, payload) events through the stub's per-sensor
    streams, unpaced."""
    for kind, _, payload in events:
        stub_builder.add_sensor_data(kind, payload)


def cloud_server_part(events, true_poses, device):
    """A MapBuilderServer on `device` (backend_options' asynchronous pose
    graph, Prometheus on a free port) driven through a MapBuilderStub on
    localhost: a {range, imu, odometry} trajectory with the sensors
    phase's per-scan options, both subscriptions, the first CLOUD_SCANS
    scans streamed unpaced, then FinishTrajectory and RunFinalOptimization
    over the wire. Checks the wire against the server's own state. Also
    returns the inputs of the path's first window-sum call."""
    import urllib.request

    from cartographer_tpu_torch.cloud.map_builder_server import MapBuilderServer
    from cartographer_tpu_torch.cloud.map_builder_stub import MapBuilderStub
    from cartographer_tpu_torch.common.config import TrajectoryBuilderOptions
    from cartographer_tpu_torch.kernels import launch_counts, reset_launch_counts
    from cartographer_tpu_torch.mapping.grid_2d import compute_cropped
    from cartographer_tpu_torch.mapping.id import NodeId, SubmapId

    time_step = SLICE_WORLD["time_step"]
    mb_options, _ = backend_options()
    server = MapBuilderServer(mb_options, monitoring_port=0, device=device)
    server.start()
    stub = MapBuilderStub(f"localhost:{server.port}")
    local_results, optimizations, last_result = [], [], [0.0]

    def on_local_result(tid, t, pose):
        local_results.append((tid, t, pose))
        last_result[0] = time.perf_counter()

    try:
        subscriptions = [
            stub.receive_local_slam_results(on_local_result),
            stub.receive_global_slam_optimizations(
                lambda submaps, nodes: optimizations.append((submaps, nodes))),
        ]
        options = TrajectoryBuilderOptions(trajectory_builder_2d=sensor_options())
        tid = stub.add_trajectory_builder({"range", "imu", "odometry"}, options)
        head = first_scans(events, CLOUD_SCANS)
        with window_sums_inputs(0) as kept:
            sync(device)
            reset_launch_counts()
            t_first_write = time.perf_counter()
            stream_events(stub.get_trajectory_builder(tid), head)
            t0 = time.perf_counter()
            stub.finish_trajectory(tid)
            finish_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            stub.pose_graph.run_final_optimization()
            final_optimization_s = time.perf_counter() - t0
            sync(device)
            launches = launch_counts()
        for name in ("correlative_window", "lm_match_2d", "supercover_scatter_2d"):
            require_launches(launches, name, 1, "scans through the server")
        t0 = time.perf_counter()
        wire_poses = stub.pose_graph.get_trajectory_node_poses()
        node_poses_s = time.perf_counter() - t0

        pg = server.map_builder.pose_graph
        nodes = pg.get_trajectory_nodes()
        if set(wire_poses) != set(nodes.ids(NodeId)) or not all(
                np.array_equal(pose, nodes.at(nid).global_pose) for nid, pose in wire_poses.items()):
            raise AssertionError("node poses over the wire differ from the server's")
        errs, _, _ = node_errors(pg, true_poses, time_step, STARTUP_NODES)
        if errs.max() > 0.3:
            raise AssertionError(f"max node error {errs.max():.3f} m > 0.3 m from node {STARTUP_NODES}")
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not optimizations:
            time.sleep(0.05)
        if len(local_results) < nodes.size():
            raise AssertionError(f"{len(local_results)} local SLAM results for {nodes.size()} nodes")
        if not optimizations:
            raise AssertionError("no global optimization event")

        state = stub.serialize_state()
        if state_records(state) != state_records(server.map_builder.serialize_state()):
            raise AssertionError("WriteState's records differ from the server's own state")
        texture = stub.get_submap_data(SubmapId(tid, 0))
        cropped = compute_cropped(pg.get_all_submap_data().at(SubmapId(tid, 0)).submap.grid)
        if not (np.array_equal(texture["intensity"],
                               np.where(cropped.known, cropped.probability, 0.5).astype(np.float32))
                and np.array_equal(texture["alpha"], cropped.known.astype(np.float32))
                and np.array_equal(texture["origin"], np.asarray(cropped.origin, np.float64))):
            raise AssertionError("GetSubmapData differs from compute_cropped of submap 0")
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{server._exporter.port}/metrics", timeout=10).read().decode()
        found = re.search(r"^mapping_pose_graph_optimizations (\S+)$", body, re.M)
        if found is None or float(found.group(1)) < 1:
            raise AssertionError("/metrics shows no pose-graph optimization")
        for subscription in subscriptions:
            subscription.cancel()
        stream_s = last_result[0] - t_first_write
        return {
            "scans": CLOUD_SCANS,
            "events": len(head),
            "nodes": nodes.size(),
            "submaps": pg.get_all_submap_data().size(),
            "constraints": len(pg.constraints),
            "local_slam_results": len(local_results),
            "global_optimization_events": len(optimizations),
            "scans_per_s": CLOUD_SCANS / stream_s,
            "real_time_ratio": CLOUD_SCANS * time_step / stream_s,
            "finish_trajectory_rtt_s": finish_s,
            "run_final_optimization_rtt_s": final_optimization_s,
            "get_trajectory_node_poses_rtt_s": node_poses_s,
            "max_node_error_m": float(errs.max()),
            "node_poses_equal_over_wire": True,
            "write_state_records_equal": True,
            "state_mb": len(state) / 1e6,
            "submap_0_texture": list(texture["intensity"].shape),
            "metrics_pose_graph_optimizations": float(found.group(1)),
            "launches": launches,
        }, kept[0][0]
    finally:
        stub.close()
        server.shutdown()
        server.map_builder.shutdown()


def cloud_uplink_part(events, device):
    """A robot server on `device` uploading to a second server on the same
    card (batches of 10): UPLINK_LEGS scans streamed with the upstream up,
    shut down, and restarted on its old port (tests/test_client_server.py's
    fault injection at full width). The uploader drains; the robot builds
    more than 10 nodes and the restarted upstream at least one."""
    from cartographer_tpu_torch.cloud.map_builder_server import MapBuilderServer
    from cartographer_tpu_torch.cloud.map_builder_stub import MapBuilderStub
    from cartographer_tpu_torch.common.config import TrajectoryBuilderOptions
    from cartographer_tpu_torch.kernels import launch_counts, reset_launch_counts

    mb_options, _ = backend_options()
    upstream = MapBuilderServer(mb_options, device=device)
    upstream.start()
    port = upstream.port
    robot = MapBuilderServer(mb_options, uplink_address=f"localhost:{port}",
                             uplink_batch_size=10, device=device)
    robot.start()
    stub = MapBuilderStub(f"localhost:{robot.port}")
    servers = [robot, upstream]
    try:
        tid = stub.add_trajectory_builder(
            {"range", "imu", "odometry"},
            TrajectoryBuilderOptions(trajectory_builder_2d=sensor_options()))
        builder = stub.get_trajectory_builder(tid)
        ends = np.cumsum(UPLINK_LEGS)
        legs = [first_scans(events, int(n)) for n in ends]
        legs = [legs[0]] + [b[len(a):] for a, b in zip(legs, legs[1:])]
        sync(device)
        reset_launch_counts()
        t0 = time.perf_counter()
        stream_events(builder, legs[0])
        builder.close_streams()  # every write acknowledged by the robot
        robot.wait_until_idle()
        drained_before = robot._uploader.wait_until_drained()
        upstream_before = upstream.map_builder.pose_graph.get_trajectory_nodes().size()
        upstream.shutdown()
        stream_events(builder, legs[1])
        builder.close_streams()
        robot.wait_until_idle()
        upstream = MapBuilderServer(mb_options, address=f"localhost:{port}", device=device)
        upstream.start()
        servers.append(upstream)
        stream_events(builder, legs[2])
        builder.close_streams()
        robot.wait_until_idle()
        drained = robot._uploader.wait_until_drained()
        upstream.wait_until_idle()
        sync(device)
        wall = time.perf_counter() - t0
        launches = launch_counts()
        robot_nodes = robot.map_builder.pose_graph.get_trajectory_nodes().size()
        upstream_nodes = upstream.map_builder.pose_graph.get_trajectory_nodes().size()
        if not (drained_before and drained):
            raise AssertionError("the uploader did not drain")
        if robot_nodes <= 10 or upstream_nodes < 1:
            raise AssertionError(
                f"robot {robot_nodes} nodes, restarted upstream {upstream_nodes}")
        for name in ("correlative_window", "lm_match_2d", "supercover_scatter_2d"):
            require_launches(launches, name, robot_nodes - 1, "robot nodes")
        return {
            "scans": int(ends[-1]), "legs": list(UPLINK_LEGS), "batch": 10,
            "robot_nodes": robot_nodes,
            "upstream_nodes_before_shutdown": upstream_before,
            "upstream_nodes_after_restart": upstream_nodes,
            "uploader_drained": True,
            "wall_s": wall,
            "launches": launches,
        }
    finally:
        stub.close()
        for server in servers:
            server.shutdown()
            server.map_builder.shutdown()


def server_main_part(events, device):
    """tools/map_builder_server_main as a subprocess on the card (its
    default device; `--device cpu` only where `device` is the CPU), on a
    Lua configuration set written into a temporary directory: it prints
    its port, builds more than 3 nodes from SERVER_MAIN_SCANS scans sent
    over the wire, and exits 0 on SIGINT within 30 s."""
    import signal
    import tempfile

    from cartographer_tpu_torch.cloud.map_builder_stub import MapBuilderStub
    from cartographer_tpu_torch.common.config import TrajectoryBuilderOptions
    from cartographer_tpu_torch.testing.server_config import write_server_configuration

    with tempfile.TemporaryDirectory() as directory:
        basename = write_server_configuration(directory)
        t0 = time.perf_counter()
        device_flag = ["--device", "cpu"] if str(device) == "cpu" else []
        proc = subprocess.Popen(
            [sys.executable, "-m", "cartographer_tpu_torch.tools.map_builder_server_main",
             "--configuration_directory", directory, "--configuration_basename", basename,
             *device_flag],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        try:
            line = proc.stdout.readline()
            if "listening on port" not in line:
                proc.kill()
                raise AssertionError(f"server main did not start: {line!r} {proc.stderr.read()[-2000:]}")
            port = int(line.strip().rsplit(" ", 1)[-1])
            startup_s = time.perf_counter() - t0
            stub = MapBuilderStub(f"localhost:{port}")
            tid = stub.add_trajectory_builder(
                {"range"}, TrajectoryBuilderOptions(trajectory_builder_2d=loop_world_options()))
            builder = stub.get_trajectory_builder(tid)
            stream_events(builder, [e for e in first_scans(events, SERVER_MAIN_SCANS)
                                    if e[0] == "range"])
            stub.finish_trajectory(tid)
            nodes = len(stub.pose_graph.get_trajectory_node_poses())
            stub.close()
            if nodes <= 3:
                raise AssertionError(f"server main built {nodes} nodes")
            proc.send_signal(signal.SIGINT)
            t0 = time.perf_counter()
            rc = proc.wait(timeout=30)
            exit_s = time.perf_counter() - t0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if rc != 0:
            raise AssertionError(f"server main exited {rc}: {proc.stderr.read()[-2000:]}")
    return {"scans": SERVER_MAIN_SCANS, "nodes": nodes, "startup_s": startup_s,
            "exit_code": rc, "exit_s": exit_s}


def cloud_phase(device, smi):
    """The cloud SLAM server on `device`: the server path through the
    stub, the uplink with a restarted upstream, and the server main as a
    subprocess. Also returns the inputs of the server path's first
    window-sum call."""
    from cartographer_tpu_torch.testing.synthetic import generate_loop_world

    transport = grpc_transport()
    measurements, true_poses = generate_loop_world(**SLICE_WORLD)
    events = sensor_events(measurements)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    server, server_args = cloud_server_part(events, true_poses, device)
    server["part_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    uplink = cloud_uplink_part(events, device)
    uplink["part_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    server_main = server_main_part(events, device)
    server_main["part_s"] = time.perf_counter() - t0
    r = {
        "phase": "cloud",
        **transport,
        "server": server,
        "uplink": uplink,
        "server_main": server_main,
        "phase_s": time.perf_counter() - t_phase,
        "card": smi,
    }
    emit(r)
    return r, server_args


MULTIGPU_WORKER_ARGS = ()  # the worker's own defaults: the full width
MULTIGPU_TIMEOUT_S = 600


def worker_ranks(world, backend, device, extra=()):
    """tools/multihost_worker on `world` ranks joined over localhost
    (default device cuda:{rank % cards}, `--device cpu` only where
    `device` is the CPU): each rank's JSON reports by metric."""
    from cartographer_tpu_torch.parallel.multihost import free_port

    address = f"127.0.0.1:{free_port()}"
    device_flag = ["--device", "cpu"] if str(device) == "cpu" else []
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "cartographer_tpu_torch.tools.multihost_worker",
             "--coordinator_address", address, "--num_processes", str(world),
             "--process_id", str(rank), "--backend", backend, *device_flag,
             *MULTIGPU_WORKER_ARGS, *extra],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in range(world)
    ]
    outs = []
    try:
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=MULTIGPU_TIMEOUT_S)
            if proc.returncode != 0:
                raise AssertionError(
                    f"{backend} rank {rank} of {world} exited {proc.returncode}: {err[-3000:]}")
            lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
            outs.append({r["metric"]: r for r in lines})
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def multigpu_phase(device, smi):
    """The multi-rank backend on one card, through tools/multihost_worker
    at its full width (4,096 candidates per rank on a 1024^2 pool, A 64,
    N 512; SPA 10,000 nodes and 30,000 constraints, LM 20, CG 50):
    (a) one rank over NCCL; (b) two ranks sharing the card over gloo on
    CUDA tensors, each with the 2D production drain; (c) the 3D
    production drain on those two ranks. Checks: the ranks' costs (rel
    1e-6) and pose digests (abs 1e-6) agree, (b)'s cost is within rel 1e-3
    of (a)'s, the sharded scores equal score_level unsharded on the card
    (1e-6), the dryrun's checks on every rank, every tensor the ranks
    report (scores, poses, collectives, pyramids) lies on the card, and
    each rank's kernel launches on the card: the 2D drain's per-scan
    builder launches the LM and the scatter insertion, the 3D drain none
    of the four 2D kernels."""
    from cartographer_tpu_torch.testing.production_dryrun import (
        check_drain_2d,
        check_drain_3d,
    )

    t_phase = time.perf_counter()
    on_card = str(device) != "cpu"
    kind = "cuda" if on_card else "cpu"

    def check_rank(reports, backend, world):
        score, spa = reports["sharded_candidate_scores"], reports["sharded_spa_solve"]
        for r in (score, spa):
            if (r["backend"], r["num_processes"]) != (backend, world):
                raise AssertionError(f"run as {r['backend']} x {r['num_processes']}")
        if score["max_abs_err_vs_unsharded"] > 1e-6:
            raise AssertionError(f"sharded scores off by {score['max_abs_err_vs_unsharded']}")
        devices = {score["device"], score["scores_device"], spa["poses_device"]}
        if {d.split(":")[0] for d in devices} != {kind} or set(spa["collectives"]) != {kind}:
            raise AssertionError(f"tensors on {devices}, collectives {spa['collectives']}")
        return {"candidates_per_s_per_rank": score["items_per_sec_per_device"],
                "spa_s_per_solve": spa["seconds"], "final_cost": spa["final_cost"],
                "collectives": spa["collectives"][kind]}

    # (a) one rank over NCCL.
    t0 = time.perf_counter()
    backend_a = "nccl" if on_card else "gloo"
    (one,) = worker_ranks(1, backend_a, device)
    run_a = {"backend": backend_a, "world_size": 1, **check_rank(one, backend_a, 1),
             "run_s": time.perf_counter() - t0}
    # (b) and (c): two ranks on the one card over gloo.
    t0 = time.perf_counter()
    duo = worker_ranks(2, "gloo", device, ("--production", "--production_3d"))
    ranks = [check_rank(reports, "gloo", 2) for reports in duo]
    costs = [r["final_cost"] for r in ranks]
    if abs(costs[0] - costs[1]) > 1e-6 * abs(costs[0]):
        raise AssertionError(f"ranks disagree on the SPA cost: {costs}")
    if abs(costs[0] - run_a["final_cost"]) > 1e-3 * abs(run_a["final_cost"]):
        raise AssertionError(f"two ranks' cost {costs[0]} against one rank's {run_a['final_cost']}")
    drains = {}
    for name, check in (("production_drain_2d", check_drain_2d),
                        ("production_drain_3d", check_drain_3d)):
        stats = [reports[name] for reports in duo]
        for st in stats:
            check(st)
            if st["tensor_devices"] != [kind]:
                raise AssertionError(f"{name} tensors on {st['tensor_devices']}")
            if on_card and name == "production_drain_2d":
                # The per-scan builder on a probability grid: every node
                # but the first matched, every node inserted.
                require_launches(st["launches"], "lm_match_2d", st["num_nodes"] - 1, "nodes")
                require_launches(st["launches"], "supercover_scatter_2d", st["num_nodes"],
                                 "nodes")
                require_none(st["launches"], ["supercover_dense_2d"], "the per-scan path")
            elif on_card:
                require_none(st["launches"], ["correlative_window", *NEW_2D_KERNELS, "spa_2d"],
                             "the 3D drain")
        if abs(stats[0]["pose_digest"] - stats[1]["pose_digest"]) > 1e-6:
            raise AssertionError(f"ranks disagree on {name}: "
                                 f"{[st['pose_digest'] for st in stats]}")
        drains[name] = {k: stats[0][k] for k in (
            "num_nodes", "inter_constraints", "max_node_error_m", "travel_m",
            "sharded_search_batches", "sharded_spa_solves", "seconds")}
        drains[name]["launches"] = {k: sum(st["launches"][k] for st in stats)
                                    for k in stats[0]["launches"]}
    run_b = {"backend": "gloo", "world_size": 2, "ranks": ranks,
             "run_s": time.perf_counter() - t0}
    r = {
        "phase": "multigpu",
        "one_rank": run_a,
        "two_ranks": run_b,
        "drains": drains,
        "launches": {k: sum(d["launches"][k] for d in drains.values())
                     for k in drains["production_drain_2d"]["launches"]},
        "phase_s": time.perf_counter() - t_phase,
        "card": smi,
    }
    emit(r)
    return r


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cartographer_tpu_torch.kernels import _build

    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({
        "phase": "device", "name": kind, "nvidia_smi": smi,
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda,
    })

    t0 = time.perf_counter()
    logs = _build.build_all()
    build = {"phase": "build", "sources": _build.sources(),
             "seconds": time.perf_counter() - t0,
             "ptxas": {name: ptxas_usage(log) for name, log in logs.items()}}
    emit(build)

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    if "--spa-2d" in sys.argv:
        timed("spa_2d", spa_2d_phase, device)
        emit({"phase": "seconds", **seconds, "card": smi})
        return 0

    if "--refine-study" in sys.argv:
        study_s = float(sys.argv[sys.argv.index("--refine-study") + 1])
        _, saved_2d = backend_phase(device, smi)
        study = refine_study(device, saved_2d, study_s)
        return 1 if study["failed"] else 0

    kernels = timed("kernel", kernel_phase, device)
    cases = {"correlative_window": kernels, **timed("kernel_2d", kernel_phase_2d, device)}
    cases["spa_2d"] = timed("spa_2d", spa_2d_phase, device)
    sl, real = timed("slice", slice_phase, device, smi)
    kernels["real"] = kernel_case("real", real["correlative_window"])
    cases["lm_match_2d"]["real"] = lm_case("real", real["lm_match_2d"])
    cases["supercover_dense_2d"]["real"] = insertion_case(
        "real", "dense", real["supercover_dense_2d"])
    be, saved_2d = timed("backend", backend_phase, device, smi)
    cases["lm_match_2d"]["real_refine"] = lm_case("real_refine", saved_2d.pop("refine_inputs"))
    se, per_scan_cases = timed("sensors", sensors_phase, device, smi)
    cases["supercover_scatter_2d"]["real"] = insertion_case(
        "real", "scatter", per_scan_cases.pop("scatter_per_scan"))
    for name, args in per_scan_cases.items():
        kernels[name] = kernel_case(name, args)
    s3 = timed("local_slam_3d", local_slam_3d_phase, device, smi)
    b3, saved_3d = timed("backend_3d", backend_3d_phase, device, smi)
    pe, localization_args = timed("persist", persist_phase, device, smi, saved_2d, saved_3d)
    kernels["localization"] = kernel_case("localization", localization_args)
    cl, cloud_args = timed("cloud", cloud_phase, device, smi)
    kernels["cloud"] = kernel_case("cloud", cloud_args)
    mg = timed("multigpu", multigpu_phase, device, smi)
    emit({"phase": "seconds", **seconds, "card": smi})

    # Each path's launches of each kernel, counted from 0 just before it
    # was driven.
    paths = {
        "slice_chunked": sl["launches"],
        "backend_map_builder": be["launches"],
        "sensors_chunked": se["chunked"]["launches"],
        "sensors_per_scan": se["per_scan"]["launches"],
        "sensors_per_scan_tsdf": se["per_scan_tsdf"]["launches"],
        "sensors_map_builder_default": se["map_builder"]["launches"],
        "local_slam_3d_chunked": s3["chunked"]["launches"],
        "local_slam_3d_per_scan": s3["per_scan"]["launches"],
        "backend_3d_map_builder": b3["map_builder"]["launches"],
        "persist_localization": pe["localization"]["launches"],
        "persist_imu_based_3d": pe["imu_based_3d"]["launches"],
        "cloud_server": cl["server"]["launches"],
        "cloud_uplink": cl["uplink"]["launches"],
        "multigpu": mg["launches"],
    }
    sources = {
        "correlative_window": ("correlative_window.cu",
                               "cartographer_tpu/ops/pallas_kernels.py:82"),
        "lm_match_2d": ("lm_match_2d.cu",
                        "cartographer_tpu/ops/scan_matching/gauss_newton_2d.py:498"),
        "supercover_dense_2d": ("supercover_2d.cu", "cartographer_tpu/ops/raycast_2d.py:192"),
        "supercover_scatter_2d": ("supercover_2d.cu", "cartographer_tpu/ops/raycast_2d.py:32"),
        "spa_2d": ("spa_2d.cu", "cartographer_tpu/ops/spa_solver.py:160"),
    }
    line = []
    for name, (source, replaces) in sources.items():
        by_path = {path: counts[name] for path, counts in paths.items()}
        main_case = cases[name]["main"]
        line.append({
            "name": name,
            "route": "cuda",
            "source": f"cartographer_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": main_case["max_abs_err"],
            "ms": main_case["kernel_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": None,
            # Every case, the real paths' among them.
            "cases": {case: {"ms": c["kernel_ms"], "plain_ms": c["plain_ms"],
                             "bound_ms": c["bound_ms"], "max_abs_err": c["max_abs_err"]}
                      for case, c in cases[name].items()},
        })
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
