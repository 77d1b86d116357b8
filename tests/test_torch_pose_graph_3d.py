"""The port's 3D backend as a whole: one recorded node sequence feeds the
JAX package's PoseGraph3D (synchronous drain) and the port's, through
`replay_nodes_3d`, and gives the same constraints and optimized poses;
the port's MapBuilder runs the JAX package's 3D MapBuilder scenario
(tests/test_map_builder_3d.py) on the CPU in both drain modes; at most
one drain runs at a time; a trimmed node leaves no cached cloud behind
(2D and 3D); and a drain that raises on a pool worker is re-raised by
wait_for_all_computations."""

import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.common import config as jconfig
from cartographer_tpu.mapping.hybrid_grid import Grid3D as JGrid3D
from cartographer_tpu.mapping.id import NodeId as JNodeId
from cartographer_tpu.mapping.pose_graph_3d import PoseGraph3D as JaxPoseGraph3D
from cartographer_tpu.mapping.submap_3d import Submap3D as JSubmap3D
from cartographer_tpu.mapping.trajectory_node import (
    TrajectoryNodeData as JNodeData,
)
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.common.task import Task, TaskFailed, TaskState, ThreadPool
from cartographer_tpu_torch.mapping.id import NodeId
from cartographer_tpu_torch.mapping.map_builder import MapBuilder
from cartographer_tpu_torch.mapping.pose_graph_3d import PoseGraph3D, replay_nodes_3d
from cartographer_tpu_torch.ops.scan_matching import rotational_histogram
from cartographer_tpu_torch.sensor.data import ImuData
from cartographer_tpu_torch.testing.synthetic import (
    FAKE_START_TIME,
    generate_fake_range_measurements,
)
from cartographer_tpu_torch.transform import rigid3

from test_torch_backend_card import one_torch_thread  # noqa: F401
from test_torch_fast_correlative_3d import fc_options, grid_values, wall_cloud
import test_torch_pose_graph as pg2d

CPU = torch.device("cpu")
TRAVEL = 1.0
DURATION = 4.0


# -- the backend against the JAX package ----------------------------------------------


def recorded_trajectory(num_nodes=18, num_range_data=3, seed=4):
    """A node sequence through the wall world with the insertion pattern
    of ActiveSubmaps3D (a new submap every num_range_data nodes, the older
    one finished at 2 num_range_data): each node's clouds in its own
    frame, a drifting local pose, and per submap the world's grids seen
    from the submap's origin. Returns (records, submaps) as numpy, in
    replay_nodes_3d's format."""
    rng = np.random.default_rng(seed)
    world = wall_cloud(rng, 300)
    hv, ho = grid_values(world, 40, 0.2, rng)
    lv, lo = grid_values(world, 14, 0.8, rng)
    records, submaps, active, counts = [], {}, [], {}
    drift = np.zeros(3)
    for i in range(num_nodes):
        true = rigid3.make(
            np.array([0.05 * i, 0.02 * i, 0.0]),
            rigid3.quat_from_angle_axis(np.array([0.0, 0.0, 0.01 * i])),
        )
        drift += rng.normal(0, 0.004, 3)
        local = rigid3.compose(rigid3.translation(drift), true)
        cloud = rigid3.apply(rigid3.inverse(true), world.astype(np.float64))
        cloud = (cloud + rng.normal(0, 0.01, cloud.shape)).astype(np.float32)
        if not active or counts[active[-1]] == num_range_data:
            key = len(submaps)
            origin = local[:3]
            submaps[key] = dict(
                local_pose=rigid3.translation(origin),
                high_resolution_grid=dict(values=hv, origin=ho - origin, resolution=0.2),
                low_resolution_grid=dict(values=lv, origin=lo - origin, resolution=0.8),
                rotational_scan_matcher_histogram=rotational_histogram.compute_histogram(
                    rigid3.apply(rigid3.inverse(rigid3.translation(origin)), world.astype(np.float64)), 120
                ),
            )
            active = (active + [key])[-2:]
            counts[key] = 0
        for key in active:
            counts[key] += 1
        records.append(dict(
            node=dict(
                time=FAKE_START_TIME + 0.1 * i,
                gravity_alignment=np.array([1.0, 0, 0, 0]),
                filtered_gravity_aligned_point_cloud=None,
                local_pose=local,
                high_resolution_point_cloud=cloud,
                low_resolution_point_cloud=cloud[::3].copy(),
                rotational_scan_matcher_histogram=rotational_histogram.compute_histogram(
                    cloud.astype(np.float64), 120
                ),
            ),
            submaps=list(active),
            finished=[counts[k] == 2 * num_range_data for k in active],
        ))
    return records, submaps


def replay_jax(pose_graph, records, submaps):
    """replay_nodes_3d for the JAX package's PoseGraph3D."""
    built = {}

    def grid(fields):
        return JGrid3D(
            values=jnp.asarray(fields["values"]),
            origin=jnp.asarray(np.asarray(fields["origin"], np.float32)),
            resolution=fields["resolution"],
        )

    for rec in records:
        insertion = []
        for key, finished in zip(rec["submaps"], rec["finished"]):
            if key not in built:
                sm = submaps[key]
                built[key] = JSubmap3D(
                    local_pose=sm["local_pose"],
                    high_resolution_grid=grid(sm["high_resolution_grid"]),
                    low_resolution_grid=grid(sm["low_resolution_grid"]),
                    rotational_scan_matcher_histogram=sm["rotational_scan_matcher_histogram"],
                )
            if finished:
                built[key].finish()
            insertion.append(built[key])
        pose_graph.add_node(JNodeData(**rec["node"]), 0, insertion)


def backend_options(config, backend):
    pg = config.PoseGraphOptions(optimize_every_n_nodes=0)
    cb = pg.constraint_builder
    cb.sampling_ratio = 1.0
    cb.min_score = 0.3
    cb.loop_closure_backend = backend
    cb.fast_correlative_scan_matcher_3d = fc_options(config, 3)
    return pg


def constraint_rows(pose_graph):
    return sorted(
        (c.tag, c.submap_id.submap_index, c.node_id.node_index, tuple(c.pose.zbar_ij))
        for c in pose_graph.constraints
    )


def test_replay_matches_jax_pose_graph(one_torch_thread):  # noqa: F811
    records, submaps = recorded_trajectory()
    jpg = JaxPoseGraph3D(backend_options(jconfig, "native"))
    replay_jax(jpg, records, submaps)
    tpg = PoseGraph3D(backend_options(tconfig, "native"), device=CPU)
    replay_nodes_3d(tpg, 0, records, submaps, CPU)
    for pg in (jpg, tpg):
        pg.finish_trajectory(0)
        pg.run_final_optimization()
    want, got = constraint_rows(jpg), constraint_rows(tpg)
    assert [r[:3] for r in got] == [r[:3] for r in want]
    assert sum(r[0] != "INTRA_SUBMAP" for r in got) >= 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[3][:3], w[3][:3], atol=1e-3, rtol=0)
    jnodes = jpg.get_trajectory_nodes()
    tnodes = tpg.get_trajectory_nodes()
    for node_id, node in tnodes.items(NodeId):
        jnode = jnodes.at(JNodeId(node_id.trajectory_id, node_id.node_index))
        np.testing.assert_allclose(node.global_pose[:3], jnode.global_pose[:3], atol=1e-3, rtol=0)
    assert len(tpg.solve_seconds) == 2


# -- MapBuilder, as tests/test_map_builder_3d.py drives the JAX package's ----------------


def map_builder_options(backend="auto", async_pose_graph=False, optimize_every_n_nodes=12):
    pose_graph = tconfig.PoseGraphOptions(optimize_every_n_nodes=optimize_every_n_nodes)
    pose_graph.constraint_builder.sampling_ratio = 0.6
    pose_graph.constraint_builder.loop_closure_backend = backend
    pose_graph.constraint_builder.fast_correlative_scan_matcher_3d = (
        tconfig.FastCorrelativeScanMatcherOptions3D(
            branch_and_bound_depth=3,
            full_resolution_depth=3,
            linear_xy_search_window=1.0,
            linear_z_search_window=0.4,
            angular_search_window=np.radians(10.0),
            min_rotational_score=0.1,
        )
    )
    return tconfig.MapBuilderOptions(
        use_trajectory_builder_2d=False,
        use_trajectory_builder_3d=True,
        pose_graph=pose_graph,
        async_pose_graph=async_pose_graph,
        num_background_threads=2,
    )


def trajectory_options(trimmer=None):
    c = tconfig
    return c.TrajectoryBuilderOptions(
        trajectory_builder_3d=c.TrajectoryBuilder3DOptions(
            min_range=0.1,
            max_range=10.0,
            motion_filter=c.MotionFilterOptions(
                max_time_seconds=0.5, max_distance_meters=0.05, max_angle_radians=0.004
            ),
            high_resolution_adaptive_voxel_filter=c.AdaptiveVoxelFilterOptions(
                max_length=2.0, min_num_points=100, max_range=15.0
            ),
            low_resolution_adaptive_voxel_filter=c.AdaptiveVoxelFilterOptions(
                max_length=4.0, min_num_points=150, max_range=15.0
            ),
            submaps=c.SubmapsOptions3D(
                num_range_data=8,
                high_resolution=0.10,
                low_resolution=0.45,
                high_resolution_grid_size=192,
                low_resolution_grid_size=96,
            ),
        ),
        pure_localization_trimmer=trimmer,
    )


def drive(mb, duration=DURATION, trimmer=None, before_feed=None):
    """tests/test_map_builder_3d.py's world: the semicircle wall while
    moving 1 m along (2, 1, 0), IMU at 50 Hz. Returns (local SLAM results,
    node errors against the truth)."""
    results = []
    tid = mb.add_trajectory_builder(
        {"range", "imu"}, trajectory_options(trimmer), lambda *a: results.append(a)
    )
    builder = mb.get_trajectory_builder(tid)
    direction = np.array([2.0, 1.0, 0.0])
    translation = direction / np.linalg.norm(direction) * TRAVEL * duration / DURATION
    data = generate_fake_range_measurements(
        translation=translation, duration=duration, time_step=0.1
    )
    imu = [
        ImuData(time=t, linear_acceleration=np.array([0.0, 0.0, 9.8]), angular_velocity=np.zeros(3))
        for t in np.arange(FAKE_START_TIME - 0.5, FAKE_START_TIME + duration + 0.2, 1.0 / 50.0)
    ]
    events = sorted(
        [("imu", d.time, d) for d in imu] + [("range", m.time, m) for m in data],
        key=lambda e: e[1],
    )
    if before_feed is not None:
        before_feed()
    for kind, _, payload in events:
        builder.add_sensor_data(kind, payload)
    mb.finish_trajectory(tid)
    mb.pose_graph.run_final_optimization()
    velocity = translation / duration
    errs = [
        np.linalg.norm(rigid3.trans(node.global_pose) - (node.constant_data.time - FAKE_START_TIME) * velocity)
        for _, node in mb.pose_graph.get_trajectory_nodes().items(NodeId)
    ]
    return results, errs


def counting_searches(pose_graph):
    """Wrap the constraint builder's run_pending to count the searches of
    every drain; returns the count list."""
    cb = pose_graph._constraint_builder
    counts = []
    run = cb.run_pending

    def counted():
        out = run()
        counts.append(cb.last_drain_timings.get("searches", 0))
        return out

    cb.run_pending = counted
    return counts


@pytest.mark.parametrize(
    "backend,async_pose_graph", [("auto", False), ("device", True)], ids=["sync_native", "async_device"]
)
def test_map_builder_3d_closes_the_loop_on_cpu(backend, async_pose_graph, one_torch_thread):  # noqa: F811
    """The JAX package's test_map_builder_3d checks: more than 10 local
    SLAM results, every node within 0.1 x travel of the truth after the
    final optimization, an INTRA_SUBMAP constraint; and the constraint
    builder searched."""
    mb = MapBuilder(map_builder_options(backend, async_pose_graph), device=CPU)
    searches = counting_searches(mb.pose_graph)
    try:
        results, errs = drive(mb)
    finally:
        mb.shutdown()
    assert len(results) > 10
    assert max(errs) < 0.1 * TRAVEL
    assert any(c.tag == "INTRA_SUBMAP" for c in mb.pose_graph.constraints)
    assert sum(searches) >= 1
    assert len(mb.pose_graph.solve_seconds) >= 3


# -- drain discipline and the repairs ------------------------------------------------


def test_at_most_one_drain_in_flight_under_a_concurrent_feed_3d(one_torch_thread):  # noqa: F811
    """PoseGraph3D schedules its drains as PoseGraph2D does: while the feed
    and two more threads keep asking for drains, the drain tasks and
    run_pending each run one at a time."""
    mb = MapBuilder(
        map_builder_options("native", async_pose_graph=True, optimize_every_n_nodes=3),
        device=CPU,
    )
    pg = mb.pose_graph
    cb = pg._constraint_builder
    state = {"tasks": 0, "max_tasks": 0, "runs": 0, "max_runs": 0, "calls": 0}
    lock = threading.Lock()

    def counted(key, fn):
        def wrapper(*args):
            with lock:
                state[key] += 1
                state["max_" + key] = max(state["max_" + key], state[key])
                state["calls"] += key == "runs"
            try:
                time.sleep(0.005)
                return fn(*args)
            finally:
                with lock:
                    state[key] -= 1

        return wrapper

    cb.run_pending = counted("runs", cb.run_pending)
    pg._locked_handle_work_queue = counted("tasks", pg._locked_handle_work_queue)
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            pg._dispatch_work_queue()
            time.sleep(0.001)

    extra = [threading.Thread(target=hammer, daemon=True) for _ in range(2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _, errs = drive(mb, duration=2.0, before_feed=lambda: [t.start() for t in extra])
    finally:
        sys.setswitchinterval(interval)
        stop.set()
        for t in extra:
            t.join(timeout=30)
        mb.shutdown()
    assert not any(t.is_alive() for t in extra)
    assert state["calls"] > 3
    assert state["max_tasks"] == 1
    assert state["max_runs"] == 1
    assert max(errs) < 0.1 * TRAVEL


def recording_evictions(constraint_builder):
    """Wrap evict_node to record the node ids it found cached."""
    evicted = []
    evict = constraint_builder.evict_node

    def recorded(node_id):
        caches = [constraint_builder._node_clouds]
        if hasattr(constraint_builder, "_native_node_clouds"):
            caches.append(constraint_builder._native_node_clouds)
        if any(node_id in c for c in caches):
            evicted.append(node_id)
        evict(node_id)

    constraint_builder.evict_node = recorded
    return evicted


def test_trim_evicts_cached_node_clouds_3d(one_torch_thread):  # noqa: F811
    """The pure-localization trimmer keeps 2 submaps: every node it trims
    leaves the constraint builder's per-node caches (device and native),
    and the caches hold only live nodes. Every node is searched (and its
    clouds cached), and no search matches, so the nodes of a trimmed
    submap lose their last constraint and are trimmed with it."""
    options = map_builder_options("native", optimize_every_n_nodes=6)
    options.pose_graph.constraint_builder.sampling_ratio = 1.0
    options.pose_graph.constraint_builder.min_score = 0.99
    mb = MapBuilder(options, device=CPU)
    cb = mb.pose_graph._constraint_builder
    evicted = recording_evictions(cb)
    drive(mb, trimmer=tconfig.PureLocalizationTrimmerOptions(max_submaps_to_keep=2))
    live = {node_id for node_id, _ in mb.pose_graph.get_trajectory_nodes().items(NodeId)}
    assert evicted and not set(evicted) & live
    assert set(cb._node_clouds) <= live and set(cb._native_node_clouds) <= live


def test_trim_evicts_cached_node_clouds_2d(one_torch_thread):  # noqa: F811
    """The same for PoseGraph2D: ConstraintBuilder2D._node_clouds holds no
    trimmed node (the JAX package keeps them)."""
    topts = pg2d.trajectory_options(tconfig)
    topts.pure_localization_trimmer = tconfig.PureLocalizationTrimmerOptions(max_submaps_to_keep=2)
    pose_graph = pg2d.pose_graph_options(tconfig, optimize_every_n_nodes=8)
    pose_graph.constraint_builder.sampling_ratio = 1.0
    pose_graph.constraint_builder.min_score = 0.99
    mb = MapBuilder(
        tconfig.MapBuilderOptions(use_trajectory_builder_2d=True, pose_graph=pose_graph),
        device=CPU,
    )
    cb = mb.pose_graph._constraint_builder
    evicted = recording_evictions(cb)
    tid = mb.add_trajectory_builder({"range"}, topts)
    builder = mb.get_trajectory_builder(tid)
    for m in pg2d.measurements()[0]:
        builder.add_sensor_data("range", m)
    mb.finish_trajectory(tid)
    live = {node_id for node_id, _ in mb.pose_graph.get_trajectory_nodes().items(NodeId)}
    assert evicted and not set(evicted) & live
    assert set(cb._node_clouds) <= live


def test_failed_task_is_reported():
    """A work item that raises leaves its task FAILED; Task.wait re-raises
    it (the JAX package marks it COMPLETED), and dependents still run."""
    pool = ThreadPool(1)
    try:
        failing = Task(lambda: 1 / 0)
        ran = threading.Event()
        dependent = Task(ran.set)
        dependent.add_dependency(failing)
        pool.schedule(failing)
        pool.schedule(dependent)
        with pytest.raises(TaskFailed) as info:
            failing.wait(timeout=10)
        assert isinstance(info.value.__cause__, ZeroDivisionError)
        assert failing.state == TaskState.FAILED and failing.done
        assert dependent.wait(timeout=10) and ran.is_set()
        assert dependent.state == TaskState.COMPLETED
    finally:
        pool.shutdown()


@pytest.mark.parametrize("dims", ["2d", "3d"])
def test_raising_drain_is_reraised(dims):
    """A drain whose search raises on a pool worker: the pose graph's
    wait_for_all_computations (and so finish_trajectory) raises, and no
    later drain replaces the failed one."""
    if dims == "3d":
        pg = PoseGraph3D(tconfig.PoseGraphOptions(), ThreadPool(1), device=CPU)
    else:
        from cartographer_tpu_torch.mapping.pose_graph_2d import PoseGraph2D

        pg = PoseGraph2D(tconfig.PoseGraphOptions(), ThreadPool(1), device=CPU)

    def search():
        raise RuntimeError("search failed")

    pg._constraint_builder.run_pending = search
    pg._dispatch_work_queue()
    for _ in range(2):
        with pytest.raises(TaskFailed) as info:
            pg.wait_for_all_computations(timeout=30)
        assert "search failed" in str(info.value.__cause__)
    failed = pg._pending_task
    pg._dispatch_work_queue()
    assert pg._pending_task is failed
    with pytest.raises(TaskFailed):
        pg.finish_trajectory(0)
    pg._thread_pool.shutdown()


def test_3d_entry_points_need_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cartographer_tpu_torch.mapping.constraint_builder_3d import ConstraintBuilder3D
    from cartographer_tpu_torch.mapping.optimization_problem_3d import OptimizationProblem3D

    pg = tconfig.PoseGraphOptions()
    entry_points = [
        lambda **kw: MapBuilder(
            tconfig.MapBuilderOptions(
                use_trajectory_builder_2d=False, use_trajectory_builder_3d=True
            ),
            **kw,
        ),
        lambda **kw: PoseGraph3D(pg, **kw),
        lambda **kw: ConstraintBuilder3D(pg.constraint_builder, **kw),
        lambda **kw: OptimizationProblem3D(pg.optimization_problem, **kw),
    ]
    for make in entry_points:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        make(device="cpu")
