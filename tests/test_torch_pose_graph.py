"""The port's 2D backend as a whole against the JAX package: one node
sequence recorded from the JAX chunked frontend feeds both PoseGraph2Ds
(synchronous drain, device loop-closure backend) and gives the same
constraints and optimized poses; the port's MapBuilder closes the loop
on the CPU in both drain modes; at most one drain runs at a time; and the
entry points need CUDA unless told otherwise."""

import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.common import config as jconfig
from cartographer_tpu.mapping.chunked_frontend_2d import (
    ChunkedLocalTrajectoryBuilder2D as JaxFrontend,
)
from cartographer_tpu.mapping.grid_2d import Grid2D as JGrid2D
from cartographer_tpu.mapping.id import NodeId as JNodeId
from cartographer_tpu.mapping.pose_graph_2d import PoseGraph2D as JaxPoseGraph
from cartographer_tpu.mapping.submap_2d import Submap2D as JSubmap2D
from cartographer_tpu.mapping.trajectory_node import (
    TrajectoryNodeData as JNodeData,
)
from cartographer_tpu.testing import synthetic as jsynthetic
from cartographer_tpu.transform import rigid2, rigid3
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.mapping.constraint_builder_2d import ConstraintBuilder2D
from cartographer_tpu_torch.mapping.id import NodeId
from cartographer_tpu_torch.mapping.map_builder import MapBuilder
from cartographer_tpu_torch.mapping.optimization_problem_2d import (
    OptimizationProblem2D,
)
from cartographer_tpu_torch.mapping.pose_graph_2d import PoseGraph2D, replay_nodes
from cartographer_tpu_torch.testing import synthetic as tsynthetic
from cartographer_tpu_torch.testing.synthetic import FAKE_START_TIME
from test_torch_backend_card import one_torch_thread  # noqa: F401

TRAVEL = 1.2
DURATION = 4.0
TIME_STEP = 0.1


def pose_graph_options(config, backend="device", optimize_every_n_nodes=20):
    """tests/test_map_builder_chunked.py's backend, with a 1 m search
    window (the BnB runs on the CPU here)."""
    pg = config.PoseGraphOptions(optimize_every_n_nodes=optimize_every_n_nodes)
    pg.constraint_builder.fast_correlative_scan_matcher = (
        config.FastCorrelativeScanMatcherOptions2D(
            linear_search_window=1.0,
            angular_search_window=np.radians(20.0),
            branch_and_bound_depth=4,
        )
    )
    pg.constraint_builder.sampling_ratio = 0.5
    pg.constraint_builder.loop_closure_backend = backend
    return pg


def trajectory_options(config):
    return config.TrajectoryBuilderOptions(
        trajectory_builder_2d=config.TrajectoryBuilder2DOptions(
            use_imu_data=False,
            max_range=10.0,
            motion_filter=config.MotionFilterOptions(max_distance_meters=0.02),
            submaps=config.SubmapsOptions2D(
                num_range_data=8,
                grid_options_2d=config.GridOptions2D(resolution=0.05, grid_size=256),
            ),
        ),
        use_chunked_device_frontend=True,
        device_frontend_chunk_size=16,
    )


def measurements(synthetic=tsynthetic, duration=DURATION):
    direction = np.array([2.0, 1.0, 0.0])
    direction /= np.linalg.norm(direction)
    translation = direction * TRAVEL * duration / DURATION
    return synthetic.generate_fake_range_measurements(
        translation=translation, duration=duration, time_step=TIME_STEP
    ), translation / duration


def node_errors(pose_graph, velocity):
    errs = []
    for _, node in pose_graph.get_trajectory_nodes().items(NodeId):
        expected = (node.constant_data.time - FAKE_START_TIME) * velocity
        errs.append(np.linalg.norm(rigid3.trans(node.global_pose) - expected))
    return errs


# -- the slice against the JAX package --------------------------------------------


def record_jax_frontend():
    """The JAX chunked frontend over the semicircle world: every inserted
    node as numpy, with its insertion submaps (by key) and their finished
    flags as a pose graph sees them at add_node, and each submap's final
    grid."""
    frontend = JaxFrontend(
        trajectory_options(jconfig).trajectory_builder_2d, {"range"}, chunk_size=16
    )
    records, live = [], {}

    def take(results):
        for r in results:
            ins = r.insertion_result
            if ins is None:
                continue
            for sm in ins.insertion_submaps:
                live.setdefault(id(sm), sm)
            d = ins.constant_data
            records.append(dict(
                node=dict(
                    time=d.time,
                    gravity_alignment=np.asarray(d.gravity_alignment, np.float64),
                    filtered_gravity_aligned_point_cloud=np.asarray(
                        d.filtered_gravity_aligned_point_cloud, np.float32
                    ),
                    local_pose=np.asarray(d.local_pose, np.float64),
                ),
                submaps=[id(sm) for sm in ins.insertion_submaps],
                finished=[sm.insertion_finished for sm in ins.insertion_submaps],
            ))

    for m in measurements(jsynthetic)[0]:
        take(frontend.add_range_data("range", m))
    take(frontend.flush())
    submaps = {
        key: dict(
            local_pose=np.asarray(sm.local_pose, np.float64),
            log_odds=np.asarray(sm.grid.log_odds),
            known=np.asarray(sm.grid.known),
            origin=np.asarray(sm.grid.origin),
            resolution=float(sm.grid.resolution),
        )
        for key, sm in live.items()
    }
    return records, submaps


def replay_jax(pose_graph, records, submaps):
    """replay_nodes for the JAX package's PoseGraph2D."""
    built = {}
    for rec in records:
        insertion = []
        for key, finished in zip(rec["submaps"], rec["finished"]):
            submap = built.get(key)
            if submap is None:
                sm = submaps[key]
                submap = JSubmap2D(
                    local_pose=sm["local_pose"],
                    grid=JGrid2D(
                        log_odds=jnp.asarray(sm["log_odds"]),
                        known=jnp.asarray(sm["known"]),
                        origin=jnp.asarray(sm["origin"]),
                        resolution=sm["resolution"],
                    ),
                )
                built[key] = submap
            if finished:
                submap.finish()
            insertion.append(submap)
        pose_graph.add_node(JNodeData(**rec["node"]), 0, insertion)


def constraint_keys(pose_graph):
    return sorted(
        (c.tag, c.submap_id.submap_index, c.node_id.node_index)
        for c in pose_graph.constraints
    )


def test_slice_matches_jax():
    records, submaps = record_jax_frontend()
    assert len(records) > 20 and len(submaps) >= 3
    want = JaxPoseGraph(pose_graph_options(jconfig))
    replay_jax(want, records, submaps)
    want.finish_trajectory(0)
    want.run_final_optimization()
    got = PoseGraph2D(pose_graph_options(tconfig), device="cpu")
    replay_nodes(got, 0, records, submaps, "cpu")
    got.finish_trajectory(0)
    got.run_final_optimization()

    assert constraint_keys(got) == constraint_keys(want)
    assert any(c.tag == "INTER_SUBMAP" for c in got.constraints)
    want_nodes = dict(want.get_trajectory_nodes().items(JNodeId))
    got_nodes = dict(got.get_trajectory_nodes().items(NodeId))
    assert len(got_nodes) == len(want_nodes) == len(records)
    for (jid, jn), (tid, tn) in zip(sorted(want_nodes.items()), sorted(got_nodes.items())):
        assert (jid.trajectory_id, jid.node_index) == (tid.trajectory_id, tid.node_index)
        w, g = rigid3.project_2d(jn.global_pose), rigid3.project_2d(tn.global_pose)
        np.testing.assert_allclose(g[:2], w[:2], atol=1e-3)
        assert abs(rigid2.normalize_angle(g[2] - w[2])) <= 1e-3


# -- the port's MapBuilder end to end --------------------------------------------


@pytest.mark.parametrize("async_pose_graph", [False, True], ids=["sync", "async"])
def test_map_builder_closes_the_loop_on_cpu(async_pose_graph):
    mb = MapBuilder(
        tconfig.MapBuilderOptions(
            use_trajectory_builder_2d=True,
            pose_graph=pose_graph_options(tconfig),
            async_pose_graph=async_pose_graph,
        ),
        device="cpu",
    )
    try:
        tid = mb.add_trajectory_builder({"range"}, trajectory_options(tconfig))
        builder = mb.get_trajectory_builder(tid)
        data, velocity = measurements()
        for m in data:
            builder.add_sensor_data("range", m)
        mb.finish_trajectory(tid)
        mb.pose_graph.run_final_optimization()
        errs = node_errors(mb.pose_graph, velocity)
        assert len(errs) > 20
        assert max(errs) < 0.1 * TRAVEL
        tags = {c.tag for c in mb.pose_graph.constraints}
        assert tags == {"INTRA_SUBMAP", "INTER_SUBMAP"}
        assert mb.pose_graph.solve_seconds
    finally:
        mb.shutdown()


# -- drain discipline ----------------------------------------------------------------


def test_at_most_one_drain_in_flight_under_a_concurrent_feed():
    """The async feed schedules drains from add_node while another thread
    keeps asking for one; the drain tasks and the constraint builder's
    run_pending each run one at a time (the JAX package's unlocked
    check-and-set of the pending task can schedule two)."""
    mb = MapBuilder(
        tconfig.MapBuilderOptions(
            use_trajectory_builder_2d=True,
            pose_graph=pose_graph_options(
                tconfig, backend="native", optimize_every_n_nodes=3
            ),
            async_pose_graph=True,
            num_background_threads=4,
        ),
        device="cpu",
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
                time.sleep(0.005)  # widen the window a second drain would need
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
        tid = mb.add_trajectory_builder({"range"}, trajectory_options(tconfig))
        builder = mb.get_trajectory_builder(tid)
        for t in extra:
            t.start()
        data, velocity = measurements(duration=2.0)
        for m in data:
            builder.add_sensor_data("range", m)
        mb.finish_trajectory(tid)
        mb.pose_graph.run_final_optimization()
    finally:
        sys.setswitchinterval(interval)
        stop.set()
        for t in extra:
            t.join(timeout=30)
        mb.shutdown()
    assert not any(t.is_alive() for t in extra)
    assert state["calls"] > 3  # the feed and the hammer did drain
    assert state["max_tasks"] == 1
    assert state["max_runs"] == 1
    assert max(node_errors(pg, velocity)) < 0.1 * TRAVEL


# -- devices ------------------------------------------------------------------------


def test_entry_points_need_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pg = tconfig.PoseGraphOptions()
    entry_points = [
        lambda **kw: MapBuilder(
            tconfig.MapBuilderOptions(use_trajectory_builder_2d=True), **kw
        ),
        lambda **kw: PoseGraph2D(pg, **kw),
        lambda **kw: ConstraintBuilder2D(pg.constraint_builder, **kw),
        lambda **kw: OptimizationProblem2D(pg.optimization_problem, **kw),
    ]
    for make in entry_points:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        make(device="cpu")
