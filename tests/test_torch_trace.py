"""The port's span recorder (`metrics.span`, `metrics.timed`): nothing is
recorded, and no clock read at a span site, outside a torch profiler
session; inside one the spans nest per thread, keep threads apart and
stop at the cap; a small MapBuilder run records every span of the 2D main
path, the four local SLAM stages tiling `add_range_data`; add_node's wait
on the work lock shows; and the pose graph's work queue gauges are live
after an asynchronous drain."""

import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.common import config
from cartographer_tpu_torch.mapping.id import NodeId
from cartographer_tpu_torch.mapping.map_builder import MapBuilder
from cartographer_tpu_torch.mapping.pose_graph_2d import PoseGraph2D
from cartographer_tpu_torch.metrics import trace
from cartographer_tpu_torch.testing import synthetic
from test_torch_backend_card import one_torch_thread  # noqa: F401

LOCAL_SLAM = ("local_slam.unwarp", "local_slam.filter", "local_slam.scan_match",
              "local_slam.insert")
MAIN_PATH = ("facade.add_sensor_data", *LOCAL_SLAM, "pose_graph.add_node",
             "pose_graph.work_lock_wait", "pose_graph.drain", "drain.search",
             "drain.refine_dispatch", "drain.refine_wait", "pose_graph.solve")


@pytest.fixture(autouse=True)
def empty_record():
    metrics.reset_spans()
    yield
    metrics.reset_spans()


def session():
    return profile(activities=[ProfilerActivity.CPU])


def recorded():
    spans = metrics.spans()
    assert all(s[5] is None or s[5] < i for i, s in enumerate(spans))
    return spans


# -- the recorder --------------------------------------------------------------


def test_nothing_is_recorded_outside_a_profiler_session():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert metrics.span("a") is metrics.NULL_SPAN
    with metrics.span("a", 1.0):
        started = metrics.span("b").start()
        started.stop()
    stopwatch = metrics.timed("c")
    time.sleep(0.002)
    assert stopwatch.stop() >= 0.002
    metrics.enable_collection()
    try:
        assert metrics.span("d") is metrics.NULL_SPAN
    finally:
        metrics.register_family_factory(metrics.FamilyFactory(real=False))
    assert metrics.spans() == [] and metrics.spans_dropped() == 0


def test_records_inside_a_profiler_session_and_stops_with_it():
    with session():
        with metrics.span("outer", 7.0):
            time.sleep(0.003)
        seconds = metrics.timed("timed").stop()
    assert metrics.span("after") is metrics.NULL_SPAN
    with metrics.span("after"):
        pass
    (outer, timed) = recorded()
    name, start, end, cpu, thread, parent, key = outer
    assert (name, parent, key, thread) == ("outer", None, 7.0, threading.get_ident())
    assert end - start >= 3e6 and cpu >= 0
    assert timed[0] == "timed" and timed[2] - timed[1] == pytest.approx(seconds * 1e9)


def test_parents_nest_per_thread_and_threads_are_kept_apart():
    ready = threading.Barrier(2)

    def work(tag):
        with metrics.span(f"{tag}.outer", tag):
            ready.wait()  # both outer spans are open at once
            with metrics.span(f"{tag}.middle"):
                inner = metrics.span(f"{tag}.inner", f"{tag}-own").start()
                ready.wait()
                inner.stop()
            ready.wait()

    with session():
        threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    spans = recorded()
    assert len(spans) == 6
    by_name = {s[0]: (i, s) for i, s in enumerate(spans)}
    for tag in ("a", "b"):
        outer_i, outer = by_name[f"{tag}.outer"]
        middle_i, middle = by_name[f"{tag}.middle"]
        _, inner = by_name[f"{tag}.inner"]
        assert outer[5] is None and middle[5] == outer_i and inner[5] == middle_i
        assert outer[4] == middle[4] == inner[4]
        assert (outer[6], middle[6], inner[6]) == (tag, tag, f"{tag}-own")
        assert outer[1] <= middle[1] <= inner[1] <= inner[2] <= middle[2] <= outer[2]
    assert by_name["a.outer"][1][4] != by_name["b.outer"][1][4]


def test_the_cap_counts_dropped_spans(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 3)
    with session():
        with metrics.span("outer"):
            for key in range(4):
                with metrics.span("child", key):
                    pass
    # The first three to stop are kept; the fourth child and the outer
    # span, which stops last, are counted.
    spans = recorded()
    assert [(s[0], s[5], s[6]) for s in spans] == [("child", None, k) for k in range(3)]
    assert metrics.spans_dropped() == 2
    metrics.reset_spans()
    assert metrics.spans() == [] and metrics.spans_dropped() == 0


# -- the 2D main path ----------------------------------------------------------


def map_builder():
    """Per-scan 2D local SLAM with an asynchronous pose graph that drains
    every 4 nodes through the native search and the batched refinement,
    over a short semicircle world (15 accumulations of 2 messages, each
    unwarped in one extrapolator call)."""
    pg = config.PoseGraphOptions(optimize_every_n_nodes=4)
    pg.constraint_builder.fast_correlative_scan_matcher = (
        config.FastCorrelativeScanMatcherOptions2D(
            linear_search_window=1.0, angular_search_window=np.radians(20.0),
            branch_and_bound_depth=4,
        )
    )
    pg.constraint_builder.sampling_ratio = 1.0
    pg.constraint_builder.loop_closure_backend = "native"
    mb = MapBuilder(
        config.MapBuilderOptions(use_trajectory_builder_2d=True, pose_graph=pg,
                                 async_pose_graph=True,
                                 num_background_threads=1),
        device="cpu",
    )
    trajectory = config.TrajectoryBuilderOptions(
        trajectory_builder_2d=config.TrajectoryBuilder2DOptions(
            use_imu_data=False, max_range=10.0, num_accumulated_range_data=2,
            motion_filter=config.MotionFilterOptions(max_distance_meters=0.02),
            submaps=config.SubmapsOptions2D(
                num_range_data=4,
                grid_options_2d=config.GridOptions2D(resolution=0.05, grid_size=256),
            ),
        ),
    )
    tid = mb.add_trajectory_builder({"range"}, trajectory)
    return mb, tid


def drive(mb, tid):
    builder = mb.get_trajectory_builder(tid)
    data = synthetic.generate_fake_range_measurements(
        translation=np.array([1.0, 0.5, 0.0]), duration=3.0, time_step=0.1
    )
    for m in data:
        builder.add_sensor_data("range", m)
    mb.finish_trajectory(tid)
    mb.pose_graph.run_final_optimization()
    return data


def test_a_map_builder_run_records_every_span_of_the_main_path():
    mb, tid = map_builder()
    local = mb.get_trajectory_builder(tid)._wrapped._local_trajectory_builder
    add_range_data, wraps = local.add_range_data, []

    def wrapped(*args):  # as the benchmark wraps it, from outside
        t0 = time.perf_counter_ns()
        try:
            return add_range_data(*args)
        finally:
            wraps.append((t0, time.perf_counter_ns()))

    local.add_range_data = wrapped
    collected = metrics.enable_collection()
    try:
        with session():
            data = drive(mb, tid)
        per_unwarp = collected.registry()[
            "mapping_2d_local_trajectory_builder_subdivisions_per_unwarp"].value()
    finally:
        mb.shutdown()
        metrics.register_family_factory(metrics.FamilyFactory(real=False))
    spans = recorded()
    assert set(MAIN_PATH) <= {s[0] for s in spans}
    feeder = {s[4] for s in spans if s[0] == "facade.add_sensor_data"}
    assert feeder == {threading.get_ident()}
    assert len(wraps) == len(data) == sum(s[0] == "local_slam.unwarp" for s in spans)
    assert {s[6] for s in spans if s[0] == "local_slam.unwarp"} == {m.time for m in data}
    stages = sorted((s for s in spans if s[0] in LOCAL_SLAM), key=lambda s: s[1])
    for s in stages:
        assert spans[s[5]][0] == "facade.add_sensor_data" and s[4] in feeder
        assert any(a <= s[1] and s[2] <= b for a, b in wraps), s
    for before, after in zip(stages, stages[1:]):
        assert before[2] <= after[1], (before, after)
    # Per accumulation: filter (twice), scan_match and insert, in order.
    accumulations = [s for s in stages if s[0] == "local_slam.insert"]
    assert len(accumulations) == sum(s[0] == "local_slam.scan_match" for s in stages) > 5
    # The accumulation's two subdivisions are unwarped in one call, at its
    # close: each call opens with its own unwarp span, the closing one
    # (staging and the unwarp of both) before the filter.
    assert per_unwarp == 2
    calls = [[s[0] for s in stages if a <= s[1] and s[2] <= b] for a, b in wraps]
    assert all(c.count("local_slam.unwarp") == 1 and c[0] == "local_slam.unwarp"
               for c in calls)
    closing = [c for c in calls if len(c) > 1]
    assert len(closing) == len(data) // 2
    assert all(c[1:3] == ["local_slam.filter", "local_slam.filter"] for c in closing)
    for s in spans:
        if s[0].startswith("drain."):
            assert spans[s[5]][0] == "pose_graph.drain"
            assert isinstance(s[6], NodeId) or s[6] is None
        if s[0] == "pose_graph.add_node":
            assert s[4] in feeder and spans[s[5]][0] == "facade.add_sensor_data"
    assert any(isinstance(s[6], NodeId) for s in spans if s[0] == "pose_graph.solve")


def test_add_node_records_its_wait_for_the_work_lock():
    pg = PoseGraph2D(config.PoseGraphOptions(), device="cpu")
    pg._add_node_locked = lambda *args: NodeId(0, 0)
    held = threading.Event()

    def hold():
        with pg._work_lock:
            held.set()
            time.sleep(0.05)

    holder = threading.Thread(target=hold)
    with session():
        holder.start()
        held.wait()
        pg.add_node(types.SimpleNamespace(time=12.5), 0, [])
        holder.join()
    (add_node, wait) = recorded()
    assert add_node[0] == "pose_graph.add_node" and wait[0] == "pose_graph.work_lock_wait"
    assert wait[5] == 0 and wait[6] == 12.5
    assert wait[2] - wait[1] >= 40e6
    assert wait[3] < 0.5 * (wait[2] - wait[1])  # waiting, not running


class CountedClock:
    """Stands in for the recorder's `time` module: counts the clock reads
    by the function that made them."""

    def __init__(self):
        self.reads = {}

    def _count(self, clock):
        import sys

        caller = sys._getframe(2).f_code.co_qualname
        self.reads[(clock, caller)] = self.reads.get((clock, caller), 0) + 1

    def perf_counter_ns(self):
        self._count("perf_counter_ns")
        return time.perf_counter_ns()

    def thread_time_ns(self):
        self._count("thread_time_ns")
        return time.thread_time_ns()


def test_without_a_session_only_the_self_timed_sites_read_the_clock(monkeypatch):
    """A whole run with no profiler session: no span recorded, and the
    recorder's clock read only by the drain's phases and the SPA solve,
    which time themselves on every call; the timings keep their keys.
    Metrics collection on: the work queue gauges read each drain's
    searches and the age of its oldest."""
    clock = CountedClock()
    monkeypatch.setattr(trace, "time", clock)
    mb, tid = map_builder()
    cb = mb.pose_graph._constraint_builder
    run_pending, drains = cb.run_pending, []

    def read_gauges():
        out = run_pending()
        drains.append((len(cb.last_drain_searches), metrics.pose_graph_work_queue_size.value(),
                       metrics.pose_graph_work_queue_delay.value(), dict(cb.last_drain_timings)))
        return out

    cb.run_pending = read_gauges
    metrics.enable_collection()
    try:
        drive(mb, tid)
    finally:
        metrics.register_family_factory(metrics.FamilyFactory(real=False))
        mb.shutdown()
    assert metrics.spans() == []
    assert set(clock.reads) == {("perf_counter_ns", "_Stopwatch.__init__"),
                                ("perf_counter_ns", "_Stopwatch.stop")}
    solves = len(mb.pose_graph.solve_seconds)
    assert solves > 0 and all(s > 0 for s in mb.pose_graph.solve_seconds)
    assert clock.reads[("perf_counter_ns", "_Stopwatch.stop")] >= solves
    searched = [d for d in drains if d[0] > 0]
    assert searched, drains
    for n, size, delay, timings in searched:
        assert size == n and delay > 0
        assert set(timings) == {"searches", "matches", "search_s", "refine_dispatch_s",
                                "refine_wait_s", "total_s"}
        assert timings["searches"] == n and 0 < timings["search_s"] <= timings["total_s"]
