"""Drive the port's `MapBuilder` with a generated stream.

The entry the window drives is `MapBuilder`'s trajectory builder
(`add_sensor_data`), built by `add_trajectory_builder` with a
`local_slam_result_callback`; the asynchronous pose graph runs beside it
on its thread pool. `Probe` wraps the bound methods of the trajectory's
own instances: always to sample what the correctness check compares
(what the extrapolator and the gravity estimate gave the stages before
the scan match, the scan matcher's inputs and pose, the grids around an
insertion, the SPA solves), and in the traced run also to record spans
around the calls into each layer.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np


class Probe:
    """Spans and sampled captures from the benchmark's side of each
    layer's boundary. Spans are (name, start, end) on `time.perf_counter`;
    captures are kept only while `recording` is set."""

    def __init__(self, rng: np.random.Generator, sample: Dict[str, float], spans: bool):
        self.rng = rng
        self.sample = sample
        self.with_spans = spans
        self.recording = False
        self.spans: List[tuple] = []
        self.matches: List[dict] = []
        self.insertions: List[dict] = []
        self.solves: List[dict] = []
        self._lock = threading.Lock()
        self._batches = None  # the extrapolator's per-point poses since the last accumulation
        self._upstream = None

    def _take(self, kind: str) -> bool:
        # One draw per call in every run, so that the sample depends on the
        # seed and the call's place in the window alone.
        return bool(self.rng.random() < self.sample.get(kind, 0.0)) and self.recording

    def span(self, name, fn):
        if not self.with_spans:
            return fn
        spans = self.spans

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spans.append((name, t0, time.perf_counter()))
        return wrapped

    def attach(self, map_builder, trajectory_id: int) -> None:
        """Wrap the trajectory's facade, local builder, scan matcher,
        active submaps and pose graph."""
        collated = map_builder.get_trajectory_builder(trajectory_id)
        local = collated._wrapped._local_trajectory_builder
        collated.add_sensor_data = self.span("facade", collated.add_sensor_data)
        local.add_range_data = self.span("local_slam", local.add_range_data)
        pg = map_builder.pose_graph
        pg._run_pending = self.span("drain", pg._run_pending)
        pg.run_optimization = self.span("solve", pg.run_optimization)
        self._wrap_accumulated(local)
        self._wrap_match(local._ceres_scan_matcher)
        self._wrap_insert(local._active_submaps)
        self._wrap_solve()
        self.local = local

    def begin(self) -> None:
        """Open the window's captures: from here on the extrapolator's
        per-point poses are kept for each accumulation (the first one in
        the window, which began before, is left out of that check)."""
        extrapolator = self.local._extrapolator
        batch = extrapolator.extrapolate_poses_batch

        def wrapped(times):
            poses = batch(times)
            if self._batches is not None:
                self._batches.append((np.array(times, np.float64), np.array(poses, np.float64)))
            return poses
        extrapolator.extrapolate_poses_batch = wrapped
        self.recording = True

    def _wrap_accumulated(self, local) -> None:
        """What the stages before the scan match gave it: each
        accumulation's per-point poses, the gravity alignment, and the
        voxel-filtered returns in the gravity-aligned frame."""
        accumulated = local._add_accumulated_range_data

        def wrapped(time, range_data, gravity_alignment):
            batches, self._batches = self._batches, ([] if self.recording else None)
            self._upstream = {
                "time": float(time), "batches": batches,
                "gravity": np.array(gravity_alignment, np.float64),
                "returns": np.array(range_data.returns.points, np.float32)}
            return accumulated(time, range_data, gravity_alignment)
        local._add_accumulated_range_data = wrapped

    def _wrap_match(self, matcher) -> None:
        match = matcher.match

        def wrapped(*args, **kwargs):
            take = self._take("matches")
            out = match(*args, **kwargs)
            if take:
                self.matches.append({"args": args, "kwargs": kwargs, "out": out,
                                     "upstream": self._upstream})
            return out
        matcher.match = wrapped

    def _wrap_insert(self, active) -> None:
        insert = active._insert

        def wrapped2(range_data):
            take = self._take("insertions")
            before = [s.grid for s in active._submaps]
            insert(range_data)
            if take:
                self.insertions.append({"range_data": range_data, "before": before,
                                        "after": [s.grid for s in active._submaps]})
        active._insert = wrapped2

    def _wrap_solve(self) -> None:
        from cartographer_tpu_torch.mapping import optimization_problem_2d as op

        solve = op.solve
        probe = self

        def wrapped(problem, *args, **kwargs):
            out = solve(problem, *args, **kwargs)
            if probe.recording:
                with probe._lock:
                    probe.solves.append({"problem": problem, "args": args,
                                         "kwargs": kwargs, "out": out})
            return out
        op.solve = wrapped
        self._restore_solve = (op, solve)

    def detach(self) -> None:
        restore = getattr(self, "_restore_solve", None)
        if restore is not None:
            restore[0].solve = restore[1]


def build(config: dict, device, on_result):
    """MapBuilder and one trajectory from the configuration's options;
    `on_result(time)` is called from the local SLAM result callback."""
    from cartographer_tpu_torch.common.config import MapBuilderOptions, TrajectoryBuilderOptions
    from cartographer_tpu_torch.mapping.map_builder import MapBuilder

    options = MapBuilderOptions.from_dict(config["map_builder"])
    trajectory = TrajectoryBuilderOptions.from_dict(config["trajectory_builder"])
    mb = MapBuilder(options, device=device)
    sensors = {s["id"] for s in config["range_sensors"]} | {"imu"}

    def callback(trajectory_id, t, local_pose, range_data, insertion):
        on_result(t, local_pose)

    tid = mb.add_trajectory_builder(sensors, trajectory, callback)
    return mb, tid


class Feeder:
    """Feeds a stream into the trajectory and records when each
    revolution's result came back (`done[k]`, perf_counter seconds)."""

    def __init__(self, stream, builder):
        self.stream = stream
        self.builder = builder
        self.next_event = 0
        self.next_rev = 0
        self.done = np.full(len(stream.rev_time), np.nan)
        self.poses: Dict[int, np.ndarray] = {}
        self._rev_of_time = {float(t): k for k, t in enumerate(stream.rev_time)}

    def on_result(self, t, local_pose) -> None:
        k = self._rev_of_time[float(t)]
        self.done[k] = time.perf_counter()
        self.poses[k] = np.asarray(local_pose, np.float64)

    def feed_revolution(self) -> int:
        """Feed every event up to and including the next revolution's last
        range message; returns that revolution's index."""
        k = self.next_rev
        if k >= len(self.stream.rev_last_event):
            raise RuntimeError(
                f"the stream's {k} revolutions are used up: the run needs more "
                "than the cell's file provides for (no revolution is reused)")
        last = int(self.stream.rev_last_event[k])
        events, add = self.stream.events, self.builder.add_sensor_data
        for i in range(self.next_event, last + 1):
            sensor_id, payload = events[i]
            add(sensor_id, payload)
        self.next_event = last + 1
        self.next_rev = k + 1
        return k


def warm_up(feeder: Feeder, local, max_revolutions: int, until: str) -> int:
    """Closed-loop feed to local SLAM's steady state: until the trajectory
    holds its two active submaps (`until` = "two_active_submaps") or, in
    cells whose window sees the pose graph's loop-closure drains, until
    the first submap has finished as well ("first_finished_submap"), so
    that the drains against finished submaps run through the whole window
    and their shapes are warm. Returns the revolutions fed."""
    def active():
        return local._active_submaps.submaps()

    finished = False
    while True:
        submaps = active()
        finished = finished or any(s.insertion_finished for s in submaps)
        if len(submaps) >= 2 and (until == "two_active_submaps" or finished):
            return feeder.next_rev
        if feeder.next_rev >= max_revolutions:
            raise RuntimeError(
                f"warm-up fed {feeder.next_rev} revolutions without reaching {until}")
        feeder.feed_revolution()


def closed_loop(feeder: Feeder, seconds: float) -> dict:
    """Bag replay as fast as results come back: the window opens now and
    closes after `seconds`; the revolutions fed in it are awaited after."""
    t0 = time.perf_counter()
    first = feeder.next_rev
    end = t0 + seconds
    while time.perf_counter() < end:
        feeder.feed_revolution()
    fed = list(range(first, feeder.next_rev))
    return {"t0": t0, "t1": end, "due": fed}


def flush(feeder: Feeder, revolutions: List[int], max_extra: int = 8) -> None:
    """Feed up to `max_extra` more revolutions until every one of
    `revolutions` has its result (a result can wait on the next IMU
    message in the collator)."""
    for _ in range(max_extra):
        if all(not np.isnan(feeder.done[k]) for k in revolutions):
            return
        if feeder.next_rev >= len(feeder.stream.rev_last_event):
            return
        feeder.feed_revolution()


def settle(map_builder, timeout_s: float = 120.0) -> None:
    """Wait for the pose graph's drain in flight, if any, to finish."""
    from cartographer_tpu_torch.common.task import TaskState

    pg = map_builder.pose_graph
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        task = getattr(pg, "_pending_task", None)
        if task is None or task.state == TaskState.COMPLETED:
            return
        task.wait(timeout=1.0)
    raise RuntimeError(f"the pose graph's drain did not finish in {timeout_s} s")
