"""Drive the port's `MapBuilder` with a generated stream.

The entry the window drives is `MapBuilder`'s trajectory builder
(`add_sensor_data`), built by `add_trajectory_builder` with a
`local_slam_result_callback`; the asynchronous pose graph runs beside it
on its thread pool. What wraps the trajectory's own instances, to sample
what the correctness check compares and to record the benchmark's spans,
is the configuration's kind's `Probe` (`harness/<kind>.py`); what is here
serves every kind.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np


def build(config: dict, device, on_result):
    """MapBuilder and one trajectory from the configuration's options;
    `on_result(time, local_pose)` is called from the local SLAM result
    callback. The default of a kind's `build`."""
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


def warmed_up(local, until: str) -> bool:
    """Whether local SLAM has reached its steady state: the trajectory
    holds its two active submaps (`until` = "two_active_submaps") or, in
    cells whose window sees the pose graph's loop-closure drains, the
    first submap has finished as well ("first_finished_submap"), so that
    the drains against finished submaps run through the whole window and
    their shapes are warm. A finished submap stays active until the next
    insertion, which a check after every revolution sees. The default of a
    kind's `warmed_up`."""
    submaps = local._active_submaps.submaps()
    finished = any(s.insertion_finished for s in submaps)
    return len(submaps) >= 2 and (until == "two_active_submaps" or finished)


def warm_up(feeder: Feeder, local, max_revolutions: int, until: str,
            steady=warmed_up) -> int:
    """Closed-loop feed, a revolution at a time, until `steady(local,
    until)` holds (the kind's `warmed_up`). Returns the revolutions fed."""
    while not steady(local, until):
        if feeder.next_rev >= max_revolutions:
            raise RuntimeError(
                f"warm-up fed {feeder.next_rev} revolutions without reaching {until}")
        feeder.feed_revolution()
    return feeder.next_rev


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


def drain(map_builder, trajectory_id: int) -> None:
    """The default of a kind's `drain`: nothing, since the per-scan
    builders hold no revolution back once its next messages are in."""


def flush(feeder: Feeder, revolutions: List[int], drain_held=lambda: None,
          max_extra: int = 8) -> None:
    """Feed up to `max_extra` more revolutions until every one of
    `revolutions` has its result (a result can wait on the next IMU
    message in the collator); where some still has none, call
    `drain_held()` (the kind's `drain`), which hands over what the local
    builder holds back."""
    def pending():
        return any(np.isnan(feeder.done[k]) for k in revolutions)

    for _ in range(max_extra):
        if not pending() or feeder.next_rev >= len(feeder.stream.rev_last_event):
            break
        feeder.feed_revolution()
    if pending():
        drain_held()


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
