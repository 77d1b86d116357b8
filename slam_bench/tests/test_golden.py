"""The planar 2D kind held to numbers recorded before its code moved
behind `harness/planar_2d.py`: at `test_faults.py`'s small cell, for
seeds 0 and 1, the stream's events hash alike, and every number that the
kind's `compare` gives, for the program and for the control, equals its
recorded value exactly.

Two things differ from that cell so that a run repeats exactly: the pose
graph drains synchronously (an asynchronous drain takes whatever is
pending when it starts, so the SPA problem would follow the host's
timing), and the window feeds a fixed 40 revolutions in place of a timed
one (the sample is drawn per call). Torch runs on 4 threads, as when the
values were recorded.

    python -m pytest slam_bench/tests/test_golden.py -q
"""

import hashlib
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from slam_bench import drive, registry, run

BENCH = Path(registry.HERE)
GOLDEN = registry.load_json(Path(__file__).with_name("golden_planar_2d.json"))
SECONDS = 0.1
WINDOW_REVOLUTIONS = 40
THREADS = 4


def make_root(root: Path) -> Path:
    """A checkout with the small synchronous cell beside the real ones."""
    shutil.copytree(BENCH, root / BENCH.name, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = registry.benchmark()
    base = root / BENCH.name
    config = registry.load_json(base / "configs" / "backpack_2d.json")
    config["trajectory_builder"]["trajectory_builder_2d"]["submaps"]["num_range_data"] = 4
    config["map_builder"]["pose_graph"]["optimize_every_n_nodes"] = 4
    config["map_builder"]["async_pose_graph"] = False
    config["name"] = "golden_2d"
    (base / "configs" / "golden_2d.json").write_text(json.dumps(config))
    cell = registry.load_json(base / "cells" / "backpack_2d.replay.json")
    cell.update(config="golden_2d", warmup_revolutions_max=400,
                sample={"matches": 1.0, "insertions": 1.0})
    (base / "cells" / "golden_2d.replay.json").write_text(json.dumps(cell))
    bench["workloads"].append({"name": "golden_2d.replay", "config": "golden_2d",
                               "traffic": "replay", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def fixed_window(feeder, seconds):
    t0 = time.perf_counter()
    first = feeder.next_rev
    for _ in range(WINDOW_REVOLUTIONS):
        feeder.feed_revolution()
    return {"t0": t0, "t1": time.perf_counter(), "due": list(range(first, feeder.next_rev))}


def stream_hash(stream) -> str:
    """SHA-256 over every event's sensor, time and arrays, in order."""
    h = hashlib.sha256()
    for sensor_id, p in stream.events:
        h.update(sensor_id.encode())
        h.update(np.float64(p.time).tobytes())
        if sensor_id == "imu":
            arrays = (p.linear_acceleration, p.angular_velocity)
        else:
            arrays = (p.origin, p.ranges.points, p.ranges.times)
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def golden_run(root: Path, seed: int) -> dict:
    """The stream's hash, and every compared and recorded number of the
    program and of the control."""
    spec = registry.workload("golden_2d.replay", root)
    kind = registry.harness(spec["config"], root)
    stream = kind.generate(spec["config"], run.revolutions_needed(spec["cell"], SECONDS), seed, "cpu")
    threads = torch.get_num_threads()
    loop = drive.closed_loop
    torch.set_num_threads(THREADS)
    drive.closed_loop = fixed_window
    try:
        torch.manual_seed(0)
        result = run.measure("golden_2d.replay", seed, SECONDS, False, device="cpu",
                             root=root, control=True)
    finally:
        drive.closed_loop = loop
        torch.set_num_threads(threads)
    numbers = {n: c["value"] for n, c in result["compared"].items()}
    numbers.update(result["recorded"])
    control = {n: v for n, v in result["control"].items() if n != "correct"}
    return {"stream": stream_hash(stream), "numbers": numbers, "control": control}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("seed", [0, 1])
def test_numbers_match_the_recorded_ones(root, seed):
    got = golden_run(root, seed)
    assert got == GOLDEN[str(seed)]
