"""The harness on the CPU: the generator, the rate arithmetic, finding a
cell and its configuration's kind by their files, kinds planted as new
files alone (a 3D one; one on the chunked 2D frontend, whose `drain`
hands over the scans its last chunk holds; one whose `build` loads a
frozen map first), and what the benchmark's modules import.

    python -m pytest slam_bench/tests -q
"""

import ast
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from slam_bench import layers, registry

BENCH = Path(registry.HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "cartographer_tpu"}


def config(name):
    return registry.load_json(BENCH / "configs" / f"{name}.json")


def generate(name, revolutions, seed):
    return registry.harness(config(name)).generate(config(name), revolutions, seed, "cpu")


def range_points(stream, k):
    return [p.ranges.points for s, p in stream.events if s != "imu"][k]


def test_generator_same_seed_same_stream():
    seed = 2**31 + 5
    a = generate("backpack_2d", 12, seed)
    b = generate("backpack_2d", 12, seed)
    c = generate("backpack_2d", 12, seed + 1)
    assert len(a.events) == len(b.events) == len(c.events)
    assert np.array_equal(a.rev_time, c.rev_time)
    for k in (0, len(a.rev_time) - 1):
        assert np.array_equal(range_points(a, k), range_points(b, k))
        assert not np.array_equal(range_points(a, k), range_points(c, k))
    imu_a = [p.angular_velocity for s, p in a.events if s == "imu"]
    imu_b = [p.angular_velocity for s, p in b.events if s == "imu"]
    assert np.array_equal(np.stack(imu_a), np.stack(imu_b))


def test_generator_sensor_shapes():
    s2 = generate("backpack_2d", 4, 3)
    per_rev = [sum(len(p.ranges.points) for s, p in s2.events[: s2.rev_last_event[0] + 1]
                   if s == "range")]
    assert per_rev[0] <= 1081 and s2.points_per_rev > 1000
    subdivisions = [s for s, _ in s2.events[: s2.rev_last_event[0] + 1] if s == "range"]
    assert len(subdivisions) == 10
    # The generator's own copy holds what the messages carry.
    sent = [p.ranges.points for s, p in s2.events[: s2.rev_last_event[0] + 1] if s == "range"]
    planar = registry.harness(config("backpack_2d"))
    kept = planar.subdivisions(*(a[0] for a in s2.raw[0]), config("backpack_2d")["range_sensors"][0])
    assert all(np.array_equal(p, q) for p, (q, _) in zip(sent, kept))


def record(done, t0=10.0, t1=20.0):
    done = np.asarray(done, np.float64)
    due = list(range(len(done)))
    return {"t0": t0, "t1": t1, "done": done, "due": due, "done_of_due": done[due],
            "spans": [], "device_events": []}


def test_rate_counts_results_inside_the_window():
    r = record([9.9, 10.0, 12.0, 19.99, 20.0, np.nan])
    assert layers.completed_in_window(r) == 3
    assert layers.rate(r) == pytest.approx(0.3)


def test_new_cell_file_is_found_without_editing(tmp_path):
    """A cell, its mix and a metric added as new files (and entries in
    BENCHMARK.json) are found by name; no existing file is edited."""
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "backpack_2d.slow_walk", "config": "backpack_2d",
                               "traffic": "slow_walk", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "test_metric", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "facade",
                               "moves": "scans_per_s", "workloads": ["backpack_2d.slow_walk"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    base = tmp_path / BENCH.name
    (base / "mixes" / "slow_walk.json").write_text(json.dumps({"loop": "closed"}))
    cell = json.loads((base / "cells" / "backpack_2d.replay.json").read_text())
    cell["traffic"] = "slow_walk"
    (base / "cells" / "backpack_2d.slow_walk.json").write_text(json.dumps(cell))
    (base / "metrics" / "test_metric.py").write_text("def read(record):\n    return 42.0\n")

    spec = registry.workload("backpack_2d.slow_walk", tmp_path)
    assert spec["mix"] == {"loop": "closed"}
    assert spec["config"]["name"] == "backpack_2d"
    names = [m["name"] for m in registry.metrics_for("backpack_2d.slow_walk", True, tmp_path)]
    assert "test_metric" in names and "roofline.lm_match_2d" not in names
    assert registry.reader("test_metric", tmp_path)({}) == 42.0
    e2e = [m["name"] for m in registry.metrics_for("backpack_2d.slow_walk", False, tmp_path)]
    assert e2e == ["setup_s"]


def test_every_cell_and_metric_has_its_files():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        spec = registry.workload(w["name"])
        assert spec["cell"]["config"] == w["config"] and spec["cell"]["traffic"] == w["traffic"]
        kind = registry.harness(spec["config"])
        assert all(callable(getattr(kind, f)) for f in ("generate", "Probe", "compare"))
        assert kind.drift is None or callable(kind.drift)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.reader(m["name"]))


def test_the_shared_files_name_no_kind():
    """What is 2D is reached through harness/planar_2d.py alone."""
    for name in ("run.py", "drive.py", "check.py", "trace.py"):
        text = (BENCH / name).read_text()
        assert "_2d" not in text and "2D" not in text, name


def imported_top_levels(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        found = set(imported_top_levels(path)) & FORBIDDEN
        assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "numpy", "torch"}
    for path in (BENCH / "reference").glob("*.py"):
        names = set(imported_top_levels(path))
        assert names <= allowed, f"{path} imports {names - allowed}"
    code = ("import sys, slam_bench.reference.lm_2d, slam_bench.reference.insert_2d, "
            "slam_bench.reference.spa_2d, slam_bench.reference.frontend_2d; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'cartographer_tpu_torch', 'cartographer_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


STUB_3D_STREAM = '''"""A 3D kind planted by the test: a 16-ring cloud in a box room."""

import math

import numpy as np
import torch

from slam_bench import world


def generate(config, num_revolutions, seed, device):
    from cartographer_tpu_torch.sensor.data import TimedPointCloud, TimedPointCloudData

    hall, sensor = config["world"], config["range_sensors"][0]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    f64 = dict(dtype=torch.float64, device=device)
    rev_s = 1.0 / sensor["rate_hz"]
    lo = torch.tensor([-hall["half_width"] - 5.0, -hall["half_height"] - 5.0, -1.0], **f64)
    hi = torch.tensor([hall["half_width"] + 5.0, hall["half_height"] + 5.0, 3.0], **f64)
    azimuths = sensor["azimuths"]
    az = torch.arange(azimuths, **f64) * (2.0 * math.pi / azimuths)
    el = torch.deg2rad(torch.linspace(-15.0, 15.0, sensor["rings"], **f64))
    az, el = (g.reshape(-1) for g in torch.meshgrid(az, el, indexing="ij"))
    ray_dt = ((torch.arange(azimuths, **f64) + 1.0) / azimuths - 1.0) * rev_s
    ray_dt = ray_dt.repeat_interleave(sensor["rings"])
    direction = torch.stack([el.cos() * az.cos(), el.cos() * az.sin(), el.sin()], -1)
    end = world.START_TIME + (torch.arange(num_revolutions, **f64) + 1.0) * rev_s
    x, y, yaw, _, _, _ = world.path_state(end[:, None] + ray_dt[None], hall)
    c, s = yaw.cos()[..., None], yaw.sin()[..., None]
    dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
    d = torch.stack([c[..., 0] * dx - s[..., 0] * dy, s[..., 0] * dx + c[..., 0] * dy,
                     dz.expand_as(x)], -1)
    o = torch.stack([x, y, torch.zeros_like(x)], -1)
    safe = torch.where(d.abs() > 1e-9, d, torch.full_like(d, 1e-9))
    reach = torch.where(safe > 0, (hi - o) / safe, (lo - o) / safe).min(-1).values
    reach = reach + sensor["range_noise_m"] * torch.randn(reach.shape, generator=gen, **f64)
    points = (direction[None] * reach[..., None]).to(torch.float32).cpu().numpy()
    rel = ray_dt.to(torch.float32).expand(reach.shape).cpu().numpy()
    msgs = [(float(end[k]), 1, sensor["id"], TimedPointCloudData(
        time=float(end[k]), origin=np.zeros(3, np.float32),
        ranges=TimedPointCloud(points=points[k], times=rel[k])), k)
        for k in range(num_revolutions)]
    msgs += world.imu_messages(config, num_revolutions, rev_s, gen, device)
    return world.stream(config, num_revolutions, rev_s, msgs, [(points, rel)])

'''

COUNTING_PROBE = '''

class Probe:
    """Counts the window's range data on the local builder, names its
    class, and lists the trajectories that the pose graph holds frozen."""

    def __init__(self, rng, sample, spans):
        self.recording = False
        self.spans = []
        self.local = None
        self.range_data = 0

    def attach(self, map_builder, trajectory_id):
        local = map_builder.get_trajectory_builder(trajectory_id)._wrapped._local_trajectory_builder
        add = local.add_range_data

        def counted(*args, **kwargs):
            self.range_data += self.recording
            return add(*args, **kwargs)
        local.add_range_data = counted
        self.local = local
        self.builder = type(local).__name__
        self.frozen = [t for t in range(trajectory_id)
                       if map_builder.pose_graph.is_trajectory_frozen(t)]

    def begin(self):
        self.recording = True

    def detach(self):
        pass

    def counts(self):
        return {"local_builder": self.builder, "range_data": self.range_data,
                "frozen": self.frozen}


def compare(probe, config, stream, missing, control=False):
    return {"results_missing": missing}


drift = None
'''
STUB_3D = STUB_3D_STREAM + COUNTING_PROBE


def plant(root, kind, kind_text, config, cell):
    """A checkout at `root` with a kind, its configuration, a cell of it
    and a closed-loop mix added as new files, and the cell's entry in
    BENCHMARK.json; returns the cell's name and the bytes of every
    benchmark file that was there before."""
    shutil.copytree(BENCH, root / BENCH.name,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(registry.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    base = root / BENCH.name
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    name = config["name"]
    config = {**config, "harness": kind}
    (base / "configs" / f"{name}.json").write_text(json.dumps(config))
    (base / "harness" / f"{kind}.py").write_text(kind_text)
    (base / "mixes" / "stub_replay.json").write_text(json.dumps({"loop": "closed"}))
    (base / "cells" / f"{name}.stub_replay.json").write_text(json.dumps({
        "config": name, "traffic": "stub_replay", "expected_revolutions_per_s": 40.0,
        "scan_factor": 3, "warmup_until": "two_active_submaps", "sample": {},
        "limits": {"results_missing": 0}, **cell}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": f"{name}.stub_replay", "config": name,
                               "traffic": "stub_replay", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return f"{name}.stub_replay", before


def test_a_kind_is_planted_as_new_files(tmp_path):
    """A 3D configuration whose sensors, probe and checks differ from the
    planar kind's runs to a result through the 3D MapBuilder from new
    files alone: its kind, configuration, cell, mix and BENCHMARK.json
    entry. Every file of the benchmark's that was there keeps its bytes."""
    from slam_bench import run

    config = {
        "name": "stub_3d",
        "range_sensors": [{"id": "range", "rings": 16, "azimuths": 64, "rate_hz": 10.0,
                           "range_noise_m": 0.01}],
        "imu": {"rate_hz": 100.0, "gyro_noise": 0.001, "accel_noise": 0.02},
        "world": {"half_width": 8.0, "half_height": 6.0, "lap_s": 60.0},
        "map_builder": {"use_trajectory_builder_2d": False, "use_trajectory_builder_3d": True,
                        "pose_graph": {"optimize_every_n_nodes": 0,
                                       "constraint_builder": {"sampling_ratio": 0.0}}},
        "trajectory_builder": {"trajectory_builder_3d": {
            "motion_filter": {"max_time_seconds": 0.0},
            "submaps": {"num_range_data": 2, "high_resolution_grid_size": 128,
                        "low_resolution_grid_size": 64}}},
    }
    cell, before = plant(tmp_path, "stub_3d", STUB_3D, config, {"warmup_revolutions_max": 20})

    result = run.measure(cell, 2**31 + 7, 0.5, False, device="cpu", root=tmp_path)
    assert result["correct"] is True, result["compared"]
    assert result["compared"] == {"results_missing": {"value": 0, "limit": 0}}
    assert result["sample"]["local_builder"] == "LocalTrajectoryBuilder3D"
    assert result["sample"]["range_data"] >= result["attempted"] > 0  # and the flush's
    assert set(result["metrics"]) == {"setup_s"}
    assert all(p.read_bytes() == data for p, data in before.items())


def small_planar(name):
    """backpack_2d at a size a CPU test holds: 256 x 256 grids, submaps of
    4 range data, every range data inserted, no loop-closure search and
    no optimization."""
    c = json.loads(json.dumps(config("backpack_2d")))
    c["name"] = name
    c["map_builder"]["pose_graph"]["optimize_every_n_nodes"] = 0
    c["map_builder"]["pose_graph"]["constraint_builder"]["sampling_ratio"] = 0.0
    tb2d = c["trajectory_builder"]["trajectory_builder_2d"]
    tb2d["submaps"]["num_range_data"] = 4
    tb2d["submaps"]["grid_options_2d"]["grid_size"] = 256
    tb2d["motion_filter"]["max_time_seconds"] = 0.0
    return c


STUB_CHUNKED = '''"""A kind planted by the test: the planar stream in one subdivision, on
the chunked 2D frontend, which holds scans until its chunk is full."""

from pathlib import Path

from slam_bench import registry

generate = registry.harness({}, Path(__file__).resolve().parents[2]).generate


def warmed_up(local, until):
    submaps = local._submaps
    finished = any(s.insertion_finished for s in submaps)
    return len(submaps) >= 2 and (until == "two_active_submaps" or finished)
'''

DRAIN_BY_FINISHING = '''

def drain(map_builder, trajectory_id):
    map_builder.finish_trajectory(trajectory_id)
'''

WINDOW_REVOLUTIONS = 20


@pytest.mark.parametrize("with_drain", [True, False], ids=["drain", "no_drain"])
def test_a_chunked_kind_drains_its_last_chunk(tmp_path, monkeypatch, with_drain):
    """On the chunked 2D frontend (chunks of 32 scans) a window of 20
    revolutions, with the flush's 8 more, ends inside a chunk: the kind's
    `drain` finishes the trajectory and every due revolution has its
    result; without `drain` the chunk's held scans come out missing."""
    from slam_bench import drive, run

    config = small_planar("stub_chunked_2d")
    config["range_sensors"][0]["subdivisions"] = 1
    config["trajectory_builder"]["use_chunked_device_frontend"] = True
    config["trajectory_builder"]["device_frontend_chunk_size"] = 32
    config["trajectory_builder"]["trajectory_builder_2d"]["num_accumulated_range_data"] = 1
    text = STUB_CHUNKED + (DRAIN_BY_FINISHING if with_drain else "") + COUNTING_PROBE
    cell, _ = plant(tmp_path, "stub_chunked_2d", text, config, {"warmup_revolutions_max": 80})

    def fixed_window(feeder, seconds):
        t0 = time.perf_counter()
        first = feeder.next_rev
        for _ in range(WINDOW_REVOLUTIONS):
            feeder.feed_revolution()
        return {"t0": t0, "t1": time.perf_counter(), "due": list(range(first, feeder.next_rev))}

    monkeypatch.setattr(drive, "closed_loop", fixed_window)
    result = run.measure(cell, 2**31 + 13, 0.5, False, device="cpu", root=tmp_path)
    assert result["sample"]["local_builder"] == "ChunkedLocalTrajectoryBuilder2D"
    assert result["attempted"] == WINDOW_REVOLUTIONS
    missing = result["compared"]["results_missing"]["value"]
    if with_drain:
        assert result["correct"] is True and missing == 0, result["compared"]
    else:
        assert result["correct"] is False and missing > 0, result["compared"]


STUB_FROZEN_MAP = '''"""A kind planted by the test: the planar kind's stream on the per-scan 2D
builder, driven in a MapBuilder that first loads a frozen map."""

from pathlib import Path

from slam_bench import drive, registry

generate = registry.harness({}, Path(__file__).resolve().parents[2]).generate


def build(config, device, on_result):
    """Map the configuration's `map_revolutions` in one MapBuilder, load
    its state frozen into a fresh one, and only then add the trajectory
    the window drives."""
    from cartographer_tpu_torch.common.config import MapBuilderOptions, TrajectoryBuilderOptions
    from cartographer_tpu_torch.mapping.map_builder import MapBuilder

    mapper, mapped = drive.build(config, device, lambda t, pose: None)
    builder = mapper.get_trajectory_builder(mapped)
    for sensor_id, payload in generate(config, config["map_revolutions"], 0, device).events:
        builder.add_sensor_data(sensor_id, payload)
    mapper.finish_trajectory(mapped)
    state = mapper.serialize_state()
    mapper.shutdown()

    mb = MapBuilder(MapBuilderOptions.from_dict(config["map_builder"]), device=device)
    mb.load_state(state, load_frozen_state=True)
    sensors = {s["id"] for s in config["range_sensors"]} | {"imu"}
    trajectory = TrajectoryBuilderOptions.from_dict(config["trajectory_builder"])
    tid = mb.add_trajectory_builder(
        sensors, trajectory, lambda _, t, local_pose, *rest: on_result(t, local_pose))
    return mb, tid
'''


def test_a_kind_builds_on_a_frozen_map(tmp_path):
    """A kind's `build` loads a mapped state frozen before it adds the
    trajectory the window drives; the run reaches its result."""
    from slam_bench import run

    config = {**small_planar("stub_frozen_2d"), "map_revolutions": 12}
    cell, _ = plant(tmp_path, "stub_frozen_2d", STUB_FROZEN_MAP + COUNTING_PROBE, config,
                    {"warmup_revolutions_max": 20})
    result = run.measure(cell, 2**31 + 17, 0.5, False, device="cpu", root=tmp_path)
    assert result["sample"]["frozen"] == [0]
    assert result["sample"]["local_builder"] == "LocalTrajectoryBuilder2D"
    assert result["correct"] is True, result["compared"]
    assert result["attempted"] > 0
