"""The harness on the CPU: the generator, the rate arithmetic, the
plain SPA reference, finding a cell by its files, and what the
benchmark's modules import.

    python -m pytest slam_bench/tests -q
"""

import ast
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from slam_bench import layers, registry, world

BENCH = Path(registry.HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "cartographer_tpu"}


def config(name):
    return registry.load_json(BENCH / "configs" / f"{name}.json")


def range_points(stream, k):
    return [p.ranges.points for s, p in stream.events if s != "imu"][k]


def test_generator_same_seed_same_stream():
    seed = 2**31 + 5
    a = world.generate(config("backpack_2d"), 12, seed, "cpu")
    b = world.generate(config("backpack_2d"), 12, seed, "cpu")
    c = world.generate(config("backpack_2d"), 12, seed + 1, "cpu")
    assert len(a.events) == len(b.events) == len(c.events)
    assert np.array_equal(a.rev_time, c.rev_time)
    for k in (0, len(a.rev_time) - 1):
        assert np.array_equal(range_points(a, k), range_points(b, k))
        assert not np.array_equal(range_points(a, k), range_points(c, k))
    imu_a = [p.angular_velocity for s, p in a.events if s == "imu"]
    imu_b = [p.angular_velocity for s, p in b.events if s == "imu"]
    assert np.array_equal(np.stack(imu_a), np.stack(imu_b))


def test_generator_sensor_shapes():
    s2 = world.generate(config("backpack_2d"), 4, 3, "cpu")
    per_rev = [sum(len(p.ranges.points) for s, p in s2.events[: s2.rev_last_event[0] + 1]
                   if s == "range")]
    assert per_rev[0] <= 1081 and s2.points_per_rev > 1000
    subdivisions = [s for s, _ in s2.events[: s2.rev_last_event[0] + 1] if s == "range"]
    assert len(subdivisions) == 10
    # The generator's own copy holds what the messages carry.
    sent = [p.ranges.points for s, p in s2.events[: s2.rev_last_event[0] + 1] if s == "range"]
    kept = world.subdivisions(*(a[0] for a in s2.raw[0]), config("backpack_2d")["range_sensors"][0])
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
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.reader(m["name"]))


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
