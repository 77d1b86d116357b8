"""Finds each piece of a cell by name, in files of its own:

- the cell: `cells/<workload name>.json` (its configuration, traffic mix,
  stream sizes, correctness sample and limits);
- its configuration: `configs/<config>.json`;
- its traffic mix: `mixes/<traffic>.json`;
- its configuration's kind: `harness/<kind>.py`, where the configuration
  names its kind under `"harness"` (`planar_2d` where it names none);
- each metric's reader: `metrics/<metric name>.py`, a `read(record)`
  that returns a number, or None where it finds nothing to read;

and which metrics the cell reports, from `BENCHMARK.json` at the root of
the checkout. A new cell, configuration, kind, mix or metric is new files
and entries there; no file that exists changes.

A kind holds what depends on the configuration's sensors, captures and
reference; `run.measure` calls it wherever a run needs them:

- `generate(config, revolutions, seed, device) -> world.Stream`;
- `Probe(rng, sample, spans)`: `attach(map_builder, trajectory_id)`,
  `begin()` (the window's captures open), `detach()`; `local`, the local
  trajectory builder that `drive.warm_up` watches; `recording`, which the
  run clears when the window's revolutions are in; `spans`, the
  benchmark's own (name, start, end) spans in the traced run; and
  `counts()`, what it sampled, for the result's `sample`;
- `compare(probe, config, stream, missing, control=False) -> dict`:
  every number the cell compares or records (`check.judge`);
- `drift(poses, stream, revolutions)`, or None: a distance from the
  generator's truth, printed and never compared;
- optionally `record_launches(launches) -> [(module, name, original)]`:
  wraps the kernels whose launches its roofline readers read, while the
  traced run's `trace.DeviceTrace` runs.

Three more parts are optional; where a kind leaves one out, `run.measure`
takes the function of the same name in `drive.py`, which is what every
run did before a kind could bring its own:

- `build(config, device, on_result) -> (map_builder, trajectory_id)`,
  once, before the probe attaches: the `MapBuilder` and the trajectory the
  window drives, with `on_result(time, local_pose)` as its local SLAM
  result callback. `drive.build`: an empty `MapBuilder` and one
  trajectory from the configuration's options. A kind may load a frozen
  state first, or add other trajectories.
- `warmed_up(local, until) -> bool`, before the window, after each
  revolution that `drive.warm_up` feeds (and before the first): whether
  the probe's `local` builder has reached the cell's `warmup_until`.
  `drive.warmed_up`: the per-scan builders' `_active_submaps`.
- `drain(map_builder, trajectory_id)`, after the window, once, where
  `drive.flush`'s extra revolutions leave some revolution due in the
  window without its result; `drive.settle` then waits for the pose
  graph's drain in flight. `drive.drain` does nothing; a builder that
  holds scans back (a chunk not yet full) hands them over here, as
  `MapBuilder.finish_trajectory` does at a bag's end.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(name: str, root: Path = ROOT) -> dict:
    """The BENCHMARK.json entry, the cell's file, its configuration and
    its mix, by the workload's name."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    base = root / HERE.name
    cell = load_json(base / "cells" / f"{name}.json")
    config = load_json(base / "configs" / f"{entry['config']}.json")
    mix = load_json(base / "mixes" / f"{entry['traffic']}.json")
    return {"entry": entry, "cell": cell, "config": config, "mix": mix}


def metrics_for(name: str, trace: bool, root: Path = ROOT):
    """[(metric entry)] the cell reports: its end-to-end metrics with
    `trace` off, its per-layer metrics with it on. A metric without
    `workloads` belongs to every cell."""
    bench = benchmark(root)
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


DEFAULT_HARNESS = "planar_2d"


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str, root: Path = ROOT):
    """The `read` function of metrics/<metric>.py."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    return _load(f"slam_bench.metrics.{metric}", path).read


def harness(config: dict, root: Path = ROOT):
    """The module harness/<kind>.py of the configuration's kind."""
    kind = config.get("harness", DEFAULT_HARNESS)
    return _load(f"slam_bench.harness.{kind}", root / HERE.name / "harness" / f"{kind}.py")
