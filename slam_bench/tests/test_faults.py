"""A whole run on the CPU, past the look for a card, with the timed path
broken underneath, at a size a test run holds (submaps of 4 range data):
`correct` has to come out false for each fault a cell can have, and true
with none.

- a step that returns its state unchanged: the insertion leaves the grid
  as it was; the scan match returns the prediction;
- half of the batch left out: half of each subdivision's points dropped
  by the range data collator; five of a revolution's ten subdivisions
  accumulated; half of the rays not inserted; half of the points left
  out of the scan match, its cost normalised over the rest;
- an answer altered where it is produced: the matched pose moved 1 cm,
  or turned 5 mrad;
  the SPA solve's poses moved 1 cm.

There is no exchange between chips: every cell takes one chip.

    python -m pytest slam_bench/tests/test_faults.py -q
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from slam_bench import registry, run

BENCH = Path(registry.HERE)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout with the small test cells beside the real ones."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(BENCH, root / BENCH.name, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = registry.benchmark()
    base = root / BENCH.name
    config = registry.load_json(base / "configs" / "backpack_2d.json")
    config["trajectory_builder"]["trajectory_builder_2d"]["submaps"]["num_range_data"] = 4
    config["map_builder"]["pose_graph"]["optimize_every_n_nodes"] = 4
    config["name"] = "small_2d"
    (base / "configs" / "small_2d.json").write_text(json.dumps(config))
    cell = registry.load_json(base / "cells" / "backpack_2d.replay.json")
    cell.update(config="small_2d", warmup_revolutions_max=400,
                sample={"matches": 1.0, "insertions": 1.0})
    (base / "cells" / "small_2d.replay.json").write_text(json.dumps(cell))
    bench["workloads"].append({"name": "small_2d.replay", "config": "small_2d",
                               "traffic": "replay", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def drive(root, plant=None):
    torch.manual_seed(0)
    return run.measure("small_2d.replay", 2**31 + 11, 3.0, False, device="cpu",
                       root=root, plant=plant)


def patch(monkeypatch, module, name, make):
    original = getattr(module, name)

    def plant(probe):
        monkeypatch.setattr(module, name, make(original))
    return plant


def half(mask):
    mask = mask.clone()
    n = mask.shape[-1]
    mask[..., n // 2:] = False
    return mask


class _KeepHalfOfTen:
    """numpy, but a concatenation of a revolution's ten subdivisions keeps
    every other one."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def concatenate(arrays, *a, **k):
        if isinstance(arrays, list) and len(arrays) == 10:
            arrays = arrays[::2]
        return np.concatenate(arrays, *a, **k)


def faults_2d():
    from cartographer_tpu_torch.mapping import local_trajectory_builder_2d as ltb
    from cartographer_tpu_torch.mapping import range_data_collator as rdc
    from cartographer_tpu_torch.ops import raycast_2d, spa_solver
    from cartographer_tpu_torch.ops.scan_matching import gauss_newton_2d as gn

    def collate_half(f):
        def g(self):
            out = f(self)
            keep = np.arange(len(out.points)) < (len(out.points) + 1) // 2
            for field in ("points", "times", "origin_index", "intensities"):
                setattr(out, field, getattr(out, field)[keep])
            return out
        return g

    def accumulate_half(f):
        return _KeepHalfOfTen()

    def insert_unchanged(f):
        return lambda log_odds, known, *a, **k: (log_odds, known)

    def insert_half(f):
        return lambda lo, kn, oc, ec, hit, valid, *a, **k: f(lo, kn, oc, ec, hit, half(valid), *a, **k)

    def match_unchanged(f):
        return lambda lo, kn, org, initial, *a, **k: (initial.clone(), torch.zeros(()))

    def match_half(f):
        return lambda lo, kn, org, ini, tgt, pts, mask, *a, **k: f(lo, kn, org, ini, tgt, pts, half(mask), *a, **k)

    def match_altered(f):
        def g(*a, **k):
            pose, cost = f(*a, **k)
            return pose + torch.tensor([0.01, 0.0, 0.0]), cost
        return g

    def match_turned(f):
        def g(*a, **k):
            pose, cost = f(*a, **k)
            return pose + torch.tensor([0.0, 0.0, 0.005], dtype=pose.dtype), cost
        return g

    def spa_altered(f):
        def g(self, x):
            return f(self, x + torch.tensor([0.01, 0.0, 0.0], dtype=x.dtype, device=x.device))
        return g

    return {
        "match_turned": (gn, "match_log_odds", match_turned),
        "spa_altered": (spa_solver._Layout, "split", spa_altered),
        "collate_half_points": (rdc.RangeDataCollator, "_crop_and_merge", collate_half),
        "accumulate_half_subdivisions": (ltb, "np", accumulate_half),
        "insert_unchanged": (raycast_2d, "insert_scan", insert_unchanged),
        "insert_half_rays": (raycast_2d, "insert_scan", insert_half),
        "match_unchanged": (gn, "match_log_odds", match_unchanged),
        "match_half_points": (gn, "match_log_odds", match_half),
        "match_altered": (gn, "match_log_odds", match_altered),
    }


def test_sound_run_is_correct(root):
    result = drive(root)
    assert result["correct"], result["compared"]
    sample = result["sample"]
    assert sample["matches"] > 0 and sample["insertions"] > 0 and sample["upstream"] > 0
    assert sample["solves"] > 0


@pytest.mark.parametrize("fault", ["collate_half_points", "accumulate_half_subdivisions",
                                   "insert_unchanged", "insert_half_rays", "match_unchanged",
                                   "match_half_points", "match_altered", "match_turned",
                                   "spa_altered"])
def test_fault_comes_out_not_correct(root, fault, monkeypatch):
    module, name, make = faults_2d()[fault]
    result = drive(root, plant=patch(monkeypatch, module, name, make))
    assert not result["correct"], result["compared"]
