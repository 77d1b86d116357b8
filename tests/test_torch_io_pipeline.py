"""The port's offline IO modules against the JAX package on seeded inputs:
the points-processing pipeline (every stage, the files it writes byte for
byte), submap painting of port submaps, and floor detection."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.io import points_processor as jpp
from cartographer_tpu.io import submap_painter as jpaint
from cartographer_tpu.mapping import detect_floors as jfloors
from cartographer_tpu.mapping.grid_2d import Grid2D as JGrid2D
from cartographer_tpu.mapping.submap_2d import Submap2D as JSubmap2D
from cartographer_tpu_torch.io import points_processor as tpp
from cartographer_tpu_torch.io import submap_painter as tpaint
from cartographer_tpu_torch.mapping import detect_floors as tfloors
from cartographer_tpu_torch.mapping.submap_2d import submap_from_numpy
from cartographer_tpu_torch.transform import rigid3

# In a process that has loaded JAX, the first torch.exp has been seen to
# return values up to 1.4e-4 off (CPU, about 1 run in 12); later calls
# agree with numpy to an ulp. One call here, before any test, takes it.
torch.exp(torch.zeros(4096))

PIPELINE = [
    {"action": "fixed_ratio_sampler", "sampling_ratio": 0.9},
    {"action": "frame_id_filter", "drop_frames": ["camera"]},
    {"action": "min_max_range_filter", "min_range": 0.5, "max_range": 6.0},
    {"action": "vertical_range_filter", "min_z": -1.5, "max_z": 1.5},
    {"action": "voxel_filter_and_remove_moving_objects", "voxel_size": 0.2,
     "miss_per_hit_limit": 3.0},
    {"action": "intensity_to_color", "min_intensity": 0.0, "max_intensity": 50.0,
     "frame_id": "lidar"},
    {"action": "color_points", "color": [0.2, 0.4, 0.6], "frame_id": "lidar2"},
    {"action": "dump_num_points"},
    {"action": "write_xyz", "filename": "points.xyz"},
    {"action": "write_ply", "filename": "points.ply"},
    {"action": "write_pcd", "filename": "points.pcd"},
    {"action": "write_xray_image", "voxel_size": 0.1, "filename": "xray.png"},
    {"action": "write_probability_grid", "resolution": 0.1, "filename": "grid.png"},
    {"action": "write_hybrid_grid", "resolution": 0.1, "filename": "grid.npz"},
]


def run(pp, batches):
    files = {}

    def factory(name):
        files[name] = io.BytesIO()
        return files[name]

    pipeline = pp.build_pipeline(PIPELINE, factory)
    pp.run_pipeline(pipeline, lambda: [pp.PointsBatch(**b) for b in batches])
    counter = next(p for p in pipeline if isinstance(p, pp.CountingPointsProcessor))
    return counter.num_points, {k: v.getvalue() for k, v in files.items()}


def seeded_batches(seed=0):
    rng = np.random.default_rng(seed)
    wall = np.stack([np.full(40, 3.0), np.linspace(-2, 2, 40), np.zeros(40)], 1)
    out = []
    for k, frame in enumerate(["lidar", "lidar2", "camera", "lidar", "lidar2", "lidar"]):
        pts = np.concatenate([wall, rng.uniform(-7, 7, (200, 3))]).astype(np.float32)
        if k == 0:
            pts = np.concatenate([pts, [[1.5, 0.0, 0.0]]]).astype(np.float32)
        out.append(dict(time=0.1 * k, origin=np.zeros(3, np.float32), frame_id=frame,
                        points=pts, intensities=rng.uniform(0, 60, len(pts)).astype(np.float32)))
    return out


def test_pipeline_matches_jax():
    """Every stage, with the outlier filter's multi-pass restarts: the
    same count and the same bytes in every file written."""
    t_count, t_files = run(tpp, seeded_batches())
    j_count, j_files = run(jpp, seeded_batches())
    assert t_count == j_count > 0
    assert sorted(t_files) == sorted(j_files) == sorted(
        c["filename"] for c in PIPELINE if "filename" in c)
    for name, data in j_files.items():
        assert t_files[name] == data, name
    assert t_files["xray.png"][:8] == b"\x89PNG\r\n\x1a\n"


def test_unknown_action_raises():
    with pytest.raises(ValueError, match="unknown points processor"):
        tpp.build_pipeline([{"action": "no_such_stage"}])


def test_submap_painter_matches_jax():
    """Port submaps (tensor grids) paint as the JAX package paints the same
    grids: the same intensity image and origin."""
    rng = np.random.default_rng(3)
    t_tiles, j_tiles = [], []
    for k in range(3):
        known = np.zeros((64, 64), bool)
        known[10 + k: 40, 5: 50 - 3 * k] = rng.random((30 - k, 45 - 3 * k)) < 0.7
        log_odds = np.where(known, rng.normal(0, 2, (64, 64)), 0).astype(np.float32)
        origin = np.array([-1.6 + 0.3 * k, -1.6], np.float32)
        local = np.array([0.1 * k, 0.0, 0.0])
        glob = np.array([0.1 * k + 0.02, -0.01, 0.01 * k])
        t_tiles.append((submap_from_numpy(local, log_odds, known, origin, 0.05, "cpu"), glob))
        j_tiles.append((JSubmap2D(local_pose=local, grid=JGrid2D(
            log_odds=jnp.asarray(log_odds), known=jnp.asarray(known),
            origin=jnp.asarray(origin), resolution=0.05)), glob))
    t_img, t_origin = tpaint.paint_submaps(t_tiles, 0.05)
    j_img, j_origin = jpaint.paint_submaps(j_tiles, 0.05)
    assert isinstance(t_img, np.ndarray) and t_img.shape == j_img.shape
    np.testing.assert_allclose(t_img, j_img, atol=1e-6)
    np.testing.assert_array_equal(t_origin, j_origin)
    t_png, j_png = io.BytesIO(), io.BytesIO()
    tpaint.save_png(t_img, t_png)
    jpaint.save_png(j_img, j_png)
    assert t_png.getvalue() == j_png.getvalue()
    empty = submap_from_numpy(np.zeros(3), np.zeros((8, 8), np.float32),
                              np.zeros((8, 8), bool), np.zeros(2), 0.05, "cpu")
    assert tpaint.paint_submaps([(empty, np.zeros(3))], 0.05) is None


def walk(segments, seed):
    rng = np.random.default_rng(seed)
    times, poses, t, x = [], [], 0.0, 0.0
    for n, step, z in segments:
        for _ in range(n):
            times.append(t)
            poses.append(rigid3.translation(np.array([x, 0.0, z + rng.normal(0, 0.02)])))
            t += 1.0
            x += step
    return times, poses


@pytest.mark.parametrize("segments,num_floors", [
    ([(50, 0.6, 0.0), (5, 0.4, 4.0), (50, 0.6, 8.0)], 2),
    ([(50, 0.6, 0.0), (4, 0.5, 3.0), (6, 0.5, 0.1)], 1),
    ([(10, 0.2, 0.0), (10, 0.2, 4.0)], 0),
    ([(50, 0.6, 0.0), (5, 0.4, 4.0), (50, 0.6, 0.6)], 1),
], ids=["stairs", "revisit", "all_short", "nearby_levels"])
def test_detect_floors_matches_jax(segments, num_floors):
    """tests/test_detect_floors.py's walks with seeded altitude noise."""
    times, poses = walk(segments, seed=len(segments))
    t, j = tfloors.detect_floors(times, poses), jfloors.detect_floors(times, poses)
    assert len(t) == len(j) == num_floors
    for a, b in zip(t, j):
        assert a.z == b.z
        assert [(s.start, s.end) for s in a.timespans] == [(s.start, s.end) for s in b.timespans]
