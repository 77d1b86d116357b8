"""3D local SLAM's device ops on the card against their CPU runs: the
dense and paged inserters, the grid reads, the 6-DoF LM matcher, the 3D
correlative scorer, `run_chunk` in paged mode and the per-scan builder.
Nothing here imports the JAX package:
`python -m pytest tests/test_torch_local_slam_3d_card.py -m cuda`."""

import numpy as np
import pytest
import torch

from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.mapping import paged_grid_3d as tpg
from cartographer_tpu_torch.mapping.chunked_frontend_3d import (
    ChunkedLocalTrajectoryBuilder3D,
)
from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
    LocalTrajectoryBuilder3D,
)
from cartographer_tpu_torch.ops import frontend_3d as tf
from cartographer_tpu_torch.ops import raycast_3d
from cartographer_tpu_torch.ops.scan_matching import correlative_3d, gauss_newton_3d
from cartographer_tpu_torch.sensor.data import ImuData
from cartographer_tpu_torch.testing.synthetic import (
    FAKE_START_TIME,
    generate_fake_range_measurements,
)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def on(dev, *arrays):
    return [torch.from_numpy(np.asarray(a)).to(dev) for a in arrays]


def rays(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    cells = rng.integers(lo, hi, (n, 3)).astype(np.int32)
    return rng, cells, rng.uniform(size=n) < 0.9


@pytest.mark.cuda
def test_dense_insert_on_card_matches_cpu():
    """Bit-identical, duplicates and off-grid endpoints included."""
    need_card()
    rng, cells, valid = rays(0, 20000, -20, 276)
    values = rng.integers(-127, 128, (256, 256, 256)).astype(np.int8)
    origin = np.array([128, 120, 130], np.int32)
    out = {
        dev: raycast_3d.insert_scan_3d(*on(dev, values, origin, cells, valid), 12, -5, 2).cpu()
        for dev in ("cpu", "cuda")
    }
    assert torch.equal(out["cuda"], out["cpu"])


@pytest.mark.cuda
def test_paged_insert_on_card_matches_cpu():
    """Table, pool, block count and dropped writes bit-identical over four
    lanes and five scans, the pool running full."""
    need_card()
    rng, _, _ = rays(1, 1, 0, 1)
    grids = {}
    for dev in ("cpu", "cuda"):
        grids[dev] = (
            torch.full((4, 64**3), -1, dtype=torch.int32, device=dev),
            torch.zeros((4, 300, 4096), dtype=torch.int8, device=dev),
            torch.zeros(4, dtype=torch.int32, device=dev),
            torch.zeros(4, dtype=torch.int32, device=dev),
        )
    for scan in range(5):
        origin = rng.integers(400, 600, (4, 3)).astype(np.int32)
        cells = (origin[:, None, :] + rng.integers(-150, 150, (4, 3000, 3))).astype(np.int32)
        cells[:, :50] = rng.integers(-40, 1070, (4, 50, 3))  # off the extent too
        valid = rng.uniform(size=(4, 3000)) < 0.95
        for dev in ("cpu", "cuda"):
            grids[dev] = tpg.insert_cells_paged(
                *grids[dev], *on(dev, origin, cells, valid), 12, -5, 2,
                block_bits=4, table_size=64,
            )
        for a, b in zip(grids["cuda"], grids["cpu"]):
            assert torch.equal(a.cpu(), b), scan
    assert int(grids["cpu"][2].min()) == 300  # every pool ran full


def paged_room(dev):
    """A paged grid with some structure: inserts of a box of returns."""
    rng = np.random.default_rng(2)
    grid = tpg.make_paged_grid_3d(np.zeros(3), 0.1, device=dev)
    for _ in range(3):
        pts = rng.uniform(-2.5, 2.5, (4000, 3))
        pts[:, 0] = np.where(rng.uniform(size=4000) < 0.5, np.sign(pts[:, 0]) * 2.5, pts[:, 0])
        cells = np.floor((pts - grid.origin.cpu().numpy()) / 0.1 + 0.5).astype(np.int32)
        origin = np.floor(-grid.origin.cpu().numpy() / 0.1 + 0.5).astype(np.int32)
        grid = tpg.insert_scan_3d_paged(
            grid, *on(dev, origin, cells, np.ones(4000, bool)), 12, -5, 2)
    return grid, pts.astype(np.float32)


@pytest.mark.cuda
def test_matchers_on_card_match_cpu():
    """The 6-DoF LM within 1e-4 m / rad and the correlative scores within
    rtol 1e-5 (same best candidate), on a paged grid at the bench's
    resolution."""
    need_card()
    out = {}
    for dev in ("cpu", "cuda"):
        grid, pts = paged_room(dev)
        p = np.zeros((1024, 3), np.float32)
        p[:800] = pts[:800] * 0.98
        m = np.arange(1024) < 800
        t0 = np.array([0.03, -0.02, 0.01], np.float32)
        q0 = np.array([0.9999, 0.0, 0.0, 0.0141], np.float32)
        q0 /= np.linalg.norm(q0)
        args = on(dev, t0, q0, t0, p, m, p, m)
        packed = gauss_newton_3d.match_3d(
            grid, grid.origin, grid, grid.origin, *args,
            torch.full((), 0.1, device=dev), torch.full((), 0.1, device=dev),
            1.0, 6.0, 5.0, 400.0,
        )
        angles = np.linspace(-0.05, 0.05, 16).astype(np.float32)
        scores, best, _ = correlative_3d.score_candidates_3d(
            grid, grid.origin, *on(dev, p, m, angles, np.ones(16, bool), t0),
            0.1, 0.1, 0.1, 2,
        )
        out[dev] = packed.cpu().numpy(), scores.cpu().numpy(), int(best)
    np.testing.assert_allclose(out["cuda"][0][:7], out["cpu"][0][:7], atol=1e-4)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-5)
    assert out["cuda"][2] == out["cpu"][2]


def bench_like_options():
    return tconfig.TrajectoryBuilder3DOptions(
        min_range=0.1, max_range=10.0,
        motion_filter=tconfig.MotionFilterOptions(
            max_time_seconds=0.5, max_distance_meters=0.2, max_angle_radians=0.2),
        submaps=tconfig.SubmapsOptions3D(
            num_range_data=4, high_resolution=0.10, low_resolution=0.45,
            high_resolution_grid_size=256, low_resolution_grid_size=128),
    )


def bench_like_events(num):
    direction = np.array([2.0, 1.0, 0.0]) / np.sqrt(5.0)
    scans = generate_fake_range_measurements(
        translation=direction * 5.0, duration=30.0, time_step=0.1)[:num]
    imu = [ImuData(time=float(t), linear_acceleration=np.array([0.0, 0.0, 9.8]),
                   angular_velocity=np.zeros(3))
           for t in np.arange(FAKE_START_TIME - 0.5, scans[-1].time, 0.02)]
    events = [("imu", d.time, d) for d in imu] + [("range", m.time, m) for m in scans]
    return sorted(events, key=lambda e: (e[1], e[0] == "range"))


@pytest.mark.cuda
def test_run_chunk_on_card_matches_cpu():
    """Each chunk of the paged chunked frontend rerun on the CPU from the
    card's state before it: identical flags, poses within 1e-3."""
    need_card()
    builder = ChunkedLocalTrajectoryBuilder3D(bench_like_options(), {"range"},
                                              chunk_size=4, device="cuda")
    run = tf.run_chunk
    S = tf.SIDX
    compared = []

    def checked(cfg, state, shift, buf):
        out = run(cfg, state, shift, buf)
        cpu = run(cfg, tf.state_from_numpy(tf.state_to_numpy(state), device="cpu"),
                  shift, buf.cpu())
        n = len(tf.SCALARS) * cfg.chunk_size * 4
        g = out[2].cpu().numpy()[:n].view(np.float32).reshape(cfg.chunk_size, -1)
        c = cpu[2].numpy()[:n].view(np.float32).reshape(cfg.chunk_size, -1)
        for k in ("matched", "inserted", "created", "popped", "finished", "count0"):
            np.testing.assert_array_equal(g[:, S[k]], c[:, S[k]], err_msg=k)
        np.testing.assert_allclose(g[:, S["est_x"]: S["est_qz"] + 1],
                                   c[:, S["est_x"]: S["est_qz"] + 1], atol=1e-3)
        compared.append(int(g[:, S["inserted"]].sum()))
        return out

    tf.run_chunk = checked
    try:
        for kind, _, payload in bench_like_events(24):
            if kind == "imu":
                builder.add_imu_data(payload)
            else:
                builder.add_range_data("range", payload)
    finally:
        tf.run_chunk = run
    assert len(compared) == 6 and sum(compared) >= 3


@pytest.mark.cuda
def test_per_scan_builder_on_card_matches_cpu_copy():
    """Each scan on the card and by a CPU copy of the builder as it stood:
    the same result kinds, poses within 1e-3 m / rad."""
    need_card()
    builder = LocalTrajectoryBuilder3D(bench_like_options(), {"range"}, device="cuda")
    compared = 0
    for kind, _, payload in bench_like_events(10):
        if kind == "imu":
            builder.add_imu_data(payload)
            continue
        twin = builder.to("cpu")
        g = builder.add_range_data("range", payload)
        c = twin.add_range_data("range", payload)
        assert (g is None) == (c is None)
        if g is None:
            continue
        assert (g.insertion_result is None) == (c.insertion_result is None)
        np.testing.assert_allclose(g.local_pose, c.local_pose, atol=1e-3)
        compared += 1
    assert compared >= 9
