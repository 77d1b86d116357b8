"""Local SLAM's device ops on the card against their CPU runs: the
scatter inserter, the TSDF inserter, the TSDF matcher, `run_chunk` with
IMU and odometry, and the per-scan builder, whose correlative match goes
through the CUDA window-sum kernel. Nothing here imports the JAX package:
`python -m pytest tests/test_torch_local_slam_card.py -m cuda`."""

import math

import numpy as np
import pytest
import torch

from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.kernels import correlative_window as cw
from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (
    LocalTrajectoryBuilder2D,
)
from cartographer_tpu_torch.mapping import probability_values as pv
from cartographer_tpu_torch.ops import frontend_2d as tf
from cartographer_tpu_torch.ops import raycast_2d, tsdf_raycast_2d
from cartographer_tpu_torch.ops.scan_matching import gauss_newton_2d as tgn
from cartographer_tpu_torch.testing.synthetic import (
    generate_fake_range_measurements,
    generate_loop_world,
)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def on(dev, *arrays):
    return [torch.from_numpy(np.asarray(a)).to(dev) for a in arrays]


@pytest.mark.cuda
def test_insert_scan_on_card_matches_cpu():
    need_card()
    rng = np.random.default_rng(0)
    size, n = 512, 2048
    log_odds = rng.uniform(-3, 3, (size, size)).astype(np.float32)
    known = rng.uniform(size=(size, size)) < 0.3
    origin = np.array([250.3, 260.7], np.float32)
    ends = rng.uniform(-30, size + 30, (n, 2)).astype(np.float32)
    is_hit = rng.uniform(size=n) < 0.7
    valid = rng.uniform(size=n) < 0.95
    out = {
        dev: [t.cpu().numpy() for t in raycast_2d.insert_scan(
            *on(dev, log_odds, known, origin, ends, is_hit, valid),
            0.2, -0.4, 1024, True)]
        for dev in ("cpu", "cuda")
    }
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])


def tsdf_case(seed, size=256, n=512):
    rng = np.random.default_rng(seed)
    th = np.sort(rng.uniform(-math.pi, math.pi, n))
    r = 4.0 + 0.5 * np.sin(3 * th)
    origin = np.array([0.5 * size, 0.5 * size], np.float32)
    hits = (origin + np.stack([r * np.cos(th), r * np.sin(th)], 1) / 0.05).astype(np.float32)
    normals = (th + math.pi).astype(np.float32)
    ranges = r.astype(np.float32)
    valid = np.ones(n, bool)
    tsd = np.full((size, size), 0.3, np.float32)
    return tsd, np.zeros((size, size), np.float32), origin, hits, normals, valid, ranges


@pytest.mark.cuda
def test_tsdf_insert_and_match_on_card_match_cpu():
    need_card()
    static = (0.05, 0.3, 10.0, 0.5, 0.5, 0, 32, False)
    grids = {}
    for dev in ("cpu", "cuda"):
        tsd, weight = None, None
        for seed in (1, 2):
            args = on(dev, *tsdf_case(seed))
            if tsd is not None:
                args[0], args[1] = tsd, weight
            tsd, weight = tsdf_raycast_2d.insert_scan_tsdf(*args, *static)
        grids[dev] = (tsd, weight)
    # The weighted sums use atomics on the card: 1e-5, not bitwise.
    for c, g in zip(grids["cpu"], grids["cuda"]):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), atol=1e-5, rtol=0)
    th = np.linspace(-math.pi, math.pi, 300, endpoint=False)
    r = 4.0 + 0.5 * np.sin(3 * th)
    pts = np.zeros((512, 2), np.float32)
    pts[:300] = np.stack([r * np.cos(th), r * np.sin(th)], 1)
    mask = np.arange(512) < 300
    poses = {}
    for dev in ("cpu", "cuda"):
        tsd, weight = grids["cpu"] if dev == "cpu" else (t.cuda() for t in grids["cpu"])
        origin, initial, target, p, m = on(
            dev, np.zeros(2, np.float32), np.array([6.43, 6.37, 0.03], np.float32),
            np.array([6.43, 6.37], np.float32), pts, mask)
        poses[dev] = tgn.match_tsdf(tsd, weight, origin, initial, target, p, m,
                                    0.05, 0.3, 1.0, 10.0, 40.0, 20, True)[0].cpu().numpy()
    np.testing.assert_allclose(poses["cuda"], poses["cpu"], atol=1e-4)


def sensor_chunk_config():
    return tf.FrontendConfig2D(
        grid_size=256, resolution=0.05, num_range_data=2,
        hit_log_odds=pv.hit_update_log_odds(0.55), miss_log_odds=pv.miss_update_log_odds(0.49),
        insert_free_space=True, min_range=0.0, max_range=10.0, missing_data_ray_length=5.0,
        min_z=-0.8, max_z=2.0, voxel_filter_size=0.025, avf_max_length=0.5,
        avf_min_num_points=200, avf_max_range=50.0, occupied_space_weight=1.0,
        translation_weight=10.0, rotation_weight=40.0, gn_iterations=20, mf_max_time=5.0,
        mf_max_distance=0.04, mf_max_angle=math.radians(10.0), pose_queue_duration=0.001,
        num_steps=256, max_imu_per_scan=8, use_imu=True, use_odometry=True,
        max_odom_per_scan=4, use_online_correlative=True,
        rtcsm_angular_search_window=math.radians(3.0), rtcsm_num_linear=2, rtcsm_a_cap=8,
        has_misses=False, chunk_size=1, num_points=1792,
    )


@pytest.mark.cuda
def test_run_chunk_with_imu_and_odometry_on_card_matches_cpu():
    """Scan by scan from one state: the card's step rerun on the CPU."""
    need_card()
    cfg = sensor_chunk_config()
    scans = generate_fake_range_measurements(
        translation=np.array([1.07, 0.54, 0.0]), duration=4.0, time_step=0.1)[:8]
    q = tf.point_quantization_scale(cfg)
    o_points, o_times, o_meta, o_imu, o_odom, total = tf.input_layout(cfg)
    state = tf.init_state(256, 0.0, tracker_last_acc_t=0.0, device="cuda")
    velocity = np.array([1.07, 0.54, 0.0]) / 4.0
    epoch = scans[0].time
    for i, m in enumerate(scans):
        buf = np.zeros(total, np.uint8)
        pts = m.ranges.points
        buf[o_points:o_times].view(np.int16).reshape(1792, 3)[: len(pts)] = np.round(pts / q)
        meta = buf[o_meta:o_imu].view(np.float32)
        meta[0] = meta[5] = m.time - epoch
        meta[4] = len(pts)
        imu = buf[o_imu:o_odom].view(np.float32).reshape(8, 8)
        odom = buf[o_odom:total].view(np.float32).reshape(4, 9)
        for j in range(5):
            t = m.time - 0.1 + 0.02 * (j + 0.5) - epoch
            imu[j] = [t, 0, 0, 9.8, 0, 0, 0.001 * j, 1]
        for j in range(2):
            t = m.time - 0.1 + 0.05 * (j + 0.5)
            odom[j] = [t - epoch, *((t - scans[0].time) * velocity), 1, 0, 0, 0, 1]
        shift = np.float32(m.time - epoch)
        epoch = m.time
        cpu_state = tf.state_from_numpy(tf.state_to_numpy(state), device="cpu")
        state, _, _, packed = tf.run_chunk(cfg, state, shift, torch.from_numpy(buf).cuda())
        _, _, _, cpu_packed = tf.run_chunk(cfg, cpu_state, shift, torch.from_numpy(buf))
        n = len(tf.SCALARS)
        g = packed.cpu().numpy()[: 4 * n].view(np.float32)
        c = cpu_packed.numpy()[: 4 * n].view(np.float32)
        for k in ("matched", "inserted", "created", "popped", "finished", "num_filtered"):
            assert g[tf.SIDX[k]] == c[tf.SIDX[k]], (i, k)
        S = tf.SIDX
        np.testing.assert_allclose(g[[S["pose_x"], S["pose_y"]]], c[[S["pose_x"], S["pose_y"]]],
                                   atol=1e-3)
        assert abs(g[S["pose_yaw"]] - c[S["pose_yaw"]]) <= 1e-3
    assert int(state.odo_len) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("grid_type", ["PROBABILITY_GRID", "TSDF"])
def test_per_scan_builder_on_card_launches_the_kernel(grid_type):
    """Scan by scan from one state (a free run amplifies float noise, ROADMAP
    Queue C): the card's builder and a CPU copy of it agree per scan, and
    every match against a submap launches the window-sum kernel."""
    need_card()
    opts = tconfig.TrajectoryBuilder2DOptions(
        use_imu_data=False, max_range=12.0, use_online_correlative_scan_matching=True,
        submaps=tconfig.SubmapsOptions2D(
            num_range_data=3,
            grid_options_2d=tconfig.GridOptions2D(grid_type=grid_type, grid_size=1024)),
    )
    scans, _ = generate_loop_world(laps=0.03, num_beams=512)
    builder = LocalTrajectoryBuilder2D(opts, {"range"}, device="cuda")
    cw.LAUNCHES = 0
    matched = 0
    for m in scans[:12]:
        twin = builder.to("cpu")
        launches = cw.LAUNCHES
        g = builder.add_range_data("range", m)
        c = twin.add_range_data("range", m)
        assert (g is None) == (c is None)
        if g is None:
            continue
        assert (g.insertion_result is None) == (c.insertion_result is None)
        np.testing.assert_allclose(g.local_pose, c.local_pose, atol=1e-3)
        assert cw.LAUNCHES == launches + (1 if matched else 0)
        matched += 1
    assert matched >= 10
