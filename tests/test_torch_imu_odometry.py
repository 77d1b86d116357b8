"""IMU and odometry fusion in the PyTorch port against the JAX package:
`run_chunk` with `use_imu`, with `use_odometry` and with both, from one
state and one packed buffer; the chunked builder fed IMU and odometry
beside the scans; and the host-side ImuTracker and PoseExtrapolator
copies. The JAX side runs the direct-gather LM matcher
(`use_band_matcher=False`), as tests/test_torch_frontend_2d.py does."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.common import config as jconfig
from cartographer_tpu.mapping.chunked_frontend_2d import (
    ChunkedLocalTrajectoryBuilder2D as JaxBuilder,
)
from cartographer_tpu.mapping.imu_tracker import ImuTracker as JaxImuTracker
from cartographer_tpu.mapping.pose_extrapolator import (
    PoseExtrapolator as JaxExtrapolator,
)
from cartographer_tpu.ops import frontend_2d as jf
from cartographer_tpu.sensor import data as jdata
from cartographer_tpu.testing.synthetic import FAKE_START_TIME
from cartographer_tpu.transform import rigid3
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.mapping.chunked_frontend_2d import (
    ChunkedLocalTrajectoryBuilder2D as TorchBuilder,
)
from cartographer_tpu_torch.mapping.imu_tracker import ImuTracker as TorchImuTracker
from cartographer_tpu_torch.mapping.pose_extrapolator import (
    PoseExtrapolator as TorchExtrapolator,
)
from cartographer_tpu_torch.ops import frontend_2d as tf
from cartographer_tpu_torch.sensor import data as tdata
from tests.test_torch_backend_card import one_torch_thread  # noqa: F401
from tests.test_torch_frontend_2d import (
    CHUNK,
    FLAGS,
    GRID,
    builder_options,
    cfg_kwargs,
    jax_state_as_numpy,
    lifecycle,
    pack_chunk,
    scalars,
    semicircle_scans,
)

# The semicircle world's motion: 1.2 m along (2, 1) in 4 s.
DIRECTION = np.array([2.0, 1.0, 0.0]) / np.sqrt(5.0)
VELOCITY = DIRECTION * 1.2 / 4.0
IMU_PER_SCAN = 5  # 50 Hz against the 10 Hz scans
ODOM_PER_SCAN = 2  # 20 Hz


def imu_samples(t0, t1, seed):
    """Gravity and a small zero-mean gyro noise (the platform does not
    turn), 50 Hz, for the scan window [t0, t1)."""
    rng = np.random.default_rng(seed)
    times = t0 + (np.arange(IMU_PER_SCAN) + 0.5) * (t1 - t0) / IMU_PER_SCAN
    return [
        (t, np.array([0.0, 0.0, 9.8]), np.array([0.0, 0.0, rng.normal(0, 0.01)]))
        for t in times
    ]


def odom_samples(t0, t1, seed):
    """The true pose with 1e-4 m noise, 20 Hz, in [t0, t1)."""
    rng = np.random.default_rng(seed)
    times = t0 + (np.arange(ODOM_PER_SCAN) + 0.5) * (t1 - t0) / ODOM_PER_SCAN
    return [
        (t, (t - FAKE_START_TIME) * VELOCITY + rng.normal(0, 1e-4, 3),
         np.array([1.0, 0.0, 0.0, 0.0]))
        for t in times
    ]


def pack_sensors(cfg, buf, scans, epoch, use_imu, use_odometry):
    """Fill the IMU and odometry sections of a packed chunk: each scan gets
    the samples of the 0.1 s before it."""
    _, _, _, o_imu, o_odom, total = tf.input_layout(cfg)
    imu = buf[o_imu:o_odom].view(np.float32).reshape(CHUNK, cfg.max_imu_per_scan, 8)
    odom = (
        buf[o_odom:total].view(np.float32).reshape(CHUNK, cfg.max_odom_per_scan, 9)
        if use_odometry else None
    )
    for i, m in enumerate(scans):
        seed = int(round(m.time * 100))
        if use_imu:
            for j, (t, acc, gyro) in enumerate(imu_samples(m.time - 0.1, m.time, seed)):
                imu[i, j] = [t - epoch, *acc, *gyro, 1.0]
        if use_odometry:
            for j, (t, xyz, q) in enumerate(odom_samples(m.time - 0.1, m.time, seed)):
                odom[i, j] = [t - epoch, *xyz, *q, 1.0]


@pytest.mark.parametrize(
    "use_imu,use_odometry,num_chunks",
    [(True, False, 1), (False, True, 1), (True, True, 2)],
    ids=["imu", "odometry", "both"],
)
def test_run_chunk_matches_jax(use_imu, use_odometry, num_chunks):
    kw = dict(
        cfg_kwargs(10.0, False), max_imu_per_scan=8, use_imu=use_imu,
        use_odometry=use_odometry, max_odom_per_scan=4,
    )
    jcfg = jf.FrontendConfig2D(**kw, use_pallas_rtcsm=False)
    tcfg = tf.FrontendConfig2D(**kw)
    scans = semicircle_scans(num_chunks * CHUNK)
    jstate = jf.init_state(GRID, 0.0, tracker_last_acc_t=0.0 if use_imu else -1e30)
    epoch = scans[0].time
    for c in range(num_chunks):
        chunk = scans[c * CHUNK : (c + 1) * CHUNK]
        buf = pack_chunk(tcfg, chunk, chunk[0].time)
        pack_sensors(tcfg, buf, chunk, chunk[0].time, use_imu, use_odometry)
        shift = np.float32(chunk[0].time - epoch)
        epoch = chunk[0].time
        tstate = tf.state_from_numpy(jax_state_as_numpy(jstate), device="cpu")
        jstate, _, j_pts, j_packed = jf.run_chunk(
            jcfg, jstate, jnp.float32(shift), jnp.asarray(buf)
        )
        tstate, _, t_pts, t_packed = tf.run_chunk(
            tcfg, tstate, shift, torch.from_numpy(buf)
        )
        js, ts = scalars(j_packed, CHUNK), scalars(t_packed.numpy(), CHUNK)
        S = tf.SIDX
        for k in FLAGS:
            np.testing.assert_array_equal(ts[:, S[k]], js[:, S[k]], err_msg=k)
        xy = [S["pose_x"], S["pose_y"], S["anchor_x"], S["anchor_y"]]
        np.testing.assert_allclose(ts[:, xy], js[:, xy], atol=1e-3)
        np.testing.assert_allclose(ts[:, S["pose_yaw"]], js[:, S["pose_yaw"]], atol=1e-3)
        quat = [S["g_qw"], S["g_qx"], S["g_qy"], S["g_qz"]]
        np.testing.assert_allclose(ts[:, quat], js[:, quat], atol=1e-5)
        assert js[:, S["matched"]].sum() >= CHUNK - 1
        np.testing.assert_allclose(
            t_pts.numpy()[..., :3], np.asarray(j_pts)[..., :3], atol=1e-3
        )
        # The carried fusion state: odometry ring, velocities, trackers.
        jd = jax_state_as_numpy(jstate)
        td = tf.state_to_numpy(tstate)
        np.testing.assert_array_equal(td["odo_len"], jd["odo_len"])
        for k in ("odo_t", "odo_xyz", "odo_q", "tracker_ori", "tracker_grav",
                  "tracker_omega", "odo_trk_ori", "odo_trk_omega", "odo_trk_t",
                  "newest_t", "last_extrap_t"):
            np.testing.assert_allclose(td[k], jd[k], atol=1e-5, err_msg=k)
        for k in ("vel", "lin_vel_odo", "ang_vel_odo", "ang_vel"):
            np.testing.assert_allclose(td[k], jd[k], atol=2e-3, err_msg=k)
    if use_odometry:
        assert int(td["odo_len"]) >= 2


def sensor_events(num_scans, pkg):
    """Scans of the semicircle world with IMU at 50 Hz from 0.04 s before
    the first scan and odometry at 20 Hz, time-sorted, as the sensor data
    types of `pkg` (either package's sensor.data)."""
    scans = [
        pkg.TimedPointCloudData(
            m.time, m.origin, pkg.TimedPointCloud(m.ranges.points, m.ranges.times)
        )
        for m in semicircle_scans(num_scans)
    ]
    events = [("range", m.time, m) for m in scans]
    t = FAKE_START_TIME - 0.04
    rng = np.random.default_rng(3)
    while t < scans[-1].time:
        events.append(("imu", t, pkg.ImuData(
            time=float(t), linear_acceleration=np.array([0.0, 0.0, 9.8]),
            angular_velocity=np.array([0.0, 0.0, rng.normal(0, 0.01)]),
        )))
        t += 0.02
    rng = np.random.default_rng(11)
    for t in np.arange(FAKE_START_TIME + 0.01, scans[-1].time, 0.05):
        pos = (t - FAKE_START_TIME) * VELOCITY + rng.normal(0, 1e-4, 3)
        events.append(("odom", float(t), pkg.OdometryData(
            time=float(t), pose=rigid3.make(pos, np.array([1.0, 0.0, 0.0, 0.0])),
        )))
    events.sort(key=lambda e: (e[1], e[0] != "imu"))
    return events


def feed(builder, events):
    results = []
    for kind, _, payload in events:
        if kind == "imu":
            builder.add_imu_data(payload)
        elif kind == "odom":
            builder.add_odometry_data(payload)
        else:
            results.extend(builder.add_range_data("range", payload))
    results.extend(builder.flush())
    return results


def sensor_options(mod):
    opts = builder_options(mod)
    opts.use_imu_data = True
    return opts


def test_builder_with_imu_and_odometry_matches_jax():
    jb = JaxBuilder(sensor_options(jconfig), {"range"}, chunk_size=CHUNK)
    jb._cfg = dataclasses.replace(jb._cfg, use_band_matcher=False)
    j_res = feed(jb, sensor_events(16, jdata))
    tb = TorchBuilder(sensor_options(tconfig), {"range"}, chunk_size=CHUNK, device="cpu")
    t_res = feed(tb, sensor_events(16, tdata))

    assert len(t_res) == len(j_res) > 12
    assert [r.time for r in t_res] == [r.time for r in j_res]
    assert lifecycle(t_res) == lifecycle(j_res)
    assert tb._cfg.use_imu and tb._sticky_odometry
    for j, t in zip(j_res, t_res):
        err = np.linalg.norm(rigid3.trans(j.local_pose) - rigid3.trans(t.local_pose))
        assert err < 0.05, (t.time, err)
    for r in t_res:
        truth = (r.time - FAKE_START_TIME) * VELOCITY
        assert np.linalg.norm(rigid3.trans(r.local_pose) - truth) < 0.12


@pytest.mark.parametrize("kind", ["imu", "odom"])
def test_builder_with_one_sensor_runs(kind):
    """The chunked builder with IMU only or odometry only (the other
    stream left out): every scan matched, near the truth."""
    opts = sensor_options(tconfig) if kind == "imu" else builder_options(tconfig)
    tb = TorchBuilder(opts, {"range"}, chunk_size=CHUNK, device="cpu")
    events = [e for e in sensor_events(CHUNK, tdata) if e[0] in ("range", kind)]
    results = feed(tb, events)
    assert len(results) == CHUNK
    assert tb._cfg.use_imu == (kind == "imu")
    assert tb._sticky_odometry == (kind == "odom")
    for r in results:
        truth = (r.time - FAKE_START_TIME) * VELOCITY
        assert np.linalg.norm(rigid3.trans(r.local_pose) - truth) < 0.12


def test_builder_sensor_feeds():
    """IMU data with use_imu_data=False raises RuntimeError (as the JAX
    builder does); scans before the first IMU sample are dropped; odometry
    before the first scan is ignored."""
    tb = TorchBuilder(builder_options(tconfig), {"range"}, device="cpu")
    imu = tdata.ImuData(time=FAKE_START_TIME, linear_acceleration=np.array([0, 0, 9.8]),
                        angular_velocity=np.zeros(3))
    with pytest.raises(RuntimeError):
        tb.add_imu_data(imu)
    odom = tdata.OdometryData(time=FAKE_START_TIME, pose=rigid3.identity())
    tb.add_odometry_data(odom)
    assert not tb._sticky_odometry and not tb._odom_buffer
    tb = TorchBuilder(sensor_options(tconfig), {"range"}, chunk_size=1, device="cpu")
    scans = semicircle_scans(2)
    assert tb.add_range_data("range", scans[0]) == []
    assert tb._state is None
    tb.add_imu_data(dataclasses.replace(imu, time=scans[0].time + 0.01))
    assert tb._state is not None
    assert len(tb.add_range_data("range", scans[1])) == 1


def test_imu_tracker_matches_jax_copy():
    rng = np.random.default_rng(5)
    j, t = JaxImuTracker(10.0, 1.0), TorchImuTracker(10.0, 1.0)
    time = 1.0
    for _ in range(50):
        time += rng.uniform(0.005, 0.05)
        acc = np.array([0.0, 0.0, 9.8]) + rng.normal(0, 0.3, 3)
        gyro = rng.normal(0, 0.2, 3)
        for tr in (j, t):
            tr.advance(time)
            tr.add_imu_linear_acceleration_observation(acc)
            tr.add_imu_angular_velocity_observation(gyro)
        np.testing.assert_allclose(t.orientation(), j.orientation(), atol=1e-12)
    np.testing.assert_allclose(t._gravity_vector, j._gravity_vector, atol=1e-12)


def test_pose_extrapolator_matches_jax_copy():
    rng = np.random.default_rng(6)
    imu0 = dict(time=10.0, linear_acceleration=np.array([0.0, 0.0, 9.8]),
                angular_velocity=np.array([0.0, 0.0, 0.1]))
    j = JaxExtrapolator.initialize_with_imu(0.001, 10.0, jdata.ImuData(**imu0))
    t = TorchExtrapolator.initialize_with_imu(0.001, 10.0, tdata.ImuData(**imu0))
    time = 10.0
    for step in range(30):
        for _ in range(4):
            time += 0.02
            imu = dict(time=time, linear_acceleration=np.array([0.0, 0.0, 9.8])
                       + rng.normal(0, 0.1, 3),
                       angular_velocity=np.array([0.0, 0.0, 0.1]) + rng.normal(0, 0.02, 3))
            j.add_imu_data(jdata.ImuData(**imu))
            t.add_imu_data(tdata.ImuData(**imu))
        if step % 2:
            pose = rigid3.make(np.array([0.3 * time, 0.1, 0.0]), np.array([1.0, 0, 0, 0]))
            j.add_odometry_data(jdata.OdometryData(time=time, pose=pose))
            t.add_odometry_data(tdata.OdometryData(time=time, pose=pose))
        time += 0.01
        times = time + np.linspace(0.0, 0.05, 7)
        np.testing.assert_allclose(
            t.extrapolate_poses_batch(times), j.extrapolate_poses_batch(times), atol=1e-12
        )
        np.testing.assert_allclose(
            t.estimate_gravity_orientation(times[-1]),
            j.estimate_gravity_orientation(times[-1]), atol=1e-12,
        )
        pose_j = j.extrapolate_pose(times[-1])
        np.testing.assert_allclose(t.extrapolate_pose(times[-1]), pose_j, atol=1e-12)
        pose = rigid3.make(rigid3.trans(pose_j) + rng.normal(0, 0.01, 3), rigid3.quat(pose_j))
        j.add_pose(times[-1], pose)
        t.add_pose(times[-1], pose)
        time = times[-1]
