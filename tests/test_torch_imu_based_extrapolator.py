"""The port's IMU-based pose extrapolator against the JAX package's: the
scenarios of tests/test_imu_based_extrapolator.py plus a seeded one with
odometry, query by query within 1e-4 m / rad, and both per-scan local
builders with use_imu_based over 4 scans from one carried state.

Every query here gives the JAX solver the same padded table shapes
(8 nodes and constraints, 4 rows of odometry, IMU rotation and
acceleration; the builders' short window 4 of each), so that the JAX
side compiles its solve twice in the whole file."""

import math

import numpy as np
import pytest
import torch

from cartographer_tpu.common import config as jconfig
from cartographer_tpu.mapping.imu_based_pose_extrapolator import (
    ImuBasedPoseExtrapolator as JaxExtrapolator,
)
from cartographer_tpu.mapping.local_trajectory_builder_2d import (
    LocalTrajectoryBuilder2D as JaxBuilder2D,
)
from cartographer_tpu.mapping.local_trajectory_builder_3d import (
    LocalTrajectoryBuilder3D as JaxBuilder3D,
)
from cartographer_tpu.sensor import data as jdata
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.mapping.imu_based_pose_extrapolator import (
    ImuBasedPoseExtrapolator as TorchExtrapolator,
)
from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (
    LocalTrajectoryBuilder2D as TorchBuilder2D,
)
from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
    LocalTrajectoryBuilder3D as TorchBuilder3D,
)
from cartographer_tpu_torch.mapping.pose_extrapolator_interface import (
    create_with_imu_data,
    create_without_imu,
)
from cartographer_tpu_torch.sensor import data as tdata
from cartographer_tpu_torch.transform import rigid3
from tests.test_torch_backend_card import one_torch_thread  # noqa: F401
from tests.test_torch_imu_odometry import sensor_events
from tests.test_torch_local_slam_2d import feed_per_scan, per_scan_options
from tests.test_torch_local_slam_3d import builder_options, events, feed

ATOL = 1e-4
# Pose window of the builders' extrapolators: the last pose before the
# horizon and the ones after it, so at most 3 poses at 10 Hz.
BUILDER_WINDOW = 0.06


def imu(pkg, t, accel=(0.0, 0.0, 9.8), omega=(0.0, 0.0, 0.0)):
    return pkg.ImuData(time=float(t), linear_acceleration=np.asarray(accel, float),
                       angular_velocity=np.asarray(omega, float))


def straight_line(pkg, make):
    """tests/test_imu_based_extrapolator.py: straight line with odometry."""
    ex = make(pose_queue_duration=5.0)
    v = np.array([1.0, 0.0, 0.0])
    for t in np.arange(0.0, 2.01, 0.05):
        ex.add_imu_data(imu(pkg, t))
        ex.add_odometry_data(pkg.OdometryData(time=t, pose=rigid3.translation(v * t)))
    for t in np.arange(0.0, 2.01, 0.5):
        ex.add_pose(t, rigid3.translation(v * t))
    return ex


def observed_poses(pkg, make):
    """tests/test_imu_based_extrapolator.py: IMU only, poses to reproduce."""
    ex = make()
    for t in np.arange(0.0, 1.01, 0.1):
        ex.add_imu_data(imu(pkg, t))
    for t in np.arange(0.0, 1.01, 0.25):
        ex.add_pose(t, rigid3.translation(np.array([t, 2 * t, 0.0])))
    return ex


def seeded_curve(pkg, make):
    """A curve with yaw: noisy IMU (gravity, acceleration, a turn rate),
    odometry with noise, and noisy pose observations."""
    rng = np.random.default_rng(5)
    ex = make(pose_queue_duration=5.0)

    def truth(t):
        yaw = 0.3 * t
        pos = np.array([math.sin(yaw) / 0.3, (1.0 - math.cos(yaw)) / 0.3, 0.02 * t])
        return rigid3.make(pos, np.array([math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)]))

    for t in np.arange(0.0, 2.01, 0.05):
        ex.add_imu_data(imu(pkg, t, accel=np.array([0.0, 0.3, 9.8]) + rng.normal(0, 0.05, 3),
                            omega=np.array([0.0, 0.0, 0.3]) + rng.normal(0, 0.01, 3)))
        noise = rigid3.translation(rng.normal(0, 2e-3, 3))
        ex.add_odometry_data(pkg.OdometryData(time=t, pose=rigid3.compose(truth(t), noise)))
    for t in np.arange(0.0, 2.01, 0.5):
        ex.add_pose(t, rigid3.compose(truth(t), rigid3.translation(rng.normal(0, 0.01, 3))))
    return ex


def pair(scenario):
    return (
        scenario(jdata, lambda **kw: JaxExtrapolator(
            jconfig.ImuBasedExtrapolatorOptions(**kw))),
        scenario(tdata, lambda **kw: TorchExtrapolator(
            tconfig.ImuBasedExtrapolatorOptions(**kw), device="cpu")),
    )


def assert_poses_close(t_poses, j_poses):
    t_poses, j_poses = np.atleast_2d(t_poses), np.atleast_2d(j_poses)
    np.testing.assert_allclose(t_poses[:, :3], j_poses[:, :3], atol=ATOL)
    for a, b in zip(t_poses, j_poses):
        angle = 2.0 * math.acos(min(1.0, abs(float(np.dot(a[3:7], b[3:7])))))
        assert angle < ATOL


@pytest.mark.parametrize("scenario", [straight_line, seeded_curve],
                         ids=["straight_line", "seeded_curve"])
def test_queries_match_jax(scenario):
    jex, tex = pair(scenario)
    pose = tex.extrapolate_pose(2.2)
    assert_poses_close(pose, jex.extrapolate_pose(2.2))
    if scenario is straight_line:  # tests/test_imu_based_extrapolator.py
        assert pose[0] >= 1.9 and abs(pose[1]) < 0.1
    assert_poses_close(tex.extrapolate_poses_batch([2.1, 2.2]),
                       jex.extrapolate_poses_batch([2.1, 2.2]))
    j, t = (ex.extrapolate_poses_with_gravity([2.05, 2.1, 2.2]) for ex in (jex, tex))
    assert len(t.previous_poses) == len(j.previous_poses) == 2
    assert_poses_close(np.stack(t.previous_poses), np.stack(j.previous_poses))
    assert_poses_close(t.current_pose, j.current_pose)
    np.testing.assert_allclose(t.current_velocity, j.current_velocity, atol=1e-12)
    np.testing.assert_allclose(t.gravity_from_tracking, j.gravity_from_tracking, atol=ATOL)
    assert tex.get_last_extrapolated_time() == jex.get_last_extrapolated_time() == 2.2


def test_batch_reproduces_observed_poses_like_jax():
    jex, tex = pair(observed_poses)
    times = [0.25, 0.5, 0.75]
    out = tex.extrapolate_poses_batch(times)
    assert_poses_close(out, jex.extrapolate_poses_batch(times))
    for row, t in zip(out, times):  # tests/test_imu_based_extrapolator.py
        np.testing.assert_allclose(row[:3], [t, 2 * t, 0.0], atol=0.05)


def test_factory_builds_it_on_the_builders_device():
    options = tconfig.PoseExtrapolatorOptions(use_imu_based=True)
    ex = create_with_imu_data(options, [imu(tdata, 1.0)], "cpu")
    assert isinstance(ex, TorchExtrapolator) and ex.device.type == "cpu"
    assert ex.get_last_pose_time() == 1.0
    ex = create_without_imu(options, 2.0, "cpu")
    assert isinstance(ex, TorchExtrapolator) and ex.get_last_pose_time() == 2.0
    if not torch.cuda.is_available():  # device=None means CUDA, no fallback
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TorchExtrapolator(tconfig.ImuBasedExtrapolatorOptions())


def imu_based(options):
    options.pose_extrapolator.use_imu_based = True
    options.pose_extrapolator.imu_based.pose_queue_duration = BUILDER_WINDOW
    return options


def carried(jb, tb, j_events, t_events, feed_fn, prediction_arg):
    """Both builders over the same data, the port's carried along the JAX
    one's: each scan's match is recorded on both sides and the JAX match
    goes on into both extrapolators and submaps. Returns the results and
    per scan (JAX prediction, port prediction, JAX match, port match)."""
    j_match, t_match = jb._scan_match, tb._scan_match
    steps = []

    def j_step(*args):
        pose = j_match(*args)
        steps.append([np.asarray(args[prediction_arg]), None, np.asarray(pose), None])
        return pose

    def t_step(*args):
        step = next(s for s in steps if s[1] is None)
        step[1] = np.asarray(args[prediction_arg])
        step[3] = np.asarray(t_match(*args))
        return step[2]

    jb._scan_match, tb._scan_match = j_step, t_step
    return feed_fn(jb, j_events), feed_fn(tb, t_events), steps


def test_local_builder_2d_matches_jax():
    """LocalTrajectoryBuilder2D with IMU, odometry and the IMU-based
    extrapolator: 4 scans from one carried state, predictions within
    1e-4 and matches within 1e-3 m of the JAX builder's."""
    jb = JaxBuilder2D(imu_based(per_scan_options(jconfig, use_imu=True)), {"range"})
    tb = TorchBuilder2D(imu_based(per_scan_options(tconfig, use_imu=True)), {"range"},
                        device="cpu")
    j_res, t_res, steps = carried(jb, tb, sensor_events(4, jdata), sensor_events(4, tdata),
                                  feed_per_scan, prediction_arg=-2)
    assert isinstance(tb._extrapolator, TorchExtrapolator)
    assert len(t_res) == len(j_res) == len(steps) == 4
    for j_pred, t_pred, j_pose, t_pose in steps:
        np.testing.assert_allclose(t_pred, j_pred, atol=ATOL)
        np.testing.assert_allclose(t_pose, j_pose, atol=1e-3)
    for j, t in zip(j_res, t_res):
        assert t.time == j.time
        assert (t.insertion_result is None) == (j.insertion_result is None)
        np.testing.assert_allclose(t.local_pose, j.local_pose, atol=1e-3)


def test_local_builder_3d_matches_jax():
    """LocalTrajectoryBuilder3D with the IMU-based extrapolator: 4 scans
    from one carried state, each match within 1e-3 m / rad of the JAX
    builder's; `to("cpu")` copies the extrapolator onto the new device."""
    jb = JaxBuilder3D(imu_based(builder_options(jconfig)), {"range"})
    tb = TorchBuilder3D(imu_based(builder_options(tconfig)), {"range"}, device="cpu")
    j_res, t_res, steps = carried(jb, tb, events(jdata, 4), events(tdata, 4), feed,
                                  prediction_arg=0)
    assert isinstance(tb._extrapolator, TorchExtrapolator)
    matched = [s for s in steps if s[3] is not None]
    assert len(t_res) == len(j_res) == 4 and len(matched) >= 3
    for j_pred, t_pred, j_pose, t_pose in matched:
        assert_poses_close(t_pred, j_pred)
        np.testing.assert_allclose(t_pose[:3], j_pose[:3], atol=1e-3)
        assert 2.0 * math.acos(min(1.0, abs(float(np.dot(t_pose[3:], j_pose[3:]))))) < 1e-3
    for j, t in zip(j_res, t_res):
        assert t.time == j.time
        assert (t.insertion_result is None) == (j.insertion_result is None)
    twin = tb.to("cpu")
    assert twin._extrapolator is not tb._extrapolator
    assert twin._extrapolator.device.type == "cpu"
