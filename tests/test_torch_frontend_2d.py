"""The PyTorch port of the chunked 2D local-SLAM frontend against the JAX
package, as a whole: `run_chunk` on one packed buffer from one carried
state, and `ChunkedLocalTrajectoryBuilder2D` over a scan stream. Both
run with online correlative matching on and the direct-gather LM matcher
(`use_band_matcher=False` on the JAX side; the band matcher is a TPU
formulation the port does not have).

The semicircle world is centred on the sensor, so yaw is weakly observed:
with a wide RTCSM window both implementations wander in yaw and break
near-ties differently. The window is 3 degrees here, as in the JAX
package's own RTCSM test (tests/test_chunked_frontend_2d.py:309-338)."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.common import config as jconfig
from cartographer_tpu.mapping.chunked_frontend_2d import (
    ChunkedLocalTrajectoryBuilder2D as JaxBuilder,
)
from cartographer_tpu.ops import frontend_2d as jf
from cartographer_tpu.sensor.data import TimedPointCloud, TimedPointCloudData
from cartographer_tpu.testing.synthetic import generate_fake_range_measurements
from cartographer_tpu.transform import rigid3
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.mapping import probability_values as pv
from cartographer_tpu_torch.mapping.chunked_frontend_2d import (
    ChunkedLocalTrajectoryBuilder2D as TorchBuilder,
)
from cartographer_tpu_torch.ops import frontend_2d as tf
from cartographer_tpu_torch.ops.scan_matching.correlative_2d import (
    compute_angular_step,
)

RES = 0.05
GRID = 256  # 12.8 m: the 5 m wall fits the extent
CHUNK = 8
N_POINTS = 1792  # the wall's 1575 (+64 open-side) points, padded to 256s
WINDOW = math.radians(3.0)


def semicircle_scans(num, open_side_misses=False):
    """The JAX package's semicircle world. With `open_side_misses`, 64
    beams into the open half of the semicircle come back at 12 m, beyond
    max_range, as missing echoes."""
    direction = np.array([2.0, 1.0, 0.0])
    direction /= np.linalg.norm(direction)
    scans = generate_fake_range_measurements(
        translation=direction * 1.2, duration=4.0, time_step=0.1
    )[:num]
    if not open_side_misses:
        return scans
    a = np.linspace(np.pi + 0.05, 2 * np.pi - 0.05, 64)
    far = np.stack([12 * np.cos(a), 12 * np.sin(a), np.zeros(64)], 1)
    out = []
    for m in scans:
        pts = np.concatenate([m.ranges.points, far.astype(np.float32)])
        out.append(TimedPointCloudData(
            m.time, m.origin, TimedPointCloud(pts, np.zeros(len(pts), np.float32))
        ))
    return out


def cfg_kwargs(max_range, has_misses):
    a_cap = int(math.ceil(WINDOW / compute_angular_step(RES, min(max_range, 50.0))))
    return dict(
        grid_size=GRID, resolution=RES, num_range_data=2,
        hit_log_odds=pv.hit_update_log_odds(0.55),
        miss_log_odds=pv.miss_update_log_odds(0.49),
        insert_free_space=True, min_range=0.0, max_range=max_range,
        missing_data_ray_length=5.0, min_z=-0.8, max_z=2.0,
        voxel_filter_size=0.025, avf_max_length=0.5, avf_min_num_points=200,
        avf_max_range=50.0, occupied_space_weight=1.0,
        translation_weight=10.0, rotation_weight=40.0, gn_iterations=20,
        mf_max_time=5.0, mf_max_distance=0.04, mf_max_angle=math.radians(10.0),
        pose_queue_duration=0.001, num_steps=256, max_imu_per_scan=4,
        use_online_correlative=True, rtcsm_angular_search_window=WINDOW,
        rtcsm_num_linear=2, rtcsm_a_cap=a_cap, has_misses=has_misses,
        chunk_size=CHUNK, num_points=N_POINTS, use_band_matcher=False,
    )


def pack_chunk(cfg, scans, epoch):
    """One packed input buffer as __graft_entry__.entry() builds it: int16
    points relative to the sensor origin, all point times at the scan
    time (span 0), meta (t_scan, origin, count, t0, span, z)."""
    q = tf.point_quantization_scale(cfg)
    o_points, o_times, o_meta, o_imu, _, total = tf.input_layout(cfg)
    buf = np.zeros(total, np.uint8)
    scan_points = buf[o_points:o_times].view(np.int16).reshape(CHUNK, N_POINTS, 3)
    scan_meta = buf[o_meta:o_imu].view(np.float32).reshape(CHUNK, 8)
    for i, m in enumerate(scans):
        pts = m.ranges.points
        scan_points[i, : len(pts)] = np.clip(np.round(pts / q), -32767, 32767)
        scan_meta[i, 0] = scan_meta[i, 5] = m.time - epoch
        scan_meta[i, 4] = len(pts)
    return buf


def jax_state_as_numpy(state):
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


def scalars(packed, c):
    n = len(tf.SCALARS)
    return np.asarray(packed)[: c * n * 4].view(np.float32).reshape(c, n)


FLAGS = ["matched", "inserted", "created", "popped", "finished", "num_filtered"]


@pytest.mark.parametrize("has_misses", [False, True])
def test_run_chunk_matches_jax(has_misses):
    kw = cfg_kwargs(10.0, has_misses)
    jcfg = jf.FrontendConfig2D(**kw, use_pallas_rtcsm=False)
    tcfg = tf.FrontendConfig2D(**kw)
    scans = semicircle_scans(2 * CHUNK, open_side_misses=has_misses)
    jstate = jf.init_state(GRID, 0.0)
    epoch = scans[0].time
    seen = {k: 0.0 for k in FLAGS}
    for c in range(2):
        chunk = scans[c * CHUNK : (c + 1) * CHUNK]
        buf = pack_chunk(tcfg, chunk, chunk[0].time)
        shift = np.float32(chunk[0].time - epoch)
        epoch = chunk[0].time
        # Both sides start the chunk from the JAX state, carried across.
        tstate = tf.state_from_numpy(jax_state_as_numpy(jstate), device="cpu")
        j_out = jf.run_chunk(jcfg, jstate, jnp.float32(shift), jnp.asarray(buf))
        t_out = tf.run_chunk(tcfg, tstate, shift, torch.from_numpy(buf))
        jstate, j_fin, j_pts, j_packed = j_out
        tstate, t_fin, t_pts, t_packed = t_out

        js, ts = scalars(j_packed, CHUNK), scalars(t_packed.numpy(), CHUNK)
        S = tf.SIDX
        for k in FLAGS:
            np.testing.assert_array_equal(ts[:, S[k]], js[:, S[k]], err_msg=k)
            seen[k] += js[:, S[k]].sum()
        # Poses: from one state the first scans agree to ~1e-7. The LM
        # stops on a relative-cost test in a flat valley, so once the
        # inputs differ by ulps (transcendentals, sum order) its stopping
        # point moves by up to ~1e-4 m, and the chunk's scan-match ->
        # insert loop carries that on: within 8 scans the two stay within
        # 5e-4 m here, under the 1e-3 m / 1e-3 rad bound.
        xy = [S["pose_x"], S["pose_y"], S["anchor_x"], S["anchor_y"]]
        np.testing.assert_allclose(ts[:, xy], js[:, xy], atol=1e-3)
        np.testing.assert_allclose(ts[:, S["pose_yaw"]], js[:, S["pose_yaw"]], atol=1e-3)
        np.testing.assert_array_equal(ts[:, S["count0"]], js[:, S["count0"]])
        np.testing.assert_array_equal(ts[:, S["count1"]], js[:, S["count1"]])

        # Grids: the inserter is bit-identical on equal inputs
        # (test_torch_frontend_ops), but ray ends within the ~1e-4 m pose
        # differences of a cell boundary land in the neighbouring cell, so
        # a few boundary cells differ in their known bit, and a few more
        # (0.14% with 64 missing-echo rays a scan) took one update more or
        # less over the chunk.
        j_known = np.asarray(jstate.grids_known)
        t_known = tstate.grids_known.numpy()
        assert (t_known == j_known).mean() >= 0.999
        both = t_known & j_known
        close = np.abs(tstate.grids_lo.numpy() - np.asarray(jstate.grids_lo)) <= 1e-5
        assert close[both].mean() >= 0.995
        assert int(t_fin["count"]) == int(j_fin["count"])
        for i in range(int(j_fin["count"])):
            assert (t_fin["known"][i].numpy() == np.asarray(j_fin["known"][i])).mean() >= 0.999
        # Per-point outputs: gravity-aligned points and mask codes.
        assert t_pts.shape == j_pts.shape
        np.testing.assert_allclose(
            t_pts.numpy()[..., :3], np.asarray(j_pts)[..., :3], atol=1e-4
        )
        assert (t_pts.numpy()[..., -1] == np.asarray(j_pts)[..., -1]).mean() >= 0.999
    # The run exercised every event kind the flags carry.
    assert seen["matched"] and seen["inserted"] and seen["created"]
    assert seen["popped"] and seen["finished"]
    n_miss = (t_pts.numpy()[..., -1] == 3).sum()
    assert (n_miss > 0) == has_misses


def test_state_round_trip():
    state = tf.init_state(16, 1.5, device="cpu")
    d = tf.state_to_numpy(state)
    back = tf.state_from_numpy(d, device="cpu")
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(back, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name
    jd = jax_state_as_numpy(jf.init_state(16, 1.5))
    assert set(jd) == set(d)
    for k in d:
        assert jd[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(jd[k], d[k], err_msg=k)


def test_unported_options_raise():
    """The TPU band matcher and the debug stage stubs raise; IMU and
    odometry fusion run (tests/test_torch_imu_odometry.py holds them
    against the JAX package)."""
    tcfg = tf.FrontendConfig2D(**cfg_kwargs(10.0, False))
    state = tf.init_state(GRID, device="cpu")
    for change in ({"use_band_matcher": True}, {"disable": "voxel"}):
        cfg = dataclasses.replace(tcfg, **change)
        buf = np.zeros(tf.input_layout(cfg)[-1], np.uint8)
        with pytest.raises(NotImplementedError):
            tf.run_chunk(cfg, state, 0.0, buf)
    cfg = dataclasses.replace(tcfg, use_imu=True, use_odometry=True, chunk_size=1)
    buf = np.zeros(tf.input_layout(cfg)[-1], np.uint8)
    out_state, _, out_points, packed = tf.run_chunk(cfg, state, 0.0, buf)
    assert out_points.shape == (1, N_POINTS, 4)
    assert scalars(packed.numpy(), 1)[0, tf.SIDX["matched"]] == 0.0  # no points
    assert int(out_state.odo_len) == 0


def builder_options(mod):
    return mod.TrajectoryBuilder2DOptions(
        use_imu_data=False,
        max_range=10.0,
        use_online_correlative_scan_matching=True,
        real_time_correlative_scan_matcher=mod.RealTimeCorrelativeScanMatcherOptions(
            angular_search_window=WINDOW
        ),
        motion_filter=mod.MotionFilterOptions(
            max_distance_meters=0.04, max_angle_radians=math.radians(10.0)
        ),
        submaps=mod.SubmapsOptions2D(
            num_range_data=5,
            grid_options_2d=mod.GridOptions2D(resolution=RES, grid_size=GRID),
        ),
    )


def run(builder, measurements):
    results = []
    for m in measurements:
        results.extend(builder.add_range_data("range", m))
    results.extend(builder.flush())
    return results


def lifecycle(results):
    return [
        None if r.insertion_result is None else tuple(
            s.num_range_data for s in r.insertion_result.insertion_submaps
        )
        for r in results
    ]


def test_builder_matches_jax_builder():
    jb = JaxBuilder(builder_options(jconfig), {"range"}, chunk_size=CHUNK)
    jb._cfg = dataclasses.replace(jb._cfg, use_band_matcher=False)
    j_res = run(jb, semicircle_scans(40))
    tb = TorchBuilder(builder_options(tconfig), {"range"}, chunk_size=CHUNK, device="cpu")
    t_res = run(tb, semicircle_scans(40))

    assert [r.time for r in t_res] == [r.time for r in j_res]
    assert lifecycle(t_res) == lifecycle(j_res)
    assert any(s and len(s) == 2 for s in lifecycle(t_res))
    # The scan-match -> insert loop amplifies float differences over the
    # run (tests/test_chunked_frontend_2d.py:87-100), hence 0.05 m.
    for j, t in zip(j_res, t_res):
        err = np.linalg.norm(rigid3.trans(j.local_pose) - rigid3.trans(t.local_pose))
        assert err < 0.05, (t.time, err)
    finished = 0
    for r in t_res:
        if r.insertion_result:
            assert r.insertion_result.constant_data.filtered_gravity_aligned_point_cloud.shape[1] == 3
            for s in r.insertion_result.insertion_submaps:
                assert s.grid is not None and s.grid.known.dtype == torch.bool
                finished += s.insertion_finished
    assert finished > 0
    assert t_res[-1].range_data_in_local.returns.size > 0


def test_builder_rejects_unported_inputs():
    """IMU data without use_imu_data raises RuntimeError, as in the JAX
    builder; with it the builder is built for IMU fusion; odometry before
    the first scan is ignored."""
    from cartographer_tpu_torch.sensor.data import ImuData, OdometryData

    opts = builder_options(tconfig)
    opts.use_imu_data = True
    assert TorchBuilder(opts, {"range"}, device="cpu")._cfg.use_imu
    tb = TorchBuilder(builder_options(tconfig), {"range"}, device="cpu")
    with pytest.raises(RuntimeError, match="use_imu_data"):
        tb.add_imu_data(ImuData(time=0.0, linear_acceleration=np.array([0, 0, 9.8]),
                                angular_velocity=np.zeros(3)))
    tb.add_odometry_data(OdometryData(time=0.0, pose=rigid3.identity()))
    assert tb._state is None and not tb._odom_buffer
