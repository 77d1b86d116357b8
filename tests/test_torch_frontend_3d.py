"""The PyTorch port's chunked 3D frontend program `frontend_3d.run_chunk`
against the JAX package's, in dense and paged mode: every chunk starts
both from the JAX state carried so far, with one packed buffer (built by
the port's ChunkedLocalTrajectoryBuilder3D, whose packing is the JAX
builder's), and the insert flags, submap events, poses, grids and the
chunk's finished-submap ring are compared."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.ops import frontend_3d as jf
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.mapping.chunked_frontend_3d import (
    ChunkedLocalTrajectoryBuilder3D,
)
from cartographer_tpu_torch.ops import frontend_3d as tf
from cartographer_tpu_torch.sensor.data import ImuData
from cartographer_tpu_torch.testing.synthetic import (
    FAKE_START_TIME,
    generate_fake_range_measurements,
)
from tests.test_torch_backend_card import one_torch_thread  # noqa: F401

CHUNK = 4
FLAGS = ("matched", "inserted", "created", "popped", "finished", "count0",
         "count1", "oob_high", "oob_low")


def small_options(mod, sparse, max_range=10.0):
    """The JAX package's 3D test settings cut down: 2 range data per submap
    and an insert every other scan, so three chunks of four scans create,
    pop and finish submaps; grids of 128 / 32 cells (paged: 16^3 blocks of
    8^3 cells and 512 of them per grid)."""
    return mod.TrajectoryBuilder3DOptions(
        min_range=0.1,
        max_range=max_range,
        motion_filter=mod.MotionFilterOptions(
            max_time_seconds=0.15, max_distance_meters=0.2, max_angle_radians=0.2
        ),
        high_resolution_adaptive_voxel_filter=mod.AdaptiveVoxelFilterOptions(
            max_length=2.0, min_num_points=100, max_range=15.0
        ),
        low_resolution_adaptive_voxel_filter=mod.AdaptiveVoxelFilterOptions(
            max_length=4.0, min_num_points=150, max_range=15.0
        ),
        submaps=mod.SubmapsOptions3D(
            num_range_data=2, high_resolution=0.10, low_resolution=0.45,
            high_resolution_grid_size=128, low_resolution_grid_size=32,
            sparse_grids=sparse, sparse_block_bits=3,
            sparse_high_table_size=16, sparse_high_pool_blocks=512,
            sparse_low_table_size=16, sparse_low_pool_blocks=512,
        ),
    )


def imu_stream(data_cls, t0, t1, rate=50.0):
    return [
        data_cls(time=t, linear_acceleration=np.array([0.0, 0.0, 9.8]),
                 angular_velocity=np.zeros(3))
        for t in np.arange(t0, t1, 1.0 / rate)
    ]


def semicircle_scans(num):
    direction = np.array([2.0, 1.0, 0.0])
    direction /= np.linalg.norm(direction)
    return generate_fake_range_measurements(
        translation=direction * 1.0, duration=4.0, time_step=0.1
    )[:num]


def captured_chunks(options, num_chunks):
    """The (cfg, epoch shift, packed buffer) of each chunk the port's
    builder dispatches."""
    builder = ChunkedLocalTrajectoryBuilder3D(
        options, {"range"}, chunk_size=CHUNK, device="cpu"
    )
    captured = []
    run = tf.run_chunk

    def capture(cfg, state, shift, buf):
        captured.append((cfg, shift, buf.clone()))
        return run(cfg, state, shift, buf)

    scans = semicircle_scans(CHUNK * num_chunks)
    # The IMU starts just before the first scan, so every chunk has the
    # same IMU slot count (one compile of the JAX program).
    imu = imu_stream(ImuData, FAKE_START_TIME - 0.05, FAKE_START_TIME + 2.0)
    tf.run_chunk = capture
    try:
        i = 0
        for m in scans:
            while i < len(imu) and imu[i].time <= m.time:
                builder.add_imu_data(imu[i])
                i += 1
            builder.add_range_data("range", m)
    finally:
        tf.run_chunk = run
    first_imu = imu[0]
    return captured, first_imu


def jax_state_as_numpy(state):
    return {
        f.name: None if getattr(state, f.name) is None
        else np.asarray(getattr(state, f.name))
        for f in dataclasses.fields(state)
    }


def scalars(packed, c):
    n = len(tf.SCALARS)
    return np.asarray(packed)[: c * n * 4].view(np.float32).reshape(c, n)


def initial_jax_state(jcfg, first_imu):
    """The JAX builder's initial state from the first IMU sample."""
    from cartographer_tpu.mapping.imu_tracker import ImuTracker

    tracker = ImuTracker(jcfg.imu_gravity_time_constant, first_imu.time)
    tracker.add_imu_linear_acceleration_observation(first_imu.linear_acceleration)
    tracker.add_imu_angular_velocity_observation(first_imu.angular_velocity)
    tracker.advance(first_imu.time)
    return jf.init_state(
        jcfg, 0.0, initial_q=tracker.orientation(),
        tracker_grav=tracker._gravity_vector,
        tracker_omega=tracker._imu_angular_velocity, tracker_last_acc_t=0.0,
    )


@pytest.mark.parametrize(
    "sparse,max_range", [(False, 10.0), (True, 5.0)],
    ids=["dense", "paged_with_misses"],
)
def test_run_chunk_matches_jax(sparse, max_range):
    """From one state and one buffer, per chunk: identical flags, counts
    and dropped writes, poses within 1e-3 m / 1e-3 (quaternion
    components), grids equal but for boundary cells, and the same finished
    submaps. With max_range 5 m about half of the wall comes back as
    missing echoes.

    Most scans agree to ~1e-6; the LM stops on a relative-cost test in a
    flat valley, so ulp-level input differences can move one scan's stop
    by an iteration (4.7e-4 in the fourth scan of the second paged chunk),
    which the chunk's later scans carry, as in 2D
    (tests/test_torch_frontend_2d.py)."""
    captured, first_imu = captured_chunks(small_options(tconfig, sparse, max_range), 3)
    assert len(captured) == 3
    jstate = None
    seen = {k: 0.0 for k in FLAGS}
    S = tf.SIDX
    for cfg, shift, buf in captured:
        assert cfg.paged == sparse and cfg.has_misses == (max_range < 6.0)
        jcfg = jf.FrontendConfig3D(**dataclasses.asdict(cfg))
        if jstate is None:
            jstate = initial_jax_state(jcfg, first_imu)
        tstate = tf.state_from_numpy(jax_state_as_numpy(jstate), device="cpu")
        j_state, j_fin, j_packed = jf.run_chunk(
            jcfg, jstate, jnp.float32(shift), jnp.asarray(buf.numpy()))
        t_state, t_fin, t_packed = tf.run_chunk(cfg, tstate, shift, buf)
        js, ts = scalars(j_packed, CHUNK), scalars(t_packed.numpy(), CHUNK)
        for k in FLAGS:
            np.testing.assert_array_equal(ts[:, S[k]], js[:, S[k]], err_msg=k)
            seen[k] += js[:, S[k]].sum()
        pose = slice(S["est_x"], S["g_qz"] + 1)
        np.testing.assert_allclose(ts[:, pose], js[:, pose], atol=1e-3, rtol=0)
        assert t_packed.shape == j_packed.shape
        # The quantized clouds and their filter codes.
        j_bytes, t_bytes = np.asarray(j_packed), t_packed.numpy()
        assert (j_bytes == t_bytes).mean() > 0.995
        grids = (["pg_table", "pg_pool", "pg_nblocks", "pg_dropped"] if sparse
                 else ["high_values", "low_values"])
        for name in grids:
            a = getattr(t_state, name).numpy()
            b = np.asarray(getattr(j_state, name))
            assert (a == b).mean() >= 0.9999, name
        assert int(t_fin["count"]) == int(j_fin["count"])
        for k in t_fin:
            if k != "count":
                for i in range(int(j_fin["count"])):
                    assert (t_fin[k][i].numpy() == np.asarray(j_fin[k][i])).mean() >= 0.9999
        jstate = j_state
    assert seen["matched"] and seen["inserted"] and seen["created"]
    assert seen["popped"] and seen["finished"]


def test_state_round_trip_and_jax_fields():
    """state_from_numpy inverts state_to_numpy; the fields, their dtypes
    and initial values are the JAX package's in both modes."""
    for sparse in (False, True):
        options = small_options(tconfig, sparse)
        cfg = ChunkedLocalTrajectoryBuilder3D(options, {"range"}, device="cpu")._cfg
        state = tf.init_state(cfg, 1.5, device="cpu")
        d = tf.state_to_numpy(state)
        back = tf.state_from_numpy(d, device="cpu")
        for f in dataclasses.fields(state):
            a, b = getattr(state, f.name), getattr(back, f.name)
            assert (a is None) == (b is None), f.name
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), f.name
        jd = jax_state_as_numpy(jf.init_state(
            jf.FrontendConfig3D(**dataclasses.asdict(cfg)), 1.5))
        assert set(jd) == set(d)
        for k in d:
            assert (jd[k] is None) == (d[k] is None), k
            if d[k] is not None:
                assert jd[k].dtype == d[k].dtype, k
                np.testing.assert_array_equal(jd[k], d[k], err_msg=k)


def test_layouts_and_unported_options():
    options = small_options(tconfig, True)
    cfg = dataclasses.replace(
        ChunkedLocalTrajectoryBuilder3D(options, {"range"}, device="cpu")._cfg,
        chunk_size=4, num_points=512, max_imu_per_scan=8,
    )
    jcfg = jf.FrontendConfig3D(**dataclasses.asdict(cfg))
    for linear in (False, True):
        for misses in (False, True):
            c = dataclasses.replace(cfg, linear_times=linear, has_misses=misses)
            j = dataclasses.replace(jcfg, linear_times=linear, has_misses=misses)
            assert tf.input_layout(c) == jf.input_layout(j)
            assert tf.output_layout(c) == jf.output_layout(j)
    assert tf.point_quantization_scale(cfg) == jf.point_quantization_scale(jcfg)
    assert tf.SCALARS == jf.SCALARS
    state = tf.init_state(cfg, device="cpu")
    buf = torch.zeros(tf.input_layout(cfg)[-1], dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="stubs"):
        tf.run_chunk(dataclasses.replace(cfg, disable="match"), state, 0.0, buf)
    with pytest.raises(ValueError, match="packed_input"):
        tf.run_chunk(cfg, state, 0.0, buf[:-1])
    with pytest.raises(ValueError, match="equal high/low"):
        tf.init_state(dataclasses.replace(cfg, low_pool_blocks=8), device="cpu")
