"""3D local SLAM of the PyTorch port against the JAX package: the
`ActiveSubmaps3D` lifecycle and `Submap3D.finish`, the per-scan
`LocalTrajectoryBuilder3D` (paged and dense grids, intensities, online
correlative matching) over 8 scans from one carried state, the chunked
builder's schedule against the per-scan builder (dense and paged), and the
configurations that are not ported."""

import logging
import math

import numpy as np
import pytest

from cartographer_tpu import metrics as jmetrics
from cartographer_tpu.common import config as jconfig
from cartographer_tpu.mapping import submap_3d as jsubmap
from cartographer_tpu.mapping.local_trajectory_builder_3d import (
    LocalTrajectoryBuilder3D as JaxLocalBuilder,
)
from cartographer_tpu.sensor import data as jdata
from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.mapping import submap_3d as tsubmap
from cartographer_tpu_torch.mapping.chunked_frontend_3d import (
    ChunkedLocalTrajectoryBuilder3D,
    supports,
)
from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
    LocalTrajectoryBuilder3D as TorchLocalBuilder,
)
from cartographer_tpu_torch.mapping.map_builder import MapBuilder
from cartographer_tpu_torch.mapping.paged_grid_3d import PagedGrid3D, as_dense
from cartographer_tpu_torch.sensor import data as tdata
from cartographer_tpu_torch.testing.synthetic import (
    FAKE_START_TIME,
    generate_fake_range_measurements,
)
from cartographer_tpu_torch.transform import rigid3
from tests.test_torch_backend_card import one_torch_thread  # noqa: F401
from tests.test_torch_frontend_3d import imu_stream

TRAVEL = 1.0


def builder_options(mod, sparse=True, intensities=False, rtcsm=False):
    """The JAX package's 3D test options (tests/test_chunked_frontend_3d.py)
    with 2 range data per submap, so that a few inserts create, pop and
    finish submaps; dense grids of 128 / 48 cells (+-6.4 m and +-10.8 m
    hold the 5 m wall) and paged ones of 24^3 blocks of 8^3 cells."""
    options = mod.TrajectoryBuilder3DOptions(
        min_range=0.1,
        max_range=10.0,
        motion_filter=mod.MotionFilterOptions(
            max_time_seconds=0.5, max_distance_meters=0.05, max_angle_radians=0.004
        ),
        high_resolution_adaptive_voxel_filter=mod.AdaptiveVoxelFilterOptions(
            max_length=2.0, min_num_points=100, max_range=15.0
        ),
        low_resolution_adaptive_voxel_filter=mod.AdaptiveVoxelFilterOptions(
            max_length=4.0, min_num_points=150, max_range=15.0
        ),
        use_intensities=intensities,
        use_online_correlative_scan_matching=rtcsm,
        real_time_correlative_scan_matcher=mod.RealTimeCorrelativeScanMatcherOptions(
            linear_search_window=0.15, angular_search_window=math.radians(3.0)
        ),
        submaps=mod.SubmapsOptions3D(
            num_range_data=2, high_resolution=0.10, low_resolution=0.45,
            high_resolution_grid_size=128, low_resolution_grid_size=48,
            sparse_grids=sparse, sparse_block_bits=3,
            sparse_high_table_size=24, sparse_high_pool_blocks=1024,
            sparse_low_table_size=24, sparse_low_pool_blocks=1024,
        ),
    )
    return options


def scans(num, intensities=False):
    direction = np.array([2.0, 1.0, 0.0])
    direction /= np.linalg.norm(direction)
    out = generate_fake_range_measurements(
        translation=direction * TRAVEL, duration=4.0, time_step=0.1
    )[:num]
    if intensities:
        rng = np.random.default_rng(0)
        for m in out:
            m.intensities = rng.uniform(5.0, 60.0, m.ranges.size).astype(np.float32)
    return out


def events(data_mod, num, intensities=False):
    imu = imu_stream(data_mod.ImuData, FAKE_START_TIME - 0.5, FAKE_START_TIME + 4.1)
    out = [("imu", d.time, d) for d in imu] + [
        ("range", m.time, m) for m in scans(num, intensities)]
    return sorted(out, key=lambda e: (e[1], e[0] == "range"))


def feed(builder, evs):
    results = []
    for kind, _, payload in evs:
        if kind == "imu":
            builder.add_imu_data(payload)
        else:
            r = builder.add_range_data("range", payload)
            if isinstance(r, list):
                results.extend(r)
            elif r is not None:
                results.append(r)
    if hasattr(builder, "flush"):
        results.extend(builder.flush())
    return results


# -- ActiveSubmaps3D ----------------------------------------------------------


def range_data_stream(data_mod, num, seed=3):
    """Range data in the local frame around a moving origin (a noisy ring
    of returns, some of them far off), with intensities, and the
    gravity-aligned rotation and histogram of each."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num):
        origin = np.array([0.0513 * i + 0.011, 0.0217 * i, 0.005 * i], np.float32)
        th = np.linspace(-np.pi, np.pi, 300, endpoint=False)
        r = 2.2 + 0.05 * rng.normal(size=300)
        hits = origin + np.stack([r * np.cos(th), r * np.sin(th),
                                  rng.uniform(-1.0, 1.0, 300)], 1)
        hits[:10] = origin + rng.uniform(-30, 30, (10, 3))  # far off
        rd = data_mod.RangeData(
            origin=origin,
            returns=data_mod.PointCloud(hits.astype(np.float32),
                                        rng.uniform(5, 60, 300).astype(np.float32)),
            misses=data_mod.PointCloud(np.zeros((0, 3), np.float32)),
        )
        yaw = 0.02 * i
        lfga = np.array([math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)])
        histogram = rng.uniform(0, 1, 24).astype(np.float32)
        out.append((rd, lfga, histogram))
    return out


def grid_fields(grid):
    if isinstance(grid, jsubmap.PagedGrid3D):
        return {k: np.asarray(getattr(grid, k)) for k in
                ("table", "pool", "num_blocks", "dropped", "origin")}
    return {"values": np.asarray(grid.values), "origin": np.asarray(grid.origin)}


def torch_grid_fields(grid):
    if isinstance(grid, PagedGrid3D):
        return {k: getattr(grid, k).numpy() for k in
                ("table", "pool", "num_blocks", "dropped", "origin")}
    return {"values": grid.values.numpy(), "origin": grid.origin.numpy()}


@pytest.mark.parametrize(
    "sparse,intensities", [(True, False), (False, False), (True, True)],
    ids=["paged", "dense", "intensities"],
)
def test_active_submaps_3d_match_jax(sparse, intensities):
    """Ten inserts, two range data per submap: submaps created, popped and
    finished alike, their grids (paged tables and pools, dense volumes,
    the cropped dense grids of finished paged submaps) bit-identical and
    their intensity sums within 1e-6. With intensities the grids are dense
    whatever sparse_grids says."""
    def opts(mod):
        return mod.SubmapsOptions3D(
            num_range_data=2, high_resolution=0.1, low_resolution=0.45,
            high_resolution_grid_size=64, low_resolution_grid_size=16,
            sparse_grids=sparse, sparse_block_bits=3, sparse_high_table_size=8,
            sparse_high_pool_blocks=256, sparse_low_table_size=4,
            sparse_low_pool_blocks=64,
        )

    j_active = jsubmap.ActiveSubmaps3D(opts(jconfig), use_intensities=intensities)
    t_active = tsubmap.ActiveSubmaps3D(opts(tconfig), use_intensities=intensities,
                                       device="cpu")
    finished = 0
    for (j_rd, lfga, hist), (t_rd, _, _) in zip(range_data_stream(jdata, 10),
                                                range_data_stream(tdata, 10)):
        j_subs = j_active.insert_data(j_rd, lfga, hist)
        t_subs = t_active.insert_data(t_rd, lfga, hist)
        assert len(t_subs) == len(j_subs)
        for a, b in zip(t_subs, j_subs):
            assert a.num_range_data == b.num_range_data
            assert a.insertion_finished == b.insertion_finished
            np.testing.assert_array_equal(a.local_pose, b.local_pose)
            np.testing.assert_array_equal(a.rotational_scan_matcher_histogram,
                                          b.rotational_scan_matcher_histogram)
            for name in ("high_resolution_grid", "low_resolution_grid"):
                ga, gb = getattr(a, name), getattr(b, name)
                paged = sparse and not intensities and not a.insertion_finished
                assert isinstance(ga, PagedGrid3D) == paged
                fa, fb = torch_grid_fields(ga), grid_fields(gb)
                assert set(fa) == set(fb)
                for k in fa:
                    np.testing.assert_array_equal(fa[k], fb[k], err_msg=(name, k))
            if intensities:
                for name in ("intensity_sum", "intensity_count"):
                    np.testing.assert_allclose(getattr(a, name).numpy(),
                                               np.asarray(getattr(b, name)),
                                               rtol=1e-6, atol=1e-6)
                assert float(a.intensity_count.sum()) > 100
        finished += t_subs[0].insertion_finished
    assert finished >= 3
    # Finished paged submaps were densified: every grid is dense then.
    assert not isinstance(t_subs[0].high_resolution_grid, PagedGrid3D)


def test_finish_counts_dropped_writes(caplog):
    """A paged submap whose pool overflowed counts its dropped writes in
    mapping_grid_out_of_extent_points and warns when it finishes, as the
    JAX package does."""
    def opts(mod):
        return mod.SubmapsOptions3D(
            num_range_data=1, high_resolution=0.1, low_resolution=0.45,
            sparse_grids=True, sparse_block_bits=3, sparse_high_table_size=8,
            sparse_high_pool_blocks=4, sparse_low_table_size=4,
            sparse_low_pool_blocks=4,
        )

    collected = metrics.enable_collection()
    j_collected = jmetrics.enable_collection()
    try:
        j_active = jsubmap.ActiveSubmaps3D(opts(jconfig))
        t_active = tsubmap.ActiveSubmaps3D(opts(tconfig), device="cpu")
        with caplog.at_level(logging.WARNING):
            for (j_rd, lfga, hist), (t_rd, _, _) in zip(range_data_stream(jdata, 3),
                                                        range_data_stream(tdata, 3)):
                j_active.insert_data(j_rd, lfga, hist)
                t_active.insert_data(t_rd, lfga, hist)
        name = "mapping_grid_out_of_extent_points"
        dropped = collected.registry()[name].value()
        assert dropped == j_collected.registry()[name].value() > 100
    finally:
        metrics.register_family_factory(metrics.FamilyFactory())
        jmetrics.register_family_factory(jmetrics.FamilyFactory())
    warned = [r for r in caplog.records
              if r.name == "cartographer_tpu_torch.mapping.submap_3d"
              and "dropped" in r.message]
    assert len(warned) >= 2  # both grids of the first finished submap


# -- LocalTrajectoryBuilder3D -------------------------------------------------


def carried_runs(variant, num_scans=8):
    """Both per-scan builders over the same scans and IMU, the port's
    carried along the JAX one's: at every scan the port's own match is
    recorded, and the JAX match goes on into both extrapolators, motion
    filters and submaps. So each scan starts both matchers from one
    state. Returns both runs' results and per scan the two matches."""
    kw = dict(sparse=variant != "dense", intensities=variant == "intensities",
              rtcsm=variant == "rtcsm")
    jb = JaxLocalBuilder(builder_options(jconfig, **kw), {"range"})
    tb = TorchLocalBuilder(builder_options(tconfig, **kw), {"range"}, device="cpu")
    j_match, t_match = jb._scan_match, tb._scan_match
    steps = []

    def j_step(*args):
        pose = j_match(*args)
        steps.append([np.asarray(pose), None])
        return pose

    def t_step(*args):
        step = next(s for s in steps if s[1] is None)
        step[1] = np.asarray(t_match(*args))
        return step[0]

    jb._scan_match, tb._scan_match = j_step, t_step
    intens = variant == "intensities"
    j_res = feed(jb, events(jdata, num_scans, intens))
    t_res = feed(tb, events(tdata, num_scans, intens))
    return j_res, t_res, steps, tb


def angle_between(a, b):
    return 2.0 * math.acos(min(1.0, abs(float(np.dot(a[3:7], b[3:7])))))


@pytest.mark.parametrize("variant", ["paged", "dense", "intensities", "rtcsm"])
def test_local_builder_matches_jax(variant):
    """Eight scans from one carried state: the same results and inserts,
    equal poses (the port's copy of the extrapolator and filters), and
    each scan's own match within 1e-3 m / 1e-3 rad of the JAX one. The
    matcher alone holds 1e-4 (tests/test_torch_gauss_newton_3d.py); here
    the LM stops on a relative-cost test in the semicircle world's flat
    valley (z and yaw are weakly observed), so ulp-level differences in
    its inputs move a scan's result by up to 2.2e-4 m (dense grids, the
    fourth scan), as in 2D (tests/test_torch_local_slam_2d.py)."""
    j_res, t_res, steps, tb = carried_runs(variant)
    assert len(t_res) == len(j_res) == 8
    for j, t in zip(j_res, t_res):
        assert t.time == j.time
        assert (t.insertion_result is None) == (j.insertion_result is None)
        np.testing.assert_allclose(t.local_pose, j.local_pose, atol=1e-9)
    matched = [s for s in steps if s[1] is not None]
    assert len(matched) == len(steps) >= 7  # all but the first scan match
    for j_pose, t_pose in matched:
        np.testing.assert_allclose(t_pose[:3], j_pose[:3], atol=1e-3, rtol=0)
        assert angle_between(t_pose, j_pose) < 1e-3
    inserted = [r for r in t_res if r.insertion_result is not None]
    assert len(inserted) >= 4
    assert inserted[-1].insertion_result.insertion_submaps[0].num_range_data > 2
    data = inserted[-1].insertion_result.constant_data
    assert data.rotational_scan_matcher_histogram.shape == (120,)
    assert data.high_resolution_point_cloud.shape[0] > 0
    submap = tb._active_submaps.submaps()[0]
    if variant == "intensities":
        assert float(submap.intensity_count.sum()) > 0
    high = as_dense(submap.high_resolution_grid)
    assert int((high.values != 0).sum()) > 100
    assert np.linalg.norm(submap.rotational_scan_matcher_histogram) > 0


def test_local_builder_copy_runs_alike():
    """`to(device)` copies the builder as it stands: the copy and the
    original take the next scans alike."""
    builder = TorchLocalBuilder(builder_options(tconfig), {"range"}, device="cpu")
    evs = events(tdata, 6)
    split = [i for i, e in enumerate(evs) if e[0] == "range"][3] + 1
    feed(builder, evs[:split])
    twin = builder.to("cpu")
    a_grid = builder._active_submaps.submaps()[0].high_resolution_grid
    b_grid = twin._active_submaps.submaps()[0].high_resolution_grid
    assert a_grid is not b_grid and a_grid.pool.data_ptr() != b_grid.pool.data_ptr()
    a, b = feed(builder, evs[split:]), feed(twin, evs[split:])
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.local_pose, y.local_pose)


# -- the chunked builder ------------------------------------------------------


@pytest.mark.parametrize("sparse", [True, False], ids=["paged", "dense"])
def test_chunked_schedule_matches_per_scan(sparse):
    """The chunked builder against the per-scan one, as the JAX package
    holds its own (tests/test_chunked_frontend_3d.py): the same results
    and node schedule, poses within 0.03 m, bounded drift, the same
    submap counts at every insert, and grids attached to every submap."""
    options = builder_options(tconfig, sparse=sparse)
    options.motion_filter = tconfig.MotionFilterOptions(
        max_time_seconds=0.5, max_distance_meters=0.2, max_angle_radians=0.2)
    evs = events(tdata, 24)
    per_scan = TorchLocalBuilder(options, {"range"}, device="cpu")
    host, host_counts = [], []
    for r in feed_each(per_scan, evs):
        host.append(r)
        if r.insertion_result is not None:
            host_counts.append(tuple(
                s.num_range_data for s in r.insertion_result.insertion_submaps))
    chunked = ChunkedLocalTrajectoryBuilder3D(options, {"range"}, chunk_size=8,
                                              device="cpu")
    results = feed(chunked, evs)
    assert len(results) == len(host) > 15
    assert [r.insertion_result is not None for r in results] == [
        r.insertion_result is not None for r in host]
    for h, c in zip(host, results):
        assert h.time == c.time
        assert np.linalg.norm(rigid3.trans(h.local_pose) - rigid3.trans(c.local_pose)) < 0.03
    direction = np.array([2.0, 1.0, 0.0]) / math.sqrt(5.0)
    last = results[-1]
    expected = (last.time - FAKE_START_TIME) * direction * TRAVEL / 4.0
    assert np.linalg.norm(rigid3.trans(last.local_pose) - expected) < 0.1 * TRAVEL
    # Submap counts as each insert saw them (the chunk replays the events
    # before the next chunk mutates them).
    chunk_counts = [c for c in chunked_counts(options, evs)]
    assert chunk_counts == host_counts
    for r in results:
        if r.insertion_result is None:
            continue
        for s in r.insertion_result.insertion_submaps:
            assert s.high_resolution_grid is not None
            assert s.low_resolution_grid is not None


def feed_each(builder, evs):
    """Per-scan results as they come (counts read before the next scan)."""
    for kind, _, payload in evs:
        if kind == "imu":
            builder.add_imu_data(payload)
            continue
        r = builder.add_range_data("range", payload)
        if r is not None:
            yield r


def chunked_counts(options, evs):
    """Submap counts at every insert of a chunked run, read off the
    replayed events right after each insert."""
    builder = ChunkedLocalTrajectoryBuilder3D(options, {"range"}, chunk_size=8,
                                              device="cpu")
    counts = []
    replay = builder._replay_insert

    def recording(*args):
        result = replay(*args)
        counts.append(tuple(s.num_range_data for s in result.insertion_submaps))
        return result

    builder._replay_insert = recording
    feed(builder, evs)
    return counts


def test_chunked_drops_odometry_observably(caplog):
    """Odometry is not fused by the chunked 3D frontend: one warning, and
    every sample counted in mapping_frontend_odometry_samples_dropped."""
    collected = metrics.enable_collection()
    try:
        builder = ChunkedLocalTrajectoryBuilder3D(builder_options(tconfig), {"range"},
                                                  device="cpu")
        with caplog.at_level(logging.WARNING):
            for k in range(3):
                builder.add_odometry_data(tdata.OdometryData(
                    time=FAKE_START_TIME + 0.1 * k, pose=rigid3.identity()))
        name = "mapping_frontend_odometry_samples_dropped"
        assert collected.registry()[name].value() == 3
    finally:
        metrics.register_family_factory(metrics.FamilyFactory())
    assert sum("does not fuse odometry" in r.message for r in caplog.records) == 1


def test_unported_and_unsupported_configurations_raise():
    options = builder_options(tconfig, intensities=True)
    assert not supports(options)
    with pytest.raises(ValueError, match="LocalTrajectoryBuilder3D"):
        ChunkedLocalTrajectoryBuilder3D(options, {"range"}, device="cpu")
    # The IMU-based extrapolator is ported: the per-scan builder takes it,
    # and MapBuilder's 3D route builds that builder with it
    # (tests/test_torch_imu_based_extrapolator.py drives both).
    options = builder_options(tconfig)
    options.pose_extrapolator.use_imu_based = True
    assert not supports(options)
    TorchLocalBuilder(options, {"range"}, device="cpu")
    mb = MapBuilder(tconfig.MapBuilderOptions(use_trajectory_builder_2d=False,
                                              use_trajectory_builder_3d=True),
                    device="cpu")
    tid = mb.add_trajectory_builder(
        {"range", "imu"},
        tconfig.TrajectoryBuilderOptions(trajectory_builder_3d=options),
    )
    local = mb.get_trajectory_builder(tid)._wrapped._local_trajectory_builder
    assert isinstance(local, TorchLocalBuilder)
    mb.shutdown()
