"""The per-scan 2D local SLAM of the PyTorch port against the JAX package:
the scatter inserter `raycast_2d.insert_scan`, the correlative matcher,
the `ActiveSubmaps2D` lifecycle, `LocalTrajectoryBuilder2D` over a scan
stream, and `MapBuilder`'s routing to it (the default 2D options, the
observable fallback of the chunked frontend, the pure-localization
trimmer).

The semicircle world is centred on the sensor, so yaw is weakly observed:
the correlative window is 3 degrees here, as in
tests/test_torch_frontend_2d.py."""

import logging
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu import metrics as jmetrics
from cartographer_tpu.common import config as jconfig
from cartographer_tpu.mapping import grid_2d as jgrid
from cartographer_tpu.mapping import submap_2d as jsubmap
from cartographer_tpu.mapping.local_trajectory_builder_2d import (
    LocalTrajectoryBuilder2D as JaxLocalBuilder,
)
from cartographer_tpu.mapping.scan_matching_2d import (
    RealTimeCorrelativeScanMatcher2D as JaxRtcsm,
)
from cartographer_tpu.ops import raycast_2d as jray
from cartographer_tpu.sensor import data as jdata
from cartographer_tpu.testing.synthetic import FAKE_START_TIME
from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.mapping import grid_2d as tgrid
from cartographer_tpu_torch.mapping import submap_2d as tsubmap
from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (
    LocalTrajectoryBuilder2D as TorchLocalBuilder,
)
from cartographer_tpu_torch.mapping.id import NodeId
from cartographer_tpu_torch.mapping.map_builder import MapBuilder
from cartographer_tpu_torch.mapping.scan_matching_2d import (
    RealTimeCorrelativeScanMatcher2D as TorchRtcsm,
)
from cartographer_tpu_torch.mapping.trimmers import PureLocalizationTrimmer
from cartographer_tpu_torch.ops import raycast_2d as tray
from cartographer_tpu_torch.sensor import data as tdata
from tests.test_torch_backend_card import one_torch_thread, wall_world  # noqa: F401
from tests.test_torch_frontend_2d import RES, WINDOW, semicircle_scans
from tests.test_torch_imu_odometry import VELOCITY, sensor_events


def random_insert_case(seed, size=96, n=300):
    """A known-in-part grid and rays from inside it, a quarter of whose
    endpoints fall off the grid (up to 20 cells past its edge)."""
    rng = np.random.default_rng(seed)
    log_odds = rng.uniform(-3.0, 3.0, (size, size)).astype(np.float32)
    known = rng.uniform(size=(size, size)) < 0.3
    log_odds[~known] = 0.0
    origin = rng.uniform(0.3 * size, 0.7 * size, 2).astype(np.float32)
    ends = rng.uniform(-20.0, size + 20.0, (n, 2)).astype(np.float32)
    ends[: 3 * n // 4] = rng.uniform(2.0, size - 2.0, (3 * n // 4, 2))
    is_hit = rng.uniform(size=n) < 0.7
    valid = rng.uniform(size=n) < 0.9
    return log_odds, known, origin, ends, is_hit, valid


@pytest.mark.parametrize("insert_free_space", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_insert_scan_matches_jax(seed, insert_free_space):
    log_odds, known, origin, ends, is_hit, valid = random_insert_case(seed)
    num_steps = 256
    args = (0.2, -0.4, num_steps, insert_free_space)
    j_lo, j_kn = jray.insert_scan(
        jnp.asarray(log_odds), jnp.asarray(known), jnp.asarray(origin),
        jnp.asarray(ends), jnp.asarray(is_hit), jnp.asarray(valid), *args,
    )
    t = torch.from_numpy
    t_lo, t_kn = tray.insert_scan(
        t(log_odds), t(known), t(origin), t(ends), t(is_hit), t(valid), *args
    )
    np.testing.assert_array_equal(t_kn.numpy(), np.asarray(j_kn))
    np.testing.assert_allclose(t_lo.numpy(), np.asarray(j_lo), atol=1e-6, rtol=0)
    # Something was inserted, free space only when asked for.
    assert (t_kn.numpy() & ~known).sum() > (200 if insert_free_space else 100)


def test_correlative_matcher_matches_jax():
    log_odds, known, scan, center = wall_world(4, size=128)
    origin = np.array([0.1, -0.2], np.float32)
    jg = jgrid.Grid2D(log_odds=jnp.asarray(log_odds), known=jnp.asarray(known),
                      origin=jnp.asarray(origin), resolution=0.05)
    tg = tgrid.grid_from_numpy(log_odds, known, origin, 0.05, "cpu")
    opts = dict(linear_search_window=0.15, angular_search_window=math.radians(10.0))
    jm = JaxRtcsm(jconfig.RealTimeCorrelativeScanMatcherOptions(**opts))
    tm = TorchRtcsm(tconfig.RealTimeCorrelativeScanMatcherOptions(**opts))
    for k in range(4):
        initial = np.array([center[0] + origin[0] + 0.03 * k, center[1] + origin[1] - 0.04,
                            0.05 * (k - 2)])
        j_score, j_pose = jm.match(initial, scan, jg)
        t_score, t_pose = tm.match(initial, scan, tg)
        assert abs(t_score - j_score) < 1e-6
        np.testing.assert_allclose(t_pose, j_pose, atol=1e-9)


def range_data_stream(num, seed=2):
    """Range data in the local frame: a noisy ring of returns around a
    moving origin plus a few missing echoes, and one far hit off a 64
    grid."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num):
        origin = np.array([0.0513 * i + 0.011, 0.0217 * i + 0.007, 0.0], np.float32)
        th = np.linspace(-np.pi, np.pi, 120, endpoint=False)
        r = 1.2 + 0.05 * rng.normal(size=120)
        hits = origin + np.stack([r * np.cos(th), r * np.sin(th), np.zeros(120)], 1)
        hits[0, :2] = origin[:2] + [4.0, 0.0]  # off the 64 x 0.05 m grid
        misses = origin + np.array([[0.0, 2.5, 0.0], [-2.5, 0.0, 0.0]])
        out.append((origin, hits.astype(np.float32), misses.astype(np.float32)))
    return out


def submaps_options(mod, grid_type="PROBABILITY_GRID"):
    return mod.SubmapsOptions2D(
        num_range_data=3,
        grid_options_2d=mod.GridOptions2D(grid_type=grid_type, resolution=RES, grid_size=64),
    )


def range_data(pkg, origin, hits, misses):
    return pkg.RangeData(origin=origin, returns=pkg.PointCloud(hits),
                         misses=pkg.PointCloud(misses))


def test_active_submaps_lifecycle_matches_jax(caplog):
    js = jsubmap.ActiveSubmaps2D(submaps_options(jconfig))
    ts = tsubmap.ActiveSubmaps2D(submaps_options(tconfig), torch.device("cpu"))
    collected = metrics.enable_collection()
    j_collected = jmetrics.enable_collection()
    try:
        with caplog.at_level(logging.WARNING):
            for origin, hits, misses in range_data_stream(10):
                j_out = js.insert_range_data(range_data(jdata, origin, hits, misses))
                t_out = ts.insert_range_data(range_data(tdata, origin, hits, misses))
                assert [s.num_range_data for s in t_out] == [s.num_range_data for s in j_out]
                assert [s.insertion_finished for s in t_out] == [
                    s.insertion_finished for s in j_out]
                for a, b in zip(t_out, j_out):
                    np.testing.assert_array_equal(a.local_pose, b.local_pose)
                    np.testing.assert_array_equal(a.grid.known.numpy(), np.asarray(b.grid.known))
                    np.testing.assert_allclose(a.grid.log_odds.numpy(),
                                               np.asarray(b.grid.log_odds), atol=1e-6)
                    np.testing.assert_array_equal(a.grid.origin.numpy(), np.asarray(b.grid.origin))
        name = "mapping_grid_out_of_extent_points"
        oob = collected.registry()[name].value()
        j_oob = j_collected.registry()[name].value()
    finally:
        metrics.register_family_factory(metrics.FamilyFactory())
        jmetrics.register_family_factory(jmetrics.FamilyFactory())
    # At least the far hit of every scan, counted alike; one warning per
    # overflowing submap on both sides.
    assert oob == j_oob >= 10
    warned = {"cartographer_tpu.mapping.submap_2d": 0,
              "cartographer_tpu_torch.mapping.submap_2d": 0}
    for r in caplog.records:
        if "extent overflow" in r.message:
            warned[r.name] += 1
    assert warned["cartographer_tpu_torch.mapping.submap_2d"] == warned[
        "cartographer_tpu.mapping.submap_2d"] >= 3


def per_scan_options(mod, grid_type="PROBABILITY_GRID", use_imu=False):
    return mod.TrajectoryBuilder2DOptions(
        use_imu_data=use_imu,
        max_range=10.0,
        use_online_correlative_scan_matching=True,
        real_time_correlative_scan_matcher=mod.RealTimeCorrelativeScanMatcherOptions(
            angular_search_window=WINDOW
        ),
        motion_filter=mod.MotionFilterOptions(
            max_distance_meters=0.04, max_angle_radians=math.radians(10.0)
        ),
        submaps=mod.SubmapsOptions2D(
            num_range_data=3,
            grid_options_2d=mod.GridOptions2D(
                grid_type=grid_type, resolution=RES, grid_size=256
            ),
        ),
    )


def feed_per_scan(builder, events):
    results = []
    for kind, _, payload in events:
        if kind == "imu":
            builder.add_imu_data(payload)
        elif kind == "odom":
            builder.add_odometry_data(payload)
        else:
            r = builder.add_range_data("range", payload)
            if r is not None:
                results.append(r)
    return results


def compare_runs(j_res, t_res, atol):
    assert len(t_res) == len(j_res)
    for j, t in zip(j_res, t_res):
        assert t.time == j.time
        assert (t.insertion_result is None) == (j.insertion_result is None)
        np.testing.assert_allclose(t.local_pose, j.local_pose, atol=atol)
        if t.insertion_result is not None:
            assert [s.num_range_data for s in t.insertion_result.insertion_submaps] == [
                s.num_range_data for s in j.insertion_result.insertion_submaps]


def builder_events(sensors, num_scans):
    if sensors:
        return sensor_events(num_scans, jdata), sensor_events(num_scans, tdata)
    events = [("range", m.time, m) for m in semicircle_scans(num_scans)]
    return events, events


def builders(sensors):
    return (
        JaxLocalBuilder(per_scan_options(jconfig, use_imu=sensors), {"range"}),
        TorchLocalBuilder(per_scan_options(tconfig, use_imu=sensors), {"range"}, device="cpu"),
    )


def carried_runs(sensors, num_scans):
    """Both builders over the same scans, the port's carried along the JAX
    one's: at every scan the port's own match is recorded, and the JAX
    match goes on into its extrapolator, motion filter and submaps. So
    each scan starts both matchers from one state, and only the per-scan
    step is compared. Returns both runs' results, and per scan the two
    pose predictions and the two matches."""
    jb, tb = builders(sensors)
    j_match, t_match = jb._scan_match, tb._scan_match
    steps = []

    def j_step(*args):  # (time, prediction, cloud) in the JAX builder
        pose = j_match(*args)
        steps.append([np.asarray(args[-2]), None, np.asarray(pose), None])
        return pose

    def t_step(prediction, cloud):
        step = next(s for s in steps if s[1] is None)
        step[1], step[3] = np.asarray(prediction), np.asarray(t_match(prediction, cloud))
        return step[2]

    jb._scan_match, tb._scan_match = j_step, t_step
    j_ev, t_ev = builder_events(sensors, num_scans)
    return feed_per_scan(jb, j_ev), feed_per_scan(tb, t_ev), steps


@pytest.mark.parametrize(
    "sensors,free_scans", [(False, 8), (True, 3)], ids=["range", "imu_odometry"]
)
def test_local_builder_matches_jax(sensors, free_scans):
    """Both per-scan builders over 8 scans: the same schedule, and each
    scan's pose prediction and match from one carried state within
    1e-3 m. The predictions are equal: the extrapolator, IMU and odometry
    included, computes the same from the same poses.

    Free-running, the two agree within 1.1e-4 m over all 8 range-only
    scans, and with IMU and odometry over the first 3. The LM stops on a
    relative-cost test, so ulp-level differences move its result by up to
    ~1e-4 m; with IMU and odometry the third scan's 1e-4 m moves the
    fourth's prediction by as much, and the correlative matcher then takes
    the neighbouring angle (a 0.0098 rad step; best scores 0.5867 and
    0.5874), which later scans carry as up to 1.5e-2 m (ROADMAP Queue C)."""
    j_ev, t_ev = builder_events(sensors, free_scans)
    jb, tb = builders(sensors)
    j_res, t_res = feed_per_scan(jb, j_ev), feed_per_scan(tb, t_ev)
    assert len(j_res) == free_scans
    compare_runs(j_res, t_res, 1e-3)

    j_res, t_res, steps = carried_runs(sensors, 8)
    assert len(j_res) == len(steps) == 8
    compare_runs(j_res, t_res, 1e-3)
    for j_prediction, t_prediction, j_pose, t_pose in steps:
        np.testing.assert_array_equal(t_prediction, j_prediction)
        np.testing.assert_allclose(t_pose, j_pose, atol=1e-3)
    last = t_res[-1].insertion_result or next(
        r.insertion_result for r in reversed(t_res) if r.insertion_result)
    assert last.insertion_submaps[0].grid.log_odds.device.type == "cpu"


@pytest.mark.parametrize("grid_type", ["PROBABILITY_GRID", "TSDF"])
def test_local_builder_copy_runs_on_alike(grid_type):
    """`to(device)` copies the builder as it stands: the copy and the
    original take the next scans alike, and neither touches the other's
    grids or extrapolator."""
    builder = TorchLocalBuilder(
        per_scan_options(tconfig, grid_type=grid_type), {"range"}, device="cpu")
    scans = semicircle_scans(6)
    for m in scans[:4]:
        builder.add_range_data("range", m)
    twin = builder.to("cpu")
    assert twin._extrapolator is not builder._extrapolator
    grids = [s.grid for s in builder._active_submaps.submaps()]
    twin_grids = [s.grid for s in twin._active_submaps.submaps()]
    assert len(grids) == len(twin_grids) >= 1
    for a, b in zip(grids, twin_grids):
        assert a is not b and a.origin.data_ptr() != b.origin.data_ptr()
    for m in scans[4:]:
        a, b = builder.add_range_data("range", m), twin.add_range_data("range", m)
        np.testing.assert_array_equal(b.local_pose, a.local_pose)
        assert (a.insertion_result is None) == (b.insertion_result is None)


def map_builder_options(mod):
    pose_graph = mod.PoseGraphOptions(optimize_every_n_nodes=6)
    pose_graph.constraint_builder.fast_correlative_scan_matcher = (
        mod.FastCorrelativeScanMatcherOptions2D(
            linear_search_window=0.5, angular_search_window=math.radians(10.0),
            branch_and_bound_depth=3,
        )
    )
    pose_graph.constraint_builder.loop_closure_backend = "device"
    return mod.MapBuilderOptions(use_trajectory_builder_2d=True, pose_graph=pose_graph)


def test_map_builder_default_options_run_the_per_scan_builder():
    """The default TrajectoryBuilderOptions (per-scan frontend, IMU on)
    plus odometry: routed to LocalTrajectoryBuilder2D, and it runs."""
    options = tconfig.TrajectoryBuilderOptions()
    assert not options.use_chunked_device_frontend
    assert options.trajectory_builder_2d.use_imu_data
    opts2d = options.trajectory_builder_2d
    opts2d.max_range = 10.0
    opts2d.submaps.grid_options_2d.grid_size = 256
    opts2d.submaps.num_range_data = 3
    opts2d.motion_filter.max_distance_meters = 0.04
    mb = MapBuilder(map_builder_options(tconfig), device="cpu")
    tid = mb.add_trajectory_builder({"range", "imu", "odometry"}, options)
    builder = mb.get_trajectory_builder(tid)
    assert isinstance(builder._wrapped._local_trajectory_builder, TorchLocalBuilder)
    names = {"imu": "imu", "odom": "odometry", "range": "range"}
    for kind, _, payload in sensor_events(10, tdata):
        builder.add_sensor_data(names[kind], payload)
    mb.finish_trajectory(tid)
    mb.shutdown()
    nodes = list(mb.pose_graph.get_trajectory_nodes().items(NodeId))
    assert len(nodes) >= 5
    assert np.all(np.isfinite([n.global_pose for _, n in nodes]))


def test_chunked_request_outside_its_scope_falls_back_observably(caplog):
    """use_chunked_device_frontend with a TSDF configuration: one warning
    and one count per scan (tests/test_map_builder.py:140-171)."""
    options = tconfig.TrajectoryBuilderOptions(
        trajectory_builder_2d=per_scan_options(tconfig, grid_type="TSDF"),
        use_chunked_device_frontend=True,
    )
    collected = metrics.enable_collection()
    try:
        mb = MapBuilder(map_builder_options(tconfig), device="cpu")
        with caplog.at_level(logging.WARNING):
            tid = mb.add_trajectory_builder({"range"}, options)
        assert any(
            "use_chunked_device_frontend requested but unsupported" in r.message
            for r in caplog.records
        )
        builder = mb.get_trajectory_builder(tid)
        scans = [e[2] for e in sensor_events(4, tdata) if e[0] == "range"]
        for m in scans:
            builder.add_sensor_data("range", m)
        mb.finish_trajectory(tid)
        mb.shutdown()
        count = collected.registry()["mapping_frontend_slow_path_scans"].value()
    finally:
        metrics.register_family_factory(metrics.FamilyFactory())
    assert count == len(scans)


def test_map_builder_adds_the_pure_localization_trimmer():
    options = tconfig.TrajectoryBuilderOptions(
        trajectory_builder_2d=per_scan_options(tconfig),
        pure_localization_trimmer=tconfig.PureLocalizationTrimmerOptions(
            max_submaps_to_keep=2
        ),
    )
    mb = MapBuilder(map_builder_options(tconfig), device="cpu")
    tid = mb.add_trajectory_builder({"range"}, options)
    trimmers = mb.pose_graph._trimmers
    assert len(trimmers) == 1 and isinstance(trimmers[0], PureLocalizationTrimmer)
    assert trimmers[0]._trajectory_id == tid
    mb.shutdown()


def test_per_scan_entry_points_need_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchLocalBuilder(per_scan_options(tconfig), {"range"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsubmap.ActiveSubmaps2D(submaps_options(tconfig))
    # The IMU-based extrapolator is ported: MapBuilder builds the per-scan
    # builder with it on the MapBuilder's device.
    imu_based = tconfig.TrajectoryBuilderOptions()
    imu_based.trajectory_builder_2d.pose_extrapolator.use_imu_based = True
    mb = MapBuilder(map_builder_options(tconfig), device="cpu")
    tid = mb.add_trajectory_builder({"range"}, imu_based)
    local = mb.get_trajectory_builder(tid)._wrapped._local_trajectory_builder
    assert isinstance(local, TorchLocalBuilder) and local._device.type == "cpu"
    mb.shutdown()


def revolution_events(num_revs, odometry=False, imu_delay=0.0, times_per_subdivision=None):
    """The semicircle world's scans (every 10th wall point) as 40 Hz
    revolutions cut into ten messages, as the scanner publishes them:
    the points' times spread over 25 ms ending at the scan's time, each
    message stamped with its last point's. IMU at 400 Hz with a varying
    yaw rate, so that IMU samples fall inside every revolution; with
    `odometry`, odometry at 50 Hz. `times_per_subdivision` coarsens a
    message's point times to that many. Time-sorted, IMU first at equal
    times, as the sensor collator hands them over, but for `imu_delay`:
    each IMU sample then comes that much later, though before the end of
    its revolution. One list for each package."""
    raw, revolution_ends = [], []
    for m in semicircle_scans(num_revs):
        points = m.ranges.points[::10]
        t = m.time - 0.025 * (1.0 - np.arange(1, len(points) + 1) / len(points))
        for part in np.array_split(np.arange(len(points)), 10):
            times = t[part]
            if times_per_subdivision is not None:
                times = np.concatenate([
                    np.full(len(g), times[g[-1]])
                    for g in np.array_split(np.arange(len(part)), times_per_subdivision)])
            end = float(times[-1])
            raw.append((end, "range", end, (points[part], (times - end).astype(np.float32))))
        revolution_ends.append(end)
    last = revolution_ends[-1]
    rng = np.random.default_rng(7)
    for k in range(int((last - FAKE_START_TIME + 0.04) / 0.0025)):
        t = FAKE_START_TIME - 0.04 + 0.0025 * k
        due = revolution_ends[np.searchsorted(revolution_ends, t)]
        raw.append((min(t + imu_delay, due - 1e-9), "imu", t, rng.normal(0.0, 0.05)))
    if odometry:
        for t in np.arange(FAKE_START_TIME + 0.01, last, 0.02):
            raw.append((float(t), "odom", float(t), (t - FAKE_START_TIME) * VELOCITY))
    raw.sort(key=lambda e: (e[0], e[1] != "imu"))

    def events(pkg):
        out = []
        for _, kind, t, value in raw:
            if kind == "range":
                payload = pkg.TimedPointCloudData(
                    t, np.zeros(3, np.float32), pkg.TimedPointCloud(*value))
            elif kind == "imu":
                payload = pkg.ImuData(time=t, linear_acceleration=np.array([0.0, 0.0, 9.8]),
                                      angular_velocity=np.array([0.0, 0.0, value]))
            else:
                payload = pkg.OdometryData(
                    time=t, pose=np.concatenate([value, [1.0, 0.0, 0.0, 0.0]]))
            out.append((kind, t, payload))
        return out

    return events(jdata), events(tdata)


# name: (num_accumulated_range_data, use_imu_based, odometry, IMU delay in
# s, subdivisions per unwarp; None: as odometry or late IMU samples split
# the accumulation)
ACCUMULATION_CASES = {
    "batched": (10, False, False, 0.0, 10),
    "imu_based": (10, True, False, 0.0, 1),
    "one_per_accumulation": (1, False, False, 0.0, 1),
    "odometry": (10, False, True, 0.0, None),
    "late_imu": (10, False, False, 0.006, None),
}


@pytest.mark.parametrize("case", list(ACCUMULATION_CASES))
def test_local_builder_unwarps_each_accumulation_once(case):
    """Ten subdivisions a revolution with IMU over 4 revolutions, the
    port's builder carried along the JAX one's matches: the range data
    each hands on after the unwarp (`_add_accumulated_range_data`) and
    each pose prediction agree within 1e-6 m (1e-4 with the IMU-based
    extrapolator's float32 window fit), as the JAX builder unwarps every
    subdivision apart. The constant-velocity extrapolator unwarps an
    accumulation in one call; the IMU-based one, and one subdivision an
    accumulation, take one call a subdivision; odometry splits the
    accumulation where it arrives, and so does an IMU sample that comes
    after a subdivision it precedes. The gauge of subdivisions per unwarp
    reads the last call's."""
    num_accumulated, use_imu_based, odometry, imu_delay, per_unwarp = (
        ACCUMULATION_CASES[case])

    def options(mod):
        o = per_scan_options(mod, use_imu=True)
        o.num_accumulated_range_data = num_accumulated
        o.pose_extrapolator.use_imu_based = use_imu_based
        o.pose_extrapolator.imu_based.pose_queue_duration = 0.06
        return o

    jb = JaxLocalBuilder(options(jconfig), {"range"})
    tb = TorchLocalBuilder(options(tconfig), {"range"}, device="cpu")
    j_match, t_match = jb._scan_match, tb._scan_match
    steps, handed = [], {jb: [], tb: []}

    def j_step(*args):  # (time, prediction, cloud) in the JAX builder
        pose = j_match(*args)
        steps.append([np.asarray(args[-2]), None, np.asarray(pose)])
        return pose

    def t_step(prediction, cloud):
        t_match(prediction, cloud)
        step = next(s for s in steps if s[1] is None)
        step[1] = np.asarray(prediction)
        return step[2]

    jb._scan_match, tb._scan_match = j_step, t_step
    for builder in (jb, tb):
        def wrapped(time, range_data, gravity, accumulated=builder._add_accumulated_range_data,
                    out=handed[builder]):
            out.append((time, range_data))
            return accumulated(time, range_data, gravity)
        builder._add_accumulated_range_data = wrapped

    j_ev, t_ev = revolution_events(4, odometry, imu_delay, 1 if use_imu_based else None)
    calls = []
    collected = metrics.enable_collection()
    try:
        j_res, t_res = feed_per_scan(jb, j_ev), []
        for event in t_ev:
            t_res.extend(feed_per_scan(tb, [event]))
            extrapolator = tb._extrapolator
            if extrapolator is not None and "extrapolate_poses_batch" not in vars(extrapolator):
                def counted(times, batch=extrapolator.extrapolate_poses_batch):
                    calls.append(len(times))
                    return batch(times)
                extrapolator.extrapolate_poses_batch = counted
        gauge = collected.registry()[
            "mapping_2d_local_trajectory_builder_subdivisions_per_unwarp"].value()
    finally:
        metrics.register_family_factory(metrics.FamilyFactory())

    atol = 1e-4 if use_imu_based else 1e-6
    accumulations = len(handed[tb])
    assert accumulations == len(handed[jb]) == 40 // num_accumulated
    for (j_time, j_rd), (t_time, t_rd) in zip(handed[jb], handed[tb]):
        assert t_time == j_time
        np.testing.assert_allclose(t_rd.origin, j_rd.origin, atol=atol)
        for got, want in ((t_rd.returns, j_rd.returns), (t_rd.misses, j_rd.misses)):
            assert got.size == want.size
            np.testing.assert_allclose(got.points, want.points, atol=atol)
    compare_runs(j_res, t_res, 1e-3)
    assert len(steps) == len(t_res) == accumulations
    for j_prediction, t_prediction, _ in steps:
        np.testing.assert_allclose(t_prediction, j_prediction, atol=atol)

    scans = [e[2] for e in t_ev if e[0] == "range"]
    assert not tb._staged_times and sum(calls) == sum(len(m.ranges.points) for m in scans)
    if per_unwarp is None:  # odometry every 20 ms, IMU every 2.5 ms
        assert accumulations < len(calls) <= len(scans)
    else:
        assert len(calls) == len(scans) // per_unwarp
        assert gauge == per_unwarp
