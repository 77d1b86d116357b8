"""TSDF submaps in the PyTorch port against the JAX package: the inserter
`insert_scan_tsdf`, the normals, the LM matcher `match_tsdf`, TSDF
submaps in `ActiveSubmaps2D` and in `LocalTrajectoryBuilder2D`, and TSDF
submaps in `ConstraintBuilder2D` (the device search even under
"native", refined one by one)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.common import config as jconfig
from cartographer_tpu.mapping import normal_estimation_2d as jnormals
from cartographer_tpu.mapping import submap_2d as jsubmap
from cartographer_tpu.mapping.constraint_builder_2d import (
    ConstraintBuilder2D as JaxConstraintBuilder,
)
from cartographer_tpu.mapping.grid_2d import Grid2D as JGrid2D
from cartographer_tpu.mapping.id import NodeId as JNodeId
from cartographer_tpu.mapping.id import SubmapId as JSubmapId
from cartographer_tpu.mapping.local_trajectory_builder_2d import (
    LocalTrajectoryBuilder2D as JaxLocalBuilder,
)
from cartographer_tpu.mapping.trajectory_node import TrajectoryNodeData as JNodeData
from cartographer_tpu.mapping.tsdf_2d import TSDF2D as JTSDF2D
from cartographer_tpu.ops import tsdf_raycast_2d as jtsdf
from cartographer_tpu.ops.scan_matching import gauss_newton_2d as jgn
from cartographer_tpu.sensor import data as jdata
from cartographer_tpu.transform import rigid2, rigid3
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.mapping import normal_estimation_2d as tnormals
from cartographer_tpu_torch.mapping import submap_2d as tsubmap
from cartographer_tpu_torch.mapping.constraint_builder_2d import (
    ConstraintBuilder2D as TorchConstraintBuilder,
)
from cartographer_tpu_torch.mapping.grid_2d import grid_from_numpy
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (
    LocalTrajectoryBuilder2D as TorchLocalBuilder,
)
from cartographer_tpu_torch.mapping.trajectory_node import TrajectoryNodeData
from cartographer_tpu_torch.mapping.tsdf_2d import TSDF2D, tsdf_from_numpy
from cartographer_tpu_torch.ops import tsdf_raycast_2d as ttsdf
from cartographer_tpu_torch.ops.scan_matching import gauss_newton_2d as tgn
from cartographer_tpu_torch.sensor import data as tdata
from tests.test_torch_backend_card import one_torch_thread, wall_world  # noqa: F401
from tests.test_torch_constraint_builder import ORIGIN, options
from tests.test_torch_local_slam_2d import (
    compare_runs,
    feed_per_scan,
    per_scan_options,
    range_data,
    range_data_stream,
    submaps_options,
)
from tests.test_torch_imu_odometry import sensor_events

RES = 0.05
TRUNC = 0.3


def wall_scan(seed, num=240):
    """A wavy closed wall of radius ~1.6 m around the origin, as hits
    sorted by bearing, with its normals from the JAX package."""
    rng = np.random.default_rng(seed)
    th = np.linspace(-math.pi, math.pi, num, endpoint=False)
    r = 1.6 + 0.25 * np.sin(3 * th) + 0.01 * rng.normal(size=num)
    return np.stack([r * np.cos(th), r * np.sin(th)], 1)


def tsdf_args(hits, origin, grid_origin, use_normals, size=96):
    n_pad = 256
    hits_p = np.zeros((n_pad, 2))
    hits_p[: len(hits)] = hits
    normals = np.full(n_pad, np.nan, np.float32)
    if use_normals:
        normals[: len(hits)] = jnormals.estimate_normals(
            hits, origin, jconfig.NormalEstimationOptions2D()
        )
    ranges = np.zeros(n_pad, np.float32)
    ranges[: len(hits)] = np.linalg.norm(hits - origin, axis=1)
    valid = np.arange(n_pad) < len(hits)
    tsd = np.full((size, size), TRUNC, np.float32)
    weight = np.zeros((size, size), np.float32)
    return (
        tsd, weight, ((origin - grid_origin) / RES).astype(np.float32),
        ((hits_p - grid_origin) / RES).astype(np.float32), normals, valid, ranges,
    )


@pytest.mark.parametrize(
    "use_normals,free_space,range_exponent",
    [(True, False, 0), (True, False, 2), (False, True, 0)],
    ids=["normals", "normals_range_weight", "free_space"],
)
def test_insert_scan_tsdf_matches_jax(use_normals, free_space, range_exponent):
    grid_origin = np.array([-2.4, -2.4])
    args = tsdf_args(wall_scan(0), np.array([0.02, -0.03]), grid_origin, use_normals)
    static = (RES, TRUNC, 10.0, 0.5 if use_normals else 0.0, 0.5, range_exponent,
              128 if free_space else 32, free_space)
    j_tsd, j_w = jtsdf.insert_scan_tsdf(*[jnp.asarray(a) for a in args], *static)
    # A second insertion from another origin exercises the weighted average.
    args2 = tsdf_args(wall_scan(1), np.array([0.1, 0.05]), grid_origin, use_normals)
    j_tsd, j_w = jtsdf.insert_scan_tsdf(j_tsd, j_w, *[jnp.asarray(a) for a in args2[2:]],
                                        *static)
    t_tsd, t_w = ttsdf.insert_scan_tsdf(*[torch.from_numpy(np.asarray(a)) for a in args],
                                        *static)
    t_tsd, t_w = ttsdf.insert_scan_tsdf(t_tsd, t_w,
                                        *[torch.from_numpy(np.asarray(a)) for a in args2[2:]],
                                        *static)
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_tsd.numpy(), np.asarray(j_tsd), atol=1e-5, rtol=0)
    assert (np.asarray(j_w) > 0).sum() > 300


def test_normals_match_jax_exactly():
    rng = np.random.default_rng(3)
    hits = wall_scan(2)[rng.permutation(240)] + [0.3, -0.1]
    origin = np.array([0.25, -0.05])
    order_t = tnormals.sort_range_data_by_angle(hits, origin)
    np.testing.assert_array_equal(order_t, jnormals.sort_range_data_by_angle(hits, origin))
    hits = hits[order_t]
    for radius in (0.1, 0.5):
        np.testing.assert_array_equal(
            tnormals.estimate_normals(hits, origin, tconfig.NormalEstimationOptions2D(
                sample_radius=radius)),
            jnormals.estimate_normals(hits, origin, jconfig.NormalEstimationOptions2D(
                sample_radius=radius)),
        )


@pytest.mark.parametrize("nonmonotonic", [False, True])
def test_match_tsdf_matches_jax(nonmonotonic):
    grid_origin = np.array([-2.4, -2.4], np.float32)
    args = tsdf_args(wall_scan(4), np.zeros(2), grid_origin, True)
    static = (RES, TRUNC, 10.0, 0.5, 0.5, 0, 32, False)
    tsd, weight = (np.array(a) for a in jtsdf.insert_scan_tsdf(
        *[jnp.asarray(a) for a in args], *static))
    scan = wall_scan(5).astype(np.float32)
    points = np.zeros((256, 2), np.float32)
    points[:240] = scan
    mask = np.arange(256) < 240
    for k in range(3):
        initial = np.array([0.04 * (k - 1), -0.03, 0.04 * (1 - k)], np.float32)
        target = initial[:2] + 0.01
        common = (RES, TRUNC, 1.0, 10.0, 40.0, 20, nonmonotonic)
        j_pose, j_cost = jgn.match_tsdf(
            jnp.asarray(tsd), jnp.asarray(weight), jnp.asarray(grid_origin),
            jnp.asarray(initial), jnp.asarray(target), jnp.asarray(points),
            jnp.asarray(mask), *common,
        )
        t = torch.from_numpy
        t_pose, t_cost = tgn.match_tsdf(
            t(tsd), t(weight), t(grid_origin), t(initial), t(target), t(points),
            t(mask), *common,
        )
        np.testing.assert_allclose(t_pose.numpy(), np.asarray(j_pose), atol=1e-4)
        np.testing.assert_allclose(float(t_cost), float(j_cost), rtol=1e-4)
        assert np.abs(np.asarray(j_pose) - initial).max() > 1e-3


def test_tsdf_active_submaps_match_jax():
    js = jsubmap.ActiveSubmaps2D(submaps_options(jconfig, "TSDF"))
    ts = tsubmap.ActiveSubmaps2D(submaps_options(tconfig, "TSDF"), torch.device("cpu"))
    for origin, hits, misses in range_data_stream(7):
        j_out = js.insert_range_data(range_data(jdata, origin, hits, misses))
        t_out = ts.insert_range_data(range_data(tdata, origin, hits, misses))
        assert [s.num_range_data for s in t_out] == [s.num_range_data for s in j_out]
        for a, b in zip(t_out, j_out):
            np.testing.assert_array_equal(a.grid.origin.numpy(), np.asarray(b.grid.origin))
            np.testing.assert_allclose(a.grid.weight.numpy(), np.asarray(b.grid.weight),
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(a.grid.tsd.numpy(), np.asarray(b.grid.tsd),
                                       atol=1e-5, rtol=0)
    assert (ts.submaps()[0].grid.weight > 0).sum() > 100


def test_tsdf_local_builder_matches_jax():
    jb = JaxLocalBuilder(per_scan_options(jconfig, "TSDF"), {"range"})
    tb = TorchLocalBuilder(per_scan_options(tconfig, "TSDF"), {"range"}, device="cpu")
    j_res = feed_per_scan(jb, [e for e in sensor_events(8, jdata) if e[0] == "range"])
    t_res = feed_per_scan(tb, [e for e in sensor_events(8, tdata) if e[0] == "range"])
    compare_runs(j_res, t_res, 1e-3)
    inserted = [r.insertion_result for r in t_res if r.insertion_result]
    assert all(isinstance(s.grid, TSDF2D) for s in inserted[-1].insertion_submaps)


def test_tsdf_submaps_in_the_constraint_builder_match_jax():
    """Two TSDF submaps and one probability grid under the "native"
    backend: the TSDF searches take the device search and are refined one
    by one, the probability grid's take the native search; the JAX
    package does the same."""
    rng = np.random.default_rng(0)
    submaps = []
    for s in range(3):
        lo, kn, scan, center = wall_world(30 + s, size=128, radius=2.0, num_points=220)
        center = center + ORIGIN
        if s < 2:
            grid_origin = ORIGIN.astype(np.float64)
            args = tsdf_args(scan.astype(np.float64) + center, center, grid_origin, True,
                             size=128)
            static = (RES, TRUNC, 10.0, 0.5, 0.5, 0, 32, False)
            tsd, weight = (np.asarray(a) for a in jtsdf.insert_scan_tsdf(
                *[jnp.asarray(a) for a in args], *static))
            grids = (
                JTSDF2D(tsd=jnp.asarray(tsd), weight=jnp.asarray(weight),
                        origin=jnp.asarray(ORIGIN), resolution=RES,
                        truncation_distance=TRUNC, max_weight=10.0),
                tsdf_from_numpy(tsd, weight, ORIGIN, RES, TRUNC, 10.0, "cpu"),
            )
        else:
            grids = (
                JGrid2D(log_odds=jnp.asarray(lo), known=jnp.asarray(kn),
                        origin=jnp.asarray(ORIGIN), resolution=RES),
                grid_from_numpy(lo, kn, ORIGIN, RES, "cpu"),
            )
        submaps.append((grids, scan, center, rigid2.make(rng.uniform(-1, 1, 2), 0.0)))
    searches = []
    clouds = []
    for n in range(6):
        s = n % 3
        _, scan, center, local = submaps[s]
        yaw = rng.uniform(-0.1, 0.1)
        c, sn = math.cos(-yaw), math.sin(-yaw)
        pts = scan @ np.array([[c, sn], [-sn, c]], np.float32)
        pts = pts + rng.normal(0, 0.005, pts.shape).astype(np.float32)
        clouds.append(np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1))
        rel = rigid2.relative(local, np.array([center[0], center[1], yaw]))
        searches.append((s, n, rel + [*rng.uniform(-0.1, 0.1, 2), 0.03]))

    def run(cb_cls, side, ids, node_cls, config):
        SubmapIdT, NodeIdT = ids
        kw = {"device": "cpu"} if side else {}
        cb = cb_cls(options(config, "native"), **kw)
        for s, sm in enumerate(submaps):
            cb.set_submap_local_pose(SubmapIdT(0, s), sm[3])
        for s, n, rel in searches:
            data = node_cls(time=float(n), gravity_alignment=np.array([1.0, 0, 0, 0]),
                            filtered_gravity_aligned_point_cloud=clouds[n],
                            local_pose=rigid3.identity())
            cb.maybe_add_constraint(SubmapIdT(0, s), submaps[s][0][side], NodeIdT(0, n),
                                    data, rel)
        return {
            (c.submap_id.submap_index, c.node_id.node_index): np.asarray(c.pose.zbar_ij)
            for c in cb.run_pending()
        }

    want = run(JaxConstraintBuilder, 0, (JSubmapId, JNodeId), JNodeData, jconfig)
    got = run(TorchConstraintBuilder, 1, (SubmapId, NodeId), TrajectoryNodeData, tconfig)
    assert set(got) == set(want)
    assert {s for s, _ in got} == {0, 1, 2}
    for key, zbar in want.items():
        tol = 1e-3 if key[0] < 2 else 0.05  # the native search: within a cell
        np.testing.assert_allclose(got[key][:2], zbar[:2], atol=tol)
        assert abs(rigid2.normalize_angle(got[key][2] - zbar[2])) <= (
            1e-3 if key[0] < 2 else 0.01)
