"""The port's 3D loop-closure search against the JAX package: the uint8
octave pyramid (byte for byte), the device branch-and-bound against
JAX's bnb_search_3d at the test depth 3 and the production depth 8, beam
overflow and its widening retries, and the native C++ search against the
device search through ConstraintBuilder3D at both depths. Inputs come
from numpy seeds; the JAX side runs on the CPU, the port with
device="cpu".

The world's occupied cells carry varied log-odds: with one value in
every cell (as in the JAX package's own 3D BnB world) whole families of
candidates tie on their integer score sums, and the JAX search, which
sums f32 probabilities, then breaks the tie by rounding noise while the
port breaks it by candidate index (fast_correlative_3d docstring)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.common import config as jconfig
from cartographer_tpu.mapping.hybrid_grid import Grid3D as JGrid3D
from cartographer_tpu.ops.scan_matching import fast_correlative_3d as jfc
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.mapping.constraint_builder_3d import ConstraintBuilder3D
from cartographer_tpu_torch.mapping.hybrid_grid import grid3d_from_numpy
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.submap_3d import Submap3D
from cartographer_tpu_torch.mapping.trajectory_node import TrajectoryNodeData
from cartographer_tpu_torch.ops.scan_matching import fast_correlative_3d as tfc
from cartographer_tpu_torch.ops.scan_matching import rotational_histogram
from cartographer_tpu_torch.transform import rigid3

from test_torch_backend_card import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def wall_cloud(rng, n=400):
    """A wavy ring wall with two pillars, in the node frame."""
    ang = rng.uniform(0, 2 * np.pi, n)
    r = 3.0 + 0.4 * np.sin(3 * ang)
    z = rng.uniform(-0.8, 1.2, n)
    ring = np.stack([r * np.cos(ang), r * np.sin(ang), z], -1)
    k = n // 8
    pil = np.concatenate([
        np.stack([1.0 + 0.15 * np.cos(ang[:k]), -0.5 + 0.15 * np.sin(ang[:k]), z[:k]], -1),
        np.stack([-1.2 + 0.2 * np.cos(ang[k:2 * k]), 1.0 + 0.2 * np.sin(ang[k:2 * k]), z[k:2 * k]], -1),
    ])
    return np.concatenate([ring, pil]).astype(np.float32)


def grid_values(cloud, size, res, rng, shift=(0, 0, 0)):
    """int8 log-odds [size, size + 4, size - 4] (z, y, x) centred on the
    origin: occupied cells at the cloud with varied values, free space
    elsewhere inside the wall."""
    shape = (size, size + 4, size - 4)
    vals = np.zeros(shape, np.int8)
    origin = -0.5 * res * np.array(shape[::-1], np.float64) + np.asarray(shift) * res
    cells = np.floor((cloud - origin) / res + 0.5).astype(int)
    ok = np.all((cells >= 0) & (cells < np.array(shape[::-1])), axis=1)
    c = cells[ok]
    vals[c[:, 2], c[:, 1], c[:, 0]] = rng.integers(30, 127, len(c))
    free = rng.uniform(size=shape) < 0.05
    vals[free & (vals == 0)] = -20
    return vals, origin.astype(np.float32)


def make_world(seed=3, high_size=48, high_res=0.2, low_size=16, low_res=0.8):
    """(high values, high origin, low values, low origin, histogram,
    cloud): a submap of the wall and a scan of it."""
    rng = np.random.default_rng(seed)
    cloud = wall_cloud(rng, 200)
    hv, ho = grid_values(cloud, high_size, high_res, rng)
    lv, lo = grid_values(cloud, low_size, low_res, rng)
    hist = rotational_histogram.compute_histogram(cloud.astype(np.float64), 120)
    return hv, ho, lv, lo, hist, cloud


def fc_options(config, depth, beam=2048):
    return config.FastCorrelativeScanMatcherOptions3D(
        branch_and_bound_depth=depth,
        full_resolution_depth=3,
        linear_xy_search_window=0.8,
        linear_z_search_window=0.4,
        angular_search_window=np.radians(10.0),
        min_rotational_score=0.1,
        min_low_resolution_score=0.1,
        beam_width=beam,
    )


def search_poses(seed, count):
    rng = np.random.default_rng(seed)
    return [
        rigid3.make(
            rng.normal(0, 0.15, 3),
            rigid3.quat_from_angle_axis(np.array([0.0, 0.0, rng.normal(0, 0.04)])),
        )
        for _ in range(count)
    ]


def jax_grid(values, origin, res):
    return JGrid3D(values=jnp.asarray(values), origin=jnp.asarray(origin), resolution=res)


def matchers(world, depth, beam=2048):
    hv, ho, lv, lo, hist, _ = world
    jm = jfc.FastCorrelativeScanMatcher3D(
        jax_grid(hv, ho, 0.2), jax_grid(lv, lo, 0.8), hist, fc_options(jconfig, depth, beam)
    )
    tm = tfc.FastCorrelativeScanMatcher3D(
        grid3d_from_numpy(hv, ho, 0.2, CPU), grid3d_from_numpy(lv, lo, 0.8, CPU),
        hist, fc_options(tconfig, depth, beam),
    )
    return jm, tm


def test_octave_pyramid_is_byte_equal():
    rng = np.random.default_rng(0)
    vals = rng.integers(-127, 128, (37, 30, 45)).astype(np.int8)
    vals[rng.uniform(size=vals.shape) < 0.3] = 0
    prob_j = jax_grid(vals, np.zeros(3, np.float32), 0.1).probability()
    prob_t = grid3d_from_numpy(vals, np.zeros(3), 0.1, CPU).probability()
    want = jfc.compute_octave_pyramid(prob_j, 8)
    got = tfc.compute_octave_pyramid(prob_t, 8)
    assert len(got) == len(want) == 8
    for level, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=str(level))
    assert np.asarray(want[-1]).max() > 0


# A match needs 0.4 at depth 8: lower thresholds keep thousands of
# candidates alive per level, which the CPU scores slowly.
MIN_SCORE = {3: 0.3, 8: 0.4}


@pytest.mark.parametrize("depth", [3, 8])
def test_bnb_search_matches_jax(depth, one_torch_thread):  # noqa: F811
    """Per search, without widening: the same best (a, x, y, z), the same
    overflow flag, scores within 1e-6."""
    world = make_world()
    cloud = world[5]
    jm, tm = matchers(world, depth)
    low_cloud = cloud[::3]
    found = 0
    for pose in search_poses(11, 4):
        args = (pose, world[4], 0.0, cloud, low_cloud, MIN_SCORE[depth])
        want = jm.match_device(*args)
        got = tm.match_device(*args)
        assert (want is None) == (got is None)
        if want is None:
            continue
        want = np.asarray(want[0])
        row = got[0]
        np.testing.assert_array_equal(row[2:], want[2:])
        np.testing.assert_allclose(row[:2], want[:2], atol=1e-6, rtol=0)
        found += want[2] >= 0
        if want[2] >= 0:
            # The best candidate rescored alone reads the search's scores.
            scores, lows = tfc.candidate_scores(tm._prepare(*args), [row[2:6].astype(int)])
            np.testing.assert_array_equal([scores[0], lows[0]], row[:2])
    assert found >= 2
    # bnb_search_3d, the JAX function's interface, on the last search.
    prep = tm._prepare(*args)
    dev_points = [torch.from_numpy(a) for a in prep["device_points"]]
    score, low, best, overflowed = tfc.bnb_search_3d(
        tm._pyramid, dev_points[0], dev_points[1], prep["q0"], prep["t0"],
        prep["angles_kept"], tm._origin, tm._resolution, tm._low_prob,
        dev_points[2], dev_points[3], prep["lorigin"], prep["lres"],
        *prep["cand"], prep["nl_xy"], prep["nl_z"], MIN_SCORE[depth],
        tm._options.min_low_resolution_score, tm._resolution / prep["lres"],
        depth, beam=tm._options.beam_width,
    )
    np.testing.assert_array_equal(best.numpy(), got[0][2:6])
    assert float(score) == got[0][0] and bool(overflowed) == bool(got[0][6])


def test_beam_overflow_and_widening_match_jax(one_torch_thread):  # noqa: F811
    """A beam of 4 binds: the overflow flags agree with JAX's at that
    beam, and batch_match_device_3d's widening retries reach JAX's exact
    (widest-beam) results."""
    world = make_world()
    cloud = world[5]
    jm, tm = matchers(world, 4, beam=4)
    low_cloud = cloud[::3]
    preps, exact, flags = [], [], []
    for pose in search_poses(12, 3):
        args = (pose, world[4], 0.0, cloud, low_cloud, 0.3)
        want = np.asarray(jm.match_device(*args)[0])
        assert want[6] == tm.match_device(*args)[0][6]
        flags.append(want[6])
        preps.append(tm._prepare(*args))
        exact.append(np.asarray(jm.match_device(*args, beam=tfc._MAX_WIDENED_BEAM)[0]))
    exact = np.stack(exact)
    assert np.all(exact[:, 6] == 0) and max(flags) > 0.5  # the beam bound
    got, _ = tfc.batch_match_device_3d(preps)
    np.testing.assert_array_equal(got[:, 2:], exact[:, 2:])
    np.testing.assert_allclose(got[:, :2], exact[:, :2], atol=1e-6, rtol=0)


def searches_against(world, count, seed):
    """A submap of `world` and `count` pending searches of its scan."""
    hv, ho, lv, lo, hist, cloud = world
    submap = Submap3D(
        local_pose=rigid3.identity(),
        high_resolution_grid=grid3d_from_numpy(hv, ho, 0.2, CPU),
        low_resolution_grid=grid3d_from_numpy(lv, lo, 0.8, CPU),
        rotational_scan_matcher_histogram=hist,
        insertion_finished=True,
    )
    node = TrajectoryNodeData(
        time=0.0,
        gravity_alignment=np.array([1.0, 0, 0, 0]),
        filtered_gravity_aligned_point_cloud=None,
        local_pose=rigid3.identity(),
        high_resolution_point_cloud=cloud,
        low_resolution_point_cloud=cloud[::3].copy(),
        rotational_scan_matcher_histogram=hist,
    )
    return submap, node, search_poses(seed, count)


def builder_options(config, backend, depth):
    o = config.ConstraintBuilderOptions()
    o.sampling_ratio = 1.0
    o.max_constraint_distance = 1e6
    o.min_score = MIN_SCORE[depth]
    o.loop_closure_backend = backend
    o.fast_correlative_scan_matcher_3d = fc_options(config, depth)
    return o


@pytest.mark.parametrize("depth", [3, 8])
def test_native_search_matches_device_search(depth, one_torch_thread):  # noqa: F811
    """csrc/bnb3d_native.cc against the device search on the same pending
    searches: the same best candidate (hence pose), scores within 1e-6."""
    submap, node, poses = searches_against(make_world(), 4, 21)
    results = {}
    for backend in ("native", "device"):
        cb = ConstraintBuilder3D(builder_options(tconfig, backend, depth), device=CPU)
        for k, pose in enumerate(poses):
            cb.maybe_add_constraint(SubmapId(0, 0), submap, NodeId(0, k), node, pose, 0.0)
        pending = list(cb._pending)
        run = cb._run_searches_native if backend == "native" else cb._run_searches_device
        results[backend] = run(pending)
    matched = 0
    for (_, n), (_, d) in zip(results["native"], results["device"]):
        assert (n is None) == (d is None)
        if n is None:
            continue
        matched += 1
        np.testing.assert_allclose(n.pose, d.pose, atol=1e-6, rtol=0)
        assert abs(n.score - d.score) < 1e-6
        assert abs(n.low_resolution_score - d.low_resolution_score) < 1e-6
        assert n.rotational_score == d.rotational_score
    assert matched >= 2
