"""The port's 3D loop-closure drain against the JAX package: the batched
dual-grid LM refinement `match_3d_batch` (K lanes reading two volumes by
index) and ConstraintBuilder3D.run_pending over the same pending searches
against two submaps of different shapes, through the native and the
device search. Inputs come from numpy seeds; the JAX side runs on the
CPU, the port with device="cpu"."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.common import config as jconfig
from cartographer_tpu.mapping.constraint_builder_3d import (
    ConstraintBuilder3D as JConstraintBuilder3D,
)
from cartographer_tpu.mapping.id import NodeId as JNodeId
from cartographer_tpu.mapping.id import SubmapId as JSubmapId
from cartographer_tpu.mapping.submap_3d import Submap3D as JSubmap3D
from cartographer_tpu.mapping.trajectory_node import (
    TrajectoryNodeData as JNodeData,
)
from cartographer_tpu.ops.scan_matching import gauss_newton_3d as jgn
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.mapping.constraint_builder_3d import ConstraintBuilder3D
from cartographer_tpu_torch.mapping.hybrid_grid import grid3d_from_numpy
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.submap_3d import Submap3D
from cartographer_tpu_torch.mapping.trajectory_node import TrajectoryNodeData
from cartographer_tpu_torch.ops.scan_matching import gauss_newton_3d as tgn
from cartographer_tpu_torch.transform import rigid3

from test_torch_backend_card import one_torch_thread  # noqa: F401
from test_torch_fast_correlative_3d import (
    fc_options,
    jax_grid,
    make_world,
    search_poses,
)
from tests.test_torch_gauss_newton_3d import room_scan, room_volume

CPU = torch.device("cpu")
T = torch.from_numpy


def _angle(qa, qb):
    d = rigid3.quat_multiply(rigid3.quat_conjugate(qa), qb)
    return 2 * np.arctan2(np.linalg.norm(d[1:]), abs(d[0]))


@pytest.mark.parametrize(
    "only_yaw,nonmonotonic", [(False, False), (True, True)], ids=["full", "yaw_nonmonotonic"]
)
def test_match_3d_batch_matches_jax(only_yaw, nonmonotonic, one_torch_thread):  # noqa: F811
    """Four lanes with their own clouds (200-256 points) and initial
    poses, reading two high-resolution volumes by index: each lane's
    packed [t, q, cost] row within 1e-4 of the JAX vmap's, which gets
    per-lane volume copies."""
    rng = np.random.default_rng(0)
    hv, ho = room_volume(40, 0.1)
    lv, lo = room_volume(16, 0.3)
    highs = np.stack([hv, np.roll(hv, 2, axis=2)])
    lows = np.stack([lv, lv])
    k = 4
    vidx = np.array([0, 1, 0, 1])
    hp = np.zeros((k, 256, 3), np.float32)
    hm = np.zeros((k, 256), bool)
    lp = np.zeros((k, 128, 3), np.float32)
    lm = np.zeros((k, 128), bool)
    t0 = np.zeros((k, 3), np.float32)
    q0 = np.zeros((k, 4), np.float32)
    for i, n in enumerate((256, 200, 150, 230)):
        pts = room_scan(rng, n)
        hp[i, :n], hm[i, :n] = pts, True
        lp[i, : n // 2], lm[i, : n // 2] = pts[::2][: n // 2], True
        t0[i] = rng.normal(0, 0.05, 3)
        q0[i] = rigid3.quat_from_angle_axis(rng.normal(0, 0.03, 3))
    hres = np.full(k, 0.1, np.float32)
    lres = np.full(k, 0.3, np.float32)
    ho_k, lo_k = np.tile(ho, (k, 1)), np.tile(lo, (k, 1))
    weights = (1.0, 6.0, 5.0, 4e2, 12, only_yaw, nonmonotonic)
    want = np.asarray(jgn.match_3d_batch(
        *(jnp.asarray(a) for a in (highs[vidx], ho_k, lows[vidx], lo_k, t0, q0, t0,
                                   hp, hm, lp, lm, hres, lres)),
        *weights,
    ))
    got = tgn.match_3d_batch(
        *(T(a) for a in (highs, ho_k, lows, lo_k, t0, q0, t0, hp, hm, lp, lm, hres, lres)),
        *weights, volume_index=T(vidx),
    ).numpy()
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=1e-4, rtol=0)
    for g, w in zip(got, want):
        assert _angle(g[3:7].astype(np.float64), w[3:7].astype(np.float64)) < 1e-4
    np.testing.assert_allclose(got[:, 7], want[:, 7], rtol=1e-4, atol=1e-6)
    assert np.max(np.abs(want[:, :3] - t0)) > 1e-3  # the LM moved


def two_submaps(seed=3):
    """Two finished submaps of the wall world, of different shapes (so
    the refinement runs one batch per shape family), and the node's data,
    as numpy."""
    a = make_world(seed)
    b = make_world(seed, high_size=40)
    return [a, b], a[5], a[4]


def constraint_rows(constraints):
    return sorted(
        (c.submap_id.submap_index, c.node_id.node_index, tuple(c.pose.zbar_ij))
        for c in constraints
    )


@pytest.mark.parametrize("backend", ["native", "device"])
def test_drain_matches_jax(backend, one_torch_thread):  # noqa: F811
    """One run_pending over six searches (three per submap) against the
    JAX ConstraintBuilder3D's drain of the same searches: the same
    constraints, zbar within 1e-4 m / rad."""
    worlds, cloud, hist = two_submaps()
    low_cloud = cloud[::3].copy()
    poses = search_poses(31, 3)

    def options(config, be):
        o = config.ConstraintBuilderOptions()
        o.sampling_ratio = 1.0
        o.max_constraint_distance = 1e6
        o.min_score = 0.3
        o.loop_closure_backend = be
        o.fast_correlative_scan_matcher_3d = fc_options(config, 3)
        return o

    jcb = JConstraintBuilder3D(options(jconfig, "native"))
    tcb = ConstraintBuilder3D(options(tconfig, backend), device=CPU)
    jnode = JNodeData(
        time=0.0, gravity_alignment=np.array([1.0, 0, 0, 0]),
        filtered_gravity_aligned_point_cloud=None, local_pose=rigid3.identity(),
        high_resolution_point_cloud=cloud, low_resolution_point_cloud=low_cloud,
        rotational_scan_matcher_histogram=hist,
    )
    tnode = TrajectoryNodeData(**{k: getattr(jnode, k) for k in (
        "time", "gravity_alignment", "filtered_gravity_aligned_point_cloud",
        "local_pose", "high_resolution_point_cloud", "low_resolution_point_cloud",
        "rotational_scan_matcher_histogram")})
    for s, (hv, ho, lv, lo, h, _) in enumerate(worlds):
        jsub = JSubmap3D(
            local_pose=rigid3.identity(), high_resolution_grid=jax_grid(hv, ho, 0.2),
            low_resolution_grid=jax_grid(lv, lo, 0.8),
            rotational_scan_matcher_histogram=h, insertion_finished=True,
        )
        tsub = Submap3D(
            local_pose=rigid3.identity(),
            high_resolution_grid=grid3d_from_numpy(hv, ho, 0.2, CPU),
            low_resolution_grid=grid3d_from_numpy(lv, lo, 0.8, CPU),
            rotational_scan_matcher_histogram=h, insertion_finished=True,
        )
        for k, pose in enumerate(poses):
            jcb.maybe_add_constraint(JSubmapId(0, s), jsub, JNodeId(0, k), jnode, pose, 0.0)
            tcb.maybe_add_constraint(SubmapId(0, s), tsub, NodeId(0, k), tnode, pose, 0.0)
    want = constraint_rows(jcb.run_pending())
    got = constraint_rows(tcb.run_pending())
    assert len(got) == len(want) >= 4
    for (gs, gn, gz), (ws, wn, wz) in zip(got, want):
        assert (gs, gn) == (ws, wn)
        np.testing.assert_allclose(gz[:3], wz[:3], atol=1e-4, rtol=0)
        assert _angle(np.array(gz[3:]), np.array(wz[3:])) < 1e-4
    timings = tcb.last_drain_timings
    assert timings["searches"] == 6 and timings["matches"] == len(got)
    assert {"search_s", "refine_wait_s", "total_s"} <= set(timings)
    # _compute_constraint, one search and its refinement on their own,
    # gives the drain's constraint.
    search = tcb.last_drain_searches[0]
    one = tcb._compute_constraint(search)
    row = next(r for r in got if r[:2] == (search.submap_id.submap_index, search.node_id.node_index))
    np.testing.assert_allclose(one.pose.zbar_ij[:3], row[2][:3], atol=1e-5, rtol=0)
