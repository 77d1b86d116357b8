"""The port's ConstraintBuilder2D against the JAX package's: identical
staged searches through run_pending (device backend) give the same
(submap, node) set and the same constraint poses; the port's native and
device backends agree; and the backend choice has no silent fallback."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from cartographer_tpu.common import config as jconfig
from cartographer_tpu.mapping.constraint_builder_2d import (
    ConstraintBuilder2D as JaxBuilder,
)
from cartographer_tpu.mapping.grid_2d import Grid2D as JGrid2D
from cartographer_tpu.mapping.id import NodeId as JNodeId
from cartographer_tpu.mapping.id import SubmapId as JSubmapId
from cartographer_tpu.mapping.trajectory_node import (
    TrajectoryNodeData as JNodeData,
)
from cartographer_tpu.transform import rigid2, rigid3
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.mapping.constraint_builder_2d import (
    ConstraintBuilder2D as TorchBuilder,
)
from cartographer_tpu_torch.mapping.grid_2d import grid_from_numpy
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.trajectory_node import TrajectoryNodeData
from test_torch_backend_card import one_torch_thread, wall_world  # noqa: F401

ORIGIN = np.array([-0.3, 0.2], np.float32)


def options(config, backend):
    opts = config.ConstraintBuilderOptions()
    opts.sampling_ratio = 1.0
    opts.max_constraint_distance = 1e6
    # A node scores 0.43-0.53 against its own wall and 0.36-0.39 against
    # another: the gate keeps the first and rejects the second.
    opts.min_score = 0.41
    opts.global_localization_min_score = 0.5
    opts.loop_closure_backend = backend
    opts.fast_correlative_scan_matcher = config.FastCorrelativeScanMatcherOptions2D(
        branch_and_bound_depth=4,
        linear_search_window=0.8,
        angular_search_window=math.radians(15.0),
    )
    return opts


def staged_searches(seed=0):
    """Three submaps (wall worlds) and eight nodes, each node's cloud a
    noisy, rotated view of one submap's wall; searches pair nodes with
    submaps (a few mismatched, one global)."""
    rng = np.random.default_rng(seed)
    submaps = []
    for s in range(3):
        lo, kn, scan, center = wall_world(20 + s, size=128, radius=2.0, num_points=220)
        local_pose = rigid2.make(rng.uniform(-1, 1, 2), 0.0)
        submaps.append((lo, kn, scan, center + ORIGIN, local_pose))
    nodes = []
    for n in range(8):
        s = n % 3
        _, _, scan, center, _ = submaps[s]
        yaw = rng.uniform(-0.2, 0.2)
        c, sn = math.cos(-yaw), math.sin(-yaw)
        pts = scan @ np.array([[c, sn], [-sn, c]], np.float32)  # rotate by -yaw
        pts = pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)
        cloud = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1)
        nodes.append((cloud, s, center, yaw))
    searches = []
    for n, (cloud, s, center, yaw) in enumerate(nodes):
        true_global = np.array([center[0], center[1], yaw])
        for t in {s, (s + 1) % 3}:
            local = submaps[t][4]
            rel = rigid2.relative(local, true_global) + [*rng.uniform(-0.2, 0.2, 2), 0.05]
            searches.append((t, n, rel if not (n == 7 and t == s) else None))
    return submaps, nodes, searches


def run(builder_cls, grid_cls, ids, node_cls, submaps, nodes, searches, builder_opts):
    SubmapIdT, NodeIdT = ids
    cb = builder_cls(builder_opts)
    grids = [grid_cls(lo, kn) for lo, kn, *_ in submaps]
    for s, sm in enumerate(submaps):
        cb.set_submap_local_pose(SubmapIdT(0, s), sm[4])
    datas = [
        node_cls(
            time=float(n), gravity_alignment=np.array([1.0, 0, 0, 0]),
            filtered_gravity_aligned_point_cloud=cloud,
            local_pose=rigid3.identity(),
        )
        for n, (cloud, *_) in enumerate(nodes)
    ]
    for s, n, rel in searches:
        if rel is None:
            cb.maybe_add_global_constraint(SubmapIdT(0, s), grids[s], NodeIdT(0, n), datas[n])
        else:
            cb.maybe_add_constraint(SubmapIdT(0, s), grids[s], NodeIdT(0, n), datas[n], rel)
    out = cb.run_pending()
    return {
        (c.submap_id.submap_index, c.node_id.node_index): np.asarray(c.pose.zbar_ij)
        for c in out
    }


def jax_grid(lo, kn):
    return JGrid2D(log_odds=jnp.asarray(lo), known=jnp.asarray(kn),
                   origin=jnp.asarray(ORIGIN), resolution=0.05)


def torch_grid(lo, kn):
    return grid_from_numpy(lo, kn, ORIGIN, 0.05, "cpu")


def torch_builder(backend):
    return lambda opts: TorchBuilder(opts, device="cpu")


def test_run_pending_device_matches_jax():
    submaps, nodes, searches = staged_searches()
    want = run(JaxBuilder, jax_grid, (JSubmapId, JNodeId), JNodeData,
               submaps, nodes, searches, options(jconfig, "device"))
    got = run(torch_builder("device"), torch_grid, (SubmapId, NodeId), TrajectoryNodeData,
              submaps, nodes, searches, options(tconfig, "device"))
    assert set(got) == set(want)
    assert 4 <= len(got) < len(searches)  # found and rejected both occur
    for key, zbar in want.items():
        np.testing.assert_allclose(got[key][:2], zbar[:2], atol=1e-3)
        assert abs(rigid2.normalize_angle(got[key][2] - zbar[2])) <= 1e-3


def test_native_backend_agrees_with_device_backend():
    submaps, nodes, searches = staged_searches(seed=1)
    found = {
        backend: run(torch_builder(backend), torch_grid, (SubmapId, NodeId),
                     TrajectoryNodeData, submaps, nodes, searches,
                     options(tconfig, backend))
        for backend in ("device", "native")
    }
    assert set(found["native"]) == set(found["device"])
    assert found["device"]
    for key, zbar in found["device"].items():
        # Same lattice, same refinement: within one cell and 0.01 rad
        # (float32 against double discretization), as the JAX package's
        # own native-vs-device test allows.
        np.testing.assert_allclose(found["native"][key][:2], zbar[:2], atol=0.05)
        assert abs(rigid2.normalize_angle(found["native"][key][2] - zbar[2])) < 0.01


def test_backend_choice_has_no_fallback():
    """"auto" is "native" in the port; an unknown backend raises."""
    assert TorchBuilder(options(tconfig, "auto"), device="cpu")._use_native_backend()
    assert not TorchBuilder(options(tconfig, "device"), device="cpu")._use_native_backend()
    with pytest.raises(ValueError, match="loop_closure_backend"):
        TorchBuilder(options(tconfig, "gpu"), device="cpu")
