"""The backend's device ops on the card against their CPU runs (the
device branch-and-bound and the batched LM refinement), and the worlds
the backend tests share. Nothing here imports the JAX package, so the
card tests run where it cannot be imported:
`python -m pytest tests/test_torch_backend_card.py -m cuda`."""

import math

import numpy as np
import pytest
import torch

from cartographer_tpu_torch.common.config import (
    FastCorrelativeScanMatcherOptions2D as TFastOptions,
)
from cartographer_tpu_torch.mapping.grid_2d import grid_from_numpy
from cartographer_tpu_torch.ops.scan_matching import fast_correlative_2d as tfc
from cartographer_tpu_torch.ops.scan_matching import gauss_newton_2d as tgn
from cartographer_tpu_torch.transform import rigid2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run has several test workers per
    host, and torch's thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def wall_world(seed, size=128, res=0.05, radius=2.2, num_points=300):
    """A wavy closed wall around the grid centre with scattered free cells
    (log-odds, known), and a scan of it from the centre."""
    rng = np.random.default_rng(seed)
    center = np.array([0.5 * size * res, 0.5 * size * res])
    th = np.linspace(-math.pi, math.pi, num_points, endpoint=False)
    r = radius + 0.3 * np.sin(3 * th) + 0.03 * rng.normal(size=num_points)
    scan = np.stack([r * np.cos(th), r * np.sin(th)], 1).astype(np.float32)
    log_odds = np.zeros((size, size), np.float32)
    known = np.zeros((size, size), bool)
    cells = np.clip(np.floor((scan + center) / res).astype(int), 0, size - 1)
    log_odds[cells[:, 1], cells[:, 0]] = rng.uniform(0.5, 3.5, num_points)
    known[cells[:, 1], cells[:, 0]] = True
    free = rng.integers(0, size, size=(size * size // 8, 2))
    sel = ~known[free[:, 0], free[:, 1]]
    log_odds[free[sel, 0], free[sel, 1]] = rng.uniform(-3.5, -0.5, sel.sum())
    known[free[sel, 0], free[sel, 1]] = True
    return log_odds, known, scan, center


def searches(mod, grids, options_cls, beam, scans, centers, seeds):
    """The same windowed and full-submap searches for either package."""
    out = []
    matchers = [mod.FastCorrelativeScanMatcher2D(
        g, options_cls(branch_and_bound_depth=4, beam_width=beam,
                       linear_search_window=0.6,
                       angular_search_window=math.radians(15.0)))
        for g in grids]
    for i, seed in enumerate(seeds):
        rng = np.random.default_rng(seed)
        gi = i % len(grids)
        initial = None
        if i % 3 != 2:
            initial = rigid2.make(
                centers[gi] + rng.uniform(-0.3, 0.3, 2), rng.uniform(-0.15, 0.15)
            )
        cloud = np.concatenate([scans[gi], np.zeros((len(scans[gi]), 1), np.float32)], 1)
        out.append(dict(
            matcher=matchers[gi], initial_pose=initial, point_cloud=cloud,
            device_points=mod.FastCorrelativeScanMatcher2D.stage_points(cloud),
            min_score=0.55 if i % 4 != 3 else 0.97,
        ))
    return out


@pytest.mark.cuda
def test_device_bnb_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    worlds = [wall_world(s, size=96, radius=1.6, num_points=200) for s in (2, 3)]
    origin = np.array([0.1, -0.2])
    scans = [w[2] for w in worlds]
    centers = [w[3] + origin for w in worlds]
    packed = {}
    for dev in ("cpu", "cuda"):
        grids = [grid_from_numpy(lo, kn, origin, 0.05, dev) for lo, kn, *_ in worlds]
        batch = searches(tfc, grids, TFastOptions, 256, scans, centers, range(7))
        packed[dev] = tfc.batch_match_device(batch)[0]
    cpu, card = packed["cpu"], packed["cuda"]
    np.testing.assert_array_equal(card[:, 1] >= 0, cpu[:, 1] >= 0)
    np.testing.assert_allclose(card[:, 0], cpu[:, 0], atol=1e-5)
    assert 3 <= int(np.sum(cpu[:, 1] >= 0)) < 7


@pytest.mark.cuda
def test_batched_lm_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    worlds = [wall_world(s, size=96, radius=1.6, num_points=180) for s in (7, 8)]
    rng = np.random.default_rng(9)
    k, n_pad = 64, 256
    points = np.zeros((2, n_pad, 2), np.float32)
    pmask = np.zeros((2, n_pad), bool)
    for r in range(2):
        points[r, :180] = worlds[r][2]
        pmask[r, :180] = True
    sidx = (np.arange(k) % 2).astype(np.int32)
    initial = np.zeros((k, 3), np.float32)
    for i in range(k):
        c = worlds[sidx[i]][3]
        initial[i] = [*(c + rng.uniform(-0.06, 0.06, 2)), rng.uniform(-0.04, 0.04)]
    args = [
        np.stack([w[0] for w in worlds]), np.stack([w[1] for w in worlds]), points,
        pmask, np.zeros((k, 2), np.float32), initial, initial[:, :2].copy(),
        np.full(k, 0.05, np.float32), sidx, sidx,
    ]
    out = {
        dev: tgn.match_log_odds_batch(
            *[torch.from_numpy(a).to(dev) for a in args], 20.0, 10.0, 1.0, 20, False
        ).cpu().numpy()
        for dev in ("cpu", "cuda")
    }
    np.testing.assert_allclose(out["cuda"][:, :3], out["cpu"][:, :3], atol=1e-4)
    assert np.abs(out["cpu"][:, :3] - initial).max() > 1e-3


@pytest.mark.cuda
def test_state_loaded_on_card_matches_cpu():
    """A 2D state (built on the CPU) loaded on the card: the grids live on
    the card, and poses, grids, constraints and the re-serialized records
    equal those of the same state loaded on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import io

    from cartographer_tpu_torch.common import config as c
    from cartographer_tpu_torch.io.proto_stream import ProtoStreamReader
    from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
    from cartographer_tpu_torch.mapping.map_builder import MapBuilder
    from cartographer_tpu_torch.testing.synthetic import generate_fake_range_measurements

    def options():
        return c.MapBuilderOptions(use_trajectory_builder_2d=True)

    mb = MapBuilder(options(), device="cpu")
    tid = mb.add_trajectory_builder({"range"}, c.TrajectoryBuilderOptions(
        trajectory_builder_2d=c.TrajectoryBuilder2DOptions(
            use_imu_data=False, max_range=10.0,
            motion_filter=c.MotionFilterOptions(max_distance_meters=0.04),
            submaps=c.SubmapsOptions2D(num_range_data=8))))
    for m in generate_fake_range_measurements(
            translation=np.array([1.0, 0.5, 0.0]), duration=3.0, time_step=0.05):
        mb.get_trajectory_builder(tid).add_sensor_data("range", m)
    mb.finish_trajectory(tid)
    mb.pose_graph.run_final_optimization()
    state = mb.serialize_state()
    card, cpu = MapBuilder(options(), device="cuda"), MapBuilder(options(), device="cpu")
    assert card.load_state(state) == cpu.load_state(state) == {0: 0}
    for node_id, node in cpu.pose_graph.get_trajectory_nodes().items(NodeId):
        np.testing.assert_array_equal(
            card.pose_graph.get_trajectory_nodes().at(node_id).global_pose, node.global_pose)
    submaps = cpu.pose_graph.get_all_submap_data()
    assert submaps.size() >= 2
    for submap_id, data in submaps.items(SubmapId):
        grid = card.pose_graph.get_all_submap_data().at(submap_id).submap.grid
        assert grid.log_odds.device.type == "cuda" and grid.known.device.type == "cuda"
        assert torch.equal(grid.log_odds.cpu(), data.submap.grid.log_odds)
        assert torch.equal(grid.known.cpu(), data.submap.grid.known)
    assert [(x.submap_id, x.node_id, x.tag) for x in card.pose_graph.constraints] == [
        (x.submap_id, x.node_id, x.tag) for x in cpu.pose_graph.constraints]

    def records(blob):
        return list(ProtoStreamReader(io.BytesIO(blob)))

    assert records(card.serialize_state()) == records(cpu.serialize_state())
