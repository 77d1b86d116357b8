"""The pose-graph trimmers of the PyTorch port against the JAX package:
both trimmers on the `FakeTrimmable` of tests/test_trimmers.py,
`grid_2d.compute_cropped`, and both trimmers inside the two `PoseGraph2D`s
fed one node sequence (the same submaps trimmed, the same constraints
left)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cartographer_tpu.common import config as jconfig
from cartographer_tpu.mapping import grid_2d as jgrid
from cartographer_tpu.mapping import probability_values as jpv
from cartographer_tpu.mapping import trimmers as jtrimmers
from cartographer_tpu.mapping.id import SubmapId as JSubmapId
from cartographer_tpu.mapping.pose_graph_2d import PoseGraph2D as JaxPoseGraph
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.mapping import grid_2d as tgrid
from cartographer_tpu_torch.mapping import trimmers as ttrimmers
from cartographer_tpu_torch.mapping.id import SubmapId
from cartographer_tpu_torch.mapping.pose_graph_2d import PoseGraph2D, replay_nodes
from tests.test_torch_backend_card import one_torch_thread  # noqa: F401
from tests.test_torch_pose_graph import (
    constraint_keys,
    pose_graph_options,
    record_jax_frontend,
    replay_jax,
)
from tests.test_trimmers import FakeTrimmable, _FakeSubmap


def covering(x0, y0, w, h, resolution=0.1, size=64):
    """tests/test_trimmers.py's submap covering [x0, x0+w] x [y0, y0+h],
    as (JAX submap, port submap)."""
    log_odds = np.zeros((size, size), np.float32)
    known = np.zeros((size, size), bool)
    i0, j0 = int(round(y0 / resolution)), int(round(x0 / resolution))
    known[i0 : i0 + int(h / resolution), j0 : j0 + int(w / resolution)] = True
    log_odds[known] = jpv.MAX_LOG_ODDS
    jg = jgrid.Grid2D(log_odds=jnp.asarray(log_odds), known=jnp.asarray(known),
                      origin=jnp.zeros(2, jnp.float32), resolution=resolution)
    tg = tgrid.grid_from_numpy(log_odds, known, np.zeros(2), resolution, "cpu")
    return _FakeSubmap(grid=jg, local_pose=np.zeros(3)), _FakeSubmap(
        grid=tg, local_pose=np.zeros(3))


SCENARIOS = {
    # tests/test_trimmers.py's three cases, plus a rotated, shifted stack.
    "stacked": ([(0.4, 0.4, 2.0, 2.0)] * 4 + [(4.0, 4.0, 2.0, 2.0)], (2, 1.0, 0)),
    "below_threshold": ([(0.4, 0.4, 2.0, 2.0)] * 4, (2, 1.0, 10)),
    "partial": ([(0.4, 0.4, 2.0, 2.0)] + [(1.4, 0.4, 1.0, 2.0)] * 3, (2, 1.0, 0)),
    "posed": ([(0.4, 0.4, 2.0, 2.0), (1.0, 0.4, 2.0, 2.0), (0.4, 1.0, 2.5, 1.0),
               (2.0, 2.0, 1.0, 1.0)], (1, 0.5, 0)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_overlapping_trimmer_matches_jax(name):
    rects, (fresh, area, added) = SCENARIOS[name]
    rng = np.random.default_rng(len(name))
    j_data, t_data = [], []
    for i, rect in enumerate(rects):
        js, ts = covering(*rect)
        pose = np.zeros(3) if name != "posed" else np.array(
            [*rng.uniform(-0.3, 0.3, 2), rng.uniform(-0.4, 0.4)])
        j_data.append((JSubmapId(0, i), js, pose))
        t_data.append((SubmapId(0, i), ts, pose))
    j_trim, t_trim = FakeTrimmable(j_data), FakeTrimmable(t_data)
    jtrimmers.OverlappingSubmapsTrimmer2D(fresh, area, added).trim(j_trim)
    ttrimmers.OverlappingSubmapsTrimmer2D(fresh, area, added).trim(t_trim)
    assert [s.submap_index for s in t_trim.trimmed] == [
        s.submap_index for s in j_trim.trimmed]
    if name in ("stacked", "partial"):
        assert t_trim.trimmed


class FakeTrajectory(FakeTrimmable):
    def __init__(self, ids):
        super().__init__([])
        self._ids = ids

    def get_submap_ids(self, trajectory_id):
        return [s for s in self._ids if s.trajectory_id == trajectory_id]


def test_pure_localization_trimmer_matches_jax():
    j_trim = FakeTrajectory([JSubmapId(t, i) for t in (0, 1) for i in range(6)])
    t_trim = FakeTrajectory([SubmapId(t, i) for t in (0, 1) for i in range(6)])
    jtrimmers.PureLocalizationTrimmer(1, 3).trim(j_trim)
    ttrimmers.PureLocalizationTrimmer(1, 3).trim(t_trim)
    assert [(s.trajectory_id, s.submap_index) for s in t_trim.trimmed] == [
        (s.trajectory_id, s.submap_index) for s in j_trim.trimmed] == [(1, i) for i in range(3)]
    assert not ttrimmers.PureLocalizationTrimmer(1, 3).is_finished()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_cropped_matches_jax(seed):
    rng = np.random.default_rng(seed)
    log_odds = rng.uniform(-2, 2, (40, 48)).astype(np.float32)
    known = np.zeros((40, 48), bool)
    if seed:
        y0, x0 = rng.integers(0, 20, 2)
        known[y0 : y0 + rng.integers(1, 20), x0 : x0 + rng.integers(1, 28)] = True
    origin = np.array([0.3, -1.2], np.float32)
    j = jgrid.compute_cropped(jgrid.Grid2D(
        log_odds=jnp.asarray(log_odds), known=jnp.asarray(known),
        origin=jnp.asarray(origin), resolution=0.05))
    t = tgrid.compute_cropped(tgrid.grid_from_numpy(log_odds, known, origin, 0.05, "cpu"))
    np.testing.assert_array_equal(t.known, j.known)
    # The crop is equal; its probabilities differ by an ulp where the two
    # exp implementations do.
    np.testing.assert_allclose(t.probability, j.probability, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(t.origin, j.origin)
    assert t.offset_yx == j.offset_yx and t.resolution == j.resolution


@pytest.fixture(scope="module")
def recorded():
    return record_jax_frontend()


@pytest.mark.parametrize("trimmer", ["overlapping", "pure_localization"])
def test_trimmers_in_the_pose_graph_match_jax(recorded, trimmer):
    records, submaps = recorded

    def options(config):
        pg = pose_graph_options(config)
        if trimmer == "overlapping":
            pg.overlapping_submaps_trimmer_2d = config.OverlappingSubmapsTrimmerOptions2D(
                fresh_submaps_count=1, min_covered_area=2.0, min_added_submaps_count=2,
            )
        return pg

    def add(mod):
        def add_trimmer(pg):
            if trimmer == "pure_localization":
                pg.add_trimmer(mod.PureLocalizationTrimmer(0, 2))
        return add_trimmer

    want = JaxPoseGraph(options(jconfig))
    add(jtrimmers)(want)
    replay_jax(want, records, submaps)
    got = PoseGraph2D(options(tconfig), device="cpu")
    add(ttrimmers)(got)
    replay_nodes(got, 0, records, submaps, "cpu")
    for pg in (want, got):
        pg.finish_trajectory(0)
        pg.run_final_optimization()

    def left(pg, id_type):
        return sorted(s.submap_index for s, _ in pg._submap_data.items(id_type))

    assert left(got, SubmapId) == left(want, JSubmapId)
    assert len(left(got, SubmapId)) < len(submaps)  # something was trimmed
    assert constraint_keys(got) == constraint_keys(want)
    # The trimmed submaps left the constraint builder's caches too.
    kept = {SubmapId(0, i) for i in left(got, SubmapId)}
    assert set(got._constraint_builder._submap_grids) <= kept
    assert {c.submap_id for c in got.constraints} <= kept
