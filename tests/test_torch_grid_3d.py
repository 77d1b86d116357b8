"""The 3D grids of the PyTorch port against the JAX package: the dense
inserter `raycast_3d.insert_scan_3d`, the paged inserter
`paged_grid_3d.insert_scan_3d_paged` (bit-identical values, table, pool,
block count and dropped writes, with endpoints off the grid and the pool
overflowing), the lane-batched paged insert the chunked frontend uses,
`gather_probability` on the three volume kinds, `to_dense`, and the
running intensity sums."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartographer_tpu.mapping import hybrid_grid as jhg
from cartographer_tpu.mapping import paged_grid_3d as jpg
from cartographer_tpu.ops import raycast_3d as jray
from cartographer_tpu_torch.mapping import hybrid_grid as thg
from cartographer_tpu_torch.mapping import paged_grid_3d as tpg
from cartographer_tpu_torch.ops import raycast_3d as tray
from tests.test_torch_backend_card import one_torch_thread  # noqa: F401

t = torch.from_numpy


def random_volume(rng, size):
    """An int8 log-odds volume, about half of it unknown (0)."""
    values = rng.integers(-127, 128, (size, size, size)).astype(np.int8)
    values[rng.uniform(size=values.shape) < 0.5] = 0
    return values


def random_rays(rng, n, lo, hi, valid_share=0.9):
    cells = rng.integers(lo, hi, (n, 3)).astype(np.int32)
    valid = rng.uniform(size=n) < valid_share
    return cells, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_insert_scan_3d_matches_jax(seed):
    """Bit-identical, with a quarter of the endpoints off the volume, a
    tenth masked, and rays of every length (misses on their own cells)."""
    rng = np.random.default_rng(seed)
    values = random_volume(rng, 32)
    origin_cell = rng.integers(8, 24, 3).astype(np.int32)
    cells, valid = random_rays(rng, 400, -8, 40)
    args = (12, -5, 3)
    want = np.asarray(jray.insert_scan_3d(
        jnp.asarray(values), jnp.asarray(origin_cell), jnp.asarray(cells),
        jnp.asarray(valid), *args,
    ))
    got = tray.insert_scan_3d(t(values), t(origin_cell), t(cells), t(valid), *args)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != values).sum() > 300  # hits and misses landed
    assert not np.any((want == 0) & (values != 0))  # the sentinel is kept


def test_insert_scan_3d_lanes_equal_single_inserts():
    """The lane-batched dense insert equals one insert per lane."""
    rng = np.random.default_rng(2)
    values = np.stack([random_volume(rng, 24) for _ in range(2)])
    origins = rng.integers(6, 18, (2, 3)).astype(np.int32)
    rays = [random_rays(rng, 200, -4, 28) for _ in range(2)]
    cells = np.stack([c for c, _ in rays])
    valid = np.stack([v for _, v in rays])
    got = tray.insert_scan_3d_lanes(t(values), t(origins), t(cells), t(valid), 9, -4, 2)
    for lane in range(2):
        one = tray.insert_scan_3d(
            t(values[lane]), t(origins[lane]), t(cells[lane]), t(valid[lane]), 9, -4, 2
        )
        assert torch.equal(got[lane], one)


def paged_pair(pool_blocks, block_bits=3, table_size=8, resolution=0.2):
    return (
        jpg.make_paged_grid_3d(np.zeros(3), resolution, block_bits=block_bits,
                               table_size=table_size, pool_blocks=pool_blocks),
        tpg.make_paged_grid_3d(np.zeros(3), resolution, block_bits=block_bits,
                               table_size=table_size, pool_blocks=pool_blocks,
                               device="cpu"),
    )


def assert_paged_equal(got, want):
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))
    np.testing.assert_array_equal(got.pool.numpy(), np.asarray(want.pool))
    assert int(got.num_blocks) == int(want.num_blocks)
    assert int(got.dropped) == int(want.dropped)


@pytest.mark.parametrize("pool_blocks", [512, 40], ids=["fits", "pool_overflow"])
def test_insert_scan_3d_paged_matches_jax(pool_blocks):
    """Four scans into a 64^3-cell virtual extent of 8^3-cell blocks, from
    moving origins; endpoints reach 6 cells past the extent. With 40 pool
    blocks the pool runs full in the first scan."""
    rng = np.random.default_rng(3)
    jgrid, tgrid = paged_pair(pool_blocks)
    for _ in range(4):
        origin_cell = rng.integers(20, 44, 3).astype(np.int32)
        cells, valid = random_rays(rng, 300, -6, 70)
        jgrid = jpg.insert_scan_3d_paged(
            jgrid, jnp.asarray(origin_cell), jnp.asarray(cells), jnp.asarray(valid),
            12, -5, 2,
        )
        tgrid = tpg.insert_scan_3d_paged(
            tgrid, t(origin_cell), t(cells), t(valid), 12, -5, 2
        )
        assert_paged_equal(tgrid, jgrid)
    # Writes off the extent are dropped either way; a full pool drops more.
    assert int(tgrid.dropped) > 0
    if pool_blocks == 40:
        assert int(tgrid.num_blocks) == 40
    else:
        assert 40 < int(tgrid.num_blocks) < 512


def test_insert_cells_paged_lanes_equal_single_grids():
    """The lane-batched paged insert (the chunked frontend's four stacked
    grids) gives each lane's table, pool and counts of its own insert."""
    rng = np.random.default_rng(4)
    lanes = []
    for lane in range(4):
        _, grid = paged_pair(64)
        # Give each lane some blocks already.
        cells, valid = random_rays(rng, 100, 0, 64)
        grid = tpg.insert_scan_3d_paged(grid, t(np.full(3, 32, np.int32)),
                                        t(cells), t(valid), 12, -5, 2)
        lanes.append(grid)
    origin = rng.integers(20, 44, (4, 3)).astype(np.int32)
    rays = [random_rays(rng, 150, -6, 70) for _ in range(4)]
    cells = np.stack([c for c, _ in rays])
    valid = np.stack([v for _, v in rays])
    table, pool, nblocks, dropped = tpg.insert_cells_paged(
        torch.stack([g.table for g in lanes]), torch.stack([g.pool for g in lanes]),
        torch.stack([g.num_blocks for g in lanes]),
        torch.stack([g.dropped for g in lanes]),
        t(origin), t(cells), t(valid), 12, -5, 2, block_bits=3, table_size=8,
    )
    for lane, grid in enumerate(lanes):
        one = tpg.insert_scan_3d_paged(
            grid, t(origin[lane]), t(cells[lane]), t(valid[lane]), 12, -5, 2
        )
        assert torch.equal(table[lane], one.table)
        assert torch.equal(pool[lane], one.pool)
        assert int(nblocks[lane]) == int(one.num_blocks)
        assert int(dropped[lane]) == int(one.dropped)


def filled_pair(seed=5):
    rng = np.random.default_rng(seed)
    jgrid, tgrid = paged_pair(256)
    for _ in range(3):
        origin_cell = rng.integers(24, 40, 3).astype(np.int32)
        cells, valid = random_rays(rng, 300, 4, 60)
        jgrid = jpg.insert_scan_3d_paged(
            jgrid, jnp.asarray(origin_cell), jnp.asarray(cells), jnp.asarray(valid),
            12, -5, 2,
        )
        tgrid = tpg.insert_scan_3d_paged(tgrid, t(origin_cell), t(cells), t(valid),
                                         12, -5, 2)
    return jgrid, tgrid


@pytest.mark.parametrize("kind", ["dense_f32", "dense_int8", "paged"])
def test_gather_probability_matches_jax(kind):
    """Reads at random cells, a fifth of them off the grid."""
    rng = np.random.default_rng(6)
    if kind == "paged":
        jvol, tvol = filled_pair()
        size = 64
    else:
        size = 40
        values = random_volume(rng, size)
        if kind == "dense_f32":
            prob = np.where(values != 0, rng.uniform(0.1, 0.9, values.shape), 0.1)
            values = prob.astype(np.float32)
        jvol, tvol = jnp.asarray(values), t(values)
    zi, yi, xi = (rng.integers(-size // 8, size + size // 8, (7, 300)).astype(np.int32)
                  for _ in range(3))
    want = np.asarray(jpg.gather_probability(jvol, *map(jnp.asarray, (zi, yi, xi))))
    got = tpg.gather_probability(tvol, t(zi), t(yi), t(xi)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (want == np.float32(0.1)).mean() > 0.1  # off-grid and unknown reads
    if kind == "paged":
        np.testing.assert_array_equal(
            tpg.gather_values(tvol, t(zi), t(yi), t(xi)).numpy(),
            np.asarray(jpg.gather_values(jvol, *map(jnp.asarray, (zi, yi, xi)))),
        )


def test_to_dense_matches_jax():
    jgrid, tgrid = filled_pair()
    want = jpg.to_dense(jgrid)
    got = tpg.to_dense(tgrid)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    assert got.resolution == want.resolution
    # An empty grid densifies to one unknown block at the origin.
    _, empty = paged_pair(8)
    dense = tpg.as_dense(empty)
    assert dense.values.shape == (8, 8, 8) and not dense.values.any()
    assert tpg.as_dense(dense) is dense


def test_insert_intensities_3d_matches_jax():
    rng = np.random.default_rng(7)
    size = 24
    total = rng.uniform(0, 50, (size, size, size)).astype(np.float32)
    count = rng.integers(0, 4, (size, size, size)).astype(np.float32)
    cells, valid = random_rays(rng, 500, -3, size + 3)
    cells[:100] = cells[100:200]  # repeated voxels accumulate
    intens = rng.uniform(0, 100, 500).astype(np.float32)
    want = jray.insert_intensities_3d(
        jnp.asarray(total), jnp.asarray(count), jnp.asarray(cells),
        jnp.asarray(intens), jnp.asarray(valid),
    )
    got = tray.insert_intensities_3d(t(total), t(count), t(cells), t(intens), t(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    assert (got[1].numpy() - count).sum() > 150  # about half land inside


def test_hybrid_grid_matches_jax():
    """The quantized update deltas, the probability view and the cell
    index of the dense grid."""
    for delta in (0.2, -0.04, 1e-4, -1e-4, 2.1972):
        assert thg.quantize_log_odds_delta(delta) == jhg.quantize_log_odds_delta(delta)
    rng = np.random.default_rng(8)
    values = random_volume(rng, 16)
    jgrid = jhg.Grid3D(values=jnp.asarray(values), origin=jnp.asarray(
        np.array([-0.8, -0.7, -0.6], np.float32)), resolution=0.1)
    tgrid = thg.grid3d_from_numpy(values, np.asarray(jgrid.origin), 0.1, "cpu")
    np.testing.assert_allclose(tgrid.probability().numpy(),
                               np.asarray(jgrid.probability()), rtol=1e-6)
    np.testing.assert_array_equal(tgrid.known().numpy(), np.asarray(jgrid.known()))
    pts = rng.uniform(-1.0, 1.0, (200, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        thg.cell_index_3d(tgrid, t(pts)).numpy(),
        np.asarray(jhg.cell_index_3d(jgrid, jnp.asarray(pts))),
    )
    made = thg.make_grid_3d([1.0, 2.0, 3.0], 0.5, 8, "cpu")
    want = jhg.make_grid_3d([1.0, 2.0, 3.0], 0.5, 8)
    np.testing.assert_array_equal(made.origin.numpy(), np.asarray(want.origin))
    assert made.shape == tuple(want.shape)
