"""Block-sparse (paged) 3D occupancy grids: a fixed block pool and a dense
block table, the replacement for the reference's pointer-tree HybridGrid
(mapping/3d/hybrid_grid.h:66-545).

Port of cartographer_tpu/mapping/paged_grid_3d.py:

* The virtual extent is V = table_size * 2^block_bits cells per axis,
  centered on the submap origin.
* `table` is an int32 [T^3] map from block coordinates to pool slots
  (-1 = unallocated): a lookup is one gather.
* `pool` is an int8 [P, B^3] array of cell blocks with hybrid_grid.Grid3D's
  value semantics (0 = unknown, v = log-odds v * LOG_ODDS_SCALE).
* Blocks are allocated inside the insert: one leader cell per new block is
  elected by scatter-min of the cell index (`scatter_reduce(amin)`,
  deterministic), leaders are ranked with a cumsum, so the table and pool
  equal the JAX package's. A full pool or a cell outside the virtual
  extent DROPS the write and counts it in `dropped`.

Reads are two gathers (table, then pool). Writes are two ordered
index_put_ calls on the pool (misses, then hits: duplicates of one kind
write the same value, and hits win shared cells). Dropped writes go to one
spare element past the end of the flattened table or pool.

`insert_cells_paged` takes an optional leading lane axis, so the chunked
frontend inserts into its four stacked grids in one set of ops. A
finished submap converts to a dense Grid3D cropped to its occupied blocks
(`to_dense`), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cartographer_tpu_torch.mapping import probability_values as pv
from cartographer_tpu_torch.mapping.hybrid_grid import (
    Grid3D,
    log_odds_to_probability,
)
from cartographer_tpu_torch.ops.raycast_3d import free_space_cells


@dataclasses.dataclass
class PagedGrid3D:
    """Paged int8 log-odds volume (tensors on one device)."""

    table: torch.Tensor  # i32 [T^3] flat block table; -1 = unallocated
    pool: torch.Tensor  # i8 [P, B^3] flat blocks
    num_blocks: torch.Tensor  # i32 allocated block count
    dropped: torch.Tensor  # i32 writes dropped (pool full / outside extent)
    origin: torch.Tensor  # f32 [3] world coords such that cell = round((p-origin)/res)
    resolution: float
    block_bits: int = 4
    table_size: int = 64

    @property
    def block_edge(self) -> int:
        return 1 << self.block_bits

    @property
    def virtual_size(self) -> int:
        """Cells per axis of the virtual extent."""
        return self.table_size << self.block_bits

    @property
    def pool_blocks(self) -> int:
        return self.pool.shape[0]

    @property
    def shape(self):
        v = self.virtual_size
        return (v, v, v)


def make_paged_grid_3d(
    center_xyz,
    resolution: float,
    block_bits: int = 4,
    table_size: int = 64,
    pool_blocks: int = 4096,
    device=None,
) -> PagedGrid3D:
    center = torch.as_tensor(np.asarray(center_xyz, np.float32), device=device)
    half = 0.5 * (table_size << block_bits) * resolution
    b3 = 1 << (3 * block_bits)
    dev = center.device
    return PagedGrid3D(
        table=torch.full((table_size**3,), -1, dtype=torch.int32, device=dev),
        pool=torch.zeros((pool_blocks, b3), dtype=torch.int8, device=dev),
        num_blocks=torch.zeros((), dtype=torch.int32, device=dev),
        dropped=torch.zeros((), dtype=torch.int32, device=dev),
        origin=center - half,
        resolution=resolution,
        block_bits=block_bits,
        table_size=table_size,
    )


def paged_from_numpy(
    table, pool, num_blocks, dropped, origin, resolution: float,
    block_bits: int, table_size: int, device,
) -> PagedGrid3D:
    """PagedGrid3D on `device` from numpy (e.g. a JAX package grid's
    arrays)."""

    def t(x, dtype):
        return torch.tensor(np.asarray(x, dtype), device=device)

    return PagedGrid3D(
        table=t(table, np.int32),
        pool=t(pool, np.int8),
        num_blocks=t(num_blocks, np.int32),
        dropped=t(dropped, np.int32),
        origin=t(origin, np.float32),
        resolution=float(resolution),
        block_bits=int(block_bits),
        table_size=int(table_size),
    )


def cell_key(grid: PagedGrid3D, cells):
    """Block-major flat key of integer cells [..., 3] (x, y, z): sorting
    by it groups cells of the same block contiguously. Caller masks cells
    outside [0, V)^3."""
    bits = grid.block_bits
    b_edge = grid.block_edge
    t = grid.table_size
    b = cells >> bits
    o = cells & (b_edge - 1)
    bf = (b[..., 2] * t + b[..., 1]) * t + b[..., 0]
    of = (o[..., 2] * b_edge + o[..., 1]) * b_edge + o[..., 0]
    return bf * (b_edge**3) + of


@functools.lru_cache(maxsize=None)
def _i32(values, device) -> torch.Tensor:
    """Per-axis (x, y, z) integers as an i32 [3] tensor on `device`
    (copied there once): flat-index strides and upper limits."""
    return torch.tensor(values, dtype=torch.int32, device=device)


def gather_values_cells(grid: PagedGrid3D, cells):
    """int8 cell values at integer cells [..., 3] (x, y, z); out-of-extent
    or unallocated reads return 0 (unknown)."""
    v, t, b_edge = grid.virtual_size, grid.table_size, grid.block_edge
    oob = torch.any((cells < 0) | (cells >= v), dim=-1)
    c = torch.clamp(cells, 0, v - 1)
    bf = torch.sum((c >> grid.block_bits) * _i32((1, t, t * t), c.device), dim=-1)
    of = torch.sum(
        (c & (b_edge - 1)) * _i32((1, b_edge, b_edge * b_edge), c.device), dim=-1
    )
    slot = grid.table[bf]
    vidx = torch.clamp(slot, 0, grid.pool_blocks - 1).long() * (b_edge**3) + of
    vals = grid.pool.reshape(-1)[vidx]
    return torch.where(oob | (slot < 0), 0, vals).to(torch.int8)


def gather_values(grid: PagedGrid3D, zi, yi, xi):
    """int8 cell values at integer coords; out-of-extent or unallocated
    reads return 0 (unknown)."""
    return gather_values_cells(grid, torch.stack([xi, yi, zi], dim=-1))


def gather_probability_cells(vol, cells):
    """Probability at integer cells [..., 3] (x, y, z) with off-grid and
    unknown cells read as MIN_PROBABILITY. `vol` is a dense f32
    probability volume, a dense int8 log-odds volume (Grid3D.values) or a
    PagedGrid3D — the one grid-read helper every 3D matcher shares."""
    if isinstance(vol, PagedGrid3D):
        return log_odds_to_probability(gather_values_cells(vol, cells))
    d, h, w = vol.shape
    upper = _i32((w - 1, h - 1, d - 1), cells.device)
    strides = _i32((1, w, w * h), cells.device)
    oob = torch.any((cells < 0) | (cells > upper), dim=-1)
    flat = torch.sum(torch.clamp(cells, min=0).minimum(upper).long() * strides, dim=-1)
    vals = vol.reshape(-1)[flat]
    if vol.dtype == torch.int8:
        vals = log_odds_to_probability(vals)
    return torch.where(oob, pv.MIN_PROBABILITY, vals)


def gather_probability(vol, zi, yi, xi):
    """gather_probability_cells at integer coords zi, yi, xi."""
    return gather_probability_cells(vol, torch.stack([xi, yi, zi], dim=-1))


def insert_cells_paged(
    table,  # i32 [T^3] or [L, T^3]
    pool,  # i8 [P, B^3] or [L, P, B^3]
    num_blocks,  # i32 [] or [L]
    dropped,  # i32 [] or [L]
    origin_cell,  # i32 [3] or [L, 3]
    hit_cells,  # i32 [N, 3] or [L, N, 3]
    valid,  # bool [N] or [L, N]
    hit_delta: int,
    miss_delta: int,
    num_free_space_voxels: int,
    *,
    block_bits: int,
    table_size: int,
):
    """Raw-tensor core of insert_scan_3d_paged, with an optional leading
    lane axis (independent grids of one geometry). Returns (table, pool,
    num_blocks, dropped); the inputs are not modified."""
    if table.dim() == 1:
        out = insert_cells_paged(
            table[None], pool[None], num_blocks[None], dropped[None],
            origin_cell[None], hit_cells[None], valid[None],
            hit_delta, miss_delta, num_free_space_voxels,
            block_bits=block_bits, table_size=table_size,
        )
        return tuple(x[0] for x in out)
    dev = table.device
    lanes, t3 = table.shape
    p_blocks, b3 = pool.shape[1], pool.shape[2]
    b_edge = 1 << block_bits
    v = table_size << block_bits
    t = table_size
    n = hit_cells.shape[1]

    miss_cells, pos_valid = free_space_cells(
        origin_cell, hit_cells, valid, num_free_space_voxels
    )
    cells = torch.cat([hit_cells, miss_cells.reshape(lanes, -1, 3)], dim=1)
    m_cells = cells.shape[1]
    is_hit = torch.arange(m_cells, device=dev) < n  # [M]
    sel_base = torch.cat([valid, pos_valid.reshape(lanes, -1)], dim=1)
    in_extent = torch.all((cells >= 0) & (cells < v), dim=-1)
    sel = sel_base & in_extent
    oob_dropped = torch.sum(sel_base & ~in_extent, dim=1, dtype=torch.int32)

    b = cells >> block_bits
    o = cells & (b_edge - 1)
    bf = (b[..., 2] * t + b[..., 1]) * t + b[..., 0]  # [L, M] block index
    of = (o[..., 2] * b_edge + o[..., 1]) * b_edge + o[..., 0]  # [L, M] in-block
    bf_c = torch.clamp(bf, 0, t3 - 1).long()
    lane = torch.arange(lanes, dtype=torch.int64, device=dev)[:, None]

    # Allocate: one leader cell per first-seen unallocated block (scatter-min
    # of cell positions into table space), leaders ranked by a cumsum over
    # the M touched cells.
    iota = torch.arange(m_cells, dtype=torch.int32, device=dev).expand(lanes, m_cells)
    unalloc = sel & (torch.gather(table, 1, bf_c) < 0)
    table_drop = lanes * t3  # the spare element of every flat table buffer
    first_buf = torch.full((table_drop + 1,), m_cells, dtype=torch.int32, device=dev)
    first_buf.scatter_reduce_(
        0,
        torch.where(unalloc, lane * t3 + bf_c, table_drop).reshape(-1),
        iota.reshape(-1),
        reduce="amin",
    )
    leader = unalloc & (first_buf[lane * t3 + bf_c] == iota)
    rank = torch.cumsum(leader.to(torch.int32), dim=1, dtype=torch.int32) - 1
    new_slot = num_blocks[:, None] + rank
    ok_alloc = leader & (new_slot < p_blocks)
    table_flat = torch.cat(
        [table.reshape(-1), torch.full((1,), -1, dtype=table.dtype, device=dev)]
    )
    table_flat.index_put_(
        (torch.where(ok_alloc, lane * t3 + bf_c, table_drop),), new_slot
    )
    table = table_flat[:-1].view(lanes, t3)
    num_blocks = torch.clamp(
        num_blocks + torch.sum(leader, dim=1, dtype=torch.int32), max=p_blocks
    )

    # Update: every duplicate of a cell with the same kind computes the same
    # value old + delta (old from the pre-scan pool), so a plain set is an
    # exact one-update-per-cell dedup; misses first, hits second.
    slot = torch.gather(table, 1, bf_c)
    ok_cell = sel & (slot >= 0)
    pool_dropped = torch.sum(sel & (slot < 0), dim=1, dtype=torch.int32)
    pidx = (lane * p_blocks + torch.clamp(slot, 0, p_blocks - 1).long()) * b3 + of.long()
    pool_flat = torch.cat(
        [pool.reshape(-1), torch.zeros(1, dtype=pool.dtype, device=dev)]
    )
    pool_drop = lanes * p_blocks * b3
    dv = torch.where(is_hit, hit_delta, miss_delta).to(torch.int16)
    new = torch.clamp(pool_flat[pidx].to(torch.int16) + dv, -127, 127)
    # A touched cell never lands on the unknown sentinel 0.
    new = torch.where(new == 0, torch.where(dv > 0, 1, -1).to(torch.int16), new)
    new = new.to(torch.int8)
    pool_flat.index_put_((torch.where(ok_cell & ~is_hit, pidx, pool_drop),), new)
    pool_flat.index_put_((torch.where(ok_cell & is_hit, pidx, pool_drop),), new)
    pool = pool_flat[:-1].view(lanes, p_blocks, b3)
    return table, pool, num_blocks, dropped + oob_dropped + pool_dropped


def insert_scan_3d_paged(
    grid: PagedGrid3D,
    origin_cell,  # i32 [3] sensor origin cell
    hit_cells,  # i32 [N, 3]
    valid,  # bool [N]
    hit_delta: int,
    miss_delta: int,
    num_free_space_voxels: int,
) -> PagedGrid3D:
    """raycast_3d.insert_scan_3d's semantics (bounded free space, hit
    priority, one update per voxel per scan) with blocks allocated on
    demand."""
    table, pool, num_blocks, dropped = insert_cells_paged(
        grid.table, grid.pool, grid.num_blocks, grid.dropped,
        origin_cell, hit_cells, valid,
        hit_delta, miss_delta, num_free_space_voxels,
        block_bits=grid.block_bits, table_size=grid.table_size,
    )
    return dataclasses.replace(
        grid, table=table, pool=pool, num_blocks=num_blocks, dropped=dropped
    )


def to_dense(grid: PagedGrid3D) -> Grid3D:
    """A dense Grid3D cropped to the occupied blocks' bounding box, on the
    grid's device (built on the host; called when a submap finishes)."""
    t = grid.table_size
    b = grid.block_edge
    dev = grid.pool.device
    table = grid.table.cpu().numpy().reshape(t, t, t)  # [bz, by, bx]
    occ = np.argwhere(table >= 0)
    if len(occ) == 0:
        return Grid3D(
            values=torch.zeros((b, b, b), dtype=torch.int8, device=dev),
            origin=grid.origin,
            resolution=grid.resolution,
        )
    lo = occ.min(axis=0)
    hi = occ.max(axis=0) + 1
    dense = np.zeros(tuple((hi - lo) * b), np.int8)
    pool = grid.pool.cpu().numpy()
    for bz, by, bx in occ:
        dense[
            (bz - lo[0]) * b: (bz - lo[0] + 1) * b,
            (by - lo[1]) * b: (by - lo[1] + 1) * b,
            (bx - lo[2]) * b: (bx - lo[2] + 1) * b,
        ] = pool[table[bz, by, bx]].reshape(b, b, b)
    # The origin shifts by the cropped min corner ((x, y, z) = reversed
    # block coords), computed in float64 and stored as float32, as in JAX.
    origin = grid.origin.cpu().numpy() + (
        np.array([lo[2], lo[1], lo[0]], np.float64) * b * grid.resolution
    )
    return Grid3D(
        values=torch.from_numpy(dense).to(dev),
        origin=torch.tensor(origin.astype(np.float32), device=dev),
        resolution=grid.resolution,
    )


def as_dense(grid) -> Grid3D:
    """Grid3D passthrough / PagedGrid3D conversion."""
    if isinstance(grid, PagedGrid3D):
        return to_dense(grid)
    return grid
