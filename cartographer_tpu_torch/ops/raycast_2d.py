"""Ray-cast range-data insertion into 2D probability grids.

Port of `insert_scan` (the per-scan path's scatter inserter) and of
`insert_scan_dense` with its bitmask rasterizer (the chunked frontend's)
from cartographer_tpu/ops/raycast_2d.py:32-131 and :157-264. Reference
behavior:
mapping/2d/probability_grid_range_data_inserter_2d.cc:33-133 — per scan,
each hit cell gets one odds(hit) update; every cell crossed by a ray from
the origin to a hit (or to a missing-echo endpoint) gets one odds(miss)
update; hits take priority over misses in the same cell.

For every (ray, grid row) pair the ray's supercover within that row is one
contiguous column interval; each interval becomes packed 32-bit row masks
and an OR over rays yields the miss grid. The OR runs over chunks of rays,
so the [N, H, W/32] lattice is never held whole. `insert_scan` instead
scatters the two cells beside every integer boundary crossing of each ray
(the exact supercover). All coordinates here are fractional cell units.
Both results are bit-identical to the JAX functions.

For CUDA tensors `insert_scan` and `insert_scan_dense` launch the
hand-written kernels (kernels/supercover_2d.py), bit-identical to the
plain versions here (`insert_scan_plain`, `insert_scan_dense_plain`),
which run for CPU tensors only.
"""

from __future__ import annotations

import torch

from cartographer_tpu_torch.kernels import supercover_2d
from cartographer_tpu_torch.mapping import probability_values as pv

# Int32 words per ray chunk of the [B, rays, H, W/32] lattice (16 MiB).
_CHUNK_WORDS = 1 << 22


def _scatter_true(grid_flat, ix, iy, sel, h: int, w: int):
    """Set cells (iy, ix) where `sel` in a flat [h * w + 1] bool buffer;
    unselected or off-grid cells go to the dummy cell h * w (the JAX
    `.at[].set(..., mode="drop")` with sentinels)."""
    sel = sel & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat = torch.where(sel, iy.long() * w + ix.long(), h * w)
    return grid_flat.index_fill(0, flat.reshape(-1), True)


def insert_scan(
    log_odds,  # f32 [H, W]
    known,  # bool [H, W]
    origin_cell,  # f32 [2] (cx, cy)
    ends_cell,  # f32 [N, 2] hit + missing-echo endpoints
    is_hit,  # bool [N]
    valid,  # bool [N] padding mask
    hit_log_odds: float,
    miss_log_odds: float,
    num_steps: int,
    insert_free_space: bool = True,
):
    """One range-data insertion by the exact-supercover scatter: the CUDA
    kernel for CUDA tensors, `insert_scan_plain` for CPU tensors. Returns
    (log_odds', known')."""
    if log_odds.is_cuda:
        return supercover_2d.insert_scan(
            log_odds.contiguous(), known.contiguous(), origin_cell.contiguous(),
            ends_cell.contiguous(), is_hit.contiguous(), valid.contiguous(),
            hit_log_odds, miss_log_odds, num_steps, insert_free_space,
        )
    return insert_scan_plain(
        log_odds, known, origin_cell, ends_cell, is_hit, valid, hit_log_odds,
        miss_log_odds, num_steps, insert_free_space,
    )


def insert_scan_plain(
    log_odds,  # f32 [H, W]
    known,  # bool [H, W]
    origin_cell,  # f32 [2] (cx, cy)
    ends_cell,  # f32 [N, 2] hit + missing-echo endpoints
    is_hit,  # bool [N]
    valid,  # bool [N] padding mask
    hit_log_odds: float,
    miss_log_odds: float,
    num_steps: int,
    insert_free_space: bool = True,
):
    """One range-data insertion (the exact-supercover scatter of the JAX
    `insert_scan`): hit cells get one hit update, every cell a ray passes
    through one miss update, hits win. `num_steps` bounds the integer
    boundary crossings per axis. Returns (log_odds', known')."""
    h, w = log_odds.shape
    dev = log_odds.device
    end_ix = torch.floor(ends_cell[:, 0]).to(torch.int32)
    end_iy = torch.floor(ends_cell[:, 1]).to(torch.int32)
    empty = torch.zeros(h * w + 1, dtype=torch.bool, device=dev)
    hit_flat = _scatter_true(empty, end_ix, end_iy, valid & is_hit, h, w)
    hit_grid = hit_flat[: h * w].reshape(h, w)

    if insert_free_space:
        delta = ends_cell - origin_cell[None, :]  # [N, 2]
        steps = torch.arange(num_steps, dtype=torch.float32, device=dev)
        miss_flat = empty
        for axis in (0, 1):
            # Cells adjacent to the integer crossings along `axis`.
            o, o_other = origin_cell[axis], origin_cell[1 - axis]
            d, d_other = delta[:, axis], delta[:, 1 - axis]
            step = torch.where(d >= 0, 1.0, -1.0)
            first = torch.where(d >= 0, torch.floor(o) + 1.0, torch.ceil(o) - 1.0)
            ks = first[:, None] + step[:, None] * steps[None, :]  # [N, S]
            safe_d = torch.where(torch.abs(d) < 1e-9, 1e-9, d)
            ts = (ks - o) / safe_d[:, None]
            t_valid = (ts > 0.0) & (ts <= 1.0) & (torch.abs(d) > 1e-9)[:, None]
            other = o_other + ts * d_other[:, None]
            fo = torch.floor(other).to(torch.int32)
            ki = ks.to(torch.int32)
            sel = t_valid & valid[:, None]
            if axis == 0:
                miss_flat = _scatter_true(miss_flat, ki - 1, fo, sel, h, w)
                miss_flat = _scatter_true(miss_flat, ki, fo, sel, h, w)
            else:
                miss_flat = _scatter_true(miss_flat, fo, ki - 1, sel, h, w)
                miss_flat = _scatter_true(miss_flat, fo, ki, sel, h, w)
        # Start cell (shared by all rays) and end cells.
        oix = torch.floor(origin_cell[0]).to(torch.int32).reshape(1)
        oiy = torch.floor(origin_cell[1]).to(torch.int32).reshape(1)
        every = torch.ones(1, dtype=torch.bool, device=dev)
        miss_flat = _scatter_true(miss_flat, oix, oiy, every, h, w)
        miss_flat = _scatter_true(miss_flat, end_ix, end_iy, valid, h, w)
        miss_grid = miss_flat[: h * w].reshape(h, w) & ~hit_grid
    else:
        miss_grid = torch.zeros_like(hit_grid)

    update = torch.where(
        hit_grid, hit_log_odds, torch.where(miss_grid, miss_log_odds, 0.0)
    )
    touched = hit_grid | miss_grid
    new_log_odds = torch.where(
        touched,
        torch.clamp(log_odds + update, pv.MIN_LOG_ODDS, pv.MAX_LOG_ODDS),
        log_odds,
    )
    return new_log_odds, known | touched


def _or_reduce_rays(words):
    """OR-reduce a [..., N, H, NW] int32 lattice over rays (dim -3) by
    halving."""
    while words.shape[-3] > 1:
        n = words.shape[-3]
        half = n // 2
        folded = words[..., :half, :, :] | words[..., half : 2 * half, :, :]
        if n % 2:
            folded = torch.cat([folded, words[..., 2 * half :, :, :]], dim=-3)
        words = folded
    return words.squeeze(-3)


def _interval_words(x0, x1, rowvalid, num_words: int):
    """Packed column-interval masks, OR-ed over rays.

    x0, x1: [..., N, H] int32 inclusive column range per (ray, row);
    rowvalid: [..., N, H] bool. Returns [..., H, NW] int32 (bit j of word
    k is column 32 k + j)."""
    *batch, n, h = x0.shape
    bsz = 1
    for b in batch:
        bsz *= b
    chunk = max(1, _CHUNK_WORDS // max(1, bsz * h * num_words))
    word_base = (
        torch.arange(num_words, dtype=torch.int32, device=x0.device) * 32
    )
    ones = torch.full((), -1, dtype=torch.int32, device=x0.device)
    zero = torch.zeros((), dtype=torch.int32, device=x0.device)
    acc = torch.zeros((*batch, h, num_words), dtype=torch.int32, device=x0.device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        lo = torch.clamp(x0[..., s:e, :, None] - word_base, 0, 32)
        hi = torch.clamp(x1[..., s:e, :, None] + 1 - word_base, 0, 32)
        m_lo = torch.where(lo >= 32, zero, ones << torch.clamp(lo, max=31))
        m_hi = torch.where(hi >= 32, ones, ~(ones << torch.clamp(hi, max=31)))
        word = torch.where(
            rowvalid[..., s:e, :, None] & (hi > lo), m_lo & m_hi, zero
        )
        acc = acc | _or_reduce_rays(word)
    return acc


def _unpack_bits(words, width: int):
    """[..., H, NW] int32 -> [..., H, NW*32] bool, cropped to width."""
    bits = torch.arange(32, dtype=torch.int32, device=words.device)
    unpacked = (words[..., None] >> bits) & 1
    return unpacked.reshape(*words.shape[:-1], -1)[..., :width].to(torch.bool)


def insert_scan_dense(
    log_odds,  # f32 [H, W] or [B, H, W]
    known,  # bool [H, W] or [B, H, W]
    origin_cell,  # f32 [2] or [B, 2] (cx, cy)
    ends_cell,  # f32 [N, 2] or [B, N, 2]
    is_hit,  # bool [N]
    valid,  # bool [N]
    hit_log_odds: float,
    miss_log_odds: float,
    insert_free_space: bool = True,
):
    """One range-data insertion per grid by supercover row intervals: the
    CUDA kernel for CUDA tensors, `insert_scan_dense_plain` for CPU
    tensors. Returns (log_odds', known'); the inputs are not modified."""
    if log_odds.is_cuda:
        return supercover_2d.insert_scan_dense(
            log_odds.contiguous(), known.contiguous(), origin_cell.contiguous(),
            ends_cell.contiguous(), is_hit.contiguous(), valid.contiguous(),
            hit_log_odds, miss_log_odds, insert_free_space,
        )
    return insert_scan_dense_plain(
        log_odds, known, origin_cell, ends_cell, is_hit, valid, hit_log_odds,
        miss_log_odds, insert_free_space,
    )


def insert_scan_dense_plain(
    log_odds,  # f32 [H, W] or [B, H, W]
    known,  # bool [H, W] or [B, H, W]
    origin_cell,  # f32 [2] or [B, 2] (cx, cy)
    ends_cell,  # f32 [N, 2] or [B, N, 2]
    is_hit,  # bool [N]
    valid,  # bool [N]
    hit_log_odds: float,
    miss_log_odds: float,
    insert_free_space: bool = True,
):
    """One range-data insertion per grid (the leading axis, when present,
    batches grids at different origins under the same rays): supercover
    free space, hits override misses, one update per cell per scan
    (probability_grid_range_data_inserter_2d.cc:52-96). Returns
    (log_odds', known'); the inputs are not modified."""
    h, w = log_odds.shape[-2:]
    dev = log_odds.device
    num_words = (w + 31) // 32
    y_iota = torch.arange(h, dtype=torch.int32, device=dev)  # [H]

    end_ix = torch.floor(ends_cell[..., 0]).to(torch.int32)  # [..., N]
    end_iy = torch.floor(ends_cell[..., 1]).to(torch.int32)
    in_bounds = (end_ix >= 0) & (end_ix < w) & (end_iy >= 0) & (end_iy < h)

    # Hit cells: one per hit endpoint inside the grid.
    hit_sel = valid & is_hit & in_bounds
    batch = log_odds.shape[:-2]
    flat = end_iy.long() * w + end_ix.long()
    flat = torch.where(hit_sel, flat, h * w)  # dummy cell past the end
    hit_grid = torch.zeros((*batch, h * w + 1), dtype=torch.bool, device=dev)
    hit_grid = hit_grid.scatter(-1, flat, True)
    hit_grid = hit_grid[..., : h * w].reshape(*batch, h, w)

    if insert_free_space:
        ox, oy = origin_cell[..., 0, None], origin_cell[..., 1, None]  # [..., 1]
        dx = ends_cell[..., 0] - ox  # [..., N]
        dy = ends_cell[..., 1] - oy
        yf = y_iota.to(torch.float32)  # [H]
        # Segment ∩ row slab [y, y+1] in parameter t ∈ [0, 1].
        near_zero = torch.abs(dy) < 1e-9
        safe_dy = torch.where(near_zero, 1.0, dy)[..., None]  # [..., N, 1]
        oy_ = oy[..., None]  # [..., 1, 1]
        ta = (yf - oy_) / safe_dy  # [..., N, H]
        tb = (yf + 1.0 - oy_) / safe_dy
        t0 = torch.minimum(ta, tb)
        t1 = torch.maximum(ta, tb)
        # Horizontal rays live entirely in row floor(oy).
        on_row = y_iota == torch.floor(oy_).to(torch.int32)  # [..., 1, H]
        nz = near_zero[..., None]
        t0 = torch.where(nz, torch.where(on_row, 0.0, 2.0), t0)
        t1 = torch.where(nz, torch.where(on_row, 1.0, -1.0), t1)
        t0 = torch.clamp(t0, min=0.0)
        t1 = torch.clamp(t1, max=1.0)
        rowvalid = (t1 >= t0) & valid[..., None]
        ox_ = ox[..., None]
        xa = ox_ + t0 * dx[..., None]
        xb = ox_ + t1 * dx[..., None]
        x0 = torch.floor(torch.minimum(xa, xb)).to(torch.int32)
        x1 = torch.floor(torch.maximum(xa, xb)).to(torch.int32)
        rowvalid = rowvalid & (x1 >= 0) & (x0 < w)
        x0 = torch.clamp(x0, min=0)
        x1 = torch.clamp(x1, max=w - 1)
        miss_words = _interval_words(x0, x1, rowvalid, num_words)
        miss_grid = _unpack_bits(miss_words, w) & ~hit_grid
    else:
        miss_grid = torch.zeros_like(hit_grid)

    update = torch.where(
        hit_grid,
        hit_log_odds,
        torch.where(miss_grid, miss_log_odds, 0.0),
    )
    touched = hit_grid | miss_grid
    new_log_odds = torch.where(
        touched,
        torch.clamp(log_odds + update, pv.MIN_LOG_ODDS, pv.MAX_LOG_ODDS),
        log_odds,
    )
    new_known = known | touched
    return new_log_odds, new_known
