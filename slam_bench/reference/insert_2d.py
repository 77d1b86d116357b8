"""Plain reference: one range-data insertion into the active 2D submaps.

A frozen copy of the port's host side of `ActiveSubmaps2D._insert` (hits
and misses padded to a power of two, the supercover's step bound, cell
coordinates relative to each grid's origin) and of the plain exact-
supercover scatter (`raycast_2d.insert_scan_plain`), which the card's
`supercover_2d` kernel replaces on the timed path. Hits get one hit
update, every cell a ray crosses one miss update, hits win. It imports
nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# probability_values.py: log-odds bounds of the probability clamp [0.1, 0.9].
MIN_LOG_ODDS = math.log(0.1 / 0.9)
MAX_LOG_ODDS = math.log(0.9 / 0.1)


class pv:  # the names the frozen functions use
    MIN_LOG_ODDS = MIN_LOG_ODDS
    MAX_LOG_ODDS = MAX_LOG_ODDS


def _round_up_pow2(n: int, minimum: int = 64) -> int:
    v = minimum
    while v < n:
        v *= 2
    return v


def _scatter_true(grid_flat, ix, iy, sel, h: int, w: int):
    """Set cells (iy, ix) where `sel` in a flat [h * w + 1] bool buffer;
    unselected or off-grid cells go to the dummy cell h * w (the JAX
    `.at[].set(..., mode="drop")` with sentinels)."""
    sel = sel & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat = torch.where(sel, iy.long() * w + ix.long(), h * w)
    return grid_flat.index_fill(0, flat.reshape(-1), True)


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



def insert(grids, range_data, resolution: float, inserter: dict):
    """The grids [(log_odds, known, origin)] after inserting `range_data`
    (in the local frame) into each, as ActiveSubmaps2D._insert does for a
    probability grid; `inserter` is the configuration's
    probability_grid_range_data_inserter dict."""
    hit = math.log(inserter["hit_probability"] / (1.0 - inserter["hit_probability"]))
    miss = math.log(inserter["miss_probability"] / (1.0 - inserter["miss_probability"]))
    hits = range_data.returns.points[:, :2]
    misses = range_data.misses.points[:, :2]
    n_hits, n_miss = len(hits), len(misses)
    if n_hits + n_miss == 0:
        return [(lo, kn) for lo, kn, _ in grids]
    ends = np.concatenate([hits, misses], axis=0)
    n_pad = _round_up_pow2(n_hits + n_miss)
    ends_p = np.zeros((n_pad, 2), np.float32)
    ends_p[: n_hits + n_miss] = ends
    valid = np.zeros(n_pad, bool)
    valid[: n_hits + n_miss] = True
    is_hit = np.zeros(n_pad, bool)
    is_hit[:n_hits] = True
    origin = range_data.origin[:2].astype(np.float64)
    max_len = float(np.max(np.linalg.norm(ends - origin[None, :], axis=1), initial=resolution))
    num_steps = _round_up_pow2(int(np.ceil(max_len / resolution)) + 2, 32)
    out = []
    for log_odds, known, grid_origin in grids:
        dev = log_odds.device
        origin_d = torch.from_numpy(origin.astype(np.float32)).to(dev)
        ends_d = torch.from_numpy(ends_p).to(dev)
        out.append(insert_scan_plain(
            log_odds, known, (origin_d - grid_origin) / resolution,
            (ends_d - grid_origin) / resolution, torch.from_numpy(is_hit).to(dev),
            torch.from_numpy(valid).to(dev), hit, miss, num_steps,
            inserter["insert_free_space"]))
    return out
