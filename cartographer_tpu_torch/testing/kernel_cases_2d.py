"""Inputs for the 2D main path's kernels (kernels/lm_match_2d.py and
kernels/supercover_2d.py), made from a numpy Generator as numpy arrays.

One set for every caller: the CPU tests hold the plain versions against
the JAX functions on them at small shapes, the card tests and
chip_smoke.py's kernel_2d phase hold the kernels against the plain
versions on them, the latter at the main path's shapes.
"""

from __future__ import annotations

import numpy as np


def wall_costs(rng, s, h, w, walls=60):
    """[S, H, W] f32 correspondence costs of random axis-aligned walls
    3 cells thick starting in the grid's central 60%, blurred twice with
    [1/4, 1/2, 1/4] along each axis."""
    prob = np.full((s, h, w), 0.1)
    for g in range(s):
        for _ in range(walls):
            length = int(rng.integers(max(2, h // 16), max(3, h // 3)))
            y = int(rng.integers(int(0.2 * h), int(0.8 * h)))
            x = int(rng.integers(int(0.2 * w), int(0.8 * w)))
            if rng.uniform() < 0.5:
                prob[g, y - 1 : y + 2, x : x + length] = 0.9
            else:
                prob[g, y : y + length, x - 1 : x + 2] = 0.9
    for axis in (1, 2):
        for _ in range(2):
            prob = 0.5 * prob + 0.25 * (np.roll(prob, 1, axis) + np.roll(prob, -1, axis))
    return (1.0 - np.clip(prob, 0.1, 0.9)).astype(np.float32)


def lm_case(rng, s, h, w, k, n, walls=60, edge=False, res=0.05):
    """K LM lanes on S shared grids centred on the origin (lane k on grid
    k % S): each lane's N points on its grid's walls within 10 m of the
    centre, seen from a pose up to 5 cm and 0.01 rad off the truth, 95%
    unmasked; initial poses 0, targets 1 cm off. With `edge`, lane 0's
    points are all masked and a third of lane 1's lie off the grid.
    Arrays by name: grids, grid_index, origins, initial, targets, points,
    masks, resolutions."""
    grids = wall_costs(rng, s, h, w, walls)
    origin = np.array([-0.5 * w * res, -0.5 * h * res], np.float32)
    grid_index = (np.arange(k) % s).astype(np.int32)
    points = np.zeros((k, n, 2), np.float32)
    masks = rng.uniform(size=(k, n)) < 0.95
    yy, xx = np.mgrid[0:h, 0:w]
    near = np.hypot(yy - h / 2, xx - w / 2) < 10.0 / res
    for lane in range(k):
        ys, xs = np.nonzero((grids[grid_index[lane]] < 0.5) & near)
        pick = rng.integers(0, len(ys), n)
        world = np.stack([xs[pick], ys[pick]], 1) * res + origin + res / 2
        true = np.array([*rng.uniform(-0.05, 0.05, 2), rng.uniform(-0.01, 0.01)])
        c, sn = np.cos(true[2]), np.sin(true[2])
        local = (world - true[:2]) @ np.array([[c, -sn], [sn, c]])
        points[lane] = local + rng.normal(0.0, 0.005, local.shape)
    if edge:
        masks[0] = False
        points[1, : n // 3] += np.float32(w * res)
    initial = np.zeros((k, 3), np.float32)
    return dict(
        grids=grids, grid_index=grid_index, origins=np.tile(origin, (k, 1)),
        initial=initial, targets=initial[:, :2] + np.float32(0.01), points=points,
        masks=masks, resolutions=np.full(k, res, np.float32),
    )


def insert_case(rng, b, h, w, n, reach, edge=False):
    """Grids [B, H, W] (log odds, 30% known; known) at B origins near the
    centre and N shared rays reaching 2 to `reach` cells in every
    direction (ends [B, N, 2]: the rays' world ends in each grid's
    cells), 80% hits, 95% valid. With `edge`: horizontal rays (dy = 0),
    vertical ones and ends on lattice corners. Returns (log_odds, known,
    origins, ends, is_hit, valid)."""
    log_odds = np.where(rng.uniform(size=(b, h, w)) < 0.3,
                        rng.uniform(-2.0, 2.0, (b, h, w)), 0.0).astype(np.float32)
    origin = np.array([[0.5 * w + 0.37 + 3.25 * i, 0.5 * h + 0.21 - 1.5 * i]
                       for i in range(b)], np.float32)
    a = rng.uniform(0.0, 2.0 * np.pi, n)
    r = rng.uniform(2.0, reach, n)
    ends = (origin[0] + np.stack([r * np.cos(a), r * np.sin(a)], 1)).astype(np.float32)
    if edge:
        ends[:20, 1] = origin[0, 1]
        ends[20:30, 0] = origin[0, 0]
        ends[30:50] = np.round(ends[30:50])
    ends_b = np.stack([ends + (origin[i] - origin[0]) for i in range(b)])
    return (log_odds, log_odds != 0.0, origin, ends_b,
            rng.uniform(size=n) < 0.8, rng.uniform(size=n) < 0.95)


def num_steps_for(origin, ends):
    """raycast_2d.insert_scan's crossing bound for rays from `origin` to
    `ends` [N, 2], as submap_2d sizes it: a power of two >= 32."""
    longest = float(np.max(np.abs(ends - origin[None, :]), initial=1.0))
    return 1 << max(5, int(np.ceil(np.log2(longest + 2))))
