"""Loop-closure matching: multi-resolution max pyramid + branch-and-bound.

Port of cartographer_tpu/ops/scan_matching/fast_correlative_2d.py.
Reference: internal/2d/scan_matching/fast_correlative_scan_matcher_2d.cc
:41-378. Level l of the pyramid stores, per cell, the max probability over
the 2^l x 2^l window starting there; branch-and-bound uses it as an
admissible bound.

* Pyramid: uint8 cells, (p - 0.1) / 0.8 * 255 as in the reference's
  PrecomputationGrid2D, built by shift-max doubling; cells shifted in from
  beyond the grid read 0 (= MIN_PROBABILITY), so the bound stays exact.
* Search: the JAX package's level-synchronous beam — score every surviving
  candidate of a level in one batched gather, probe the most promising at
  full resolution for true lower bounds, prune bound <= best, keep the
  best `beam`, expand 4x — run for many searches at once over a leading
  lane axis. Each lane reads its submap's pyramid from one shared stack
  by index (no per-lane copies) and the gathers use int32 indices; lanes
  are processed in chunks of similar lattice size so that no
  intermediate exceeds `_GATHER_BUDGET` elements.
* Scores are exact: a candidate's score is (sum of its cells' uint8
  values / 255 * 0.8 + 0.1 n) / n over the n scan points (a point off the
  grid reads 0), so the integer sum orders candidates exactly. Ranking
  (top-k and argmax) runs on the key sum * C + (C - 1 - index), which
  breaks ties toward the lower candidate index as jax.lax.top_k and
  jnp.argmax do; torch.topk alone gives no order among equal values.
  The JAX code sums f32 probabilities, so its scores differ from these
  in the last bits, and among candidates of equal score the two may pick
  different ones.

Candidates whose scan points fall outside the grid are scored with
MIN_PROBABILITY for those points instead of being excluded by
SearchParameters::ShrinkToFit (as in the JAX package).

With a mesh (parallel/partition.Mesh), batch_match_device splits the
SEARCH axis over the ranks: each rank runs whole searches, and only the
packed result rows cross ranks (the reference's ThreadPool fan-out,
constraint_builder_2d.cc:102-136).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.common.config import FastCorrelativeScanMatcherOptions2D
from cartographer_tpu_torch.mapping import probability_values as pv
from cartographer_tpu_torch.mapping.grid_2d import Grid2D
from cartographer_tpu_torch.ops.scan_matching.correlative_2d import compute_angular_step
from cartographer_tpu_torch.parallel import partition
from cartographer_tpu_torch.transform import rigid2

_LEAF_PROBE = 256  # candidates probed at full resolution per level
# Widening ceiling for beam-overflow retries: a search that still overflows
# here is counted by beam_overflow_retries and returns the (possibly
# inexact) widest-beam result.
_MAX_WIDENED_BEAM = 1 << 15
# Elements of the largest [lanes, candidates, points] intermediate of one
# scoring step; lanes are chunked to stay under it (~20 bytes each across
# the step's temporaries, so about 2.7 GB).
_GATHER_BUDGET = 1 << 27

_U8_SCALE = 255.0 / (pv.MAX_PROBABILITY - pv.MIN_PROBABILITY)


def _quantize_u8(prob):
    return torch.clamp(
        torch.round((prob - pv.MIN_PROBABILITY) * _U8_SCALE), 0, 255
    ).to(torch.uint8)


def compute_pyramid(prob, depth: int):
    """uint8 [depth, H, W]: level l pools over 2^l x 2^l windows starting at
    the cell (max of quantized == quantized max, so admissibility holds at
    the quantized precision)."""
    levels = [_quantize_u8(prob)]
    current = levels[0]
    h, w = current.shape
    for l in range(1, depth):
        s = 1 << (l - 1)
        shifted = torch.zeros_like(current)
        shifted[:, : max(w - s, 0)] = current[:, s:]
        row = torch.maximum(current, shifted)
        shifted = torch.zeros_like(row)
        shifted[: max(h - s, 0), :] = row[s:, :]
        current = torch.maximum(row, shifted)
        levels.append(current)
    return torch.stack(levels)


def score_level(pool, ix, iy, point_mask, angle_idx, xoff, yoff, cand_mask):
    """Scores f32 [C] of candidates (angle_idx, xoff, yoff) [C] at one
    pyramid level: the mean over the masked points of the level's cells
    (pool [H, W] of uint8 cell values, read as f32 probabilities), where
    ix, iy [A, N] are the discretized scan per angle; cells off the grid
    read MIN_PROBABILITY, and invalid candidates score -inf. The JAX
    package's `_score_level`; the batched search scores with integer sums
    instead (`_Search.score`)."""
    h, w = pool.shape
    a = angle_idx.long()
    cix = ix[a] + xoff[:, None]
    ciy = iy[a] + yoff[:, None]
    oob = (cix < 0) | (cix >= w) | (ciy < 0) | (ciy >= h)
    cells = pool[ciy.clamp(0, h - 1).long(), cix.clamp(0, w - 1).long()]
    vals = cells.to(torch.float32) * (1.0 / _U8_SCALE) + pv.MIN_PROBABILITY
    vals = torch.where(oob, pv.MIN_PROBABILITY, vals)
    count = torch.clamp(torch.sum(point_mask), min=1)
    scores = torch.sum(vals * point_mask[None, :], dim=-1) / count
    return torch.where(cand_mask, scores, -math.inf)


@dataclasses.dataclass
class MatchResult:
    score: float
    pose: np.ndarray  # SE(2) (3,)


def _rank_keys(sums, valid):
    """int64 keys that order candidates by score, ties toward the lower
    index; invalid candidates rank below every valid one."""
    c = sums.shape[-1]
    order = (c - 1) - torch.arange(c, device=sums.device, dtype=torch.int64)
    s = torch.where(valid, sums.to(torch.int64), torch.full_like(sums, -1, dtype=torch.int64))
    return s * c + order


def _take(t, idx):
    """t [K, C] gathered along dim 1 by idx [K, M]."""
    return torch.gather(t, 1, idx)


class _Search:
    """One chunk of lanes: the pyramid stack, each lane's discretized
    rotated scans, and the scoring step."""

    def __init__(self, pyr_stack, sidx, points, pmask, angles, initial, origins, res):
        self.k = sidx.shape[0]
        self.pyr_flat = pyr_stack.reshape(-1)
        _, self.depth, self.h, self.w = pyr_stack.shape
        # DiscretizeScans: world point = rot(initial rotation + angle) p +
        # initial translation, floored to cells.
        full = initial[:, 2:3] + angles  # [K, A]
        ca, sa = torch.cos(full)[:, :, None], torch.sin(full)[:, :, None]
        px, py = points[:, None, :, 0], points[:, None, :, 1]
        wx = ca * px - sa * py + initial[:, 0, None, None]
        wy = sa * px + ca * py + initial[:, 1, None, None]
        r = res[:, None, None]
        self.ix = torch.floor((wx - origins[:, 0, None, None]) / r).to(torch.int32)
        self.iy = torch.floor((wy - origins[:, 1, None, None]) / r).to(torch.int32)
        self.a_count = angles.shape[1]
        self.n = points.shape[1]
        self.pmask = pmask
        n_valid = torch.sum(pmask, dim=1).to(torch.float32)
        self.n_valid = n_valid[:, None]
        self.count = torch.clamp(n_valid, min=1.0)[:, None]
        self.sidx = sidx.to(torch.int64)
        index_dtype = torch.int32 if self.pyr_flat.numel() < 2**31 else torch.int64
        self.index_dtype = index_dtype

    def score(self, level, a, x, y, valid):
        """Integer sums [K, C] and scores [K, C] (-inf where not valid) of
        candidates (angle a, offset x, y) at one pyramid level."""
        k, c = a.shape
        n, idt = self.n, self.index_dtype
        row = (torch.arange(k, device=a.device, dtype=torch.int64)[:, None]
               * self.a_count + a.to(torch.int64)).reshape(-1)
        cix = self.ix.reshape(k * self.a_count, n).index_select(0, row).reshape(k, c, n)
        ciy = self.iy.reshape(k * self.a_count, n).index_select(0, row).reshape(k, c, n)
        cix = cix + x[:, :, None]
        ciy = ciy + y[:, :, None]
        # Negative indices must not wrap: off-grid cells read 0.
        off = (cix < 0) | (cix >= self.w) | (ciy < 0) | (ciy >= self.h)
        off |= ~self.pmask[:, None, :]
        base = ((self.sidx * self.depth + level) * (self.h * self.w)).to(idt)
        flat = (ciy.clamp(0, self.h - 1).to(idt) * self.w
                + cix.clamp(0, self.w - 1).to(idt) + base[:, None, None])
        vals = self.pyr_flat.index_select(0, flat.reshape(-1)).reshape(k, c, n)
        vals = vals.masked_fill(off, 0)
        sums = torch.sum(vals, dim=2, dtype=torch.int32)
        scores = (
            sums.to(torch.float32) * (1.0 / _U8_SCALE)
            + pv.MIN_PROBABILITY * self.n_valid
        ) / self.count
        scores = torch.where(valid, scores, torch.full_like(scores, -math.inf))
        return sums, scores


def _bnb_lanes(search, a0, x0, y0, m0, num_linear, min_score, depth, beam, leaf_probe):
    """The level-synchronous branch-and-bound for every lane of `search`
    from its top-level candidates (a0, x0, y0, m0) [K, C0]. Returns (best
    score [K] f32, best (angle, x, y) [K, 3] i32, overflowed [K] bool)."""
    k = search.k
    dev = a0.device
    best_score = min_score.to(torch.float32).clone()
    best = torch.tensor([-1, 0, 0], dtype=torch.int32, device=dev).repeat(k, 1)
    overflowed = torch.zeros(k, dtype=torch.bool, device=dev)
    lanes = torch.arange(k, device=dev)

    def update(sums, scores, a, x, y, best_score, best):
        j = torch.argmax(_rank_keys(sums, scores > -math.inf), dim=1)
        s = scores[lanes, j]
        better = s > best_score
        cand = torch.stack(
            [t[lanes, j].to(torch.int32) for t in (a, x, y)], dim=1
        )
        return torch.where(better, s, best_score), torch.where(better[:, None], cand, best)

    def probe(sums, scores, a, x, y, best_score, best):
        """Leaf probe: every internal candidate's (x, y) is a valid leaf;
        scoring the most promising at full resolution gives true lower
        bounds that tighten pruning."""
        kp = min(leaf_probe, scores.shape[1])
        _, pidx = torch.topk(_rank_keys(sums, scores > -math.inf), kp, dim=1)
        pa, px, py = _take(a, pidx), _take(x, pidx), _take(y, pidx)
        lsums, lscores = search.score(0, pa, px, py, _take(scores, pidx) > -math.inf)
        return update(lsums, lscores, pa, px, py, best_score, best)

    def expand(sums, scores, a, x, y, best_score, overflowed, half, k_beam):
        """Prune by the admissible bound, keep the best k_beam, expand 4x.
        The frontier is cut to the most survivors of any lane (one host
        synchronisation per level): the slots past them would hold only
        pruned candidates."""
        alive = scores > best_score[:, None]
        n_alive = torch.sum(alive, dim=1)
        if k_beam < scores.shape[1]:
            # The cap binds iff more than k_beam candidates survive.
            overflowed = overflowed | (n_alive > k_beam)
        width = max(1, min(k_beam, int(n_alive.max())))
        _, top = torch.topk(_rank_keys(sums, alive), width, dim=1)
        top_alive = _take(alive, top)
        ta, tx, ty = _take(a, top), _take(x, top), _take(y, top)
        xo = torch.tensor([0, half, 0, half], dtype=tx.dtype, device=dev)
        yo = torch.tensor([0, 0, half, half], dtype=ty.dtype, device=dev)
        pa = ta.repeat_interleave(4, dim=1)
        px = tx.repeat_interleave(4, dim=1) + xo.repeat(width)
        py = ty.repeat_interleave(4, dim=1) + yo.repeat(width)
        nl = num_linear[:, None]
        valid = top_alive.repeat_interleave(4, dim=1) & (px <= nl) & (py <= nl)
        return pa, px, py, valid, overflowed

    if depth == 1:
        sums, scores = search.score(0, a0, x0, y0, m0)
        best_score, best = update(sums, scores, a0, x0, y0, best_score, best)
        return best_score, best, overflowed

    sums, scores = search.score(depth - 1, a0, x0, y0, m0)
    best_score, best = probe(sums, scores, a0, x0, y0, best_score, best)
    a, x, y, valid, overflowed = expand(
        sums, scores, a0, x0, y0, best_score, overflowed,
        1 << (depth - 2), min(beam, scores.shape[1]),
    )
    for level in range(depth - 2, 0, -1):
        sums, scores = search.score(level, a, x, y, valid)
        best_score, best = probe(sums, scores, a, x, y, best_score, best)
        a, x, y, valid, overflowed = expand(
            sums, scores, a, x, y, best_score, overflowed, 1 << (level - 1), beam
        )
    sums, scores = search.score(0, a, x, y, valid)
    best_score, best = update(sums, scores, a, x, y, best_score, best)
    return best_score, best, overflowed


def bnb_search(
    pyramid,  # u8 [depth, H, W]
    points,  # f32 [N, 2] raw scan points (gravity-aligned frame)
    pmask,  # bool [N]
    angles,  # f32 [A] candidate rotations
    initial_pose,  # f32 [3] (x, y, initial rotation)
    origin,  # f32 [2] grid origin
    resolution: float,
    a0, x0, y0, m0,  # [K0] initial candidates (angle index, x, y, mask)
    num_linear: int,
    min_score: float,
    depth: int,
    beam: int = 8192,
    leaf_probe: int = _LEAF_PROBE,
):
    """One search from explicit top-level candidates (the JAX function's
    interface). Returns (score, (angle, x, y) i32 [3], overflowed)."""
    dev = pyramid.device
    f32 = dict(dtype=torch.float32, device=dev)
    search = _Search(
        pyramid[None], torch.zeros(1, dtype=torch.int64, device=dev),
        points[None], pmask[None], angles[None].to(torch.float32),
        initial_pose[None].to(torch.float32), origin[None].to(torch.float32),
        torch.tensor([resolution], **f32),
    )
    score, best, overflowed = _bnb_lanes(
        search, a0[None].long(), x0[None].to(torch.int32),
        y0[None].to(torch.int32), m0[None],
        torch.tensor([num_linear], dtype=torch.int32, device=dev),
        torch.tensor([min_score], **f32), depth, beam, leaf_probe,
    )
    return score[0], best[0], overflowed[0]


def _lattice(num_angular, num_linear, depth: int, k0: int):
    """Each lane's top-level candidates (angle-major, then x, then y) with
    offsets -num_linear .. num_linear at the top pyramid stride, as the
    JAX package generates them on the device."""
    stride = 1 << (depth - 1)
    na, nl = num_angular[:, None], num_linear[:, None]
    no = (2 * nl) // stride + 1
    idx = torch.arange(k0, dtype=torch.int32, device=na.device)[None, :]
    aa = idx // (no * no)
    r = idx - aa * (no * no)
    x0 = -nl + (r // no) * stride
    y0 = -nl + (r - (r // no) * no) * stride
    m0 = idx < (2 * na + 1) * no * no
    aa = torch.where(m0, aa, torch.zeros_like(aa))
    return aa.long(), x0, y0, m0


def _lane_chunks(preps, beam):
    """Lane chunks, as lists of indices into `preps`: the searches in the
    order of their top-level candidate counts, each chunk as many as keep
    its largest scoring step (lanes x max(4 beam, candidates) x points)
    under _GATHER_BUDGET. A full-submap search, with 100x the windowed
    ones' lattice, then pads only its own chunk. A lane's result does not
    depend on the lanes beside it."""
    order = sorted(range(len(preps)), key=lambda i: preps[i]["num_candidates"])
    chunks, cur, c_max, n_max = [], [], 0, 0
    for i in order:
        c = max(4 * beam, preps[i]["num_candidates"])
        n = preps[i]["points"].shape[0]
        if cur and (len(cur) + 1) * max(c, c_max) * max(n, n_max) > _GATHER_BUDGET:
            chunks.append(cur)
            cur, c_max, n_max = [], 0, 0
        cur.append(i)
        c_max, n_max = max(c, c_max), max(n, n_max)
    return chunks + [cur]


def _search_chunk(preps, beam, device):
    """Run the searches `preps` (one lane each) in lane chunks; returns
    packed [K, 5] rows (score, angle, x, y, overflowed) as numpy."""
    uniq, sidx = {}, []
    for pr in preps:
        sidx.append(uniq.setdefault(id(pr["m"]), len(uniq)))
    matchers = {id(pr["m"]): pr["m"] for pr in preps}
    pyr = torch.stack([matchers[m]._pyramid for m in uniq])
    depth = preps[0]["m"]._depth
    out = np.zeros((len(preps), 5), np.float32)
    for lanes in _lane_chunks(preps, beam):
        chunk = [preps[i] for i in lanes]
        k = len(chunk)
        n_pad = max(pr["points"].shape[0] for pr in chunk)
        a_pad = max(2 * pr["num_angular"] + 1 for pr in chunk)
        k0 = max(pr["num_candidates"] for pr in chunk)
        points = np.zeros((k, n_pad, 2), np.float32)
        pmask = np.zeros((k, n_pad), bool)
        scal = np.zeros((k, 9), np.float32)
        ints = np.zeros((k, 3), np.int64)
        for j, (i, pr) in enumerate(zip(lanes, chunk)):
            points[j, : len(pr["points"])] = pr["points"]
            pmask[j, : len(pr["mask"])] = pr["mask"]
            scal[j] = (*pr["initial"], *pr["m"]._origin, pr["m"]._resolution,
                       pr["min_score"], pr["step"], 0.0)
            ints[j] = (pr["num_angular"], pr["num_linear"], sidx[i])
        t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        scal_d, ints_d = t(scal), t(ints)
        na, nl = ints_d[:, 0].to(torch.int32), ints_d[:, 1].to(torch.int32)
        ai = torch.arange(a_pad, dtype=torch.int32, device=device)[None, :]
        angles = (ai - na[:, None]).to(torch.float32) * scal_d[:, 7:8]
        search = _Search(
            pyr, ints_d[:, 2], t(points), t(pmask), angles,
            scal_d[:, 0:3], scal_d[:, 3:5], scal_d[:, 5],
        )
        a0, x0, y0, m0 = _lattice(na, nl, depth, k0)
        score, best, overflowed = _bnb_lanes(
            search, a0, x0, y0, m0, nl, scal_d[:, 6], depth, beam, _LEAF_PROBE
        )
        out[lanes] = torch.cat(
            [score[:, None], best.to(torch.float32),
             overflowed[:, None].to(torch.float32)], dim=1,
        ).cpu().numpy()
    return out


def _prepare(s):
    """Host-side window parameters of one search dict (see
    batch_match_device)."""
    m = s["matcher"]
    opts = m._options
    if s["initial_pose"] is None:
        center = m._origin + 0.5 * m._resolution * np.array([m._shape[1], m._shape[0]])
        initial = rigid2.make(center, 0.0)
        linear, angular = 1e6 * m._resolution, math.pi
    else:
        initial = np.asarray(s["initial_pose"], np.float64)
        linear = opts.linear_search_window
        angular = opts.angular_search_window
    pts = np.asarray(s["point_cloud"][:, :2], np.float32)
    max_range = float(np.max(np.linalg.norm(pts, axis=1), initial=3.0 * m._resolution))
    step = compute_angular_step(m._resolution, max_range)
    num_angular = int(math.ceil(angular / step))
    num_angles = 2 * num_angular + 1
    num_linear = min(int(math.ceil(linear / m._resolution)), max(m._shape) + 1)
    num_offs = (2 * num_linear) // (1 << (m._depth - 1)) + 1
    staged = s.get("device_points")
    if staged is None:
        staged = FastCorrelativeScanMatcher2D.stage_points(pts)
    return dict(
        m=m, initial=initial, step=step, num_angular=num_angular,
        num_linear=num_linear, num_candidates=num_angles * num_offs * num_offs,
        min_score=s["min_score"], points=staged[0], mask=staged[1],
        ctx=(((np.arange(num_angles) - num_angular) * step).astype(np.float32), initial,
             float(initial[2]), m._resolution),
    )


def _search_rows(preps, rows, beam, device, mesh):
    """Packed rows of the searches `rows` (indices into `preps`); with a
    mesh each rank searches its share of `rows` and the rows are gathered
    exactly (partition.gather_rows)."""
    if mesh is None:
        return _search_chunk([preps[r] for r in rows], beam, device)
    metrics.sharded_constraint_batches.increment()
    lo, hi = partition.row_range(len(rows), mesh)
    mine = [preps[r] for r in rows[lo:hi]]
    local = _search_chunk(mine, beam, device) if mine else np.zeros((0, 5), np.float32)
    return partition.fetch(torch.from_numpy(local), mesh, len(rows))


def batch_match_device(searches, mesh=None):
    """Run K independent searches on the device, as many lanes at once as
    `_GATHER_BUDGET` allows.

    `searches`: list of dicts with keys matcher, initial_pose (None =>
    full submap), device_points ((points, mask) from stage_points, or
    None), point_cloud, min_score. All matchers share depth, beam and
    grid shape and one device. Returns (packed [K, 5] numpy array, ctxs)
    — decode row k with FastCorrelativeScanMatcher2D.decode.

    Searches whose beam cap bound (packed column 4) are re-run with a
    doubled beam up to _MAX_WIDENED_BEAM, which restores the reference
    DFS's exactness; every widening pass increments the
    beam_overflow_retries metric.

    With `mesh` every rank passes the same searches; each runs its share
    (partition.row_range) of them, and of each widening pass, and every
    pass increments the sharded_constraint_batches metric. A search's
    result does not depend on the searches beside it, so the packed rows
    equal the unsharded ones bit for bit."""
    if not searches:
        return np.zeros((0, 5), np.float32), []
    preps = [_prepare(s) for s in searches]
    device = preps[0]["m"]._pyramid.device
    if mesh is not None and not partition.same_device(device, mesh.device):
        raise ValueError(f"pyramids on {device}, mesh device {mesh.device}")
    beam = preps[0]["m"]._options.beam_width
    packed = _search_rows(preps, np.arange(len(preps)), beam, device, mesh)
    rows = np.flatnonzero(packed[:, 4] > 0.5)
    while len(rows) and beam < _MAX_WIDENED_BEAM:
        beam = min(2 * beam, _MAX_WIDENED_BEAM)
        metrics.beam_overflow_retries.increment(len(rows))
        packed[rows] = _search_rows(preps, rows, beam, device, mesh)
        rows = rows[packed[rows, 4] > 0.5]
    return packed, [pr["ctx"] for pr in preps]


class FastCorrelativeScanMatcher2D:
    """A submap's pyramid on the grid's device, and searches against it."""

    def __init__(self, grid: Grid2D, options: FastCorrelativeScanMatcherOptions2D):
        self._options = options
        self._depth = options.branch_and_bound_depth
        self._resolution = grid.resolution
        self._origin = np.asarray(grid.origin.cpu(), np.float64)
        self._shape = (grid.size, grid.size)
        self._pyramid = compute_pyramid(grid.probability(), self._depth)

    def match(
        self,
        initial_pose_estimate: np.ndarray,
        point_cloud: np.ndarray,  # (N, 2+)
        min_score: float,
    ) -> Optional[MatchResult]:
        return self._match(initial_pose_estimate, point_cloud, min_score)

    def match_full_submap(
        self, point_cloud: np.ndarray, min_score: float
    ) -> Optional[MatchResult]:
        """Window centered on the grid covering it fully, +-pi
        (fast_correlative_scan_matcher_2d.cc MatchFullSubmap)."""
        return self._match(None, point_cloud, min_score)

    def _match(self, initial_pose_estimate, point_cloud, min_score):
        packed, ctxs = batch_match_device([dict(
            matcher=self, initial_pose=initial_pose_estimate,
            point_cloud=point_cloud, device_points=None, min_score=min_score,
        )])
        return self.decode(packed[0], ctxs[0])

    @staticmethod
    def decode(packed: np.ndarray, ctx) -> Optional[MatchResult]:
        """Decode one packed row of batch_match_device."""
        angles, initial_pose_estimate, initial_rotation, resolution = ctx
        best_score = float(packed[0])
        ba, bx, by = int(packed[1]), int(packed[2]), int(packed[3])
        if ba < 0:
            return None
        pose = rigid2.make(
            np.asarray(initial_pose_estimate[:2], np.float64)
            + [bx * resolution, by * resolution],
            rigid2.normalize_angle(initial_rotation + float(angles[ba])),
        )
        return MatchResult(score=best_score, pose=pose)

    @staticmethod
    def stage_points(point_cloud: np.ndarray):
        """A node's cloud padded once for reuse across many searches:
        (points [Npad, 2] f32, mask [Npad] bool) host arrays, Npad a power
        of two >= 64."""
        pts = np.asarray(point_cloud[:, :2], np.float32)
        n = len(pts)
        size = 64
        while size < n:
            size *= 2
        out = np.zeros((size, 2), np.float32)
        out[:n] = pts
        mask = np.zeros(size, bool)
        mask[:n] = True
        return out, mask
