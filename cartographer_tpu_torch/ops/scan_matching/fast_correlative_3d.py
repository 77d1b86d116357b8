"""3D loop-closure matching: octave max pyramid + yaw-pruned branch-and-bound.

Port of cartographer_tpu/ops/scan_matching/fast_correlative_3d.py.
Reference: internal/3d/scan_matching/fast_correlative_scan_matcher_3d.cc
:112-444 with precomputation_grid_3d.cc:54-85 (octave max-pools of the
hybrid grid into uint8) and low_resolution_matcher.cc (leaf veto on the
low-resolution grid); candidate yaws pre-pruned by the rotational
histogram (rotational_scan_matcher.cc, min_rotational_score).

* Pyramid: octave levels, level l of shape ceil(size / 2^l) per axis,
  each cell the max over its 2^l cube, in uint8 ((p - 0.1) / 0.8 * 255,
  rounded half to even as XLA rounds). A candidate window with an
  unaligned base spans at most two octave cells per axis, so the
  admissible bound is the max over the 2x2x2 octave neighbourhood; the
  search reads it from a volume of those maxima, built once per submap
  (one read per point and level where the JAX package makes eight).
* Search: the JAX package's level-synchronous beam over (yaw, x, y, z)
  with offsets on the 2^(depth-1) lattice: score every candidate of a
  level, probe the most promising at full resolution (with the
  low-resolution veto) for true lower bounds, prune bound <= best, keep
  the best `beam`, expand 8x. Many searches run at once over a leading
  lane axis; each lane reads its submap's pyramid from one stack of the
  shape family's pyramids by index, and lanes are chunked so that no
  [lanes, candidates, points] intermediate exceeds `_GATHER_BUDGET`.
* Scores are exact: a candidate's score is (sum of its cells' uint8
  values / 255 * 0.8 + 0.1 n) / n over the n scan points (a point off
  the grid reads 0), so the integer sum orders candidates exactly, as in
  the native search. Ranking (top-k and argmax) runs on the key
  sum * C + (C - 1 - index), which breaks ties toward the lower
  candidate index as jax.lax.top_k and jnp.argmax do; torch.topk alone
  gives no order among equal values. The JAX code sums f32
  probabilities, so its scores differ from these in the last bits.
* The frontier after each level is cut to the most survivors of any
  lane (one host synchronisation per level); the slots past them hold
  only pruned candidates.

With a mesh (parallel/partition.Mesh), batch_match_device_3d splits the
search axis over the ranks as fast_correlative_2d.batch_match_device
does: each rank runs whole searches, and the packed rows are gathered
exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.common.config import FastCorrelativeScanMatcherOptions3D
from cartographer_tpu_torch.mapping import probability_values as pv
from cartographer_tpu_torch.mapping.hybrid_grid import Grid3D
from cartographer_tpu_torch.ops import frontend_common as fc
from cartographer_tpu_torch.ops.scan_matching import rotational_histogram
from cartographer_tpu_torch.ops.scan_matching.correlative_2d import compute_angular_step
from cartographer_tpu_torch.ops.scan_matching.fast_correlative_2d import _rank_keys, _take
from cartographer_tpu_torch.parallel import partition
from cartographer_tpu_torch.transform import rigid3

_LEAF_PROBE = 128
# Widening ceiling for beam-overflow retries (see fast_correlative_2d).
_MAX_WIDENED_BEAM = 1 << 14
# Elements of the largest [lanes, candidates, points] gather of one
# scoring step; lanes are chunked to stay under it.
_GATHER_BUDGET = 1 << 26

_U8_SCALE = 255.0 / (pv.MAX_PROBABILITY - pv.MIN_PROBABILITY)


def _quantize_u8(prob):
    return torch.clamp(
        torch.round((prob - pv.MIN_PROBABILITY) * _U8_SCALE), 0, 255
    ).to(torch.uint8)


def _pool_octave(vals):
    """Halve each axis, max over 2x2x2 (odd dims padded with 0 = MIN_PROB)."""
    d, h, w = vals.shape
    pd, ph, pw = (d + 1) // 2 * 2, (h + 1) // 2 * 2, (w + 1) // 2 * 2
    x = torch.nn.functional.pad(vals, (0, pw - w, 0, ph - h, 0, pd - d))
    x = x.reshape(pd // 2, 2, ph // 2, 2, pw // 2, 2)
    return x.amax(dim=(1, 3, 5))


def compute_octave_pyramid(prob, depth: int):
    """A tuple of uint8 volumes, level l of shape ~size/2^l per axis."""
    levels = [_quantize_u8(prob)]
    for _ in range(1, depth):
        levels.append(_pool_octave(levels[-1]))
    return tuple(levels)


def _bound_volumes(pyramid):
    """What the search reads per level: level 0 itself, and for l > 0 the
    max over each 2x2x2 neighbourhood of octave level l, padded by one
    cell on the low side, so that one read at (cell + 1) gives the
    admissible bound that eight reads at cell + {0, 1}^3 give (off-grid
    cells count 0 in both)."""
    out = [pyramid[0]]
    for level in pyramid[1:]:
        x = torch.nn.functional.pad(level, (1, 1, 1, 1, 1, 1))
        x = torch.maximum(x[:-1], x[1:])
        x = torch.maximum(x[:, :-1], x[:, 1:])
        out.append(torch.maximum(x[:, :, :-1], x[:, :, 1:]))
    return tuple(out)


def _scores(sums, n_valid, count, valid):
    scores = (sums.to(torch.float32) * (1.0 / _U8_SCALE) + pv.MIN_PROBABILITY * n_valid) / count
    return torch.where(valid, scores, torch.full_like(scores, -math.inf))


class _Search3D:
    """One chunk of lanes of one shape family: the stacked pyramids and
    low-resolution volumes, each lane's per-yaw discretized clouds, and
    the scoring steps."""

    def __init__(self, levels, low, sidx, points, pmask, low_points, low_mask,
                 q0, t0, angles, origin, res, low_origin, low_res):
        self.k, self.a_count = angles.shape
        # Per volume stack: flat values, (d, h, w), each lane's base
        # offset; i32 indices while the stack allows.
        self.levels = [self._volume(lvl, sidx) for lvl in levels]
        self.low = self._volume(low, sidx)
        # bnb_search_3d's discretization: q = yaw(angle) * q0, cells =
        # floor((R p + t0 - origin) / res + 0.5).
        half = 0.5 * angles
        zeros = torch.zeros_like(angles)
        qa = torch.stack([torch.cos(half), zeros, zeros, torch.sin(half)], dim=-1)
        q = fc.qmul(qa, q0[:, None, :])[:, :, None, :]  # [K, A, 1, 4]
        world = fc.qrot(q, points[:, None]) + t0[:, None, None, :]
        cells = torch.floor(
            (world - origin[:, None, None, :]) / res[:, None, None, None] + 0.5
        ).to(torch.int32)
        self.n = points.shape[1]
        self.cells = [cells[..., i].reshape(self.k * self.a_count, self.n) for i in range(3)]
        low_world = fc.qrot(q, low_points[:, None]) + t0[:, None, None, :]
        low_base = (low_world - low_origin[:, None, None, :]) / low_res[:, None, None, None]
        self.nl = low_points.shape[1]
        self.low_base = [low_base[..., i].reshape(self.k * self.a_count, self.nl) for i in range(3)]
        self.pmask, self.low_mask = pmask, low_mask
        f32 = torch.float32
        n_valid = torch.sum(pmask, dim=1).to(f32)[:, None]
        self.n_valid, self.count = n_valid, torch.clamp(n_valid, min=1.0)
        nl_valid = torch.sum(low_mask, dim=1).to(f32)[:, None]
        self.nl_valid, self.l_count = nl_valid, torch.clamp(nl_valid, min=1.0)

    @staticmethod
    def _volume(stack, sidx):
        flat = stack.reshape(-1)
        idt = torch.int32 if flat.numel() < 2**31 else torch.int64
        base = (sidx.to(torch.int64) * stack[0].numel()).to(idt)
        return flat, tuple(stack.shape[1:]), base[:, None, None]

    def _rows(self, a):
        k = a.shape[0]
        lanes = torch.arange(k, device=a.device, dtype=torch.int64)[:, None]
        return (lanes * self.a_count + a.to(torch.int64)).reshape(-1)

    def _read(self, vol, cz, cy, cx, point_mask):
        """uint8 reads [K, C, n] of the lanes' volumes at integer cells;
        off-grid cells and masked points read 0."""
        flat, (d, h, w), base = vol
        off = (cx < 0) | (cx >= w) | (cy < 0) | (cy >= h) | (cz < 0) | (cz >= d)
        off |= ~point_mask[:, None, :]
        idx = (cz.clamp(0, d - 1).to(base.dtype) * h + cy.clamp(0, h - 1)) * w
        idx = idx + cx.clamp(0, w - 1) + base
        return flat.index_select(0, idx.reshape(-1)).reshape(idx.shape).masked_fill(off, 0)

    def score(self, level, a, x, y, z, valid):
        """Integer sums [K, C] and scores [K, C] (-inf where not valid) of
        candidates (yaw a, offset x, y, z) at one pyramid level."""
        k, c = a.shape
        rows = self._rows(a)
        shifted = [
            (plane.index_select(0, rows).reshape(k, c, self.n) + off[:, :, None]) >> level
            for plane, off in zip(self.cells, (x, y, z))
        ]
        cx, cy, cz = shifted
        pad = 1 if level > 0 else 0  # see _bound_volumes
        vals = self._read(self.levels[level], cz + pad, cy + pad, cx + pad, self.pmask)
        sums = torch.sum(vals, dim=2, dtype=torch.int32)
        return sums, _scores(sums, self.n_valid, self.count, valid)

    def low_scores(self, a, x, y, z, valid, ratio):
        """Low-resolution veto scores [K, C] (low_resolution_matcher.cc):
        the low grid at floor(base + offset * ratio + 0.5)."""
        k, c = a.shape
        rows = self._rows(a)
        cx, cy, cz = (
            torch.floor(
                plane.index_select(0, rows).reshape(k, c, self.nl)
                + (off.to(torch.float32) * ratio[:, None])[:, :, None] + 0.5
            ).to(torch.int32)
            for plane, off in zip(self.low_base, (x, y, z))
        )
        vals = self._read(self.low, cz, cy, cx, self.low_mask)
        sums = torch.sum(vals, dim=2, dtype=torch.int32)
        return _scores(sums, self.nl_valid, self.l_count, valid)


_CHILD_OFFSETS = ((0, 1, 0, 1, 0, 1, 0, 1), (0, 0, 1, 1, 0, 0, 1, 1), (0, 0, 0, 0, 1, 1, 1, 1))


def _bnb_lanes(search, cands, nl_xy, nl_z, min_score, min_low, ratio, depth,
               beam, leaf_probe):
    """bnb_search_3d for every lane of `search` from its top-level
    candidates cands = (a, x, y, z, valid) [K, C0]. Returns (best score
    [K], best low-resolution score [K], best (a, x, y, z) [K, 4] i32,
    overflowed [K])."""
    k = search.k
    dev = min_score.device
    lanes = torch.arange(k, device=dev)
    best_score = min_score.clone()
    best_low = torch.zeros_like(min_score)
    best = torch.tensor([-1, 0, 0, 0], dtype=torch.int32, device=dev).repeat(k, 1)
    overflowed = torch.zeros(k, dtype=torch.bool, device=dev)

    def update(sums, scores, lows, ok, cand, best_score, best_low, best):
        j = torch.argmax(_rank_keys(sums, ok), dim=1)
        s = torch.where(ok[lanes, j], scores[lanes, j], torch.full_like(best_score, -math.inf))
        better = s > best_score
        pick = torch.stack([t[lanes, j].to(torch.int32) for t in cand], dim=1)
        return (
            torch.where(better, s, best_score),
            torch.where(better, lows[lanes, j], best_low),
            torch.where(better[:, None], pick, best),
        )

    a, x, y, z, valid = cands
    for level in range(depth - 1, -1, -1):
        sums, scores = search.score(level, a, x, y, z, valid)
        if level == 0:
            lows = search.low_scores(a, x, y, z, valid, ratio)
            ok = valid & (lows >= min_low[:, None])
            best_score, best_low, best = update(
                sums, scores, lows, ok, (a, x, y, z), best_score, best_low, best
            )
            break
        c = scores.shape[1]
        _, pidx = torch.topk(_rank_keys(sums, valid), min(leaf_probe, c), dim=1)
        probe = tuple(_take(t, pidx) for t in (a, x, y, z))
        pvalid = _take(valid, pidx)
        psums, pscores = search.score(0, *probe, pvalid)
        plows = search.low_scores(*probe, pvalid, ratio)
        best_score, best_low, best = update(
            psums, pscores, plows, pvalid & (plows >= min_low[:, None]), probe,
            best_score, best_low, best,
        )
        alive = scores > best_score[:, None]
        n_alive = torch.sum(alive, dim=1)
        k_beam = min(beam, c)
        if k_beam < c:
            overflowed = overflowed | (n_alive > k_beam)
        width = max(1, min(k_beam, int(n_alive.max())))
        _, top = torch.topk(_rank_keys(sums, alive), width, dim=1)
        half = 1 << (level - 1)
        offs = [
            torch.tensor([half * o for o in offsets], dtype=torch.int32, device=dev).repeat(width)
            for offsets in _CHILD_OFFSETS
        ]
        a = _take(a, top).repeat_interleave(8, dim=1)
        x, y, z = (
            _take(t, top).repeat_interleave(8, dim=1) + o for t, o in zip((x, y, z), offs)
        )
        valid = (
            _take(alive, top).repeat_interleave(8, dim=1)
            & (x <= nl_xy[:, None]) & (y <= nl_xy[:, None]) & (z <= nl_z[:, None])
        )
    return best_score, best_low, best, overflowed


def bnb_search_3d(
    pyramid,  # tuple of u8 [Dl, Hl, Wl] octave levels
    points,  # f32 [N, 3] raw high-res cloud (node frame)
    pmask,  # bool [N]
    q0,  # f32 [4] initial rotation (node->submap)
    t0,  # f32 [3] initial translation
    angles,  # f32 [A] surviving candidate yaws
    origin,  # f32 [3] high-res grid origin
    resolution,  # f32 []
    low_prob,  # u8 low-res volume
    low_points,  # f32 [Nl, 3]
    low_mask,  # bool [Nl]
    low_origin,  # f32 [3]
    low_resolution,  # f32 []
    a0, x0, y0, z0, m0,  # [K0] initial candidates
    nl_xy, nl_z, min_score, min_low_score, ratio,
    depth: int,
    beam: int = 4096,
    leaf_probe: int = _LEAF_PROBE,
):
    """One search from explicit top-level candidates (the JAX function's
    interface). Returns (score, low_score, [a, x, y, z] i32, overflowed)."""
    dev = points.device
    f32 = dict(dtype=torch.float32)
    lane = lambda v, **kw: torch.as_tensor(v, device=dev, **kw)[None]  # noqa: E731
    search = _Search3D(
        [lvl[None] for lvl in _bound_volumes(pyramid)], low_prob[None],
        torch.zeros(1, dtype=torch.int64, device=dev),
        points[None], pmask[None], low_points[None], low_mask[None],
        lane(q0, dtype=torch.float32), lane(t0, dtype=torch.float32),
        lane(angles, dtype=torch.float32), lane(origin, dtype=torch.float32),
        lane(resolution, **f32), lane(low_origin, dtype=torch.float32),
        lane(low_resolution, **f32),
    )
    cands = tuple(lane(c, dtype=torch.int32) for c in (a0, x0, y0, z0)) + (lane(m0, dtype=torch.bool),)
    score, low, best, overflowed = _bnb_lanes(
        search, cands, lane(nl_xy, dtype=torch.int32), lane(nl_z, dtype=torch.int32),
        lane(min_score, **f32), lane(min_low_score, **f32), lane(ratio, **f32),
        depth, beam, leaf_probe,
    )
    return score[0], low[0], best[0], overflowed[0]


def _shape_key(pr):
    m = pr["matcher"]
    return tuple(tuple(lvl.shape) for lvl in m._pyramid), tuple(m._low_prob.shape)


def _lane_chunks(preps, indices, beam):
    """Chunks of `indices` (one shape family) in the order of their
    top-level candidate counts, each keeping lanes x max(8 beam,
    candidates) x points under _GATHER_BUDGET."""
    order = sorted(indices, key=lambda i: len(preps[i]["cand"][0]))
    chunks, cur, c_max, n_max = [], [], 0, 0
    for i in order:
        c = max(8 * beam, len(preps[i]["cand"][0]))
        n = max(preps[i]["device_points"][0].shape[0], preps[i]["device_points"][2].shape[0])
        if cur and (len(cur) + 1) * max(c, c_max) * max(n, n_max) > _GATHER_BUDGET:
            chunks.append(cur)
            cur, c_max, n_max = [], 0, 0
        cur.append(i)
        c_max, n_max = max(c, c_max), max(n, n_max)
    return chunks + [cur]


def _assemble(preps):
    """The lanes of `preps` (one shape family) on the device: the
    _Search3D, each lane's top-level candidates (a, x, y, z, valid) and
    its scalars (nl_xy, nl_z, min score, min low score, ratio)."""
    uniq, sidx = {}, []
    for pr in preps:
        sidx.append(uniq.setdefault(id(pr["matcher"]), len(uniq)))
    matchers = list({id(pr["matcher"]): pr["matcher"] for pr in preps}.values())
    device = matchers[0]._low_prob.device
    depth = matchers[0]._depth
    levels = [torch.stack([m._bounds[l] for m in matchers]) for l in range(depth)]
    low = torch.stack([m._low_prob for m in matchers])
    k = len(preps)
    n_pad = max(pr["device_points"][0].shape[0] for pr in preps)
    nl_pad = max(pr["device_points"][2].shape[0] for pr in preps)
    a_pad = max(len(pr["angles_kept"]) for pr in preps)
    k0 = max(len(pr["cand"][0]) for pr in preps)
    points = np.zeros((k, n_pad, 3), np.float32)
    pmask = np.zeros((k, n_pad), bool)
    lpoints = np.zeros((k, nl_pad, 3), np.float32)
    lmask = np.zeros((k, nl_pad), bool)
    angles = np.zeros((k, a_pad), np.float32)
    cand = np.zeros((4, k, k0), np.int32)
    m0 = np.zeros((k, k0), bool)
    # Per lane: q0 4, t0 3, origin 3, res, low origin 3, low res, min
    # score, min low score, ratio; nl_xy, nl_z.
    scal = np.zeros((k, 18), np.float32)
    ints = np.zeros((k, 3), np.int64)
    for i, pr in enumerate(preps):
        m = pr["matcher"]
        p_, pm_, lp_, lm_ = pr["device_points"]
        points[i, : len(p_)], pmask[i, : len(pm_)] = p_, pm_
        lpoints[i, : len(lp_)], lmask[i, : len(lm_)] = lp_, lm_
        angles[i, : len(pr["angles_kept"])] = pr["angles_kept"]
        for j in range(4):
            cand[j, i, : len(pr["cand"][j])] = pr["cand"][j]
        m0[i, : len(pr["cand"][4])] = pr["cand"][4]
        scal[i] = (*pr["q0"], *pr["t0"], *m._origin, m._resolution, *pr["lorigin"],
                   pr["lres"], pr["min_score"], m._options.min_low_resolution_score,
                   m._resolution / pr["lres"])
        ints[i] = (pr["nl_xy"], pr["nl_z"], sidx[i])
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    s, n = t(scal), t(ints)
    search = _Search3D(
        levels, low, n[:, 2], t(points), t(pmask), t(lpoints), t(lmask),
        s[:, 0:4], s[:, 4:7], t(angles), s[:, 7:10], s[:, 10], s[:, 11:14], s[:, 14],
    )
    lane = (n[:, 0].to(torch.int32), n[:, 1].to(torch.int32), s[:, 15], s[:, 16], s[:, 17])
    return search, (*t(cand), t(m0)), lane


def _search_chunk(preps, beam):
    """Run the searches `preps` (one lane each, one shape family) at once;
    returns packed [K, 7] rows (score, low score, a, x, y, z, overflowed)
    as numpy."""
    search, cands, lane = _assemble(preps)
    score, low_score, best, overflowed = _bnb_lanes(
        search, cands, *lane, preps[0]["matcher"]._depth, beam, _LEAF_PROBE
    )
    return torch.cat(
        [score[:, None], low_score[:, None], best.to(torch.float32),
         overflowed[:, None].to(torch.float32)], dim=1,
    ).cpu().numpy()


def candidate_scores(prep, candidates):
    """Full-resolution scores and low-resolution scores (numpy [C]) of
    explicit candidates (a, x, y, z) of one prepared search, as the
    search scores its leaves."""
    search, _, lane = _assemble([prep])
    dev = search.pmask.device
    a, x, y, z = (
        torch.tensor([[c[i] for c in candidates]], dtype=torch.int32, device=dev)
        for i in range(4)
    )
    valid = torch.ones_like(a, dtype=torch.bool)
    _, scores = search.score(0, a, x, y, z, valid)
    lows = search.low_scores(a, x, y, z, valid, lane[4])
    return scores[0].cpu().numpy(), lows[0].cpu().numpy()


def batch_match_device_3d(preps, mesh=None):
    """Run the prepared searches (FastCorrelativeScanMatcher3D._prepare
    results) on the device, grouped by shape family (finished submaps are
    cropped to content, so their pyramids differ in shape) and chunked by
    `_GATHER_BUDGET`. Returns (packed [K, 7] numpy, ctxs) aligned with
    `preps`. Searches whose beam cap bound (column 6) are re-run with a
    doubled beam up to _MAX_WIDENED_BEAM; every widening pass increments
    the beam_overflow_retries metric.

    With `mesh` every rank passes the same searches; each runs its share
    (partition.row_range) of every pass, the packed rows are gathered
    exactly, and every pass increments sharded_constraint_batches."""
    packed = np.zeros((len(preps), 7), np.float32)
    if mesh is not None:
        for pr in preps:
            device = pr["matcher"]._low_prob.device
            if not partition.same_device(device, mesh.device):
                raise ValueError(f"searches on {device}, mesh device {mesh.device}")

    def run(indices, beam):
        indices = np.asarray(list(indices), np.int64)
        if mesh is not None:
            metrics.sharded_constraint_batches.increment()
        lo, hi = partition.row_range(len(indices), mesh)
        mine = [preps[i] for i in indices[lo:hi]]
        local = np.zeros((len(mine), 7), np.float32)
        groups = {}
        for j, pr in enumerate(mine):
            groups.setdefault(_shape_key(pr), []).append(j)
        for idx in groups.values():
            for chunk in _lane_chunks(mine, idx, beam):
                local[chunk] = _search_chunk([mine[j] for j in chunk], beam)
        if mesh is not None:
            local = partition.fetch(torch.from_numpy(local), mesh, len(indices))
        packed[indices] = local

    if preps:
        beam = preps[0]["matcher"]._options.beam_width
        run(range(len(preps)), beam)
        rows = np.flatnonzero(packed[:, 6] > 0.5)
        while len(rows) and beam < _MAX_WIDENED_BEAM:
            beam = min(2 * beam, _MAX_WIDENED_BEAM)
            metrics.beam_overflow_retries.increment(len(rows))
            run(rows, beam)
            rows = rows[packed[rows, 6] > 0.5]
    return packed, [pr["ctx"] for pr in preps]


@dataclasses.dataclass
class MatchResult3D:
    score: float
    low_resolution_score: float
    rotational_score: float
    pose: np.ndarray  # SE(3) (7,) node pose in the submap frame


class FastCorrelativeScanMatcher3D:
    """A finished submap's pyramid and low-resolution volume on the grids'
    device, and searches against them."""

    def __init__(
        self,
        high_resolution_grid: Grid3D,
        low_resolution_grid: Grid3D,
        submap_histogram: np.ndarray,
        options: FastCorrelativeScanMatcherOptions3D,
    ):
        self._options = options
        self._depth = options.branch_and_bound_depth
        self._resolution = high_resolution_grid.resolution
        self._origin = high_resolution_grid.origin.cpu().numpy()
        self._shape = tuple(high_resolution_grid.values.shape)
        self._pyramid = compute_octave_pyramid(
            high_resolution_grid.probability(), self._depth
        )
        self._bounds = _bound_volumes(self._pyramid)
        self._low_grid = low_resolution_grid
        self._low_origin = low_resolution_grid.origin.cpu().numpy()
        self._low_prob = _quantize_u8(low_resolution_grid.probability())
        self._submap_histogram = submap_histogram

    @staticmethod
    def stage_points(point_cloud: np.ndarray, low_resolution_point_cloud):
        """A node's high and low clouds padded once for reuse across many
        searches: (points, pmask, low_points, low_mask) host arrays, each
        padded to a power of two >= 64."""

        def pad(cloud):
            pts = np.asarray(cloud[:, :3], np.float32)
            n_pad = 64
            while n_pad < pts.shape[0]:
                n_pad *= 2
            out = np.zeros((n_pad, 3), np.float32)
            out[: pts.shape[0]] = pts
            mask = np.zeros(n_pad, bool)
            mask[: pts.shape[0]] = True
            return out, mask

        p, m = pad(point_cloud)
        lp, lm = pad(low_resolution_point_cloud)
        return p, m, lp, lm

    def match(
        self,
        global_node_pose_in_submap: np.ndarray,  # SE(3) (7,)
        node_histogram: np.ndarray,
        node_gravity_yaw: float,
        point_cloud: np.ndarray,  # (N, 3) high-res cloud, node frame
        low_resolution_point_cloud: np.ndarray,
        min_score: float,
        full_submap: bool = False,
    ) -> Optional[MatchResult3D]:
        prep = self._prepare(
            global_node_pose_in_submap, node_histogram, node_gravity_yaw,
            point_cloud, low_resolution_point_cloud, min_score, full_submap,
        )
        if prep is None:
            return None
        packed, ctxs = batch_match_device_3d([prep])
        return self.decode(packed[0], ctxs[0])

    def _prepare(
        self,
        global_node_pose_in_submap: np.ndarray,
        node_histogram: np.ndarray,
        node_gravity_yaw: float,
        point_cloud: np.ndarray,
        low_resolution_point_cloud: np.ndarray,
        min_score: float,
        full_submap: bool = False,
        device_points=None,
    ):
        """Host-side search preparation (window, yaw pruning, candidate
        lattice); returns a dict of per-search arrays or None when the
        rotational histogram prunes every candidate yaw."""
        opts = self._options
        if full_submap:
            linear_xy = 0.5 * self._shape[2] * self._resolution
            linear_z = 0.5 * self._shape[0] * self._resolution
            angular = math.pi
        else:
            linear_xy = opts.linear_xy_search_window
            linear_z = opts.linear_z_search_window
            angular = opts.angular_search_window

        initial_pose = np.asarray(global_node_pose_in_submap, np.float64)
        max_scan_range = float(
            np.max(np.linalg.norm(point_cloud[:, :3], axis=1), initial=3.0 * self._resolution)
        )
        step = compute_angular_step(self._resolution, max_scan_range)
        num_angular = int(math.ceil(angular / step))
        angles = (np.arange(2 * num_angular + 1) - num_angular) * step

        # Yaw pruning by rotational histogram
        # (fast_correlative_scan_matcher_3d.cc ComputeAngularSearchWindow +
        # rotational matcher scores per candidate yaw).
        rot_scores = rotational_histogram.match_angles(
            self._submap_histogram, node_histogram, node_gravity_yaw, angles
        )
        keep_angles = rot_scores >= opts.min_rotational_score
        if not keep_angles.any():
            return None
        angles_kept = angles[keep_angles]
        rot_scores_kept = rot_scores[keep_angles]

        nl_xy = int(math.ceil(linear_xy / self._resolution))
        nl_z = int(math.ceil(linear_z / self._resolution))
        nl_xy = min(nl_xy, max(self._shape) + 1)
        nl_z = min(nl_z, max(self._shape) + 1)
        top = 1 << (self._depth - 1)

        def lattice(limit):
            lo = -((limit // top) + 1) * top
            return np.arange(lo, limit + 1, top, dtype=np.int32)

        grids = np.meshgrid(
            np.arange(len(angles_kept), dtype=np.int32),
            lattice(nl_xy), lattice(nl_xy), lattice(nl_z),
            indexing="ij",
        )
        cand = tuple(g.ravel() for g in grids) + (np.ones(grids[0].size, bool),)
        if device_points is None:
            device_points = self.stage_points(point_cloud, low_resolution_point_cloud)
        return dict(
            matcher=self,
            angles_kept=angles_kept.astype(np.float32),
            q0=np.asarray(rigid3.quat(initial_pose), np.float32),
            t0=np.asarray(initial_pose[:3], np.float32),
            lorigin=np.asarray(self._low_origin, np.float32),
            lres=self._low_grid.resolution,
            cand=cand,
            nl_xy=nl_xy,
            nl_z=nl_z,
            min_score=min_score,
            device_points=device_points,
            ctx=(angles_kept, rot_scores_kept, initial_pose),
        )

    def match_device(
        self,
        global_node_pose_in_submap: np.ndarray,
        node_histogram: np.ndarray,
        node_gravity_yaw: float,
        point_cloud: np.ndarray,
        low_resolution_point_cloud: np.ndarray,
        min_score: float,
        full_submap: bool = False,
        device_points=None,
        beam: Optional[int] = None,
    ):
        """One search without beam widening; returns (packed [7] numpy row,
        decode ctx) or None when the rotational histogram prunes every
        candidate yaw."""
        prep = self._prepare(
            global_node_pose_in_submap, node_histogram, node_gravity_yaw,
            point_cloud, low_resolution_point_cloud, min_score, full_submap,
            device_points,
        )
        if prep is None:
            return None
        return _search_chunk([prep], beam or self._options.beam_width)[0], prep["ctx"]

    def decode(self, packed: np.ndarray, ctx) -> Optional[MatchResult3D]:
        angles_kept, rot_scores_kept, initial_pose = ctx
        ba = int(packed[2])
        if ba < 0:
            return None
        score, low = float(packed[0]), float(packed[1])
        bx, by, bz = int(packed[3]), int(packed[4]), int(packed[5])
        pose = self._candidate_poses(
            {"a": np.array([ba]), "x": np.array([bx]), "y": np.array([by]), "z": np.array([bz])},
            angles_kept,
            initial_pose,
        )[0]
        return MatchResult3D(
            score=score,
            low_resolution_score=low,
            rotational_score=float(rot_scores_kept[ba]),
            pose=pose,
        )

    def _candidate_poses(self, c, angles_kept, initial_pose):
        poses = []
        for a, x, y, z in zip(c["a"], c["x"], c["y"], c["z"]):
            ang = angles_kept[int(a)]
            half = 0.5 * ang
            qa = np.array([np.cos(half), 0.0, 0.0, np.sin(half)])
            q = rigid3.quat_normalize(
                rigid3.quat_multiply(qa, rigid3.quat(initial_pose))
            )
            t = initial_pose[:3] + np.array([x, y, z], np.float64) * self._resolution
            poses.append(rigid3.make(t, q))
        return poses
