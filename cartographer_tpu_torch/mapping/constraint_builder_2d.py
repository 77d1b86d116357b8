"""Loop-closure constraint search for 2D.

Port of cartographer_tpu/mapping/constraint_builder_2d.py. Reference:
internal/constraints/constraint_builder_2d.cc:59-343. For each (node,
finished submap) pair (distance-gated + per-submap sampled), run the fast
correlative matcher (branch-and-bound, min_score gate) and refine with
the LM matcher; emit an INTER_SUBMAP constraint with loop-closure
weights. Global (cross-trajectory) searches use MatchFullSubmap with
global_localization_min_score.

Searches are queued and run in batches when the pose graph drains its
work queue (`run_pending`), in three stages: the branch-and-bound
searches (threaded C++ on the host for loop_closure_backend "native",
or batched on the device for "device"), then for each chunk of accepted
matches one batched LM refinement on the device, then the constraints.
With the native backend the next chunk's search runs on a worker thread
while this chunk's refinement is assembled and launched.

In this port "auto" means "native": the JAX package falls back to the
device search when the C++ library does not build, and this port has no
such fallback — a failed build raises. TSDF submaps have no log-odds
table for the native search or the batched refinement: as in the JAX
package, their searches take the device path even under "native", and
their matches are refined one by one through CeresScanMatcher2D.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import math
import os
import threading
import time as _time
from typing import Dict, List, Optional

import numpy as np
import torch

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.common.config import ConstraintBuilderOptions
from cartographer_tpu_torch.common.fixed_ratio_sampler import FixedRatioSampler
from cartographer_tpu_torch.common.histogram import Histogram
from cartographer_tpu_torch.mapping.grid_2d import Grid2D
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.scan_matching_2d import CeresScanMatcher2D
from cartographer_tpu_torch.mapping.tsdf_2d import TSDF2D
from cartographer_tpu_torch.mapping.trajectory_node import TrajectoryNodeData
from cartographer_tpu_torch.ops.scan_matching.fast_correlative_2d import (
    FastCorrelativeScanMatcher2D,
    MatchResult,
    batch_match_device,
)
from cartographer_tpu_torch.ops.scan_matching.gauss_newton_2d import (
    match_log_odds_batch,
)
from cartographer_tpu_torch.parallel.partition import mesh_device
from cartographer_tpu_torch.transform import rigid2

INTRA_SUBMAP = "INTRA_SUBMAP"
INTER_SUBMAP = "INTER_SUBMAP"


@dataclasses.dataclass
class ConstraintPose:
    zbar_ij: np.ndarray  # SE(2) (3,) observed submap->node
    translation_weight: float
    rotation_weight: float


@dataclasses.dataclass
class Constraint:
    submap_id: SubmapId
    node_id: NodeId
    pose: ConstraintPose
    tag: str  # INTRA_SUBMAP | INTER_SUBMAP


@dataclasses.dataclass
class _PendingSearch:
    submap_id: SubmapId
    node_id: NodeId
    constant_data: TrajectoryNodeData
    initial_relative_pose: Optional[np.ndarray]  # None => global (full submap)
    # time.monotonic() at enqueue: the drain reports the oldest one's age.
    enqueued: float = dataclasses.field(default_factory=_time.monotonic)


class ConstraintBuilder2D:
    # Searches per pipeline stage of the native backend.
    _DRAIN_CHUNK = 256

    def __init__(self, options: ConstraintBuilderOptions, device=None, mesh=None):
        """`device=None` means CUDA (the mesh's device when a mesh is
        given); pass device="cpu" to run on the CPU. mesh: optional
        parallel/partition.Mesh — the drained device search batch is split
        over its ranks (whole BnB searches per rank), the analog of the
        reference's ThreadPool fan-out (constraint_builder_2d.cc:102-136)."""
        if options.loop_closure_backend not in ("native", "auto", "device"):
            raise ValueError(
                f"unknown loop_closure_backend {options.loop_closure_backend!r}"
            )
        self._options = options
        self._device = mesh_device(device, mesh)
        self._mesh = mesh
        self._ceres_matcher = CeresScanMatcher2D(options.ceres_scan_matcher)
        self._samplers: Dict[SubmapId, FixedRatioSampler] = {}
        self._matchers: Dict[SubmapId, FastCorrelativeScanMatcher2D] = {}
        self._submap_grids: Dict[SubmapId, Grid2D] = {}
        self._pending: List[_PendingSearch] = []
        self._pending_lock = threading.Lock()
        self._score_histogram = Histogram()
        self._num_finished_nodes = 0
        self._submap_local_poses: Dict[SubmapId, np.ndarray] = {}
        # Staged (pre-padded) node clouds: a node is searched against many
        # submaps, so its cloud is padded once.
        self._node_clouds: Dict[NodeId, tuple] = {}
        # Memoized device stacks of unique submap grids for the refinement.
        self._grid_stack_cache: Dict[tuple, tuple] = {}
        # Native-backend state: per-submap C++ pyramids + host origins.
        self._native_pyramids: Dict[SubmapId, object] = {}
        self._native_origins: Dict[SubmapId, tuple] = {}
        self._search_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self.last_drain_timings: Dict[str, float] = {}
        self.last_drain_searches: List[_PendingSearch] = []

    @property
    def device(self) -> torch.device:
        return self._device

    def _sampler(self, submap_id: SubmapId) -> FixedRatioSampler:
        if submap_id not in self._samplers:
            self._samplers[submap_id] = FixedRatioSampler(self._options.sampling_ratio)
        return self._samplers[submap_id]

    def _matcher(self, submap_id: SubmapId) -> FastCorrelativeScanMatcher2D:
        # Memoized per-submap pyramid (DispatchScanMatcherConstruction).
        if submap_id not in self._matchers:
            self._matchers[submap_id] = FastCorrelativeScanMatcher2D(
                self._submap_grids[submap_id],
                self._options.fast_correlative_scan_matcher,
            )
        return self._matchers[submap_id]

    def _grid_on_device(self, grid):
        if grid.origin.device == self._device:
            return grid
        if isinstance(grid, TSDF2D):
            return dataclasses.replace(
                grid,
                tsd=grid.tsd.to(self._device),
                weight=grid.weight.to(self._device),
                origin=grid.origin.to(self._device),
            )
        return Grid2D(
            log_odds=grid.log_odds.to(self._device),
            known=grid.known.to(self._device),
            origin=grid.origin.to(self._device),
            resolution=grid.resolution,
        )

    def _enqueue(self, search: _PendingSearch, grid: Grid2D) -> None:
        if search.submap_id not in self._submap_grids:
            self._submap_grids[search.submap_id] = self._grid_on_device(grid)
        with self._pending_lock:
            self._pending.append(search)

    def maybe_add_constraint(
        self,
        submap_id: SubmapId,
        grid: Grid2D,
        node_id: NodeId,
        constant_data: TrajectoryNodeData,
        initial_relative_pose: np.ndarray,
    ) -> None:
        if (
            np.linalg.norm(initial_relative_pose[:2])
            > self._options.max_constraint_distance
        ):
            return
        if not self._sampler(submap_id).pulse():
            return
        self._enqueue(
            _PendingSearch(submap_id, node_id, constant_data, initial_relative_pose),
            grid,
        )

    def maybe_add_global_constraint(
        self,
        submap_id: SubmapId,
        grid: Grid2D,
        node_id: NodeId,
        constant_data: TrajectoryNodeData,
    ) -> None:
        self._enqueue(_PendingSearch(submap_id, node_id, constant_data, None), grid)

    def notify_end_of_node(self) -> None:
        self._num_finished_nodes += 1

    def run_pending(self) -> List[Constraint]:
        """Execute queued searches; returns found constraints (WhenDone).
        Sets the work queue gauges as the reference's DrainWorkQueue
        does: the searches taken and the age of the oldest. The three
        phases are the drain.search, drain.refine_dispatch and
        drain.refine_wait spans, inside the pose graph's drain span."""
        with self._pending_lock:
            pending, self._pending = self._pending, []
        metrics.pose_graph_work_queue_size.set(len(pending))
        metrics.pose_graph_work_queue_delay.set(
            _time.monotonic() - min(s.enqueued for s in pending) if pending else 0.0
        )
        # Drop searches whose submap was evicted while they sat queued.
        stale = [s for s in pending if s.submap_id not in self._submap_grids]
        if stale:
            logging.getLogger(__name__).info(
                "Dropping %d queued constraint searches against trimmed "
                "submaps.", len(stale),
            )
            pending = [s for s in pending if s.submap_id in self._submap_grids]
        # The searches of this drain, for callers that replay it.
        self.last_drain_searches = pending
        if not pending:
            self.last_drain_timings = {}
            return []

        t0 = _time.perf_counter()
        use_native = self._use_native_backend()
        # The native search reads log-odds probability pyramids; TSDF
        # submaps have no log-odds table, so their searches take the device
        # path even under "native" (a mixed drain splits).
        if use_native:
            is_tsdf = [isinstance(self._submap_grids[s.submap_id], TSDF2D) for s in pending]
            native_pending = [s for s, t in zip(pending, is_tsdf) if not t]
            device_pending = [s for s, t in zip(pending, is_tsdf) if t]
        else:
            native_pending, device_pending = [], pending
        # Native chunks first (they drive the search worker), then one
        # device chunk: the device search batches lanes itself.
        chunks = [
            ("native", native_pending[c0: c0 + self._DRAIN_CHUNK])
            for c0 in range(0, len(native_pending), self._DRAIN_CHUNK)
        ]
        n_native_chunks = len(chunks)
        if device_pending:
            chunks.append(("device", device_pending))
        t_search = t_refine_dispatch = t_refine_wait = 0.0
        # Native path: the C++ search releases the GIL, so chunk k+1's
        # threaded search runs on a worker thread WHILE this thread decodes
        # chunk k and launches its refinement — only where the host has
        # cores to spare (on fewer than 4 the assembly thread would take
        # cycles from the search threads).
        use_worker = n_native_chunks > 0 and (os.cpu_count() or 1) >= 4
        future = None
        if use_worker:
            from cartographer_tpu_torch.native import bnb as native_bnb

            if self._search_pool is None:
                self._search_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="bnb-search"
                )
            searching = metrics.timed("drain.search")
            prep = self._prepare_native(chunks[0][1])
            future = self._search_pool.submit(
                native_bnb.match_batch, prep["pyramids"], prep["clouds"], prep["params"]
            )
            t_search += searching.stop()
        # Per chunk: [(search, refined pose or None)], the batched jobs as
        # (index into that list, search, BnB result), their device rows.
        staged = []
        num_matches = 0
        for ci, (kind, chunk) in enumerate(chunks):
            searching = metrics.timed("drain.search")
            if kind == "device":
                decoded = self._run_searches_device(chunk)
            elif use_worker:
                out_rows, found = future.result()
                if ci + 1 < n_native_chunks:
                    prep = self._prepare_native(chunks[ci + 1][1])
                    future = self._search_pool.submit(
                        native_bnb.match_batch,
                        prep["pyramids"], prep["clouds"], prep["params"],
                    )
                decoded = self._decode_native(chunk, out_rows, found)
            else:
                decoded = self._run_searches_native(chunk)
            t_search += searching.stop()
            refine = []
            jobs = []
            for search, result in decoded:
                if result is None:
                    continue
                self._score_histogram.add(result.score)
                metrics.constraint_scores.observe(result.score)
                grid = self._submap_grids[search.submap_id]
                if isinstance(grid, TSDF2D):  # refined one by one
                    cloud = search.constant_data.filtered_gravity_aligned_point_cloud
                    pose, _ = self._ceres_matcher.match(
                        result.pose[:2], result.pose, cloud, grid
                    )
                    refine.append((search, pose))
                    continue
                jobs.append((len(refine), search, result))
                refine.append((search, None))
            num_matches += len(refine)
            rows = None
            if jobs:
                dispatch = metrics.timed("drain.refine_dispatch")
                rows = self._batch_refine_dispatch([(s, r) for _, s, r in jobs])
                t_refine_dispatch += dispatch.stop()
            staged.append((refine, jobs, rows))

        results: List[Constraint] = []
        tw, rw = (
            self._options.loop_closure_translation_weight,
            self._options.loop_closure_rotation_weight,
        )
        for refine, jobs, rows in staged:
            if rows is not None:
                wait = metrics.timed("drain.refine_wait")
                poses = rows[: len(jobs), :3].cpu().numpy().astype(np.float64)
                t_refine_wait += wait.stop()
                poses[:, 2] = rigid2.normalize_angle(poses[:, 2])
                for (i, _, _), pose in zip(jobs, poses):
                    refine[i] = (refine[i][0], pose)
            if not refine:
                continue
            poses = np.stack([pose for _, pose in refine]).astype(np.float64)
            # Vectorized zbar = inverse(submap_local_pose) o refined_pose.
            sub = np.stack(
                [self._submap_local_pose(search.submap_id) for search, _ in refine]
            ).astype(np.float64)
            ct, st = np.cos(-sub[:, 2]), np.sin(-sub[:, 2])
            dx = poses[:, 0] - sub[:, 0]
            dy = poses[:, 1] - sub[:, 1]
            zx = ct * dx - st * dy
            zy = st * dx + ct * dy
            zt = rigid2.normalize_angle(poses[:, 2] - sub[:, 2])
            for (search, _), x, y, t in zip(refine, zx, zy, zt):
                results.append(
                    Constraint(
                        submap_id=search.submap_id,
                        node_id=search.node_id,
                        pose=ConstraintPose(
                            zbar_ij=np.array([x, y, t]),
                            translation_weight=tw,
                            rotation_weight=rw,
                        ),
                        tag=INTER_SUBMAP,
                    )
                )
        metrics.constraints_found.increment(len(results))
        self.last_drain_timings = {
            "searches": len(pending),
            "matches": num_matches,
            "search_s": t_search,
            "refine_dispatch_s": t_refine_dispatch,
            "refine_wait_s": t_refine_wait,
            "total_s": _time.perf_counter() - t0,
        }
        return results

    def _use_native_backend(self) -> bool:
        return self._options.loop_closure_backend in ("native", "auto")

    def _staged_cloud(self, search: _PendingSearch):
        cloud = search.constant_data.filtered_gravity_aligned_point_cloud
        staged = self._node_clouds.get(search.node_id)
        if staged is None or staged[0].shape[0] < cloud.shape[0]:
            staged = FastCorrelativeScanMatcher2D.stage_points(cloud) + (
                np.ascontiguousarray(cloud[:, :2], np.float32),
            )
            self._node_clouds[search.node_id] = staged
        return staged

    def _run_searches_device(self, pending):
        """All BnB searches of the drain on the device, batched over lanes.
        Returns [(search, MatchResult | None)]."""
        batch = []
        for search in pending:
            metrics.constraints_searched.increment()
            staged = self._staged_cloud(search)
            if search.initial_relative_pose is None:
                initial_pose = None
                min_score = self._options.global_localization_min_score
            else:
                initial_pose = rigid2.compose(
                    self._submap_local_pose(search.submap_id),
                    search.initial_relative_pose,
                )
                min_score = self._options.min_score
            batch.append(
                dict(
                    matcher=self._matcher(search.submap_id),
                    initial_pose=initial_pose,
                    point_cloud=search.constant_data.filtered_gravity_aligned_point_cloud,
                    device_points=staged[:2],
                    min_score=min_score,
                )
            )
        packed, ctxs = batch_match_device(batch, mesh=self._mesh)
        return [
            (search, FastCorrelativeScanMatcher2D.decode(row, ctx))
            for search, row, ctx in zip(pending, packed, ctxs)
        ]

    def _run_searches_native(self, pending):
        """All BnB searches of the chunk threaded across host cores
        (csrc/bnb_native.cc). Returns [(search, MatchResult | None)]."""
        from cartographer_tpu_torch.native import bnb as native_bnb

        prep = self._prepare_native(pending)
        out_rows, found = native_bnb.match_batch(
            prep["pyramids"], prep["clouds"], prep["params"]
        )
        return self._decode_native(pending, out_rows, found)

    def _prepare_native(self, pending):
        """Host-side batch assembly for the native search: pyramids
        (memoized per submap), deduplicated clouds, initial poses."""
        from cartographer_tpu_torch.native import bnb as native_bnb

        opts = self._options.fast_correlative_scan_matcher
        depth = opts.branch_and_bound_depth
        n = len(pending)
        metrics.constraints_searched.increment(n)
        pyramids = []
        clouds = []
        params = np.zeros((n, 9), np.float32)
        sub = np.zeros((n, 3), np.float64)
        rel = np.zeros((n, 3), np.float64)
        for i, search in enumerate(pending):
            sid = search.submap_id
            pyr = self._native_pyramids.get(sid)
            if pyr is None:
                grid = self._submap_grids[sid]
                # One host fetch per finished submap grid.
                log_odds = grid.log_odds.cpu().numpy()
                known = grid.known.cpu().numpy()
                prob = np.where(
                    known, 1.0 / (1.0 + np.exp(-log_odds)), 0.1
                ).astype(np.float32)
                pyr = native_bnb.NativePyramid(prob, depth)
                self._native_pyramids[sid] = pyr
                self._native_origins[sid] = (
                    grid.origin.cpu().numpy().astype(np.float64),
                    float(grid.resolution),
                )
            origin, resolution = self._native_origins[sid]
            clouds.append(self._staged_cloud(search)[2])
            if search.initial_relative_pose is None:
                center = origin + 0.5 * resolution * np.array([pyr.w, pyr.h])
                sub[i] = rigid2.make(center, 0.0)
                params[i, 6:9] = (
                    1e6 * resolution,
                    math.pi,
                    self._options.global_localization_min_score,
                )
            else:
                sub[i] = self._submap_local_pose(sid)
                rel[i] = search.initial_relative_pose
                params[i, 6:9] = (
                    opts.linear_search_window,
                    opts.angular_search_window,
                    self._options.min_score,
                )
            params[i, 0:2] = origin
            params[i, 2] = resolution
            pyramids.append(pyr)
        ct, st = np.cos(sub[:, 2]), np.sin(sub[:, 2])
        params[:, 3] = sub[:, 0] + ct * rel[:, 0] - st * rel[:, 1]
        params[:, 4] = sub[:, 1] + st * rel[:, 0] + ct * rel[:, 1]
        params[:, 5] = sub[:, 2] + rel[:, 2]
        return {"pyramids": pyramids, "clouds": clouds, "params": params}

    @staticmethod
    def _decode_native(pending, out_rows, found):
        thetas = rigid2.normalize_angle(out_rows[:, 3].astype(np.float64))
        out = []
        for i, search in enumerate(pending):
            if not found[i]:
                out.append((search, None))
                continue
            pose = np.array([out_rows[i, 1], out_rows[i, 2], thetas[i]], np.float64)
            out.append((search, MatchResult(score=float(out_rows[i, 0]), pose=pose)))
        return out

    def _batch_refine_dispatch(self, jobs):
        """Launch ONE batched LM refinement of every accepted match of a
        chunk; returns the [k, 4] device rows (x, y, theta, cost), fetched
        by the caller after the later chunks' searches.

        `jobs`: list of (_PendingSearch, MatchResult). The unique submap
        grids are stacked on the device (memoized across drains) and each
        lane reads its own by index; the unique node clouds go up once."""
        opts = self._options.ceres_scan_matcher
        grid_index: Dict[SubmapId, int] = {}
        grids = []
        cloud_index: Dict[NodeId, int] = {}
        clouds = []
        for search, _ in jobs:
            sid = search.submap_id
            if sid not in grid_index:
                grid_index[sid] = len(grids)
                grids.append(self._submap_grids[sid])
            nid = search.node_id
            if nid not in cloud_index:
                cloud_index[nid] = len(clouds)
                clouds.append(self._node_clouds[nid])
        k = len(jobs)
        n_pad = max(c[0].shape[0] for c in clouds)
        points = np.zeros((len(clouds), n_pad, 2), np.float32)
        pmask = np.zeros((len(clouds), n_pad), bool)
        for r, staged in enumerate(clouds):
            points[r, : staged[0].shape[0]] = staged[0]
            pmask[r, : staged[1].shape[0]] = staged[1]
        small = np.zeros((k, 8), np.float32)  # origin 2, pose 3, target 2, res
        idx = np.zeros((k, 2), np.int32)
        for i, (search, result) in enumerate(jobs):
            grid = self._submap_grids[search.submap_id]
            small[i, 0:2] = self._grid_origin(search.submap_id)
            small[i, 2:5] = result.pose
            small[i, 5:7] = result.pose[:2]
            small[i, 7] = grid.resolution
            idx[i] = (grid_index[search.submap_id], cloud_index[search.node_id])
        dev = self._device
        small_d = torch.from_numpy(small).to(dev)
        idx_d = torch.from_numpy(idx).to(dev)
        log_odds, known = self._grid_stack(grids)
        return match_log_odds_batch(
            log_odds,
            known,
            torch.from_numpy(points).to(dev),
            torch.from_numpy(pmask).to(dev),
            small_d[:, 0:2],
            small_d[:, 2:5],
            small_d[:, 5:7],
            small_d[:, 7],
            idx_d[:, 0],
            idx_d[:, 1],
            opts.occupied_space_weight,
            opts.translation_weight,
            opts.rotation_weight,
            opts.ceres_solver_options.max_num_iterations,
            bool(opts.ceres_solver_options.use_nonmonotonic_steps),
        )

    def _grid_origin(self, submap_id: SubmapId) -> np.ndarray:
        cached = self._native_origins.get(submap_id)
        if cached is None:
            grid = self._submap_grids[submap_id]
            cached = (grid.origin.cpu().numpy().astype(np.float64), float(grid.resolution))
            self._native_origins[submap_id] = cached
        return cached[0]

    def _grid_stack(self, grids):
        """Memoized [S, H, W] device stacks (log_odds, known) of the
        drain's unique submap grids."""
        key = tuple(id(g) for g in grids)
        hit = self._grid_stack_cache.get(key)
        if hit is not None:
            return hit[0]
        stacks = (
            torch.stack([g.log_odds for g in grids]),
            torch.stack([g.known for g in grids]),
        )
        while len(self._grid_stack_cache) >= 8:
            self._grid_stack_cache.pop(next(iter(self._grid_stack_cache)))
        self._grid_stack_cache[key] = (stacks, tuple(grids))
        return stacks

    def num_pending(self) -> int:
        return len(self._pending)

    def evict_submap(self, submap_id: SubmapId) -> None:
        """Forget a trimmed submap's cached matcher, grid and native
        pyramid (queued searches against it are dropped at the next
        drain)."""
        for cache in (
            self._matchers, self._submap_grids, self._native_pyramids,
            self._native_origins,
        ):
            cache.pop(submap_id, None)

    def evict_node(self, node_id: NodeId) -> None:
        """Forget a trimmed node's staged cloud."""
        self._node_clouds.pop(node_id, None)

    def set_submap_local_pose(self, submap_id: SubmapId, pose: np.ndarray) -> None:
        self._submap_local_poses[submap_id] = np.asarray(pose)

    def _submap_local_pose(self, submap_id: SubmapId) -> np.ndarray:
        return self._submap_local_poses[submap_id]

    def score_histogram(self) -> Histogram:
        return self._score_histogram
