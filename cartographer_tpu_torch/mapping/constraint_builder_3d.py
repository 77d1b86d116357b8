"""3D loop-closure constraint search.

Port of cartographer_tpu/mapping/constraint_builder_3d.py. Reference:
internal/constraints/constraint_builder_3d.cc — per (node, finished
submap) pair: branch-and-bound match (yaw-pruned by rotational
histograms, dual min-score gates: min_score plus min_low_resolution_score)
followed by dual-grid LM refinement; emits INTER constraints whose zbar is
the refined node pose in the submap frame.

Searches are queued and run in batches when the pose graph drains its
work queue (`run_pending`): the branch-and-bound searches (threaded C++
on the host for loop_closure_backend "native", batched on the device for
"device"), then per chunk of accepted matches the batched refinement
(`gauss_newton_3d.match_3d_batch`, one call per grid-shape family, each
lane reading its submap's grids from one stack by index), then the
constraints. In this port "auto" means "native": the JAX package falls
back to the device search when the C++ library does not build, and this
port has no such fallback — a failed build raises. A trimmed submap's and
node's caches are evicted (`evict_submap`, `evict_node`); the JAX package
keeps the trimmed nodes' clouds.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time as _time
from typing import Dict, List, Optional

import numpy as np
import torch

from cartographer_tpu_torch import metrics
from cartographer_tpu_torch.common.config import ConstraintBuilderOptions
from cartographer_tpu_torch.common.fixed_ratio_sampler import FixedRatioSampler
from cartographer_tpu_torch.common.histogram import Histogram
from cartographer_tpu_torch.mapping.constraint_builder_2d import (
    INTER_SUBMAP,
    Constraint,
    ConstraintPose,
)
from cartographer_tpu_torch.mapping.id import NodeId, SubmapId
from cartographer_tpu_torch.mapping.paged_grid_3d import PagedGrid3D
from cartographer_tpu_torch.mapping.scan_matching_3d import CeresScanMatcher3D, pad_points_3d
from cartographer_tpu_torch.mapping.submap_3d import Submap3D
from cartographer_tpu_torch.mapping.trajectory_node import TrajectoryNodeData
from cartographer_tpu_torch.ops.scan_matching import gauss_newton_3d, rotational_histogram
from cartographer_tpu_torch.ops.scan_matching.correlative_2d import compute_angular_step
from cartographer_tpu_torch.ops.scan_matching.fast_correlative_3d import (
    FastCorrelativeScanMatcher3D,
    MatchResult3D,
    batch_match_device_3d,
)
from cartographer_tpu_torch.parallel.partition import mesh_device
from cartographer_tpu_torch.transform import rigid3


@dataclasses.dataclass
class _PendingSearch3D:
    submap_id: SubmapId
    node_id: NodeId
    constant_data: TrajectoryNodeData
    global_node_pose: Optional[np.ndarray]  # in submap frame; None => global
    gravity_yaw: float


class ConstraintBuilder3D:
    # Searches per pipeline stage of the native backend.
    _DRAIN_CHUNK = 256

    def __init__(self, options: ConstraintBuilderOptions, device=None, mesh=None):
        """`device=None` means CUDA (the mesh's device when a mesh is
        given); pass device="cpu" to run on the CPU. mesh: optional
        parallel/partition.Mesh — drained device search batches are split
        over its ranks (constraint_builder_2d.ConstraintBuilder2D)."""
        if options.loop_closure_backend not in ("native", "auto", "device"):
            raise ValueError(
                f"unknown loop_closure_backend {options.loop_closure_backend!r}"
            )
        self._options = options
        self._device = mesh_device(device, mesh)
        self._mesh = mesh
        self._samplers: Dict[SubmapId, FixedRatioSampler] = {}
        self._matchers: Dict[SubmapId, FastCorrelativeScanMatcher3D] = {}
        self._submaps: Dict[SubmapId, Submap3D] = {}
        self._ceres_matcher = CeresScanMatcher3D(options.ceres_scan_matcher_3d)
        self._pending: List[_PendingSearch3D] = []
        self._pending_lock = threading.Lock()
        self._score_histogram = Histogram()
        self._rotational_score_histogram = Histogram()
        self._low_resolution_score_histogram = Histogram()
        # Per-node staged clouds (padded host arrays for the device search,
        # contiguous arrays and the max range for the native one) and
        # per-submap native pyramids with their host metadata.
        self._node_clouds: Dict[NodeId, tuple] = {}
        self._native_node_clouds: Dict[NodeId, tuple] = {}
        self._native_submaps: Dict[SubmapId, object] = {}
        self._native_meta: Dict[SubmapId, tuple] = {}
        self.last_drain_timings: Dict[str, float] = {}
        self.last_drain_searches: List[_PendingSearch3D] = []

    @property
    def device(self) -> torch.device:
        return self._device

    def _sampler(self, submap_id: SubmapId) -> FixedRatioSampler:
        if submap_id not in self._samplers:
            self._samplers[submap_id] = FixedRatioSampler(self._options.sampling_ratio)
        return self._samplers[submap_id]

    def _matcher(self, submap_id: SubmapId) -> FastCorrelativeScanMatcher3D:
        if submap_id not in self._matchers:
            submap = self._submaps[submap_id]
            self._matchers[submap_id] = FastCorrelativeScanMatcher3D(
                submap.high_resolution_grid,
                submap.low_resolution_grid,
                submap.rotational_scan_matcher_histogram,
                self._options.fast_correlative_scan_matcher_3d,
            )
        return self._matchers[submap_id]

    def _enqueue(self, search: _PendingSearch3D, submap: Submap3D) -> None:
        self._submaps.setdefault(search.submap_id, submap)
        with self._pending_lock:
            self._pending.append(search)

    def maybe_add_constraint(
        self,
        submap_id: SubmapId,
        submap: Submap3D,
        node_id: NodeId,
        constant_data: TrajectoryNodeData,
        global_node_pose_in_submap: np.ndarray,
        gravity_yaw: float,
    ) -> None:
        if (
            np.linalg.norm(global_node_pose_in_submap[:3])
            > self._options.max_constraint_distance
        ):
            return
        if not self._sampler(submap_id).pulse():
            return
        self._enqueue(
            _PendingSearch3D(
                submap_id, node_id, constant_data, global_node_pose_in_submap, gravity_yaw
            ),
            submap,
        )

    def maybe_add_global_constraint(
        self,
        submap_id: SubmapId,
        submap: Submap3D,
        node_id: NodeId,
        constant_data: TrajectoryNodeData,
        gravity_yaw: float,
    ) -> None:
        self._enqueue(
            _PendingSearch3D(submap_id, node_id, constant_data, None, gravity_yaw), submap
        )

    def notify_end_of_node(self) -> None:
        pass

    def num_pending(self) -> int:
        return len(self._pending)

    def evict_submap(self, submap_id: SubmapId) -> None:
        """Forget a trimmed submap (queued searches against it are dropped
        at the next drain) and its matcher and native pyramid."""
        for cache in (self._submaps, self._matchers, self._native_submaps, self._native_meta):
            cache.pop(submap_id, None)

    def evict_node(self, node_id: NodeId) -> None:
        """Forget a trimmed node's staged clouds."""
        self._node_clouds.pop(node_id, None)
        self._native_node_clouds.pop(node_id, None)

    def run_pending(self) -> List[Constraint]:
        """Execute queued searches; returns found constraints (WhenDone).
        With the native backend the drain runs in chunks, each chunk's
        refinement launched on the device before the next chunk's search."""
        with self._pending_lock:
            pending, self._pending = self._pending, []
        # Drop searches whose submap was trimmed while queued.
        stale = [s for s in pending if s.submap_id not in self._submaps]
        if stale:
            logging.getLogger(__name__).info(
                "Dropping %d queued constraint searches against trimmed "
                "submaps.", len(stale),
            )
            pending = [s for s in pending if s.submap_id in self._submaps]
        self.last_drain_searches = pending
        if not pending:
            self.last_drain_timings = {}
            return []
        t0 = _time.perf_counter()
        use_native = self._use_native_backend()
        chunk_size = self._DRAIN_CHUNK if use_native else len(pending)
        t_search = t_refine_wait = 0.0
        staged = []  # (jobs, dispatched refinement groups)
        num_matches = 0
        for c0 in range(0, len(pending), chunk_size):
            chunk = pending[c0: c0 + chunk_size]
            ts = _time.perf_counter()
            if use_native:
                matched = self._run_searches_native(chunk)
            else:
                matched = self._run_searches_device(chunk)
            t_search += _time.perf_counter() - ts
            jobs = []
            for search, result in matched:
                if result is None:
                    continue
                self._score_histogram.add(result.score)
                self._rotational_score_histogram.add(result.rotational_score)
                self._low_resolution_score_histogram.add(result.low_resolution_score)
                metrics.constraint_scores.observe(result.score)
                jobs.append((search, result))
            num_matches += len(jobs)
            staged.append((jobs, self._batch_refine_dispatch(jobs) if jobs else ([], [])))
        results: List[Constraint] = []
        for jobs, groups in staged:
            tw = _time.perf_counter()
            rows_all = self._batch_refine_collect(groups)
            t_refine_wait += _time.perf_counter() - tw
            for (search, _), row in zip(jobs, rows_all):
                refined_pose, _cost = self._ceres_matcher.decode(row)
                results.append(self._constraint(search, refined_pose))
        metrics.constraints_found.increment(len(results))
        self.last_drain_timings = {
            "searches": len(pending),
            "matches": num_matches,
            "search_s": t_search,
            "refine_wait_s": t_refine_wait,
            "total_s": _time.perf_counter() - t0,
        }
        return results

    def _constraint(self, search: _PendingSearch3D, refined_pose) -> Constraint:
        return Constraint(
            submap_id=search.submap_id,
            node_id=search.node_id,
            pose=ConstraintPose(
                zbar_ij=refined_pose,
                translation_weight=self._options.loop_closure_translation_weight,
                rotation_weight=self._options.loop_closure_rotation_weight,
            ),
            tag=INTER_SUBMAP,
        )

    def _batch_refine_dispatch(self, jobs):
        """Launch the refinement of every accepted match as one
        match_3d_batch per grid-shape family (finished 3D submaps are
        cropped to content, so shapes differ). Returns (rows_all, staged):
        rows_all holds the rows refined one by one (paged grids), staged
        the launched (indices, device rows) groups for
        _batch_refine_collect. Each group stacks its unique submap grids
        once; lanes read them by index."""
        opts = self._options.ceres_scan_matcher_3d
        dev = self._device
        rows_all = [None] * len(jobs)
        groups: Dict[tuple, list] = {}
        for j, (search, result) in enumerate(jobs):
            submap = self._submaps[search.submap_id]
            hg = submap.high_resolution_grid
            lg = submap.low_resolution_grid
            if isinstance(hg, PagedGrid3D) or isinstance(lg, PagedGrid3D):
                cd = search.constant_data
                rows_all[j] = self._ceres_matcher.match_device(
                    result.pose[:3], result.pose,
                    cd.high_resolution_point_cloud, hg,
                    cd.low_resolution_point_cloud, lg,
                )
                continue
            key = (tuple(hg.values.shape), tuple(lg.values.shape))
            groups.setdefault(key, []).append(j)
        staged = []
        for idxs in groups.values():
            k = len(idxs)
            uniq: Dict[int, int] = {}  # id(high grid) -> volume index
            highs, lows, origins = [], [], []
            small = np.zeros((k, 18), np.float32)  # origins 6, res 2, t0 3, q0 4, target 3
            vidx = np.zeros(k, np.int64)
            n_pad = nl_pad = 64
            for j in idxs:
                cd = jobs[j][0].constant_data
                while n_pad < len(cd.high_resolution_point_cloud):
                    n_pad *= 2
                while nl_pad < len(cd.low_resolution_point_cloud):
                    nl_pad *= 2
            hp = np.zeros((k, n_pad, 3), np.float32)
            hm = np.zeros((k, n_pad), bool)
            lp = np.zeros((k, nl_pad, 3), np.float32)
            lm = np.zeros((k, nl_pad), bool)
            for r, j in enumerate(idxs):
                search, result = jobs[j]
                submap = self._submaps[search.submap_id]
                hg, lg = submap.high_resolution_grid, submap.low_resolution_grid
                gi = uniq.get(id(hg))
                if gi is None:
                    gi = uniq[id(hg)] = len(highs)
                    highs.append(hg.values)
                    lows.append(lg.values)
                    origins.append(np.concatenate(
                        [hg.origin.cpu().numpy(), lg.origin.cpu().numpy()]
                    ))
                vidx[r] = gi
                small[r, 0:6] = origins[gi]
                small[r, 6:8] = (hg.resolution, lg.resolution)
                small[r, 8:11] = result.pose[:3]
                small[r, 11:15] = result.pose[3:7]
                small[r, 15:18] = result.pose[:3]
                cd = search.constant_data
                hp[r], hm[r] = pad_points_3d(np.asarray(cd.high_resolution_point_cloud), n_pad)
                lp[r], lm[r] = pad_points_3d(np.asarray(cd.low_resolution_point_cloud), nl_pad)
            t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            s = t(small)
            handle = gauss_newton_3d.match_3d_batch(
                torch.stack(highs), s[:, 0:3], torch.stack(lows), s[:, 3:6],
                s[:, 8:11], s[:, 11:15], s[:, 15:18],
                t(hp), t(hm), t(lp), t(lm), s[:, 6], s[:, 7],
                opts.occupied_space_weight_0,
                opts.occupied_space_weight_1,
                opts.translation_weight,
                opts.rotation_weight,
                opts.ceres_solver_options.max_num_iterations,
                opts.only_optimize_yaw,
                bool(opts.ceres_solver_options.use_nonmonotonic_steps),
                volume_index=t(vidx),
            )
            staged.append((idxs, handle))
        return rows_all, staged

    @staticmethod
    def _batch_refine_collect(groups):
        rows_all, staged = groups
        rows_all = [r if r is None else r.cpu().numpy() for r in rows_all]
        for idxs, handle in staged:
            rows = handle.cpu().numpy()
            for r, j in enumerate(idxs):
                rows_all[j] = rows[r]
        return rows_all

    def _staged_cloud(self, search: _PendingSearch3D):
        staged = self._node_clouds.get(search.node_id)
        if staged is None:
            cd = search.constant_data
            staged = FastCorrelativeScanMatcher3D.stage_points(
                cd.high_resolution_point_cloud, cd.low_resolution_point_cloud
            )
            self._node_clouds[search.node_id] = staged
        return staged

    def _run_searches_device(self, pending):
        """All BnB searches of the chunk on the device, batched over lanes.
        Returns [(search, MatchResult3D | None)]."""
        preps, kept = [], []
        for search in pending:
            metrics.constraints_searched.increment()
            matcher = self._matcher(search.submap_id)
            cd = search.constant_data
            if search.global_node_pose is None:
                initial = rigid3.make(np.zeros(3), rigid3.quat_conjugate(cd.gravity_alignment))
                min_score = self._options.global_localization_min_score
            else:
                initial = search.global_node_pose
                min_score = self._options.min_score
            prep = matcher._prepare(
                initial,
                cd.rotational_scan_matcher_histogram,
                search.gravity_yaw,
                cd.high_resolution_point_cloud,
                cd.low_resolution_point_cloud,
                min_score,
                full_submap=search.global_node_pose is None,
                device_points=self._staged_cloud(search),
            )
            if prep is not None:  # None: yaw pruning rejected every candidate
                preps.append(prep)
                kept.append(search)
        if not preps:
            return [(s, None) for s in pending]
        packed, ctxs = batch_match_device_3d(preps, mesh=self._mesh)
        decoded = {
            id(search): self._matcher(search.submap_id).decode(row, ctx)
            for search, row, ctx in zip(kept, packed, ctxs)
        }
        return [(s, decoded.get(id(s))) for s in pending]

    def _use_native_backend(self) -> bool:
        return self._options.loop_closure_backend in ("native", "auto")

    def _native_submap(self, sid: SubmapId):
        from cartographer_tpu_torch.native import bnb3 as native_bnb3

        ns = self._native_submaps.get(sid)
        if ns is None:
            opts = self._options.fast_correlative_scan_matcher_3d
            submap = self._submaps[sid]
            hg = submap.high_resolution_grid
            lg = submap.low_resolution_grid
            # One host fetch per finished submap (it no longer changes);
            # the C++ side quantizes and builds the pyramid.
            ns = native_bnb3.NativeSubmap3D(
                hg.probability().cpu().numpy(),
                lg.probability().cpu().numpy(),
                opts.branch_and_bound_depth,
                opts.full_resolution_depth,
            )
            self._native_submaps[sid] = ns
            self._native_meta[sid] = (
                hg.origin.cpu().numpy().astype(np.float64),
                float(hg.resolution),
                lg.origin.cpu().numpy().astype(np.float64),
                float(lg.resolution),
                np.asarray(submap.rotational_scan_matcher_histogram),
            )
        return ns, self._native_meta[sid]

    def _native_cloud(self, search: _PendingSearch3D):
        cached = self._native_node_clouds.get(search.node_id)
        if cached is None:
            # Stable per-node arrays (the native layer deduplicates the
            # flat upload by array identity) and the node's max range.
            cd = search.constant_data
            hc = np.ascontiguousarray(cd.high_resolution_point_cloud[:, :3], np.float32)
            cached = (
                hc,
                np.ascontiguousarray(cd.low_resolution_point_cloud[:, :3], np.float32),
                float(np.max(np.linalg.norm(hc, axis=1), initial=0.0)),
            )
            self._native_node_clouds[search.node_id] = cached
        return cached

    def _run_searches_native(self, pending):
        """Threaded C++ searches across host cores (csrc/bnb3d_native.cc).
        Yaw candidates are pre-pruned here with the rotational histogram,
        as the device path's _prepare does. Returns [(search,
        MatchResult3D | None)]."""
        from cartographer_tpu_torch.native import bnb3 as native_bnb3

        opts = self._options.fast_correlative_scan_matcher_3d
        submaps, highs, lows, angle_lists = [], [], [], []
        ctxs = []  # (angles_kept, rot_scores_kept, initial_pose, res) or None
        rows = []  # index into the native batch, or None (yaw-pruned out)
        params = np.zeros((len(pending), 19), np.float32)
        for search in pending:
            metrics.constraints_searched.increment()
            ns, (origin, res, lorigin, lres, sub_hist) = self._native_submap(search.submap_id)
            cloud, low_cloud, cloud_max_range = self._native_cloud(search)
            cd = search.constant_data
            shape = ns.shape
            if search.global_node_pose is None:
                initial = rigid3.make(np.zeros(3), rigid3.quat_conjugate(cd.gravity_alignment))
                linear_xy = 0.5 * shape[2] * res
                linear_z = 0.5 * shape[0] * res
                angular = math.pi
                min_score = self._options.global_localization_min_score
            else:
                initial = np.asarray(search.global_node_pose, np.float64)
                linear_xy = opts.linear_xy_search_window
                linear_z = opts.linear_z_search_window
                angular = opts.angular_search_window
                min_score = self._options.min_score
            max_range = max(cloud_max_range, 3.0 * res)
            step = compute_angular_step(res, max_range)
            num_angular = int(math.ceil(angular / step))
            angles = (np.arange(2 * num_angular + 1) - num_angular) * step
            rot_scores = rotational_histogram.match_angles(
                sub_hist, np.asarray(cd.rotational_scan_matcher_histogram),
                search.gravity_yaw, angles,
            )
            keep = rot_scores >= opts.min_rotational_score
            if not keep.any():
                rows.append(None)
                ctxs.append(None)
                continue
            angles_kept = angles[keep].astype(np.float32)
            nl_xy = min(int(math.ceil(linear_xy / res)), max(shape) + 1)
            nl_z = min(int(math.ceil(linear_z / res)), max(shape) + 1)
            r = len(submaps)
            rows.append(r)
            ctxs.append((angles_kept, rot_scores[keep], initial, res))
            submaps.append(ns)
            highs.append(cloud)
            lows.append(low_cloud)
            angle_lists.append(angles_kept)
            params[r] = (
                *rigid3.quat(initial), *initial[:3], *origin, res, *lorigin, lres,
                nl_xy, nl_z, min_score, opts.min_low_resolution_score,
            )
        if not submaps:
            return [(s, None) for s in pending]
        out_rows, found = native_bnb3.match_batch(
            submaps, highs, lows, angle_lists, params[: len(submaps)]
        )
        matched = []
        for search, row, ctx in zip(pending, rows, ctxs):
            if row is None or not found[row]:
                matched.append((search, None))
                continue
            angles_kept, rot_kept, initial, res = ctx
            ba = int(out_rows[row, 2])
            half = 0.5 * float(angles_kept[ba])
            qa = np.array([np.cos(half), 0.0, 0.0, np.sin(half)])
            q = rigid3.quat_normalize(rigid3.quat_multiply(qa, rigid3.quat(initial)))
            t = initial[:3] + out_rows[row, 3:6].astype(np.float64) * res
            matched.append((
                search,
                MatchResult3D(
                    score=float(out_rows[row, 0]),
                    low_resolution_score=float(out_rows[row, 1]),
                    rotational_score=float(rot_kept[ba]),
                    pose=rigid3.make(t, q),
                ),
            ))
        return matched

    def _compute_constraint(self, search: _PendingSearch3D) -> Optional[Constraint]:
        """One search and its refinement, synchronously (the reference's
        per-pair ComputeConstraint)."""
        metrics.constraints_searched.increment()
        matcher = self._matcher(search.submap_id)
        submap = self._submaps[search.submap_id]
        cd = search.constant_data
        if search.global_node_pose is None:
            # Global localization: search the full submap; center the initial
            # estimate on the submap with gravity-consistent orientation.
            initial = rigid3.make(np.zeros(3), rigid3.quat_conjugate(cd.gravity_alignment))
            result = matcher.match(
                initial, cd.rotational_scan_matcher_histogram, search.gravity_yaw,
                cd.high_resolution_point_cloud, cd.low_resolution_point_cloud,
                self._options.global_localization_min_score, full_submap=True,
            )
        else:
            result = matcher.match(
                search.global_node_pose, cd.rotational_scan_matcher_histogram,
                search.gravity_yaw, cd.high_resolution_point_cloud,
                cd.low_resolution_point_cloud, self._options.min_score,
            )
        if result is None:
            return None
        self._score_histogram.add(result.score)
        self._rotational_score_histogram.add(result.rotational_score)
        self._low_resolution_score_histogram.add(result.low_resolution_score)
        metrics.constraint_scores.observe(result.score)
        refined_pose, _ = self._ceres_matcher.match(
            result.pose[:3], result.pose,
            cd.high_resolution_point_cloud, submap.high_resolution_grid,
            cd.low_resolution_point_cloud, submap.low_resolution_grid,
        )
        return self._constraint(search, refined_pose)

    def score_histogram(self) -> Histogram:
        return self._score_histogram
