"""Pose-graph trimmers (reference: mapping/pose_graph_trimmer.h:56-81).

Copy of cartographer_tpu/mapping/trimmers.py.

PureLocalizationTrimmer keeps only the last N submaps of a trajectory —
localization mode against a frozen map (pose_graph_trimmer.cc).
"""

from __future__ import annotations


class PoseGraphTrimmer:
    def trim(self, trimmable) -> None:
        raise NotImplementedError

    def is_finished(self) -> bool:
        raise NotImplementedError


class OverlappingSubmapsTrimmer2D(PoseGraphTrimmer):
    """Coverage-based sparsification (reference:
    internal/2d/overlapping_submaps_trimmer_2d.cc): a finished submap is
    trimmed once its cells are covered by at least `fresh_submaps_count`
    newer submaps except for less than `min_covered_area` m^2, after at
    least `min_added_submaps_count` new submaps were added."""

    def __init__(
        self,
        fresh_submaps_count: int,
        min_covered_area: float,
        min_added_submaps_count: int,
    ):
        self._fresh_submaps_count = fresh_submaps_count
        self._min_covered_area = min_covered_area
        self._min_added_submaps_count = min_added_submaps_count
        self._current_submap_count = 0

    def trim(self, trimmable) -> None:
        """Coverage accounting is fully vectorized: one (cell, submap)
        row table across all finished submaps, np.unique for the global
        cell ids, and a lexsort ranking per cell to find each cell's
        `fresh_submaps_count` freshest covers — O(rows log rows) numpy
        instead of a Python dict over every cell (the reference builds a
        per-cell id list the same way, overlapping_submaps_trimmer_2d.cc
        GenerateGlobalCoverageGrid2D). Works through the Trimmable
        surface (get_optimized_submap_data / trim_submap) only."""
        import numpy as np

        from cartographer_tpu_torch.mapping.grid_2d import compute_cropped
        from cartographer_tpu_torch.transform import rigid2

        submap_data = trimmable.get_optimized_submap_data()
        if (
            len(submap_data) - self._current_submap_count
            < self._min_added_submaps_count
        ):
            return
        self._current_submap_count = len(submap_data)

        # Row table: one (global cell x, y, submap rank) row per known
        # cell of every finished submap. Rank = position in ascending
        # submap-id order (fresher submaps have higher ranks).
        submap_data.sort(key=lambda t: t[0])
        all_ids = [sid for sid, _, _ in submap_data]
        cx_all, cy_all, rank_all = [], [], []
        resolution = None
        for rank, (sid, submap, global_pose) in enumerate(submap_data):
            cropped = compute_cropped(submap.grid)
            if cropped.probability.size == 0:
                continue
            resolution = cropped.resolution
            to_global = rigid2.compose(
                np.asarray(global_pose),
                rigid2.inverse(np.asarray(submap.local_pose)),
            )
            ys, xs = np.nonzero(cropped.known)
            pts = (
                np.stack([xs + 0.5, ys + 0.5], axis=1) * cropped.resolution
                + cropped.origin
            )
            pts = rigid2.apply(to_global, pts)
            cells = np.floor(pts / cropped.resolution).astype(np.int64)
            cx_all.append(cells[:, 0])
            cy_all.append(cells[:, 1])
            rank_all.append(np.full(len(cells), rank, np.int64))
        if resolution is None:
            return
        cx = np.concatenate(cx_all)
        cy = np.concatenate(cy_all)
        rank = np.concatenate(rank_all)

        # Unique global cell ids, then dedup (cell, submap) pairs (a
        # submap's cells can alias under the global discretization).
        _, cell_idx = np.unique(
            np.stack([cx, cy], axis=1), axis=0, return_inverse=True
        )
        pair = cell_idx * len(all_ids) + rank
        pair = np.unique(pair)
        cell_idx = pair // len(all_ids)
        rank = pair % len(all_ids)

        # Within each cell, rows sorted by descending rank: position
        # 0..K-1 = the K freshest covers of that cell.
        order = np.lexsort((-rank, cell_idx))
        cell_sorted = cell_idx[order]
        rank_sorted = rank[order]
        group_start = np.zeros(len(cell_sorted), np.int64)
        new_group = np.empty(len(cell_sorted), bool)
        if len(cell_sorted):
            new_group[0] = True
            new_group[1:] = cell_sorted[1:] != cell_sorted[:-1]
            group_start = np.maximum.accumulate(
                np.where(new_group, np.arange(len(cell_sorted)), 0)
            )
        pos_in_cell = np.arange(len(cell_sorted)) - group_start
        fresh_rows = pos_in_cell < self._fresh_submaps_count
        fresh_cells = np.bincount(
            rank_sorted[fresh_rows], minlength=len(all_ids)
        )

        cell_area = resolution * resolution
        for i, sid in enumerate(all_ids):
            if fresh_cells[i] * cell_area < self._min_covered_area:
                trimmable.trim_submap(sid)

    def is_finished(self) -> bool:
        return False


class PureLocalizationTrimmer(PoseGraphTrimmer):
    def __init__(self, trajectory_id: int, max_submaps_to_keep: int):
        assert max_submaps_to_keep >= 2
        self._trajectory_id = trajectory_id
        self._max_submaps_to_keep = max_submaps_to_keep
        self._finished = False

    def trim(self, trimmable) -> None:
        if self._finished:
            return
        submap_ids = trimmable.get_submap_ids(self._trajectory_id)
        for submap_id in submap_ids[: max(0, len(submap_ids) - self._max_submaps_to_keep)]:
            trimmable.trim_submap(submap_id)

    def is_finished(self) -> bool:
        return self._finished
