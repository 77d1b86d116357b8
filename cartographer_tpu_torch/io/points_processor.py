"""Offline points-processing pipeline (chain of responsibility).

Copy of cartographer_tpu/io/points_processor.py (numpy; no device code).

Reference: io/points_processor.h, points_processor_pipeline_builder.cc:80-105
— 14 registered stages over PointsBatch plus the Null terminator: counting,
fixed-ratio sampling, frame-id filter, min/max range filter, vertical range
filter, outlier removal (3-phase voxel visibility vote,
outlier_removing_points_processor.cc), coloring, intensity-to-color,
PCD/PLY/XYZ writers, hybrid-grid writer, X-ray renderer, probability-grid
renderer. Batches flow host-side (numpy); the pipeline is I/O-bound
post-processing, not the TPU hot path.
"""

from __future__ import annotations

import dataclasses
import enum
import struct
from typing import Dict, List, Optional

import numpy as np

from cartographer_tpu_torch.common.fixed_ratio_sampler import FixedRatioSampler
from cartographer_tpu_torch.mapping import probability_values as pv


@dataclasses.dataclass
class PointsBatch:
    """io/points_batch.h: one delivery of points in the map frame."""

    time: float
    origin: np.ndarray  # (3,)
    frame_id: str
    points: np.ndarray  # (N, 3) float32
    intensities: Optional[np.ndarray] = None  # (N,)
    colors: Optional[np.ndarray] = None  # (N, 3) float32 in [0, 1]
    trajectory_index: int = 0

    def select(self, mask: np.ndarray) -> "PointsBatch":
        return PointsBatch(
            time=self.time,
            origin=self.origin,
            frame_id=self.frame_id,
            points=self.points[mask],
            intensities=None if self.intensities is None else self.intensities[mask],
            colors=None if self.colors is None else self.colors[mask],
            trajectory_index=self.trajectory_index,
        )


class FlushResult(enum.Enum):
    FINISHED = 0
    RESTART_STREAM = 1


class PointsProcessor:
    def process(self, batch: PointsBatch) -> None:
        raise NotImplementedError

    def flush(self) -> FlushResult:
        raise NotImplementedError


class NullPointsProcessor(PointsProcessor):
    def process(self, batch: PointsBatch) -> None:
        pass

    def flush(self) -> FlushResult:
        return FlushResult.FINISHED


class CountingPointsProcessor(PointsProcessor):
    ACTION = "dump_num_points"

    def __init__(self, next_processor: PointsProcessor):
        self._next = next_processor
        self.num_points = 0

    def process(self, batch: PointsBatch) -> None:
        self.num_points += len(batch.points)
        self._next.process(batch)

    def flush(self) -> FlushResult:
        return self._next.flush()


class FixedRatioSamplingPointsProcessor(PointsProcessor):
    ACTION = "fixed_ratio_sampler"

    def __init__(self, sampling_ratio: float, next_processor: PointsProcessor):
        self._sampler = FixedRatioSampler(sampling_ratio)
        self._next = next_processor

    def process(self, batch: PointsBatch) -> None:
        mask = np.array([self._sampler.pulse() for _ in range(len(batch.points))])
        self._next.process(batch.select(mask))

    def flush(self) -> FlushResult:
        return self._next.flush()


class FrameIdFilteringPointsProcessor(PointsProcessor):
    ACTION = "frame_id_filter"

    def __init__(self, keep_frames, drop_frames, next_processor: PointsProcessor):
        self._keep = set(keep_frames or [])
        self._drop = set(drop_frames or [])
        self._next = next_processor

    def process(self, batch: PointsBatch) -> None:
        if (self._keep and batch.frame_id not in self._keep) or (
            batch.frame_id in self._drop
        ):
            return
        self._next.process(batch)

    def flush(self) -> FlushResult:
        return self._next.flush()


class MinMaxRangeFilteringPointsProcessor(PointsProcessor):
    ACTION = "min_max_range_filter"

    def __init__(self, min_range: float, max_range: float, next_processor):
        self._min, self._max = min_range, max_range
        self._next = next_processor

    def process(self, batch: PointsBatch) -> None:
        ranges = np.linalg.norm(batch.points - batch.origin[None, :], axis=1)
        self._next.process(batch.select((ranges >= self._min) & (ranges <= self._max)))

    def flush(self) -> FlushResult:
        return self._next.flush()


class VerticalRangeFilteringPointsProcessor(PointsProcessor):
    ACTION = "vertical_range_filter"

    def __init__(self, min_z: float, max_z: float, next_processor):
        self._min, self._max = min_z, max_z
        self._next = next_processor

    def process(self, batch: PointsBatch) -> None:
        z = batch.points[:, 2]
        self._next.process(batch.select((z >= self._min) & (z <= self._max)))

    def flush(self) -> FlushResult:
        return self._next.flush()


class OutlierRemovingPointsProcessor(PointsProcessor):
    """3-phase voxel visibility vote (outlier_removing_points_processor.cc):
    pass 1 marks voxels containing hits, pass 2 counts rays passing through
    hit voxels, pass 3 outputs hits whose voxel has rays <= miss_per_hit_limit
    * hits. Needs two stream restarts, driven by flush()."""

    ACTION = "voxel_filter_and_remove_moving_objects"

    def __init__(self, voxel_size: float, next_processor, miss_per_hit_limit: float = 3.0):
        self._voxel_size = voxel_size
        self._limit = miss_per_hit_limit
        self._next = next_processor
        self._phase = 0
        self._voxels: Dict[tuple, List[int]] = {}

    def _key(self, pts):
        return np.round(pts / self._voxel_size).astype(np.int64)

    def process(self, batch: PointsBatch) -> None:
        if self._phase == 0:
            for k in map(tuple, self._key(batch.points)):
                self._voxels.setdefault(k, [0, 0])[0] += 1
        elif self._phase == 1:
            for point in batch.points:
                delta = point - batch.origin
                num = int(np.ceil(np.max(np.abs(delta)) / self._voxel_size)) + 1
                ts = np.linspace(0.0, 1.0, max(num, 2), endpoint=False)[1:]
                cells = self._key(batch.origin[None, :] + ts[:, None] * delta[None, :])
                seen = set()
                for k in map(tuple, cells):
                    if k in seen:
                        continue
                    seen.add(k)
                    if k in self._voxels:
                        self._voxels[k][1] += 1
        else:
            keys = self._key(batch.points)
            mask = np.array(
                [
                    self._voxels.get(tuple(k), [0, 0])[1]
                    <= self._limit * max(self._voxels.get(tuple(k), [1, 0])[0], 1)
                    for k in keys
                ]
            )
            self._next.process(batch.select(mask))

    def flush(self) -> FlushResult:
        if self._phase < 2:
            self._phase += 1
            return FlushResult.RESTART_STREAM
        return self._next.flush()


class ColoringPointsProcessor(PointsProcessor):
    ACTION = "color_points"

    def __init__(self, color, frame_id: str, next_processor):
        self._color = np.asarray(color, np.float32)
        self._frame_id = frame_id
        self._next = next_processor

    def process(self, batch: PointsBatch) -> None:
        if batch.frame_id == self._frame_id:
            batch.colors = np.tile(self._color, (len(batch.points), 1))
        self._next.process(batch)

    def flush(self) -> FlushResult:
        return self._next.flush()


class IntensityToColorPointsProcessor(PointsProcessor):
    ACTION = "intensity_to_color"

    def __init__(self, min_intensity: float, max_intensity: float, frame_id, next_processor):
        self._min, self._max = min_intensity, max_intensity
        self._frame_id = frame_id
        self._next = next_processor

    def process(self, batch: PointsBatch) -> None:
        if (
            batch.intensities is not None
            and (not self._frame_id or batch.frame_id == self._frame_id)
        ):
            gray = np.clip(
                (batch.intensities - self._min) / (self._max - self._min), 0.0, 1.0
            )
            batch.colors = np.stack([gray] * 3, axis=1).astype(np.float32)
        self._next.process(batch)

    def flush(self) -> FlushResult:
        return self._next.flush()


class XyzWriterPointsProcessor(PointsProcessor):
    ACTION = "write_xyz"

    def __init__(self, fileobj, next_processor):
        self._file = fileobj
        self._next = next_processor

    def process(self, batch: PointsBatch) -> None:
        for p in batch.points:
            self._file.write(f"{p[0]} {p[1]} {p[2]}\n".encode())
        self._next.process(batch)

    def flush(self) -> FlushResult:
        return self._next.flush()


class PlyWritingPointsProcessor(PointsProcessor):
    ACTION = "write_ply"

    def __init__(self, fileobj, next_processor):
        self._file = fileobj
        self._next = next_processor
        self._points: List[np.ndarray] = []
        self._colors: List[Optional[np.ndarray]] = []

    def process(self, batch: PointsBatch) -> None:
        self._points.append(batch.points.copy())
        self._colors.append(None if batch.colors is None else batch.colors.copy())
        self._next.process(batch)

    def flush(self) -> FlushResult:
        pts = np.concatenate(self._points) if self._points else np.zeros((0, 3))
        has_color = any(c is not None for c in self._colors)
        header = [
            "ply",
            "format binary_little_endian 1.0",
            f"element vertex {len(pts)}",
            "property float x",
            "property float y",
            "property float z",
        ]
        if has_color:
            header += [
                "property uchar red",
                "property uchar green",
                "property uchar blue",
            ]
        header.append("end_header")
        self._file.write(("\n".join(header) + "\n").encode())
        colors = []
        for p, c in zip(self._points, self._colors):
            colors.append(
                (np.clip(c, 0, 1) * 255).astype(np.uint8)
                if c is not None
                else np.full((len(p), 3), 255, np.uint8)
            )
        col = np.concatenate(colors) if colors else np.zeros((0, 3), np.uint8)
        for i in range(len(pts)):
            self._file.write(struct.pack("<fff", *pts[i]))
            if has_color:
                self._file.write(struct.pack("BBB", *col[i]))
        return self._next.flush()


class PcdWritingPointsProcessor(PointsProcessor):
    ACTION = "write_pcd"

    def __init__(self, fileobj, next_processor):
        self._file = fileobj
        self._next = next_processor
        self._points: List[np.ndarray] = []

    def process(self, batch: PointsBatch) -> None:
        self._points.append(batch.points.copy())
        self._next.process(batch)

    def flush(self) -> FlushResult:
        pts = np.concatenate(self._points) if self._points else np.zeros((0, 3))
        header = (
            "# .PCD v.7 - Point Cloud Data file format\n"
            "VERSION .7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
            f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {len(pts)}\nDATA binary\n"
        )
        self._file.write(header.encode())
        self._file.write(pts.astype("<f4").tobytes())
        return self._next.flush()


class XRayPointsProcessor(PointsProcessor):
    """X-ray (column-density) renderer onto a plane (io/xray_points_processor.cc)."""

    ACTION = "write_xray_image"

    def __init__(self, voxel_size: float, fileobj, next_processor, transform=None):
        self._voxel_size = voxel_size
        self._file = fileobj
        self._next = next_processor
        self._voxels: Dict[tuple, int] = {}

    def process(self, batch: PointsBatch) -> None:
        cells = np.round(batch.points / self._voxel_size).astype(np.int64)
        for k in map(tuple, cells):
            self._voxels[k] = self._voxels.get(k, 0) + 1
        self._next.process(batch)

    def flush(self) -> FlushResult:
        from PIL import Image

        if not self._voxels:
            return self._next.flush()
        keys = np.array(list(self._voxels.keys()))
        # Project along z: count distinct z voxels per (x, y) column.
        xy = keys[:, :2]
        x0, y0 = xy.min(axis=0)
        x1, y1 = xy.max(axis=0)
        img = np.zeros((y1 - y0 + 1, x1 - x0 + 1), np.float32)
        np.add.at(img, (xy[:, 1] - y0, xy[:, 0] - x0), 1.0)
        # Mimic the reference's saturation: intensity ~ 1 - e^{-count/k}.
        img = 1.0 - np.exp(-img / 4.0)
        image = Image.fromarray((255 * (1.0 - img)).astype(np.uint8))
        image.save(self._file, format="PNG")
        return self._next.flush()


class ProbabilityGridPointsProcessor(PointsProcessor):
    ACTION = "write_probability_grid"

    def __init__(self, resolution: float, fileobj, next_processor):
        self._resolution = resolution
        self._file = fileobj
        self._next = next_processor
        self._hits: Dict[tuple, float] = {}

    def process(self, batch: PointsBatch) -> None:
        cells = np.floor(batch.points[:, :2] / self._resolution).astype(np.int64)
        hit = pv.hit_update_log_odds(0.55)
        for k in map(tuple, cells):
            self._hits[k] = np.clip(
                self._hits.get(k, 0.0) + hit, pv.MIN_LOG_ODDS, pv.MAX_LOG_ODDS
            )
        self._next.process(batch)

    def flush(self) -> FlushResult:
        from PIL import Image

        if not self._hits:
            return self._next.flush()
        keys = np.array(list(self._hits.keys()))
        vals = np.array(list(self._hits.values()))
        x0, y0 = keys.min(axis=0)
        x1, y1 = keys.max(axis=0)
        img = np.zeros((y1 - y0 + 1, x1 - x0 + 1), np.float32)
        img[keys[:, 1] - y0, keys[:, 0] - x0] = 1.0 / (1.0 + np.exp(-vals))
        image = Image.fromarray((255 * (1.0 - img)).astype(np.uint8))
        image.save(self._file, format="PNG")
        return self._next.flush()


class HybridGridPointsProcessor(PointsProcessor):
    ACTION = "write_hybrid_grid"

    def __init__(self, resolution: float, fileobj, next_processor):
        self._resolution = resolution
        self._file = fileobj
        self._next = next_processor
        self._cells: Dict[tuple, int] = {}

    def process(self, batch: PointsBatch) -> None:
        cells = np.round(batch.points / self._resolution).astype(np.int64)
        for k in map(tuple, cells):
            self._cells[k] = self._cells.get(k, 0) + 1
        self._next.process(batch)

    def flush(self) -> FlushResult:
        keys = np.array(list(self._cells.keys())) if self._cells else np.zeros((0, 3), np.int64)
        counts = np.array(list(self._cells.values())) if self._cells else np.zeros((0,), np.int64)
        np.savez(self._file, resolution=self._resolution, cells=keys, counts=counts)
        return self._next.flush()


# -- pipeline builder (points_processor_pipeline_builder.cc) -----------------

def build_pipeline(configs: List[dict], file_writer_factory=None) -> List[PointsProcessor]:
    """configs: list of {'action': name, ...params} dicts, mirroring the Lua
    pipeline configuration. Returns the processor chain (first = entry)."""
    pipeline: List[PointsProcessor] = [NullPointsProcessor()]
    for config in reversed(configs):
        action = config["action"]
        next_processor = pipeline[-1]
        if action == CountingPointsProcessor.ACTION:
            p = CountingPointsProcessor(next_processor)
        elif action == FixedRatioSamplingPointsProcessor.ACTION:
            p = FixedRatioSamplingPointsProcessor(config["sampling_ratio"], next_processor)
        elif action == FrameIdFilteringPointsProcessor.ACTION:
            p = FrameIdFilteringPointsProcessor(
                config.get("keep_frames"), config.get("drop_frames"), next_processor
            )
        elif action == MinMaxRangeFilteringPointsProcessor.ACTION:
            p = MinMaxRangeFilteringPointsProcessor(
                config["min_range"], config["max_range"], next_processor
            )
        elif action == VerticalRangeFilteringPointsProcessor.ACTION:
            p = VerticalRangeFilteringPointsProcessor(
                config["min_z"], config["max_z"], next_processor
            )
        elif action == OutlierRemovingPointsProcessor.ACTION:
            p = OutlierRemovingPointsProcessor(
                config["voxel_size"],
                next_processor,
                config.get("miss_per_hit_limit", 3.0),
            )
        elif action == ColoringPointsProcessor.ACTION:
            p = ColoringPointsProcessor(
                config["color"], config["frame_id"], next_processor
            )
        elif action == IntensityToColorPointsProcessor.ACTION:
            p = IntensityToColorPointsProcessor(
                config["min_intensity"],
                config["max_intensity"],
                config.get("frame_id"),
                next_processor,
            )
        elif action == XyzWriterPointsProcessor.ACTION:
            p = XyzWriterPointsProcessor(
                file_writer_factory(config["filename"]), next_processor
            )
        elif action == PlyWritingPointsProcessor.ACTION:
            p = PlyWritingPointsProcessor(
                file_writer_factory(config["filename"]), next_processor
            )
        elif action == PcdWritingPointsProcessor.ACTION:
            p = PcdWritingPointsProcessor(
                file_writer_factory(config["filename"]), next_processor
            )
        elif action == XRayPointsProcessor.ACTION:
            p = XRayPointsProcessor(
                config["voxel_size"],
                file_writer_factory(config["filename"]),
                next_processor,
            )
        elif action == ProbabilityGridPointsProcessor.ACTION:
            p = ProbabilityGridPointsProcessor(
                config["resolution"],
                file_writer_factory(config["filename"]),
                next_processor,
            )
        elif action == HybridGridPointsProcessor.ACTION:
            p = HybridGridPointsProcessor(
                config["resolution"],
                file_writer_factory(config["filename"]),
                next_processor,
            )
        else:
            raise ValueError(f"unknown points processor action {action!r}")
        pipeline.append(p)
    return list(reversed(pipeline))


def run_pipeline(pipeline: List[PointsProcessor], batches_fn) -> None:
    """Drive batches through the pipeline honoring RESTART_STREAM (the
    outlier filter's multi-pass protocol, assets_writer-style)."""
    while True:
        for batch in batches_fn():
            pipeline[0].process(batch)
        if pipeline[0].flush() == FlushResult.FINISHED:
            return
