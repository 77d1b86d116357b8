"""Lossy point cloud compression for node storage.

Copy of cartographer_tpu/sensor/compression.py (numpy; no device code).

Reference: sensor/compressed_point_cloud.h:36 / .cc — points quantized onto a
1 mm grid (kPrecision=0.001), grouped into blocks of 2^10 cells per axis,
each point stored as 10-bit offsets from its block origin. Here the same
quantization is applied vectorized: store block ids + packed 10-bit offsets
as numpy int arrays. Decompression returns points at block*1024*1mm +
offset*1mm, i.e. identical loss characteristics to the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

PRECISION = 0.001  # meters
BITS_PER_COORDINATE = 10
BLOCK_SIZE = 1 << BITS_PER_COORDINATE  # cells per block per axis
MASK = BLOCK_SIZE - 1


@dataclasses.dataclass
class CompressedPointCloud:
    block_coords: np.ndarray  # (B, 3) int32: block origin in units of BLOCK_SIZE cells
    point_block: np.ndarray  # (N,) int32: block index per point
    packed_offsets: np.ndarray  # (N,) int32: 3x10-bit packed cell offsets
    num_points: int

    @staticmethod
    def compress(points: np.ndarray) -> "CompressedPointCloud":
        points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
        raster = np.round(points / PRECISION).astype(np.int64)
        block = raster >> BITS_PER_COORDINATE
        offset = (raster & MASK).astype(np.int32)
        # Unique blocks; stable order by first occurrence for determinism.
        if len(points) == 0:
            return CompressedPointCloud(
                np.zeros((0, 3), np.int32), np.zeros((0,), np.int32),
                np.zeros((0,), np.int32), 0)
        block_keys = (
            (block[:, 0].astype(np.int64) << 42)
            ^ (block[:, 1].astype(np.int64) << 21)
            ^ block[:, 2].astype(np.int64)
        )
        uniq, inverse = np.unique(block_keys, return_inverse=True)
        first_idx = np.full(len(uniq), len(points), dtype=np.int64)
        np.minimum.at(first_idx, inverse, np.arange(len(points)))
        block_coords = block[first_idx].astype(np.int32)
        packed = (
            offset[:, 0]
            | (offset[:, 1] << BITS_PER_COORDINATE)
            | (offset[:, 2] << (2 * BITS_PER_COORDINATE))
        ).astype(np.int32)
        return CompressedPointCloud(
            block_coords=block_coords,
            point_block=inverse.astype(np.int32),
            packed_offsets=packed,
            num_points=len(points),
        )

    def decompress(self) -> np.ndarray:
        if self.num_points == 0:
            return np.zeros((0, 3), dtype=np.float32)
        packed = self.packed_offsets.astype(np.int64)
        offsets = np.stack(
            [
                packed & MASK,
                (packed >> BITS_PER_COORDINATE) & MASK,
                (packed >> (2 * BITS_PER_COORDINATE)) & MASK,
            ],
            axis=1,
        )
        blocks = self.block_coords[self.point_block].astype(np.int64)
        raster = (blocks << BITS_PER_COORDINATE) + offsets
        return (raster * PRECISION).astype(np.float32)
