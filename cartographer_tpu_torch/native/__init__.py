"""Host-side C++ helpers built at first use and loaded with ctypes
(port of cartographer_tpu.native).

`csrc/native.cc` holds the host kernels of cartographer_tpu/native/
native.cc: the voxel filter, the rotational scan-matcher histogram, the
exact ray-to-pixel traversal and 2D cell accumulation. It is built by
kernels/_build.py with the host C++ compiler, like the native
loop-closure searches (native/bnb.py, native/bnb3.py). A failed build
raises with the compiler's output: there is no fallback to numpy (the
JAX package's loader returns None and its callers drop to numpy).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from cartographer_tpu_torch.kernels import _build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load("native")
            lib.voxel_filter_indices.argtypes = [
                _F32P, ctypes.c_int64, ctypes.c_float,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.voxel_filter_indices.restype = None
            lib.ray_to_pixel_mask.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, _I32P, ctypes.c_int64,
            ]
            lib.ray_to_pixel_mask.restype = ctypes.c_int64
            lib.accumulate_cells_2d.argtypes = [
                _F32P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, _I32P,
            ]
            lib.accumulate_cells_2d.restype = None
            lib.rotational_histogram.argtypes = [
                _F32P, ctypes.c_int64, ctypes.c_int32, _F32P,
            ]
            lib.rotational_histogram.restype = None
            _lib = lib
        return _lib


def voxel_filter_indices(points: np.ndarray, resolution: float) -> np.ndarray:
    """Boolean keep-mask, one point per voxel (first occurrence)."""
    points = np.ascontiguousarray(np.asarray(points)[:, :3], np.float32)
    n = len(points)
    if n == 0:
        return np.zeros(0, bool)
    out = np.zeros(n, np.uint8)
    _load().voxel_filter_indices(
        points.ctypes.data_as(_F32P), n, resolution,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.astype(bool)


def ray_to_pixel_mask(
    begin: np.ndarray, end: np.ndarray, subpixel_scale: int
) -> np.ndarray:
    """All pixels crossed by the segment (subpixel int coords), shape (K, 2)."""
    lib = _load()
    max_out = int(
        4
        + 2
        * (
            abs(int(end[0]) - int(begin[0])) // subpixel_scale
            + abs(int(end[1]) - int(begin[1])) // subpixel_scale
            + 2
        )
    )
    out = np.zeros((max_out, 2), np.int32)
    k = lib.ray_to_pixel_mask(
        int(begin[0]), int(begin[1]), int(end[0]), int(end[1]),
        subpixel_scale, out.ctypes.data_as(_I32P), max_out,
    )
    if k < 0:
        raise RuntimeError("ray_to_pixel_mask overflow")
    return out[:k]


def rotational_histogram(points: np.ndarray, histogram_size: int) -> np.ndarray:
    """Rotational scan-matcher histogram of a gravity-aligned (N, 3) cloud."""
    points = np.ascontiguousarray(np.asarray(points)[:, :3], np.float32)
    out = np.zeros(histogram_size, np.float32)
    _load().rotational_histogram(
        points.ctypes.data_as(_F32P), len(points), histogram_size,
        out.ctypes.data_as(_F32P),
    )
    return out


def accumulate_cells_2d(
    points_cells: np.ndarray, height: int, width: int
) -> np.ndarray:
    """Points per cell of an [height, width] grid; points (N, 2) in cell
    units, those outside the grid dropped."""
    points_cells = np.ascontiguousarray(np.asarray(points_cells)[:, :2], np.float32)
    grid = np.zeros((height, width), np.int32)
    if len(points_cells):
        _load().accumulate_cells_2d(
            points_cells.ctypes.data_as(_F32P), len(points_cells), height,
            width, grid.ctypes.data_as(_I32P),
        )
    return grid
