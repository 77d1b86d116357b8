"""Rotational scan matcher histograms (host C++, with a numpy oracle).

Copy of cartographer_tpu/ops/scan_matching/rotational_histogram.py: the
histogram comes from the C++ helper of csrc/native.cc (native/), with the
numpy walk kept as its parity oracle. Reference:
internal/3d/scan_matching/rotational_scan_matcher.cc:31-193. A scan's
structure is summarized by a histogram over [0, pi) of the angles between
consecutive points within 0.2 m z-slices (sorted around the slice
centroid), weighted by orthogonality to the centroid direction; candidate
yaws are pruned by the normalized dot product of rotated histograms.

The histogram is computed per inserted node on the host (irregular
slicing and sorting, tiny data).
"""

from __future__ import annotations

import numpy as np

MIN_DISTANCE = 0.2
MAX_DISTANCE = 0.9
SLICE_HEIGHT = 0.2


def _add_slice(points: np.ndarray, histogram: np.ndarray) -> None:
    if len(points) == 0:
        return
    centroid = points.mean(axis=0)
    delta_c = points[:, :2] - centroid[:2]
    norms = np.linalg.norm(delta_c, axis=1)
    keep = norms >= MIN_DISTANCE
    points = points[keep]
    if len(points) < 2:
        return
    angles_c = np.arctan2(points[:, 1] - centroid[1], points[:, 0] - centroid[0])
    order = np.argsort(angles_c, kind="stable")
    pts = points[order]

    n = len(histogram)
    last = pts[0]
    for point in pts:
        delta = point[:2] - last[:2]
        direction = point[:2] - centroid[:2]
        distance = np.linalg.norm(delta)
        if distance < MIN_DISTANCE or np.linalg.norm(direction) < MIN_DISTANCE:
            continue
        if distance > MAX_DISTANCE:
            last = point
            continue
        angle = np.arctan2(delta[1], delta[0])
        value = max(
            0.0,
            1.0
            - abs(
                np.dot(
                    delta / max(distance, 1e-12),
                    direction / max(np.linalg.norm(direction), 1e-12),
                )
            ),
        )
        angle = angle % np.pi
        bucket = int(np.clip(round(n * angle / np.pi - 0.5), 0, n - 1))
        histogram[bucket] += value
        last = point


def compute_histogram(points: np.ndarray, histogram_size: int) -> np.ndarray:
    """points (N, 3) in the gravity-aligned frame. Native C++ (csrc/
    native.cc: ~100x over the Python point walk; this runs once per
    inserted 3D node on the host); a failed build raises."""
    from cartographer_tpu_torch import native

    return native.rotational_histogram(np.asarray(points), histogram_size)


def compute_histogram_numpy(
    points: np.ndarray, histogram_size: int
) -> np.ndarray:
    """The JAX package's numpy implementation (the C++ helper's oracle)."""
    histogram = np.zeros(histogram_size, np.float32)
    if len(points) == 0:
        return histogram
    slice_idx = np.round(points[:, 2] / SLICE_HEIGHT).astype(int)
    for s in np.unique(slice_idx):
        _add_slice(points[slice_idx == s], histogram)
    return histogram


def rotate_histogram(histogram: np.ndarray, angle: float) -> np.ndarray:
    """Circular shift by a fractional number of buckets (RotateHistogram)."""
    n = len(histogram)
    if n == 0:
        return histogram
    rotate_by_buckets = -angle * n / np.pi
    full = int(np.floor(rotate_by_buckets + 0.5 - 0.5))  # RoundToInt(x - 0.5)
    fraction = rotate_by_buckets - full
    idx0 = (np.arange(n) + full) % n
    idx1 = (np.arange(n) + 1 + full) % n
    return (1.0 - fraction) * histogram[idx0] + fraction * histogram[idx1]


def match_histograms(submap_histogram: np.ndarray, scan_histogram: np.ndarray) -> float:
    normalization = np.linalg.norm(scan_histogram) * np.linalg.norm(submap_histogram)
    if normalization < 1e-3:
        return 1.0
    return float(np.dot(submap_histogram, scan_histogram) / normalization)


def match_angles(
    submap_histogram: np.ndarray,
    scan_histogram: np.ndarray,
    initial_angle: float,
    angles: np.ndarray,
) -> np.ndarray:
    """Batched RotationalScanMatcher::Match over candidate angles —
    vectorized over the whole angle axis (one fancy-gather instead of a
    Python rotate/dot per angle; identical numerics to rotate_histogram
    + match_histograms)."""
    n = len(scan_histogram)
    angles = np.asarray(angles, np.float64)
    if n == 0 or len(angles) == 0:
        return np.ones(len(angles), np.float32)
    rb = -(initial_angle + angles) * n / np.pi
    full = np.floor(rb + 0.5 - 0.5).astype(np.int64)  # RoundToInt(x - 0.5)
    fraction = (rb - full)[:, None]
    base = np.arange(n)
    idx0 = (base[None, :] + full[:, None]) % n
    rotated = (1.0 - fraction) * scan_histogram[idx0] + (
        fraction * scan_histogram[(idx0 + 1) % n]
    )
    normalization = np.linalg.norm(rotated, axis=1) * np.linalg.norm(
        submap_histogram
    )
    scores = np.where(
        normalization < 1e-3,
        1.0,
        rotated @ submap_histogram / np.maximum(normalization, 1e-12),
    )
    return scores.astype(np.float32)
