"""2D submap rendering (reference: io/submap_painter.cc — Cairo
alpha-composited submap slices; here numpy + PIL).

Copy of cartographer_tpu/io/submap_painter.py: it reads each grid
through the port's grid_2d.compute_cropped (one copy to the host) and
returns numpy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from cartographer_tpu_torch.mapping.grid_2d import compute_cropped
from cartographer_tpu_torch.transform import rigid2


def paint_submaps(
    submaps_with_poses: List[Tuple[object, np.ndarray]],
    resolution: float,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """submaps_with_poses: [(Submap2D, global_pose_2d)]. Returns (intensity
    [H, W] in [0,1], origin_xy) of the composited map, or None if empty.

    Compositing: each known cell contributes its probability with full
    alpha; overlapping submaps average (the reference uses Cairo OVER with
    per-cell alpha — averaging gives the same visual result for consistent
    maps)."""
    tiles = []
    for submap, global_pose in submaps_with_poses:
        cropped = compute_cropped(submap.grid)
        if cropped.probability.size == 0:
            continue
        tiles.append((cropped, np.asarray(global_pose), np.asarray(submap.local_pose)))
    if not tiles:
        return None

    # World-space bounding box over all submap corners.
    corners = []
    for cropped, global_pose, local_pose in tiles:
        h, w = cropped.probability.shape
        local_corners = (
            np.array([[0, 0], [w, 0], [0, h], [w, h]], np.float64)
            * cropped.resolution
            + cropped.origin
        )
        # local -> global: T_global * T_local^-1 applied to points.
        to_global = rigid2.compose(global_pose, rigid2.inverse(local_pose))
        corners.append(rigid2.apply(to_global, local_corners))
    corners = np.concatenate(corners)
    lo = corners.min(axis=0) - resolution
    hi = corners.max(axis=0) + resolution
    width = int(np.ceil((hi[0] - lo[0]) / resolution))
    height = int(np.ceil((hi[1] - lo[1]) / resolution))
    acc = np.zeros((height, width), np.float64)
    weight = np.zeros((height, width), np.float64)

    for cropped, global_pose, local_pose in tiles:
        h, w = cropped.probability.shape
        ys, xs = np.nonzero(cropped.known)
        if len(ys) == 0:
            continue
        pts_local = (
            np.stack([xs + 0.5, ys + 0.5], axis=1) * cropped.resolution
            + cropped.origin
        )
        to_global = rigid2.compose(global_pose, rigid2.inverse(local_pose))
        pts_global = rigid2.apply(to_global, pts_local)
        ix = ((pts_global[:, 0] - lo[0]) / resolution).astype(int)
        iy = ((pts_global[:, 1] - lo[1]) / resolution).astype(int)
        valid = (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
        np.add.at(acc, (iy[valid], ix[valid]), cropped.probability[ys, xs][valid])
        np.add.at(weight, (iy[valid], ix[valid]), 1.0)

    intensity = np.where(weight > 0, acc / np.maximum(weight, 1), 0.5)
    return intensity, lo


def save_png(intensity: np.ndarray, path) -> None:
    from PIL import Image

    img = (255 * (1.0 - intensity)).astype(np.uint8)
    Image.fromarray(img[::-1]).save(path, format="PNG")
