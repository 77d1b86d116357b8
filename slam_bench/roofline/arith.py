"""The card's peaks and the kernels' operations and bytes.

A frozen copy of `chip_smoke.py`'s arithmetic (HBM_BYTES_PER_S,
F32_OPS_PER_S, LM_OPS_PER_POINT, SCATTER_OPS_PER_STEP, `bound`,
`lm_path_sectors` and the bytes of `lm_case` / `insertion_case`), so that
a change to the program cannot move the yardstick. Each input byte is
counted read once and each output byte written once; the LM's operations
are those of the iterations it ran.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s; float32 outside the
# tensor cores at 67 TFLOP/s (at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Floating-point operations counted from the kernels' sources: the LM per
# valid point and patch evaluation, the scatter per (ray, crossing step).
LM_OPS_PER_POINT = 220
SCATTER_OPS_PER_STEP = 24


def bound_s(nbytes: float, ops: float):
    """The least time for the work and which bound sets it: bytes at the
    HBM rate or f32 operations at the peak, the larger."""
    b, o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (b, "bytes") if b >= o else (o, "operations")


def lm_sectors(launch: dict, rows) -> int:
    """Distinct 32-byte sectors of the cost grids that the lanes' 4 x 4
    patches cover at the poses `rows` [K, >=3] over their masked points:
    the patches every accepted pose needs read at least once."""
    grids = launch["cost_grids"]
    h, w = grids.shape[-2:]
    dev = grids.device
    k = rows.shape[0]
    points, masks = launch["points"], launch["point_masks"]
    n = points.shape[-2]
    points, masks = points.reshape(-1, n, 2), masks.reshape(-1, n)
    cloud_rows = launch.get("cloud_rows")
    if cloud_rows is not None:
        points, masks = points[cloud_rows.long()], masks[cloud_rows.long()]
    origins = launch["origins"].reshape(-1, 2)
    res = launch.get("resolutions")
    res = (torch.full((k,), launch["resolution"], device=dev) if res is None
           else res.reshape(-1))
    gi = launch.get("grid_index")
    gi = torch.zeros(k, dtype=torch.int64, device=dev) if gi is None else gi.reshape(-1).long()
    pose = rows[:, None, :3].to(torch.float32)  # [K, 1, 3]
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    px, py = points[..., 0], points[..., 1]
    u = (c * px - s * py + pose[..., 0] - origins[:, 0:1]) / res[:, None] - 0.5
    v = (s * px + c * py + pose[..., 1] - origins[:, 1:2]) / res[:, None] - 0.5
    offs = torch.arange(-1, 3, device=dev)
    row = torch.floor(v).long()[..., None, None] + offs[:, None]
    col = torch.floor(u).long()[..., None, None] + offs[None, :]
    row, col = torch.broadcast_tensors(row, col)
    keep = (row >= 0) & (row < h) & (col >= 0) & (col < w) & masks[:, :, None, None]
    flat = (gi[:, None, None, None] * h + row) * w + col
    return int(torch.unique(flat[keep] // (32 // grids.element_size())).numel())


def lm_work(launch: dict, out, iterations):
    """(bytes, operations) of one lm_match_2d launch: the sectors at the
    lanes' final poses, every other tensor input read once and the rows
    written once; LM_OPS_PER_POINT per valid point and patch evaluation
    (iterations run + 1)."""
    k = out.shape[0]
    n = launch["points"].shape[-2]
    masks = launch["point_masks"].reshape(-1, n)
    if launch.get("cloud_rows") is not None:
        masks = masks[launch["cloud_rows"].long()]
    valid = masks.sum(dim=1).to(torch.int64)
    ops = int(torch.sum(valid * (iterations.to(torch.int64) + 1))) * LM_OPS_PER_POINT
    others = sum(x.numel() * x.element_size() for key, x in launch.items()
                 if isinstance(x, torch.Tensor) and key != "cost_grids")
    return lm_sectors(launch, out) * 32 + others + k * 16, ops


def scatter_work(log_odds, ends_cell, is_hit, origin_cell, num_steps: int):
    """(bytes, operations) of one supercover scatter insertion: the grid
    read and written once (4 B of log-odds and 1 B known a cell each
    way), the rays read once; SCATTER_OPS_PER_STEP per (ray, step)."""
    cells, n = log_odds.numel(), is_hit.shape[0]
    nbytes = cells * 5 * 2 + ends_cell.numel() * 4 + 2 * n + origin_cell.numel() * 4
    return nbytes, n * num_steps * SCATTER_OPS_PER_STEP
