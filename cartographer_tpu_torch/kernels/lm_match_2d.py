"""Bicubic LM scan match: the CUDA kernel (`csrc/lm_match_2d.cu`) and its
launch count.

Replaces the device program that XLA compiled from
cartographer_tpu/ops/scan_matching/gauss_newton_2d.py `match` (:498,
while_loop at :618) and its vmapped loop-closure form
`match_log_odds_batch_packed` (:405). One block per lane runs the whole
LM loop; the note at the top of the source gives the design and bounds.
`ops/scan_matching/gauss_newton_2d.match_lanes` and `match` launch it for
CUDA tensors and run the plain version beside them
(`gauss_newton_2d.match_lanes_plain`) for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

# Kernel launches since the count was last set to 0 (by a caller
# that wants to show that a run went through the kernel).
LAUNCHES = 0

_fn = None


def _function():
    global _fn
    if _fn is None:
        from cartographer_tpu_torch.kernels import _build

        fn = _build.load("lm_match_2d").lm_match_2d
        p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        fn.argtypes = [
            p, i, i,  # grids, h, w
            p, i64, p, i64,  # grid_index, its stride; cloud_rows, its stride
            p, i64, i64, p, i64,  # points and strides; masks, lane stride
            p, i64, p, i64, p, i64,  # origins, poses, targets and row strides
            p, i64, f,  # resolutions, stride; scalar resolution
            i, i, f, f, f, i, i,  # K, N, weights, iterations, nonmonotonic
            p, p, p,  # out, iterations, stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _rows(x, name, width, k, dev):
    """(pointer, row stride) of an f32 [K, width] tensor or, for K = 1, an
    f32 [width] one; the last axis must be contiguous."""
    if x.device != dev or x.dtype != torch.float32:
        raise TypeError(f"{name}: expected f32 on {dev}, got {x.dtype} on {x.device}")
    if x.dim() == 1 and k == 1 and x.shape == (width,):
        stride = 0
    elif x.dim() == 2 and x.shape == (k, width):
        stride = x.stride(0)
    else:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected ({k}, {width})")
    if width > 1 and x.stride(-1) != 1:
        raise ValueError(f"{name}: the last axis must be contiguous")
    return x.data_ptr(), stride


def _index(x, name, k, dev):
    if x is None:
        return None, 0
    if x.device != dev or x.dtype != torch.int32 or x.shape != (k,):
        raise ValueError(f"{name}: expected i32 [{k}] on {dev}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return x.data_ptr(), x.stride(0)


def launch(
    cost_grids,  # f32 [S, H, W] (or [H, W]: one grid)
    origins,  # f32 [K, 2] (or [2] for K = 1)
    initial_poses,  # f32 [K, 3]
    target_translations,  # f32 [K, 2]
    points,  # f32 [U, N, 2] (or [N, 2] for one cloud)
    point_masks,  # bool [U, N] (or [N])
    occupied_space_weight: float,
    translation_weight: float,
    rotation_weight: float,
    max_iterations: int,
    use_nonmonotonic_steps: bool,
    *,
    grid_index=None,  # i32 [K] each lane's grid; None: grid 0
    cloud_rows=None,  # i32 [K] each lane's cloud; None: cloud k (U = K)
    resolutions=None,  # f32 [K]; None: `resolution` for every lane
    resolution: float | None = None,
    iterations=None,  # i32 [K] out: iterations each lane ran, or None
):
    """Launch the kernel: K LM solves, returns f32 [K, 4] rows (x, y,
    theta, cost). Raises on anything the kernel does not take (types and
    shapes first, then a device other than CUDA), before launching; never
    synchronises (grid_index and cloud_rows are not range-checked on the
    host)."""
    global LAUNCHES
    dev = cost_grids.device
    if cost_grids.dtype != torch.float32 or cost_grids.dim() not in (2, 3):
        raise TypeError(f"cost_grids: expected f32 [S, H, W], got "
                        f"{cost_grids.dtype} {tuple(cost_grids.shape)}")
    if not cost_grids.is_contiguous():
        raise ValueError("cost_grids must be contiguous")
    h, w = cost_grids.shape[-2:]
    if h == 0 or w == 0:
        raise ValueError("empty grid")
    k = initial_poses.shape[0] if initial_poses.dim() == 2 else 1
    o_ptr, o_stride = _rows(origins, "origins", 2, k, dev)
    p_ptr, p_stride = _rows(initial_poses, "initial_poses", 3, k, dev)
    t_ptr, t_stride = _rows(target_translations, "target_translations", 2, k, dev)
    if resolutions is None:
        if resolution is None:
            raise ValueError("give resolutions or resolution")
        r_ptr, r_stride = None, 0
    else:
        r_ptr, r_stride = _rows(resolutions[:, None], "resolutions", 1, k, dev)
    gi_ptr, gi_stride = _index(grid_index, "grid_index", k, dev)
    cr_ptr, cr_stride = _index(cloud_rows, "cloud_rows", k, dev)

    if points.device != dev or point_masks.device != dev:
        raise ValueError("points and point_masks must lie on the grids' device")
    if points.dtype != torch.float32 or point_masks.dtype != torch.bool:
        raise TypeError("expected points f32 and point_masks bool")
    pts = points if points.dim() == 3 else points[None]
    msk = point_masks if point_masks.dim() == 2 else point_masks[None]
    if pts.dim() != 3 or pts.shape[2] != 2 or msk.shape != pts.shape[:2]:
        raise ValueError(f"points {tuple(points.shape)} and point_masks "
                         f"{tuple(point_masks.shape)} do not match")
    if pts.stride(2) != 1 or msk.stride(1) != 1:
        raise ValueError("points' xy and the masks' point axis must be contiguous")
    if cloud_rows is None and pts.shape[0] != k:
        raise ValueError(f"{pts.shape[0]} clouds for {k} lanes without cloud_rows")
    if iterations is not None and (
        iterations.device != dev or iterations.dtype != torch.int32
        or iterations.shape != (k,) or not iterations.is_contiguous()
    ):
        raise ValueError("iterations: expected a contiguous i32 [K] on the device")
    if dev.type != "cuda":
        raise ValueError(f"lm_match_2d needs CUDA tensors, got {dev}")
    n = pts.shape[1]
    out = torch.empty((k, 4), dtype=torch.float32, device=dev)
    if k == 0:
        return out
    args = (
        cost_grids.data_ptr(), h, w, gi_ptr, gi_stride, cr_ptr, cr_stride,
        pts.data_ptr(), pts.stride(0), pts.stride(1), msk.data_ptr(), msk.stride(0),
        o_ptr, o_stride, p_ptr, p_stride, t_ptr, t_stride,
        r_ptr, r_stride, 0.0 if resolution is None else resolution,
        k, n, occupied_space_weight, translation_weight, rotation_weight,
        int(max_iterations), int(bool(use_nonmonotonic_steps)), out.data_ptr(),
        None if iterations is None else iterations.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if dev.index == torch.cuda.current_device():
        rc = _function()(*args)
    else:  # the launch goes to the current device
        with torch.cuda.device(dev):
            rc = _function()(*args)
    if rc != 0:
        raise RuntimeError(f"lm_match_2d launch failed: cuda error {rc}")
    LAUNCHES += 1
    return out
