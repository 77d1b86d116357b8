"""RTCSM window sums: the CUDA kernel (`csrc/correlative_window.cu`), its
launch count and its plain PyTorch version.

Replaces the TPU kernel cartographer_tpu/ops/pallas_kernels.py:82
(`correlative_score_windows`). The kernel runs one block per angle: the
warps take the angle's points in tiles of 32, the lanes of a warp hold
the D x D window in registers (lane = point slot x window column, so one
warp load reads one window row of 32 // D points), and the sums are
reduced in a fixed order without atomics, so every run gives the same
result. The note at the top of the source gives the design and bounds.
`ops/scan_matching/correlative_2d.window_sums` launches the kernel for
CUDA tensors and takes `window_sums_plain` for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from cartographer_tpu_torch.mapping import probability_values as pv

# Kernel launches since the count was last set to 0 (by a caller
# that wants to show that a run went through the kernel).
LAUNCHES = 0

_fn = None


def _function():
    global _fn
    if _fn is None:
        from cartographer_tpu_torch.kernels import _build

        fn = _build.load("correlative_window").correlative_window_sums
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def window_sums_plain(prob, ix, iy, point_mask, num_linear: int):
    """Summed window scores [A, D, D] via the batched gather formulation
    (cartographer_tpu/ops/scan_matching/correlative_2d.py:78)."""
    h, w = prob.shape
    offs = torch.arange(
        -num_linear, num_linear + 1, dtype=torch.int32, device=prob.device
    )
    idx_y = iy[:, None, None, :] + offs[None, :, None, None]
    idx_x = ix[:, None, None, :] + offs[None, None, :, None]
    idx_y, idx_x = torch.broadcast_tensors(idx_y, idx_x)
    oob = (idx_x < 0) | (idx_x >= w) | (idx_y < 0) | (idx_y >= h)
    flat = idx_y.clamp(0, h - 1).long() * w + idx_x.clamp(0, w - 1).long()
    vals = prob.reshape(-1)[flat]
    vals = torch.where(oob, pv.MIN_PROBABILITY, vals)
    return torch.sum(vals * point_mask[None, None, None, :], dim=-1)


def window_sums(prob, ix, iy, point_mask, num_linear: int):
    """Launch the CUDA kernel: prob f32 [H, W], ix/iy i32 [A, N],
    point_mask bool [N] -> f32 [A, D, D], D = 2 * num_linear + 1.
    Raises on anything the kernel does not take."""
    global LAUNCHES
    dev = prob.device
    if dev.type != "cuda" or ix.device != dev or iy.device != dev or (
        point_mask.device != dev
    ):
        raise ValueError("all inputs must lie on one CUDA device")
    if prob.dim() != 2 or ix.dim() != 2 or ix.shape != iy.shape:
        raise ValueError(
            f"shapes: prob {tuple(prob.shape)}, ix {tuple(ix.shape)}, "
            f"iy {tuple(iy.shape)}"
        )
    a, n = ix.shape
    if point_mask.shape != (n,):
        raise ValueError(f"point_mask {tuple(point_mask.shape)} != ({n},)")
    if prob.dtype != torch.float32 or ix.dtype != torch.int32 or (
        iy.dtype != torch.int32 or point_mask.dtype != torch.bool
    ):
        raise TypeError("expected prob f32, ix/iy i32, point_mask bool")
    if not (prob.is_contiguous() and ix.is_contiguous() and iy.is_contiguous()
            and point_mask.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    if num_linear < 0:
        raise ValueError(f"num_linear {num_linear} < 0")
    h, w = prob.shape
    d = 2 * num_linear + 1
    out = torch.empty((a, d, d), dtype=torch.float32, device=dev)
    if a == 0:
        return out
    if h == 0 or w == 0:
        raise ValueError("empty grid")
    args = (
        prob.data_ptr(), ix.data_ptr(), iy.data_ptr(), point_mask.data_ptr(),
        out.data_ptr(), h, w, a, n, num_linear,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if dev.index == torch.cuda.current_device():
        rc = _function()(*args)
    else:  # the launch goes to the current device
        with torch.cuda.device(dev):
            rc = _function()(*args)
    if rc != 0:
        raise RuntimeError(f"correlative_window_sums launch failed: cuda error {rc}")
    LAUNCHES += 1
    return out
