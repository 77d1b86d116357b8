"""Supercover range-data insertion into 2D probability grids: the CUDA
kernels (`csrc/supercover_2d.cu`) and their launch counts.

Replace the device programs that XLA compiled from
cartographer_tpu/ops/raycast_2d.py: `insert_scan_dense` (:192, the
chunked frontend's, vmapped over its slots) and `insert_scan` (:32, the
per-scan builder's). Hits and misses go into bit planes in per-launch
scratch (atomicOr), then one pass per cell writes log_odds' and known';
the results are bit-identical to the plain versions. The note at the top
of the source gives the design, the bounds and what keeps the bits
equal. `ops/raycast_2d.insert_scan_dense` and `insert_scan` launch these
for CUDA tensors and run the plain versions beside them
(`insert_scan_dense_plain`, `insert_scan_plain`) for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from cartographer_tpu_torch.mapping import probability_values as pv

# Launches of each kernel since its count was last set to 0.
DENSE_LAUNCHES = 0
SCATTER_LAUNCHES = 0

_fns = {}


def _function(name: str):
    fn = _fns.get(name)
    if fn is None:
        from cartographer_tpu_torch.kernels import _build

        fn = getattr(_build.load("supercover_2d"), name)
        p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        tail = [f, f, f, f, i, p, p, p, p]  # log odds x 4, free space, out..., stream
        if name == "supercover_insert_dense":
            fn.argtypes = [p, p, p, i64, p, i64, p, p, i, i, i, i, *tail]
        else:
            fn.argtypes = [p, p, p, p, p, p, i, i, i, i, *tail]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_rays(is_hit, valid, dev, n):
    for name, x in (("is_hit", is_hit), ("valid", valid)):
        if x.device != dev or x.dtype != torch.bool or x.shape != (n,):
            raise ValueError(f"{name}: expected bool [{n}] on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_grid(log_odds, known, dev):
    if log_odds.dtype != torch.float32 or known.dtype != torch.bool:
        raise TypeError("expected log_odds f32 and known bool")
    if known.shape != log_odds.shape or known.device != dev:
        raise ValueError(f"known {tuple(known.shape)} does not match log_odds "
                         f"{tuple(log_odds.shape)}")
    if not (log_odds.is_contiguous() and known.is_contiguous()):
        raise ValueError("log_odds and known must be contiguous")
    h, w = log_odds.shape[-2:]
    if h == 0 or w == 0:
        raise ValueError("empty grid")
    return h, w


def _f32(x, name, shapes, dev):
    if x.device != dev or x.dtype != torch.float32:
        raise TypeError(f"{name}: expected f32 on {dev}, got {x.dtype} on {x.device}")
    if tuple(x.shape) not in shapes:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected one of {shapes}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(dev):
    """Types and shapes are checked first, the device last."""
    if dev.type != "cuda":
        raise ValueError(f"supercover_2d needs CUDA tensors, got {dev}")


def _launch(name, args, dev):
    if dev.index == torch.cuda.current_device():
        rc = _function(name)(*args)
    else:  # the launch goes to the current device
        with torch.cuda.device(dev):
            rc = _function(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cuda error {rc}")


def insert_scan_dense(
    log_odds,  # f32 [H, W] or [B, H, W]
    known,  # bool, the same shape
    origin_cell,  # f32 [2] or [B, 2]
    ends_cell,  # f32 [N, 2] or [B, N, 2]
    is_hit,  # bool [N]
    valid,  # bool [N]
    hit_log_odds: float,
    miss_log_odds: float,
    insert_free_space: bool = True,
):
    """Launch the dense kernel (raycast_2d.insert_scan_dense's contract):
    returns new (log_odds', known'); the inputs are not modified."""
    global DENSE_LAUNCHES
    dev = log_odds.device
    h, w = _check_grid(log_odds, known, dev)
    if log_odds.dim() not in (2, 3):
        raise ValueError(f"log_odds: shape {tuple(log_odds.shape)}")
    b = log_odds.shape[0] if log_odds.dim() == 3 else 1
    n = is_hit.shape[0] if is_hit.dim() == 1 else -1
    _f32(origin_cell, "origin_cell", {(2,), (b, 2)} if log_odds.dim() == 3 else {(2,)}, dev)
    _f32(ends_cell, "ends_cell",
         {(n, 2), (b, n, 2)} if log_odds.dim() == 3 else {(n, 2)}, dev)
    _check_rays(is_hit, valid, dev, n)
    _on_cuda(dev)
    words = (w + 31) // 32
    scratch = torch.empty(2 * b * h * words, dtype=torch.int32, device=dev)
    out_lo = torch.empty_like(log_odds)
    out_kn = torch.empty_like(known)
    args = (
        log_odds.data_ptr(), known.data_ptr(),
        origin_cell.data_ptr(), 2 if origin_cell.dim() == 2 else 0,
        ends_cell.data_ptr(), 2 * n if ends_cell.dim() == 3 else 0,
        is_hit.data_ptr(), valid.data_ptr(), b, h, w, n,
        hit_log_odds, miss_log_odds, pv.MIN_LOG_ODDS, pv.MAX_LOG_ODDS,
        int(bool(insert_free_space)), scratch.data_ptr(),
        out_lo.data_ptr(), out_kn.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _launch("supercover_insert_dense", args, dev)
    DENSE_LAUNCHES += 1
    return out_lo, out_kn


def insert_scan(
    log_odds,  # f32 [H, W]
    known,  # bool [H, W]
    origin_cell,  # f32 [2]
    ends_cell,  # f32 [N, 2]
    is_hit,  # bool [N]
    valid,  # bool [N]
    hit_log_odds: float,
    miss_log_odds: float,
    num_steps: int,
    insert_free_space: bool = True,
):
    """Launch the scatter kernel (raycast_2d.insert_scan's contract):
    returns new (log_odds', known')."""
    global SCATTER_LAUNCHES
    dev = log_odds.device
    h, w = _check_grid(log_odds, known, dev)
    if log_odds.dim() != 2:
        raise ValueError(f"log_odds: shape {tuple(log_odds.shape)}, expected [H, W]")
    n = is_hit.shape[0] if is_hit.dim() == 1 else -1
    _f32(origin_cell, "origin_cell", {(2,)}, dev)
    _f32(ends_cell, "ends_cell", {(n, 2)}, dev)
    _check_rays(is_hit, valid, dev, n)
    if num_steps < 0:
        raise ValueError(f"num_steps {num_steps} < 0")
    _on_cuda(dev)
    scratch = torch.empty(2 * h * ((w + 31) // 32), dtype=torch.int32, device=dev)
    out_lo = torch.empty_like(log_odds)
    out_kn = torch.empty_like(known)
    args = (
        log_odds.data_ptr(), known.data_ptr(), origin_cell.data_ptr(),
        ends_cell.data_ptr(), is_hit.data_ptr(), valid.data_ptr(), h, w, n,
        int(num_steps), hit_log_odds, miss_log_odds, pv.MIN_LOG_ODDS,
        pv.MAX_LOG_ODDS, int(bool(insert_free_space)), scratch.data_ptr(),
        out_lo.data_ptr(), out_kn.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _launch("supercover_insert_scatter", args, dev)
    SCATTER_LAUNCHES += 1
    return out_lo, out_kn
