"""ctypes wrapper for the native 3D loop-closure search (csrc/bnb3d_native.cc).

Port of cartographer_tpu/native/bnb3.py. The yaw-pruned DFS
branch-and-bound with the low-resolution leaf veto fans across host
threads in C++ while the dual-grid refinement stays on the device
(ConstraintBuilderOptions.loop_closure_backend = "native" or "auto").
Reference: internal/3d/scan_matching/fast_correlative_scan_matcher_3d.cc
:112-444, internal/constraints/constraint_builder_3d.cc.

The library is built from the checkout by kernels/_build.py at first use,
with the JAX wrapper's host flags; a failed build raises (there is no
fallback to the device search).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence

import numpy as np

from cartographer_tpu_torch.kernels import _build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_F = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load("bnb3d_native")
            lib.bnb3_submap_create.restype = ctypes.c_void_p
            lib.bnb3_submap_create.argtypes = [
                _F, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _F, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int,
            ]
            lib.bnb3_submap_destroy.argtypes = [ctypes.c_void_p]
            lib.bnb3_match_batch.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                _F, _I64, _I32,
                _F, _I64, _I32,
                _F, _I64, _I32,
                _F, _F, _I32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            _lib = lib
        return _lib


class NativeSubmap3D:
    """Owns one 3D submap's native octave pyramid + low-res volume."""

    def __init__(
        self,
        high_prob: np.ndarray,
        low_prob: np.ndarray,
        depth: int,
        full_resolution_depth: int = 3,
    ):
        lib = _load()
        high_prob = np.ascontiguousarray(high_prob, np.float32)
        low_prob = np.ascontiguousarray(low_prob, np.float32)
        self._lib = lib
        self.depth = depth
        self.shape = high_prob.shape
        self.handle = lib.bnb3_submap_create(
            high_prob.ctypes.data_as(_F), *high_prob.shape,
            low_prob.ctypes.data_as(_F), *low_prob.shape,
            depth, full_resolution_depth,
        )

    def __del__(self):  # pragma: no cover - interpreter shutdown order
        try:
            if getattr(self, "handle", None):
                self._lib.bnb3_submap_destroy(self.handle)
                self.handle = None
        except Exception:
            pass


def _flatten(arrays: Sequence[np.ndarray], width: int):
    """Identity-deduplicated flat concatenation; per-item offset/count."""
    n = len(arrays)
    offsets = np.zeros(n, np.int64)
    counts = np.zeros(n, np.int32)
    uniq: dict = {}
    parts = []
    total = 0
    for i, c in enumerate(arrays):
        hit = uniq.get(id(c))
        if hit is None:
            part = np.ascontiguousarray(np.asarray(c, np.float32).reshape(len(c), -1)[:, :width])
            hit = (total, len(part))
            uniq[id(c)] = hit
            parts.append(part)
            total += len(part)
        offsets[i], counts[i] = hit
    flat = np.concatenate(parts) if parts else np.zeros((0, width), np.float32)
    return np.ascontiguousarray(flat, np.float32), offsets, counts


def match_batch(
    submaps: List[NativeSubmap3D],
    high_clouds: List[np.ndarray],  # per search [n_i, 3] f32
    low_clouds: List[np.ndarray],  # per search [nl_i, 3] f32
    angle_lists: List[np.ndarray],  # per search pre-pruned yaws f32
    params: np.ndarray,  # [n, 19] f32 (see bnb3d_native.cc)
    num_threads: int = 0,
    seed: bool = True,
    simd: bool = True,
):
    """Run n independent 3D searches across host threads.

    `seed=False` disables the leaf-probe incumbent seeding and
    `simd=False` pins the scalar scoring loops (together the exact
    reference DFS per core).

    Returns (out [n, 6] f32: score/low_score/a/x/y/z, found [n] i32)."""
    lib = _load()
    n = len(submaps)
    handles = (ctypes.c_void_p * n)(*[s.handle for s in submaps])
    high, off_h, cnt_h = _flatten(high_clouds, 3)
    low, off_l, cnt_l = _flatten(low_clouds, 3)
    angles, off_a, cnt_a = _flatten([np.asarray(a, np.float32)[:, None] for a in angle_lists], 1)
    params = np.ascontiguousarray(params, np.float32)
    out = np.zeros((n, 6), np.float32)
    found = np.zeros(n, np.int32)
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    lib.bnb3_match_batch(
        handles, n,
        high.ctypes.data_as(_F), off_h.ctypes.data_as(_I64), cnt_h.ctypes.data_as(_I32),
        low.ctypes.data_as(_F), off_l.ctypes.data_as(_I64), cnt_l.ctypes.data_as(_I32),
        angles.ctypes.data_as(_F), off_a.ctypes.data_as(_I64), cnt_a.ctypes.data_as(_I32),
        params.ctypes.data_as(_F),
        out.ctypes.data_as(_F), found.ctypes.data_as(_I32),
        int(num_threads), int(bool(seed)), int(bool(simd)),
    )
    return out, found
