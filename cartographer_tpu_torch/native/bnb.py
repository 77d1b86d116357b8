"""ctypes wrapper for the native loop-closure search (csrc/bnb_native.cc).

Port of cartographer_tpu/native/bnb.py. The branch-and-bound searches of
a drain fan out across host threads in C++ while the refinement stays on
the device (ConstraintBuilderOptions.loop_closure_backend = "native");
the reference gives each (node, submap) pair its own ThreadPool task
(constraint_builder_2d.cc:102-136).

The library is built from the checkout by kernels/_build.py at first use,
with the JAX wrapper's host flags; a failed build raises (there is no
fallback to the device search).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional

import numpy as np

from cartographer_tpu_torch.kernels import _build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load("bnb_native")
            lib.bnb_pyramid_create.restype = ctypes.c_void_p
            lib.bnb_pyramid_create.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
            ]
            lib.bnb_pyramid_destroy.argtypes = [ctypes.c_void_p]
            lib.bnb_match_batch.argtypes = [
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int,
            ]
            _lib = lib
        return _lib


class NativePyramid:
    """Owns one submap's native precomputation pyramid."""

    def __init__(self, prob: np.ndarray, depth: int):
        lib = _load()
        prob = np.ascontiguousarray(prob, np.float32)
        self._lib = lib
        self.h, self.w = prob.shape
        self.depth = depth
        self.handle = lib.bnb_pyramid_create(
            prob.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.h,
            self.w,
            depth,
        )

    def __del__(self):  # pragma: no cover - interpreter shutdown order
        try:
            if getattr(self, "handle", None):
                self._lib.bnb_pyramid_destroy(self.handle)
                self.handle = None
        except Exception:
            pass


def match_batch(
    pyramids: List[NativePyramid],
    clouds: List[np.ndarray],  # per search [n_i, 2] f32
    params: np.ndarray,  # [n, 9] f32 (see bnb_native.cc)
    num_threads: int = 0,
):
    """Run n independent searches across host threads.

    Clouds are deduplicated by object identity (one node is searched
    against many submaps per drain) before the flat upload to the C++
    layer; searches carry (offset, count) references into the unique
    concatenation.

    Returns (out [n, 4] f32: score/x/y/theta, found [n] i32)."""
    lib = _load()
    n = len(pyramids)
    handles = (ctypes.c_void_p * n)(*[p.handle for p in pyramids])
    offsets = np.zeros(n, np.int64)
    counts = np.zeros(n, np.int32)
    uniq: dict = {}
    flat_parts = []
    total = 0
    for i, c in enumerate(clouds):
        key = id(c)
        hit = uniq.get(key)
        if hit is None:
            part = np.ascontiguousarray(c[:, :2], np.float32)
            hit = (total, len(part))
            uniq[key] = hit
            flat_parts.append(part)
            total += len(part)
        offsets[i], counts[i] = hit
    flat = (
        np.concatenate(flat_parts)
        if flat_parts
        else np.zeros((0, 2), np.float32)
    )
    flat = np.ascontiguousarray(flat, np.float32)
    params = np.ascontiguousarray(params, np.float32)
    out = np.zeros((n, 4), np.float32)
    found = np.zeros(n, np.int32)
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    lib.bnb_match_batch(
        handles,
        n,
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        params.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        found.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(num_threads),
    )
    return out, found
