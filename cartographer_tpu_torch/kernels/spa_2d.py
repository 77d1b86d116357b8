"""2D sparse pose adjustment: the CUDA kernel (`csrc/spa_2d.cu`), its
host loop and its launch count.

One launch runs one Levenberg-Marquardt iteration of
`ops/spa_solver.solve_plain` on one thread block: linearisation, the
Jacobi-preconditioned CG, the candidate's cost and the trust-region
update. The poses and the LM state stay on the device between launches;
the host reads five integers after each launch, the solve's one
synchronisation an iteration (as the plain loop's `bool(converged)`).
`ops/spa_solver.solve` runs it for CUDA tensors without a mesh; the note
at the top of the source gives the design and its size limits.
"""

from __future__ import annotations

import ctypes

import torch

# Kernel launches since the count was last set to 0 (one an LM
# iteration; a solve with max_iterations 0 launches once for its cost).
LAUNCHES = 0

# The pointer table's fields, in csrc/spa_2d.cu's `Ptr` order: name,
# dtype, shape in the table sizes below (an int is a fixed width).
_PROBLEM = (
    ("submap_poses", torch.float32, ("S", 3)),
    ("node_poses", torch.float32, ("N", 3)),
    ("free_submap", torch.bool, ("S",)),
    ("free_node", torch.bool, ("N",)),
    ("c_submap", torch.int32, ("C",)),
    ("c_node", torch.int32, ("C",)),
    ("c_z", torch.float32, ("C", 3)),
    ("c_weight", torch.float32, ("C", 2)),
    ("c_huber", torch.bool, ("C",)),
    ("c_mask", torch.bool, ("C",)),
    ("n_a", torch.int32, ("K",)),
    ("n_b", torch.int32, ("K",)),
    ("n_z", torch.float32, ("K", 3)),
    ("n_weight", torch.float32, ("K", 2)),
    ("n_mask", torch.bool, ("K",)),
)
_EXTRAS = (
    ("l_poses", torch.float32, ("L", 3)),
    ("l_free", torch.bool, ("L",)),
    ("o_node_a", torch.int32, ("O",)),
    ("o_node_b", torch.int32, ("O",)),
    ("o_factor", torch.float32, ("O",)),
    ("o_landmark", torch.int32, ("O",)),
    ("o_z", torch.float32, ("O", 3)),
    ("o_weight", torch.float32, ("O", 2)),
    ("o_mask", torch.bool, ("O",)),
    ("f_pose", torch.float32, ("T", 3)),
    ("f_free", torch.bool, ("T",)),
    ("g_node", torch.int32, ("G",)),
    ("g_traj", torch.int32, ("G",)),
    ("g_z", torch.float32, ("G", 3)),
    ("g_weight", torch.float32, ("G", 2)),
    ("g_mask", torch.bool, ("G",)),
)
# Table sizes, then settings, in csrc/spa_2d.cu's `Dim` order.
_SIZES = ("S", "N", "L", "T", "C", "K", "O", "G")
# The state the host reads after each launch (`StateI`), and the floats
# the kernel keeps (`StateF`; the cost first).
_STATE_INTS = 5
_STATE_FLOATS = 8
_ROW_FLOATS = 22
_VECTOR_FLOATS_PER_POSE = 16
_MAX_SIZE = 1 << 24

_fn = None


def _function():
    global _fn
    if _fn is None:
        from cartographer_tpu_torch.kernels import _build

        fn = _build.load("spa_2d").spa_2d
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_int64),  # pointer table
            ctypes.POINTER(ctypes.c_int64),  # sizes and settings
            ctypes.c_float,  # huber_scale
            ctypes.c_int,  # iteration
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _checked(tables, fields, sizes, dev):
    """The tables' tensors in `fields` order, each checked for device,
    dtype, contiguity and shape; fills `sizes` from the first tensor of
    each size."""
    out = []
    for name, dtype, shape in fields:
        t = getattr(tables, name)
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != len(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        for axis, want in zip(t.shape, shape):
            if isinstance(want, str):
                want = sizes.setdefault(want, axis)
            if axis != want:
                raise ValueError(f"{name}: shape {tuple(t.shape)} does not match "
                                 f"the other tables' {dict(sizes)}")
        out.append(t)
    return out


def solve(problem, extras, huber_scale: float, max_iterations: int,
          cg_iterations: int, use_nonmonotonic_steps: bool):
    """ops/spa_solver.solve on the card: returns ((submap_poses,
    node_poses[, landmark_poses, fixed_frame_poses], cost), info), info
    holding the LM iterations run and the CG steps summed over them.
    Raises on anything the kernel does not take (devices, dtypes,
    shapes, a device other than CUDA) before the first launch, and on a
    table index out of range after the first."""
    global LAUNCHES
    dev = problem.submap_poses.device
    if max_iterations < 0 or cg_iterations < 0:
        raise ValueError("max_iterations and cg_iterations must be >= 0")
    sizes = {}
    tensors = _checked(problem, _PROBLEM, sizes, dev)
    if extras is not None:
        tensors += _checked(extras, _EXTRAS, sizes, dev)
    else:
        sizes.update(L=0, T=0, O=0, G=0)
    if dev.type != "cuda":
        raise ValueError(f"spa_2d needs CUDA tensors, got {dev}")
    if max(sizes.values()) > _MAX_SIZE or max(max_iterations, cg_iterations) > _MAX_SIZE:
        raise ValueError(f"spa_2d takes tables of up to {_MAX_SIZE} rows: {sizes}")
    poses = sizes["S"] + sizes["N"] + sizes["L"] + sizes["T"]
    rows = sizes["C"] + sizes["K"] + sizes["O"] + sizes["G"]
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    x = torch.empty((poses, 3), **f32)
    out = torch.empty((poses, 3), **f32)
    state = torch.empty(_STATE_FLOATS, **f32)
    istate = torch.empty(_STATE_INTS, **i32)
    buffers = [
        x, out, state, istate,
        torch.empty((_ROW_FLOATS, rows), **f32),
        torch.empty((3, rows), **i32),
        torch.empty(_VECTOR_FLOATS_PER_POSE * poses, **f32),
    ]
    pointers = [t.data_ptr() for t in tensors]
    if extras is None:
        pointers += [0] * len(_EXTRAS)
    pointers += [t.data_ptr() for t in buffers]
    ptrs = (ctypes.c_int64 * len(pointers))(*pointers)
    dims = (ctypes.c_int64 * 11)(
        *[sizes[k] for k in _SIZES], int(max_iterations), int(cg_iterations),
        int(bool(use_nonmonotonic_steps)))
    fn = _function()
    stream = torch.cuda.current_stream(dev).cuda_stream
    state_ints = [0] * _STATE_INTS
    with torch.cuda.device(dev):
        for it in range(max(int(max_iterations), 1)):
            rc = fn(ptrs, dims, float(huber_scale), it, stream)
            if rc != 0:
                raise RuntimeError(f"spa_2d launch failed: cuda error {rc}")
            LAUNCHES += 1
            state_ints = istate.tolist()
            converged, bad = state_ints[:2]
            if bad:
                raise IndexError("spa_2d: a constraint's index lies outside its pose table")
            if converged:
                break
    split = [sizes["S"], sizes["N"]] + ([sizes["L"], sizes["T"]] if extras is not None else [])
    info = {"iterations": state_ints[2], "cg_steps": state_ints[3]}
    return tuple(torch.split(out, split)) + (state[0],), info
