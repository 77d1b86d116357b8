"""Hand-written CUDA kernels for Hopper and their ctypes bindings.

Each kernel module holds the launch wrapper and a module-level launch
count; `correlative_window` also holds its plain PyTorch version, while
the plain versions of `lm_match_2d`, `supercover_2d` and `spa_2d` stay
beside the functions that dispatch to them
(ops/scan_matching/gauss_newton_2d.py, ops/raycast_2d.py,
ops/spa_solver.py). Sources live in `cartographer_tpu_torch/csrc/` and
are built by `_build.py` at first use; nothing is compiled when a module
is imported.
"""


def launch_counts():
    """Each kernel's launches since the counts were last set to 0."""
    from cartographer_tpu_torch.kernels import (
        correlative_window, lm_match_2d, spa_2d, supercover_2d,
    )

    return {
        "correlative_window": correlative_window.LAUNCHES,
        "lm_match_2d": lm_match_2d.LAUNCHES,
        "supercover_dense_2d": supercover_2d.DENSE_LAUNCHES,
        "supercover_scatter_2d": supercover_2d.SCATTER_LAUNCHES,
        "spa_2d": spa_2d.LAUNCHES,
    }


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    from cartographer_tpu_torch.kernels import (
        correlative_window, lm_match_2d, spa_2d, supercover_2d,
    )

    correlative_window.LAUNCHES = 0
    lm_match_2d.LAUNCHES = 0
    supercover_2d.DENSE_LAUNCHES = 0
    supercover_2d.SCATTER_LAUNCHES = 0
    spa_2d.LAUNCHES = 0
