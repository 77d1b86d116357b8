"""Count the PyTorch operations a piece of the port issues, on the CPU.

Every operation that launches a kernel on the card is counted (views are
left out), so the count predicts the kernels per scan that a card profile
shows, without a card:

    python -m cartographer_tpu_torch.testing.op_count

prints the operations per scan of both 3D local builders at the 3D bench
setting (testing/bench_3d.py), of one 6-DoF LM solve at its shapes, and
of the two small SPD solvers.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cartographer_tpu_torch.testing.bench_3d import bench_3d_options, bench_3d_world

# Operations that only reinterpret a tensor's memory: no kernel.
_VIEWS = {
    "aten.select.int", "aten.unsqueeze.default", "aten.slice.Tensor",
    "aten.expand.default", "aten.permute.default", "aten.view.default",
    "aten.t.default", "aten.transpose.int", "aten.alias.default",
    "aten._unsafe_view.default", "aten.squeeze.dim", "aten.detach.default",
    "aten.scalar_tensor.default",
}


class OpCounter(TorchDispatchMode):
    """Counts the non-view operations dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) not in _VIEWS:
            self.total += 1
        return func(*args, **(kwargs or {}))


def ops_per_scan(builder, num_warm, num_counted):
    """Feed `num_warm` scans, then count the operations of the next
    `num_counted` (a chunked builder's chunk boundaries should divide
    both)."""
    counter = OpCounter()
    scans = 0
    events, _, _ = bench_3d_world(num_warm + num_counted)
    for kind, _, payload in events:
        if kind == "imu":
            builder.add_imu_data(payload)
            continue
        if scans < num_warm:
            builder.add_range_data("range", payload)
        else:
            with counter:
                builder.add_range_data("range", payload)
        scans += 1
    return counter.total / num_counted


def lm_ops():
    """One 6-DoF LM solve on paged grids of the bench's default geometry
    with 512-point clouds."""
    from cartographer_tpu_torch.mapping.paged_grid_3d import make_paged_grid_3d
    from cartographer_tpu_torch.ops.scan_matching import gauss_newton_3d

    high = make_paged_grid_3d(np.zeros(3), 0.1, device="cpu")
    low = make_paged_grid_3d(np.zeros(3), 0.45, device="cpu")
    points = torch.randn(512, 3, generator=torch.Generator().manual_seed(0))
    mask = torch.arange(512) < 300
    counter = OpCounter()
    with counter:
        gauss_newton_3d.match_3d(
            high, high.origin, low, low.origin, torch.zeros(3),
            torch.tensor([1.0, 0.0, 0.0, 0.0]), torch.zeros(3),
            points, mask, points, mask, 0.1, 0.45, 1.0, 6.0, 5.0, 400.0,
        )
    return counter.total


def solver_ops():
    """The unrolled Cholesky of gauss_newton_2d and the column-wise one of
    gauss_newton_3d, on a 6x6 system."""
    from cartographer_tpu_torch.ops.scan_matching import gauss_newton_2d, gauss_newton_3d

    a = torch.eye(6) * 3.0 + 0.1
    b = torch.ones(6)
    counts = {}
    for name, solve in (("unrolled", gauss_newton_2d.solve_spd_small),
                        ("column-wise", gauss_newton_3d._solve_spd)):
        counter = OpCounter()
        with counter:
            solve(a, b)
        counts[name] = counter.total
    return counts


def main() -> None:
    from cartographer_tpu_torch.mapping.chunked_frontend_3d import (
        ChunkedLocalTrajectoryBuilder3D,
    )
    from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
        LocalTrajectoryBuilder3D,
    )

    chunked = ChunkedLocalTrajectoryBuilder3D(
        bench_3d_options(), {"range"}, chunk_size=16, device="cpu")
    per_scan = LocalTrajectoryBuilder3D(
        bench_3d_options(per_scan=True), {"range"}, device="cpu")
    print({
        "chunked_ops_per_scan": ops_per_scan(chunked, 16, 16),
        "per_scan_ops_per_scan": ops_per_scan(per_scan, 10, 10),
        "lm_ops_per_solve": lm_ops(),
        "solver_ops": solver_ops(),
    })


if __name__ == "__main__":
    main()
