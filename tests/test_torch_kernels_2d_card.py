"""The 2D main path's hand-written kernels on the card against their plain
PyTorch versions on the same inputs (the LM scan match, both supercover
insertions), and the builders that launch them against the CPU; plus the
cases the CPU tests share. Nothing here imports the JAX package:
`python -m pytest tests/test_torch_kernels_2d_card.py -m cuda`.

Tolerances: the insertions are bit for bit (the same float32 arithmetic,
integer results); the LM within 1e-4 m / rad and rel 1e-4 in cost (sums
in another order), a lane beyond that only as a run that branched
(chip_smoke.py's lm_stop_explained rule; none at these shapes)."""

import numpy as np
import pytest
import torch

from cartographer_tpu_torch.kernels import lm_match_2d, supercover_2d
from cartographer_tpu_torch.ops import raycast_2d
from cartographer_tpu_torch.ops.scan_matching import gauss_newton_2d
from cartographer_tpu_torch.testing import kernel_cases_2d as cases


def lm_case(seed, k=5, n=100, s=2):
    """K lanes on S 64 x 80 grids (lanes share grids), N points a lane (N
    need not be a multiple of 32); from K = 3 on, lane 0's points all
    masked and lane 1's partly off the grid."""
    return cases.lm_case(np.random.default_rng(seed), s, 64, 80, k, n, walls=8,
                         edge=k >= 3)


def insert_case(seed, b=1):
    """Grids [B, 64, 300] (W not a multiple of 32) at B origins and 400
    shared rays: horizontal (dy = 0: the near-zero branch), vertical,
    ends on lattice corners, rays leaving the grid, invalid and non-hit
    rays."""
    return cases.insert_case(np.random.default_rng(seed), b, 64, 300, 400, 400.0,
                             edge=True)


def to(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def lanes(case, dev):
    c = case
    return to(dev, c["grids"], c["grid_index"], c["origins"], c["initial"],
              c["targets"], c["points"], c["masks"], c["resolutions"])


@pytest.mark.cuda
@pytest.mark.parametrize("nonmonotonic", [False, True])
def test_lm_kernel_matches_plain(cuda, nonmonotonic):
    case = lm_case(3)
    weights = (1.0, 10.0, 40.0)
    before = lm_match_2d.LAUNCHES
    got = gauss_newton_2d.match_lanes(*lanes(case, cuda), *weights, 10, nonmonotonic)
    again = gauss_newton_2d.match_lanes(*lanes(case, cuda), *weights, 10, nonmonotonic)
    want = gauss_newton_2d.match_lanes_plain(*lanes(case, cuda), *weights, 10, nonmonotonic)
    assert lm_match_2d.LAUNCHES == before + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=1e-4)
    # K = 1 through match() (scalar resolution, no lane tensors), and K = 0.
    one = gauss_newton_2d.match(
        *to(cuda, case["grids"][1], case["origins"][3], case["initial"][3],
            case["targets"][3], case["points"][3], case["masks"][3]),
        0.05, *weights, 10, nonmonotonic)
    np.testing.assert_allclose(one[0].cpu().numpy(), got[0][3].cpu().numpy(), atol=1e-6)
    empty = lm_match_2d.launch(
        *to(cuda, case["grids"], case["origins"][:0], case["initial"][:0],
            case["targets"][:0], case["points"][:0], case["masks"][:0]),
        *weights, 10, nonmonotonic, resolution=0.05)
    assert empty.shape == (0, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,free_space", [(1, True), (2, True), (2, False)])
def test_dense_insertion_bit_identical(cuda, b, free_space):
    lo, kn, origin, ends, is_hit, valid = insert_case(b, b=b)
    args = to(cuda, lo, kn, origin, ends, is_hit, valid)
    if b == 1:
        args = [args[0][0], args[1][0], args[2][0], args[3][0], *args[4:]]
    before = supercover_2d.DENSE_LAUNCHES
    got = raycast_2d.insert_scan_dense(*args, 0.2, -0.04, free_space)
    again = raycast_2d.insert_scan_dense(*args, 0.2, -0.04, free_space)
    want = raycast_2d.insert_scan_dense_plain(*args, 0.2, -0.04, free_space)
    assert supercover_2d.DENSE_LAUNCHES == before + 2
    for g, a, p in zip(got, again, want):
        assert torch.equal(g, p) and torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("free_space", [True, False])
def test_scatter_insertion_bit_identical(cuda, free_space):
    lo, kn, origin, ends, is_hit, valid = insert_case(7)
    steps = cases.num_steps_for(origin[0], ends[0])
    args = to(cuda, lo[0], kn[0], origin[0], ends[0], is_hit, valid)
    before = supercover_2d.SCATTER_LAUNCHES
    got = raycast_2d.insert_scan(*args, 0.2, -0.04, steps, free_space)
    again = raycast_2d.insert_scan(*args, 0.2, -0.04, steps, free_space)
    want = raycast_2d.insert_scan_plain(*args, 0.2, -0.04, steps, free_space)
    assert supercover_2d.SCATTER_LAUNCHES == before + 2
    for g, a, p in zip(got, again, want):
        assert torch.equal(g, p) and torch.equal(g, a)


def loop_world_events(num_scans):
    from cartographer_tpu_torch.testing.synthetic import generate_loop_world

    measurements, _ = generate_loop_world(
        laps=0.05, time_step=0.05, num_beams=256, max_range=12.0)
    return measurements[:num_scans]


def small_options():
    from cartographer_tpu_torch.common.config import (
        GridOptions2D,
        SubmapsOptions2D,
        TrajectoryBuilder2DOptions,
    )

    return TrajectoryBuilder2DOptions(
        use_imu_data=False, max_range=12.0,
        use_online_correlative_scan_matching=True,
        submaps=SubmapsOptions2D(
            num_range_data=10,
            grid_options_2d=GridOptions2D(resolution=0.05, grid_size=512)),
    )


@pytest.mark.cuda
def test_run_chunk_launches_kernels_and_matches_cpu(cuda):
    """The chunked frontend on the card, one scan a chunk, each scan rerun
    on the CPU from the card's state: poses within 1e-3 m / rad."""
    from cartographer_tpu_torch.mapping.chunked_frontend_2d import (
        ChunkedLocalTrajectoryBuilder2D,
    )
    from cartographer_tpu_torch.ops import frontend_2d as tf

    run = tf.run_chunk
    worst = [0.0]

    def checked(cfg, state, shift, buf):
        out = run(cfg, state, shift, buf)
        cpu_out = run(cfg, tf.state_from_numpy(tf.state_to_numpy(state), device="cpu"),
                      shift, buf.cpu())
        n_sc = len(tf.SCALARS)
        g, c = [x.cpu().numpy()[: n_sc * 4].view(np.float32) for x in (out[3], cpu_out[3])]
        for key in ("pose_x", "pose_y", "pose_yaw"):
            worst[0] = max(worst[0], abs(float(g[tf.SIDX[key]] - c[tf.SIDX[key]])))
        return out

    builder = ChunkedLocalTrajectoryBuilder2D(
        small_options(), {"range"}, chunk_size=1, device=cuda)
    lm0, dense0 = lm_match_2d.LAUNCHES, supercover_2d.DENSE_LAUNCHES
    tf.run_chunk = checked
    try:
        results = []
        for m in loop_world_events(12):
            results.extend(builder.add_range_data("range", m))
        results.extend(builder.flush())
    finally:
        tf.run_chunk = run
    assert results
    assert lm_match_2d.LAUNCHES - lm0 >= len(results)
    assert supercover_2d.DENSE_LAUNCHES - dense0 >= len(results)
    assert worst[0] <= 1e-3


@pytest.mark.cuda
def test_per_scan_builder_launches_kernels_and_matches_cpu(cuda):
    """LocalTrajectoryBuilder2D on the card, each scan also run by a CPU
    copy of the builder as it stood before it: poses within 1e-3."""
    from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (
        LocalTrajectoryBuilder2D,
    )
    from cartographer_tpu_torch.transform import rigid3

    builder = LocalTrajectoryBuilder2D(small_options(), {"range"}, device=cuda)
    lm0, scatter0 = lm_match_2d.LAUNCHES, supercover_2d.SCATTER_LAUNCHES
    matched = inserted = 0
    for m in loop_world_events(10):
        twin = builder.to("cpu")
        g = builder.add_range_data("range", m)
        c = twin.add_range_data("range", m)
        assert (g is None) == (c is None)
        if g is None:
            continue
        matched += 1
        inserted += g.insertion_result is not None
        gp, cp = rigid3.project_2d(g.local_pose), rigid3.project_2d(c.local_pose)
        assert np.max(np.abs(gp - cp)) <= 1e-3
    assert matched > 1 and inserted > 0
    assert lm_match_2d.LAUNCHES - lm0 >= matched - 1
    assert supercover_2d.SCATTER_LAUNCHES - scatter0 >= inserted
