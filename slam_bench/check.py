"""What decides `correct`: the timed path's own outputs, sampled from the
seed inside the window, held against the plain reference.

Each number compared has a limit in the cell's file (`limits`); a number
without one is recorded beside them, not compared:

- `results_missing`: revolutions due in the window with no local SLAM
  result after the wait past its close (the configuration's guarantee).
- `cloud_count_gap`, `cloud_gap_m`: the stages before the scan match, on
  the sampled revolutions. The reference rebuilds, from the revolution's
  raw subdivisions as the generator made them, the returns after the
  voxel filter and the scan matcher's cloud. The first number is the
  widest relative gap in their point counts; the second, the widest
  distance from a point of the program's to the nearest point of the
  reference's returns before the voxel filter (a filter keeps points, so
  a sound run reads rounding alone).
- `unwarp_gap_m`: the stage that rebuild takes as given, by itself: the
  widest gap, over every point of the sampled revolutions, between the
  tracking frame's motion since the revolution's first point by the
  program's per-point poses and by the generator's truth.
- `lm_gap_m`, `lm_gap_rad`: the widest gap, over the sampled scan
  matches, between the pose the frontend's refinement returned and the
  reference's refinement from the same grid, prediction and cloud;
  `lm_pose_gap_m`, the widest of the translation gap plus the angle gap
  times 1 m: the most that a point within 1 m of the tracking frame
  moves between the two poses (the number that holds the angle).
- `insert_cells_differ`: cells (log-odds or known flag, over every grid
  of the sampled insertions) where the program's grid after an insertion
  differs from the reference's insertion into the grid before it; an
  exact comparison.
- `spa_gap_m`: each SPA solve that landed in the window against the
  reference's minimum of the same problem: the widest gap in submap and
  node positions.

The reference follows the program from the program's state at each
boundary (the per-point poses and gravity alignment, the grid matched
against, the grids before an insertion, the SPA problem's tables):
PERF.md says so, and the numbers above check the stages taken as given
by themselves where they can.

With `control=True` the reference stands in for the program one
precision down and is held to the reference (the control, which has to
come out not correct): every floating input and output rounded to
bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch


POSE_LEVER_M = 1.0


def _lower(x, on: bool):
    if not on:
        return x
    if isinstance(x, torch.Tensor):
        if x.is_floating_point():
            return x.to(torch.bfloat16).to(x.dtype)
        return x
    arr = np.asarray(x)
    if arr.dtype.kind == "f":
        return torch.from_numpy(np.asarray(arr, np.float32)).to(torch.bfloat16).to(torch.float32).numpy().astype(arr.dtype)
    return x


def _angle_gap(a: float, b: float) -> float:
    return abs(math.remainder(a - b, 2.0 * math.pi))


def lm_2d(matches, config, control=False):
    from slam_bench.reference import lm_2d

    options = config["trajectory_builder"]["trajectory_builder_2d"]["ceres_scan_matcher"]
    gap_m = gap_rad = pose_gap = 0.0
    for m in matches:
        target, initial, cloud, grid = m["args"][:4]

        def ref(low):
            out = lm_2d.match(_lower(grid.log_odds, low), grid.known, grid.origin,
                              grid.resolution, _lower(target, low), _lower(initial, low),
                              _lower(np.asarray(cloud), low), options)
            return np.asarray(_lower(out, low), np.float64)

        want = ref(False)
        got = ref(True) if control else np.asarray(m["out"][0], np.float64)
        d_m, d_rad = float(np.hypot(*(got[:2] - want[:2]))), _angle_gap(got[2], want[2])
        gap_m, gap_rad = max(gap_m, d_m), max(gap_rad, d_rad)
        pose_gap = max(pose_gap, d_m + POSE_LEVER_M * d_rad)
    return {"lm_gap_m": gap_m, "lm_gap_rad": gap_rad, "lm_pose_gap_m": pose_gap}


def insert_2d(insertions, config, control=False):
    from slam_bench.reference import insert_2d

    submaps = config["trajectory_builder"]["trajectory_builder_2d"]["submaps"]
    inserter = submaps["range_data_inserter"]["probability_grid_range_data_inserter"]
    res = submaps["grid_options_2d"]["resolution"]
    differ = 0
    for ins in insertions:
        def ref(low):
            before = [(_lower(g.log_odds, low), g.known, g.origin) for g in ins["before"]]
            return [(_lower(lo, low), kn) for lo, kn in
                    insert_2d.insert(before, ins["range_data"], res, inserter)]

        want = ref(False)
        got = ref(True) if control else [(g.log_odds, g.known) for g in ins["after"]]
        for (lo, kn), (glo, gkn) in zip(want, got):
            differ += int(torch.sum((lo != glo) | (kn != gkn)))
    return {"insert_cells_differ": differ}


def spa_2d(solves, control=False):
    from slam_bench.reference import spa_2d

    gap = 0.0
    for s in solves:
        assert s["kwargs"].get("extras") is None, "the cell's problems have no landmarks"
        huber = s["kwargs"]["huber_scale"]
        problem = s["problem"]
        want_s, want_n, _ = spa_2d.solve(problem, huber)
        if control:
            lowered = type(problem)(*[_lower(t, True) for t in problem])
            got = [_lower(t.to(torch.float32), True) for t in spa_2d.solve(lowered, huber)[:2]]
        else:
            got = list(s["out"][:2])
        got = [t.to(want_s.device, torch.float64) for t in got]
        for got_t, want_t in zip(got, (want_s, want_n)):
            d = torch.linalg.norm(got_t[:, :2] - want_t[:, :2], dim=1)
            gap = max(gap, float(d.max()) if d.numel() else 0.0)
    return {"spa_gap_m": gap}


def upstream_2d(matches, stream, config, control=False):
    from slam_bench import world
    from slam_bench.reference import frontend_2d

    options = config["trajectory_builder"]["trajectory_builder_2d"]
    sensor = config["range_sensors"][0]
    points, rel = stream.raw[0]
    origin = np.zeros(3)
    rev_of_time = {float(t): k for k, t in enumerate(stream.rev_time)}
    count_gap = cloud_gap = unwarp_gap = tilt = 0.0
    for m in matches:
        up = m["upstream"]
        if up is None or up["batches"] is None:
            continue  # the window's first accumulation began before it
        k = rev_of_time[up["time"]]
        table_t = np.concatenate([t for t, _ in up["batches"]])
        table_p = np.concatenate([p for _, p in up["batches"]])
        subs = [(p, stream.rev_end[k] + float(t[-1]) + (t - t[-1]).astype(np.float64))
                for p, t in world.subdivisions(points[k], rel[k], sensor)]
        filtered, cloud, aligned = frontend_2d.matcher_cloud(
            subs, origin, table_t, table_p, up["gravity"], options)
        if control:
            low = frontend_2d.matcher_cloud(
                [(_lower(p, True), t) for p, t in subs], origin, table_t,
                _lower(table_p, True), _lower(up["gravity"], True), options)
            got_returns, got_cloud = _lower(low[0], True), _lower(low[1], True)
        else:
            got_returns, got_cloud = up["returns"], np.asarray(m["args"][2], np.float32)
        for got_n, want_n in ((len(got_returns), len(filtered)), (len(got_cloud), len(cloud))):
            count_gap = max(count_gap, abs(got_n - want_n) / max(want_n, 1))
        got_all = np.concatenate([got_returns, got_cloud]).astype(np.float64)
        if len(got_all) and len(aligned):
            nearest = torch.cdist(torch.from_numpy(got_all),
                                  torch.from_numpy(aligned.astype(np.float64))).min(dim=1).values
            cloud_gap = max(cloud_gap, float(nearest.max()))
        elif len(got_all) != len(aligned):
            cloud_gap = math.inf

        # The tracking frame's motion since the revolution's first point,
        # in that point's frame: by the program's poses and by the truth.
        first = int(np.argmin(np.abs(table_t - subs[0][1][0])))
        x, y, yaw, _, _, _ = world.path_state(torch.from_numpy(table_t), config["world"])
        truth_xy, truth_yaw = np.stack([x.numpy(), y.numpy()], 1), yaw.numpy()

        def motion(xy, yaw0):
            c, s_ = np.cos(yaw0), np.sin(yaw0)
            d = xy - xy[first]
            return np.stack([c * d[:, 0] + s_ * d[:, 1], -s_ * d[:, 0] + c * d[:, 1]], 1)

        want = motion(truth_xy, truth_yaw[first])
        if control:
            got = motion(_lower(truth_xy, True), _lower(truth_yaw, True)[first])
        else:
            rot = frontend_2d.rotation_matrix(table_p[first, 3:7])
            got = ((table_p[:, :3] - table_p[first, :3]) @ rot)[:, :2]
        unwarp_gap = max(unwarp_gap, float(np.max(np.linalg.norm(got - want, axis=1))))
        up_axis = frontend_2d.rotation_matrix(up["gravity"]) @ np.array([0.0, 0.0, 1.0])
        tilt = max(tilt, float(np.arccos(np.clip(up_axis[2], -1.0, 1.0))))
    return {"cloud_count_gap": count_gap, "cloud_gap_m": cloud_gap,
            "unwarp_gap_m": unwarp_gap, "gravity_tilt_rad": tilt}


def compare(capture, config, stream, missing: int, control=False) -> dict:
    """Every number the cell compares, from the run's captures: the
    program's outputs against the reference, or with `control` the
    reference one precision down against the reference."""
    numbers = {"results_missing": missing}
    numbers.update(upstream_2d(capture.matches, stream, config, control))
    numbers.update(lm_2d(capture.matches, config, control))
    numbers.update(insert_2d(capture.insertions, config, control))
    if capture.solves:
        numbers.update(spa_2d(capture.solves, control))
    return numbers


def judge(numbers: dict, limits: dict):
    """(correct, compared, recorded): every number that has a limit in
    the cell's file at or under it; [(name, value, limit)] of those, and
    {name: value} of the numbers the cell records without comparing."""
    rows = [(n, v, limits[n]) for n, v in numbers.items() if n in limits]
    recorded = {n: v for n, v in numbers.items() if n not in limits}
    return all(v <= lim for _, v, lim in rows), rows, recorded
