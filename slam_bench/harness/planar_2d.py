"""The planar 2D kind: a configuration of planar range sensors and an IMU
(`trajectory_builder_2d`), the kind of a configuration that names none.

- `generate`: the sensors' rays cast on the card against the hall's wall
  segments, each revolution cut into its subdivisions.
- `Probe`: on the 2D local trajectory builder, its scan matcher and
  active submaps, and `optimization_problem_2d.solve`.
- `compare`: the numbers below, against `reference/*_2d.py`.
- `drift`: the local poses' planar motion against the truth's.
- `record_launches`: the 2D LM and scatter kernels' launches, for the
  roofline readers.

Each number `compare` gives has a limit in the cell's file (`limits`); a
number without one is recorded beside them, not compared:

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
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from slam_bench import world
from slam_bench.check import lower

POSE_LEVER_M = 1.0


# -- the stream ---------------------------------------------------------


def cast_segments(ox, oy, ang, segments, chunk: int = 1 << 16):
    """Distance along each planar ray (origin (ox, oy), world angle ang)
    to the nearest wall segment; inf where none is hit."""
    p0 = segments[:, 0]
    d = segments[:, 1] - segments[:, 0]
    out = []
    for i in range(0, ox.numel(), chunk):
        sl = slice(i, i + chunk)
        ux, uy = torch.cos(ang[sl])[:, None], torch.sin(ang[sl])[:, None]
        wx, wy = p0[None, :, 0] - ox[sl, None], p0[None, :, 1] - oy[sl, None]
        denom = -ux * d[None, :, 1] + uy * d[None, :, 0]
        ok = denom.abs() >= 1e-12
        safe = torch.where(ok, denom, torch.ones_like(denom))
        t = (-wx * d[None, :, 1] + wy * d[None, :, 0]) / safe
        s = (ux * wy - uy * wx) / safe
        valid = ok & (t > 0.05) & (s >= 0.0) & (s <= 1.0)
        out.append(torch.where(valid, t, torch.inf).min(dim=1).values)
    return torch.cat(out)


def generate(config: dict, num_revolutions: int, seed: int, device) -> world.Stream:
    """The configuration's stream of `num_revolutions` revolutions: rays
    cast on the card as a batched minimum over rays x wall segments; the
    points then go to the host as numpy, since sensor data reaches
    `MapBuilder` from the host."""
    from cartographer_tpu_torch.sensor.data import TimedPointCloud, TimedPointCloudData

    hall, sensors = config["world"], config["range_sensors"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    f64 = dict(dtype=torch.float64, device=device)
    rev_s = 1.0 / sensors[0]["rate_hz"]
    segments = torch.from_numpy(
        world.hall_segments(hall["half_width"], hall["half_height"], rng)).to(device)

    per_sensor = []  # per sensor: (points [R, P, 3] f32, rel times [R, P] f32)
    for sensor in sensors:
        beams = sensor["beams"]
        fov = math.radians(sensor["fov_deg"])
        ang0 = torch.linspace(-fov / 2, fov / 2, beams, **f64)
        beam_dt = rev_s / (2.0 * math.pi / (fov / (beams - 1)))
        ray_dt = torch.arange(beams, **f64) * beam_dt - (beams - 1) * beam_dt
        pts_all, times_all = [], []
        for r0 in range(0, num_revolutions, 64):
            revs = torch.arange(r0, min(r0 + 64, num_revolutions), **f64)
            end = world.START_TIME + (revs + 1.0) * rev_s  # last point of each revolution
            t = end[:, None] + ray_dt[None, :]  # [r, rays]
            x, y, yaw, _, _, _ = world.path_state(t, hall)
            wang = yaw + ang0[None, :]
            rng_ = cast_segments(x.reshape(-1), y.reshape(-1), wang.reshape(-1),
                                 segments).reshape(t.shape)
            hit = torch.isfinite(rng_) & (rng_ <= sensor["max_range_m"])
            rng_ = rng_ + sensor["range_noise_m"] * torch.randn(t.shape, generator=gen, **f64)
            p = torch.stack([rng_ * torch.cos(ang0)[None], rng_ * torch.sin(ang0)[None],
                             torch.zeros_like(rng_)], -1)
            pts_all.append(torch.where(hit[..., None], p, torch.nan).to(torch.float32).cpu())
            times_all.append(ray_dt.to(torch.float32).expand(t.shape).cpu())
        per_sensor.append((torch.cat(pts_all).numpy(), torch.cat(times_all).numpy()))

    # Range messages: each sensor's revolution cut into its subdivisions,
    # each stamped with its own last point, whose time in the message is
    # exactly 0 (the others' negative), as a driver stamps them.
    msgs = []  # (time, order, sensor_id, payload, revolution or -1)
    for k in range(num_revolutions):
        end = world.START_TIME + (k + 1) * rev_s
        for si, (sensor, (pts, rel)) in enumerate(zip(sensors, per_sensor)):
            for j, (p, tt) in enumerate(subdivisions(pts[k], rel[k], sensor)):
                last = j == sensor.get("subdivisions", 1) - 1 and si == len(sensors) - 1
                msgs.append((end + float(tt[-1]), 1, sensor["id"], TimedPointCloudData(
                    time=end + float(tt[-1]), origin=np.zeros(3, np.float32),
                    ranges=TimedPointCloud(points=p, times=tt - tt[-1]),
                ), k if last else -1))
    msgs += world.imu_messages(config, num_revolutions, rev_s, gen, device)
    return world.stream(config, num_revolutions, rev_s, msgs, per_sensor)


def subdivisions(points, rel, sensor):
    """One revolution's beams that hit, cut into the sensor's
    subdivisions in time order: [(points [n, 3], times after the
    revolution's end [n])]. The range messages carry copies."""
    keep = ~np.isnan(points[:, 0])
    p, tt = points[keep], rel[keep]
    parts = np.array_split(np.arange(len(p)), sensor.get("subdivisions", 1))
    return [(p[idx], tt[idx]) for idx in parts]


# -- the probe ----------------------------------------------------------


class Probe:
    """Spans and sampled captures from the benchmark's side of each
    layer's boundary. `Probe` wraps the bound methods of the trajectory's
    own instances: always to sample what the correctness check compares
    (what the extrapolator and the gravity estimate gave the stages before
    the scan match, the scan matcher's inputs and pose, the grids around an
    insertion, the SPA solves), and in the traced run also to record spans
    around the calls into each layer. Spans are (name, start, end) on
    `time.perf_counter`; captures are kept only while `recording` is set."""

    def __init__(self, rng: np.random.Generator, sample: Dict[str, float], spans: bool):
        self.rng = rng
        self.sample = sample
        self.with_spans = spans
        self.recording = False
        self.spans: List[tuple] = []
        self.matches: List[dict] = []
        self.insertions: List[dict] = []
        self.solves: List[dict] = []
        self._lock = threading.Lock()
        self._batches = None  # the extrapolator's per-point poses since the last accumulation
        self._upstream = None

    def _take(self, kind: str) -> bool:
        # One draw per call in every run, so that the sample depends on the
        # seed and the call's place in the window alone.
        return bool(self.rng.random() < self.sample.get(kind, 0.0)) and self.recording

    def span(self, name, fn):
        if not self.with_spans:
            return fn
        spans = self.spans

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spans.append((name, t0, time.perf_counter()))
        return wrapped

    def attach(self, map_builder, trajectory_id: int) -> None:
        """Wrap the trajectory's facade, local builder, scan matcher,
        active submaps and pose graph."""
        collated = map_builder.get_trajectory_builder(trajectory_id)
        local = collated._wrapped._local_trajectory_builder
        collated.add_sensor_data = self.span("facade", collated.add_sensor_data)
        local.add_range_data = self.span("local_slam", local.add_range_data)
        pg = map_builder.pose_graph
        pg._run_pending = self.span("drain", pg._run_pending)
        pg.run_optimization = self.span("solve", pg.run_optimization)
        self._wrap_accumulated(local)
        self._wrap_match(local._ceres_scan_matcher)
        self._wrap_insert(local._active_submaps)
        self._wrap_solve()
        self.local = local

    def begin(self) -> None:
        """Open the window's captures: from here on the extrapolator's
        per-point poses are kept for each accumulation (the first one in
        the window, which began before, is left out of that check)."""
        extrapolator = self.local._extrapolator
        batch = extrapolator.extrapolate_poses_batch

        def wrapped(times):
            poses = batch(times)
            if self._batches is not None:
                self._batches.append((np.array(times, np.float64), np.array(poses, np.float64)))
            return poses
        extrapolator.extrapolate_poses_batch = wrapped
        self.recording = True

    def _wrap_accumulated(self, local) -> None:
        """What the stages before the scan match gave it: each
        accumulation's per-point poses, the gravity alignment, and the
        voxel-filtered returns in the gravity-aligned frame."""
        accumulated = local._add_accumulated_range_data

        def wrapped(time, range_data, gravity_alignment):
            batches, self._batches = self._batches, ([] if self.recording else None)
            self._upstream = {
                "time": float(time), "batches": batches,
                "gravity": np.array(gravity_alignment, np.float64),
                "returns": np.array(range_data.returns.points, np.float32)}
            return accumulated(time, range_data, gravity_alignment)
        local._add_accumulated_range_data = wrapped

    def _wrap_match(self, matcher) -> None:
        match = matcher.match

        def wrapped(*args, **kwargs):
            take = self._take("matches")
            out = match(*args, **kwargs)
            if take:
                self.matches.append({"args": args, "kwargs": kwargs, "out": out,
                                     "upstream": self._upstream})
            return out
        matcher.match = wrapped

    def _wrap_insert(self, active) -> None:
        insert = active._insert

        def wrapped2(range_data):
            take = self._take("insertions")
            before = [s.grid for s in active._submaps]
            insert(range_data)
            if take:
                self.insertions.append({"range_data": range_data, "before": before,
                                        "after": [s.grid for s in active._submaps]})
        active._insert = wrapped2

    def _wrap_solve(self) -> None:
        from cartographer_tpu_torch.mapping import optimization_problem_2d as op

        solve = op.solve
        probe = self

        def wrapped(problem, *args, **kwargs):
            out = solve(problem, *args, **kwargs)
            if probe.recording:
                with probe._lock:
                    probe.solves.append({"problem": problem, "args": args,
                                         "kwargs": kwargs, "out": out})
            return out
        op.solve = wrapped
        self._restore_solve = (op, solve)

    def detach(self) -> None:
        restore = getattr(self, "_restore_solve", None)
        if restore is not None:
            restore[0].solve = restore[1]

    def counts(self) -> dict:
        """What the window sampled, for the result's `sample`."""
        return {"matches": len(self.matches), "insertions": len(self.insertions),
                "solves": len(self.solves),
                "upstream": sum(m["upstream"]["batches"] is not None for m in self.matches)}


def record_launches(launches: dict) -> list:
    """Record each launch of the 2D LM and scatter kernels (their tensors,
    and the LM's iterations run through its `iterations` output) into
    `launches`, for the roofline readers; returns [(module, name, the
    original)] to restore."""
    from cartographer_tpu_torch.kernels import lm_match_2d, supercover_2d

    lm_launch, scatter = lm_match_2d.launch, supercover_2d.insert_scan
    names = ("cost_grids", "origins", "initial_poses", "target_translations",
             "points", "point_masks")
    lm_records = launches.setdefault("lm_match_2d", [])
    scatter_records = launches.setdefault("supercover_scatter_2d", [])

    def lm_wrapped(*args, **kwargs):
        if kwargs.get("iterations") is None:
            k = args[2].shape[0] if args[2].dim() == 2 else 1
            kwargs["iterations"] = torch.zeros(k, dtype=torch.int32, device=args[0].device)
        out = lm_launch(*args, **kwargs)
        rec = dict(zip(names, args[:6]))
        rec.update({key: v for key, v in kwargs.items() if key != "iterations"})
        lm_records.append((rec, out, kwargs["iterations"]))
        return out

    def scatter_wrapped(*args):
        out = scatter(*args)
        scatter_records.append(args)
        return out

    lm_match_2d.launch = lm_wrapped
    supercover_2d.insert_scan = scatter_wrapped
    return [(lm_match_2d, "launch", lm_launch), (supercover_2d, "insert_scan", scatter)]


# -- the comparison -----------------------------------------------------


def _angle_gap(a: float, b: float) -> float:
    return abs(math.remainder(a - b, 2.0 * math.pi))


def lm_2d(matches, config, control=False):
    from slam_bench.reference import lm_2d

    options = config["trajectory_builder"]["trajectory_builder_2d"]["ceres_scan_matcher"]
    gap_m = gap_rad = pose_gap = 0.0
    for m in matches:
        target, initial, cloud, grid = m["args"][:4]

        def ref(low):
            out = lm_2d.match(lower(grid.log_odds, low), grid.known, grid.origin,
                              grid.resolution, lower(target, low), lower(initial, low),
                              lower(np.asarray(cloud), low), options)
            return np.asarray(lower(out, low), np.float64)

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
            before = [(lower(g.log_odds, low), g.known, g.origin) for g in ins["before"]]
            return [(lower(lo, low), kn) for lo, kn in
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
            lowered = type(problem)(*[lower(t, True) for t in problem])
            got = [lower(t.to(torch.float32), True) for t in spa_2d.solve(lowered, huber)[:2]]
        else:
            got = list(s["out"][:2])
        got = [t.to(want_s.device, torch.float64) for t in got]
        for got_t, want_t in zip(got, (want_s, want_n)):
            d = torch.linalg.norm(got_t[:, :2] - want_t[:, :2], dim=1)
            gap = max(gap, float(d.max()) if d.numel() else 0.0)
    return {"spa_gap_m": gap}


def upstream_2d(matches, stream, config, control=False):
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
                for p, t in subdivisions(points[k], rel[k], sensor)]
        filtered, cloud, aligned = frontend_2d.matcher_cloud(
            subs, origin, table_t, table_p, up["gravity"], options)
        if control:
            low = frontend_2d.matcher_cloud(
                [(lower(p, True), t) for p, t in subs], origin, table_t,
                lower(table_p, True), lower(up["gravity"], True), options)
            got_returns, got_cloud = lower(low[0], True), lower(low[1], True)
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
            got = motion(lower(truth_xy, True), lower(truth_yaw, True)[first])
        else:
            rot = frontend_2d.rotation_matrix(table_p[first, 3:7])
            got = ((table_p[:, :3] - table_p[first, :3]) @ rot)[:, :2]
        unwarp_gap = max(unwarp_gap, float(np.max(np.linalg.norm(got - want, axis=1))))
        up_axis = frontend_2d.rotation_matrix(up["gravity"]) @ np.array([0.0, 0.0, 1.0])
        tilt = max(tilt, float(np.arccos(np.clip(up_axis[2], -1.0, 1.0))))
    return {"cloud_count_gap": count_gap, "cloud_gap_m": cloud_gap,
            "unwarp_gap_m": unwarp_gap, "gravity_tilt_rad": tilt}


def compare(probe, config, stream, missing: int, control=False) -> dict:
    """Every number the cell compares, from the run's captures: the
    program's outputs against the reference, or with `control` the
    reference one precision down against the reference."""
    numbers = {"results_missing": missing}
    numbers.update(upstream_2d(probe.matches, stream, config, control))
    numbers.update(lm_2d(probe.matches, config, control))
    numbers.update(insert_2d(probe.insertions, config, control))
    if probe.solves:
        numbers.update(spa_2d(probe.solves, control))
    return numbers


def drift(poses, stream, revs):
    """The widest gap between the local poses' planar motion from the
    first of `revs` and the truth's, in metres."""
    truth = stream.true_poses
    if len(revs) < 2:
        return None

    def planar(p):  # (x, y, yaw) of an SE(3) pose [t, q]
        w, x, y, z = p[3:7]
        return np.array([p[0], p[1], np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))])

    def rel(a, b):  # b in a's frame
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1]])

    first = revs[0]
    local0, true0 = planar(poses[first]), truth[first][[0, 1, 3]]
    return max(float(np.hypot(*(rel(local0, planar(poses[k])) - rel(true0, truth[k][[0, 1, 3]]))))
               for k in revs)
