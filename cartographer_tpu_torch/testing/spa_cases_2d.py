"""2D SPA problems for ops/spa_solver, made from a numpy seed as numpy
tables: dicts of SpaProblem's and SpaExtras' fields by name
(`spa_solver.problem_from_numpy`, `extras_from_numpy`).

One set for every caller: the CPU tests hold the plain solve against the
JAX package on `loop_graph`, and the plain solve's counts on both; the
card tests and chip_smoke.py's spa_2d phase hold the kernel
(kernels/spa_2d) against the plain solve on them, `trajectory_graph` at
the benchmark cell's size and at 5,120 nodes.
"""

from __future__ import annotations

import numpy as np

from cartographer_tpu_torch.transform import rigid2


def _empty_problem(s, n, c, k):
    return dict(
        submap_poses=np.zeros((s, 3), np.float32),
        node_poses=np.zeros((n, 3), np.float32),
        free_submap=np.zeros(s, bool), free_node=np.zeros(n, bool),
        c_submap=np.zeros(c, np.int32), c_node=np.zeros(c, np.int32),
        c_z=np.zeros((c, 3), np.float32), c_weight=np.ones((c, 2), np.float32),
        c_huber=np.zeros(c, bool), c_mask=np.zeros(c, bool),
        n_a=np.zeros(k, np.int32), n_b=np.zeros(k, np.int32),
        n_z=np.zeros((k, 3), np.float32), n_weight=np.ones((k, 2), np.float32),
        n_mask=np.zeros(k, bool),
    )


def _fill(t, cons, nn):
    """Write constraint rows (submap, node, z, wt, wr, huber) and
    node-node rows (a, b, z, wt, wr) into the tables, masked in."""
    for i, (si, ni, z, wt, wr, h) in enumerate(cons):
        t["c_submap"][i], t["c_node"][i], t["c_z"][i] = si, ni, z
        t["c_weight"][i], t["c_huber"][i], t["c_mask"][i] = (wt, wr), h, True
    for i, (a, b, z, wt, wr) in enumerate(nn):
        t["n_a"][i], t["n_b"][i], t["n_z"][i] = a, b, z
        t["n_weight"][i], t["n_mask"][i] = (wt, wr), True


def loop_graph(seed, num_nodes=24, nodes_per_submap=6, extras=None):
    """A closed ring of nodes with submaps every few nodes: consistent
    intra-submap and node-node constraints from the truth, two INTER loop
    closures (without extras, one of them an outlier for the Huber loss),
    and every free pose perturbed; tables padded to powers of two (masked
    rows). `extras` "held" or "free" adds a landmark and a fixed frame,
    perturbed, held constant or free. Returns (problem tables, extras
    tables or None)."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0.0, 2 * np.pi, num_nodes, endpoint=False)
    nodes = np.stack([4 * np.cos(ang), 3 * np.sin(ang), ang + np.pi / 2], 1)
    submaps = nodes[::nodes_per_submap].copy()
    s, n = len(submaps), len(nodes)
    cons = []
    for ni in range(n):
        si = ni // nodes_per_submap
        for sj in {si, max(si - 1, 0)}:
            cons.append((sj, ni, rigid2.relative(submaps[sj], nodes[ni]), 500.0, 1600.0, False))
    z_close = rigid2.relative(submaps[0], nodes[-1])
    cons.append((0, n - 1, z_close, 1.1e4, 1e5, True))
    if not extras:
        cons.append((s - 1, 2, z_close + [0.8, -0.5, 0.3], 1.1e4, 1e5, True))
    nn = [
        (i, i + 1, rigid2.relative(nodes[i], nodes[i + 1]), 1e5, 1e5)
        for i in range(n - 1)
    ]
    start_s = submaps + rng.normal(0, [0.05, 0.05, 0.02], submaps.shape)
    start_s[0] = submaps[0]
    start_n = nodes + rng.normal(0, [0.05, 0.05, 0.02], nodes.shape)
    pad = lambda k: max(8, 1 << (k - 1).bit_length())  # noqa: E731
    t = _empty_problem(pad(s), pad(n), pad(len(cons)), pad(len(nn)))
    t["submap_poses"][:s] = start_s
    t["node_poses"][:n] = start_n
    t["free_submap"][1:s] = True
    t["free_node"][:n] = True
    _fill(t, cons, nn)
    ex = None
    if extras:
        landmark = np.array([0.5, 0.2, 0.1])
        gps_origin = np.array([10.0, -3.0, 0.4])
        o = [(3, 4, 0.25), (10, 11, 0.5), (17, 18, 0.75)]
        ex = dict(
            l_poses=np.zeros((2, 3), np.float32),
            l_free=np.array([extras == "free", False]),
            o_node_a=np.zeros(4, np.int32), o_node_b=np.zeros(4, np.int32),
            o_factor=np.zeros(4, np.float32), o_landmark=np.zeros(4, np.int32),
            o_z=np.zeros((4, 3), np.float32), o_weight=np.ones((4, 2), np.float32),
            o_mask=np.zeros(4, bool),
            f_pose=np.zeros((2, 3), np.float32),
            f_free=np.array([extras == "free", False]),
            g_node=np.zeros(8, np.int32), g_traj=np.zeros(8, np.int32),
            g_z=np.zeros((8, 3), np.float32), g_weight=np.ones((8, 2), np.float32),
            g_mask=np.zeros(8, bool),
        )
        ex["l_poses"][0] = landmark + [0.2, -0.1, 0.05]
        for i, (a, b, f) in enumerate(o):
            d = rigid2.normalize_angle(nodes[b, 2] - nodes[a, 2])
            interp = nodes[a] + f * np.array([*(nodes[b, :2] - nodes[a, :2]), d])
            ex["o_node_a"][i], ex["o_node_b"][i], ex["o_factor"][i] = a, b, f
            ex["o_z"][i] = rigid2.relative(interp, landmark)
            ex["o_weight"][i], ex["o_mask"][i] = (10.0, 20.0), True
        ex["f_pose"][0] = gps_origin + [0.3, 0.2, -0.05]
        for i, ni in enumerate(range(0, n, 4)):
            ex["g_node"][i] = ni
            ex["g_z"][i] = rigid2.relative(gps_origin, nodes[ni])
            ex["g_weight"][i], ex["g_mask"][i] = (10.0, 100.0), True
    return t, ex


def _walk(rng, num, scale, phase):
    """Poses along a figure-eight of `scale` metres, heading along the
    path, with jitter."""
    u = phase + np.linspace(0.0, 2 * np.pi * num / 400.0, num)
    x, y = scale * np.sin(u), 0.6 * scale * np.sin(2 * u)
    heading = np.arctan2(np.gradient(y), np.gradient(x))
    poses = np.stack([x, y, heading], 1) + rng.normal(0, [0.02, 0.02, 0.01], (num, 3))
    poses[:, 2] = rigid2.normalize_angle(poses[:, 2])
    return poses


def _drifted(rng, truth):
    """Poses composed from the truth's node-to-node steps with noise
    added to each step: a local SLAM's drift."""
    out = np.empty_like(truth)
    out[0] = truth[0]
    for i in range(1, len(truth)):
        step = rigid2.relative(truth[i - 1], truth[i])
        step = step + rng.normal(0, [0.005, 0.005, 0.002])
        out[i] = rigid2.compose(out[i - 1], step)
    return out


def trajectory_graph(seed, num_nodes=1000, nodes_per_submap=70, frozen_nodes=120,
                     inter=900, outliers=30):
    """A pose graph shaped as a replay's: one free trajectory of
    `num_nodes` nodes walking laps of a figure-eight, started from a
    drifted local-SLAM estimate, with a submap every `nodes_per_submap`
    nodes (the first held). As in a replay, local SLAM's rows agree with
    that estimate: each node's rows to its submap and the one before
    (weights 500 / 1600) and the node-node rows (1e5 / 1e5). The loop
    closures agree with the truth: `inter` INTER rows (1.1e4 / 1e5, Huber)
    from nodes to submaps at least two submaps back within 6 m, `outliers`
    of them wrong by decimetres. One frozen trajectory of `frozen_nodes`
    nodes (its poses held at the truth, no node-node rows) takes a quarter
    of the INTER rows. Returns (problem tables at their exact sizes, no
    masked rows; the nodes' true poses [N, 3])."""
    rng = np.random.default_rng(seed)
    truth = _walk(rng, num_nodes, 10.0, 0.0)
    frozen = _walk(rng, frozen_nodes, 10.0, 1.0)
    start = _drifted(rng, truth)
    own = np.arange(num_nodes) // nodes_per_submap
    fown = np.arange(frozen_nodes) // nodes_per_submap
    s0, s1 = own[-1] + 1, fown[-1] + 1
    submap_truth = np.concatenate([truth[::nodes_per_submap], frozen[::nodes_per_submap]])
    submap_start = np.concatenate([start[::nodes_per_submap], frozen[::nodes_per_submap]])
    node_start = np.concatenate([start, frozen])
    cons = []
    for ni, si in enumerate(np.concatenate([own, s0 + fown])):
        first = s0 if si >= s0 else 0
        for sj in sorted({si, max(si - 1, first)}):
            cons.append((sj, ni, rigid2.relative(submap_start[sj], node_start[ni]),
                         500.0, 1600.0, False))
    found = 0
    while found < inter:
        ni = int(rng.integers(num_nodes))
        if rng.uniform() < 0.25:
            sj = s0 + int(rng.integers(s1))
        else:
            sj = int(rng.integers(s0))
            if sj > own[ni] - 2:
                continue
        if np.hypot(*(submap_truth[sj, :2] - truth[ni, :2])) > 6.0:
            continue
        z = rigid2.relative(submap_truth[sj], truth[ni]) + rng.normal(0, [0.01, 0.01, 0.004])
        if found < outliers:
            z = z + rng.uniform([-0.6, -0.6, -0.3], [0.6, 0.6, 0.3])
        cons.append((sj, ni, z, 1.1e4, 1e5, True))
        found += 1
    nn = [(i, i + 1, rigid2.relative(start[i], start[i + 1]), 1e5, 1e5)
          for i in range(num_nodes - 1)]
    t = _empty_problem(s0 + s1, num_nodes + frozen_nodes, len(cons), len(nn))
    t["submap_poses"][:] = submap_start
    t["node_poses"][:] = node_start
    t["free_submap"][1:s0] = True
    t["free_node"][:num_nodes] = True
    _fill(t, cons, nn)
    return t, np.concatenate([truth, frozen])
