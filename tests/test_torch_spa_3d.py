"""The port's SE(3) SPA solver against the JAX package: one problem with
every residual family (submap-node with Huber, node-node, IMU rotation
with a calibration quaternion, IMU acceleration with per-trajectory
gravity, landmarks, fixed frames with the TolerantLoss, fix_z), and the
written-out Jacobian blocks against a central difference. Inputs come
from numpy seeds; the JAX side runs on the CPU, the port with
device="cpu"."""

import numpy as np
import pytest
import torch

from cartographer_tpu.ops import spa_solver_3d as jspa
from cartographer_tpu_torch.ops import spa_solver_3d as tspa
from cartographer_tpu_torch.transform import rigid3

from test_torch_backend_card import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _quat(rng, scale):
    return rigid3.quat_from_angle_axis(rng.normal(0, scale, 3))


def _pose(t, q):
    return np.concatenate([t, q])


def se3_problem(seed, num_nodes=10, nodes_per_submap=4, fix_z=False,
                tolerant=True, calibration=True):
    """Numpy tables of a small 3D graph with every residual family. The
    truth is a helix of nodes; constraints are consistent with it (one
    INTER outlier for the Huber loss), IMU rows come from the truth with
    a calibration quaternion and gravity 9.8 on trajectory 0 (a second
    trajectory row holds one rotation row), and every free pose starts
    perturbed."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0.0, 1.5 * np.pi, num_nodes)
    nodes = [
        _pose(np.array([3 * np.cos(a), 3 * np.sin(a), 0.1 * a]),
              rigid3.quat_multiply(
                  rigid3.quat_from_angle_axis(np.array([0.0, 0.0, a + np.pi / 2])),
                  _quat(rng, 0.05)))
        for a in ang
    ]
    submaps = [nodes[i] for i in range(0, num_nodes, nodes_per_submap)]
    s, n = len(submaps), len(nodes)
    noisy = lambda p, st, sr: rigid3.compose(  # noqa: E731
        p, _pose(rng.normal(0, st, 3), _quat(rng, sr)))
    t = {}
    t["submap_t"] = np.stack([noisy(p, 0.05, 0.02)[:3] for p in submaps]).astype(np.float32)
    t["submap_q"] = np.stack([noisy(p, 0.05, 0.02)[3:] for p in submaps]).astype(np.float32)
    t["submap_t"][0], t["submap_q"][0] = submaps[0][:3], submaps[0][3:]
    start_n = [noisy(p, 0.05, 0.02) for p in nodes]
    t["node_t"] = np.stack([p[:3] for p in start_n]).astype(np.float32)
    t["node_q"] = np.stack([p[3:] for p in start_n]).astype(np.float32)
    t["free_submap"] = np.arange(s) > 0
    t["free_node"] = np.ones(n, bool)
    t["fix_z"] = np.asarray(fix_z)
    cons = []
    for ni in range(n):
        si = ni // nodes_per_submap
        for sj in sorted({si, max(si - 1, 0)}):
            cons.append((sj, ni, rigid3.relative(submaps[sj], nodes[ni]), 500.0, 1600.0, False))
    cons.append((0, n - 1, rigid3.relative(submaps[0], nodes[-1]), 1.1e4, 1e5, True))
    bad = rigid3.compose(rigid3.relative(submaps[-1], nodes[1]), _pose(np.array([0.6, -0.4, 0.2]), _quat(rng, 0.2)))
    cons.append((s - 1, 1, bad, 1.1e4, 1e5, True))
    t["c_submap"] = np.array([c[0] for c in cons], np.int32)
    t["c_node"] = np.array([c[1] for c in cons], np.int32)
    t["c_z_t"] = np.stack([c[2][:3] for c in cons]).astype(np.float32)
    t["c_z_q"] = np.stack([c[2][3:] for c in cons]).astype(np.float32)
    t["c_weight"] = np.array([(c[3], c[4]) for c in cons], np.float32)
    t["c_huber"] = np.array([c[5] for c in cons])
    t["c_mask"] = np.ones(len(cons), bool)
    t["c_mask"][-3] = False  # a masked row reads as padding
    nn = [(i, i + 1, rigid3.relative(nodes[i], nodes[i + 1])) for i in range(n - 1)]
    t["n_a"] = np.array([r[0] for r in nn], np.int32)
    t["n_b"] = np.array([r[1] for r in nn], np.int32)
    t["n_z_t"] = np.stack([r[2][:3] for r in nn]).astype(np.float32)
    t["n_z_q"] = np.stack([r[2][3:] for r in nn]).astype(np.float32)
    t["n_weight"] = np.tile(np.array([[1e3, 1e3]], np.float32), (len(nn), 1))
    t["n_mask"] = np.ones(len(nn), bool)
    calib = _quat(rng, 0.03) if calibration else np.array([1.0, 0, 0, 0])
    # IMU rotation: dq = conj(c) (conj(q_a) q_b) c, the gyro delta in the
    # imu frame, slightly noisy.
    rot = []
    for i in range(n - 1):
        qa, qb = nodes[i][3:], nodes[i + 1][3:]
        rel = rigid3.quat_multiply(rigid3.quat_conjugate(qa), qb)
        dq = rigid3.quat_multiply(rigid3.quat_multiply(rigid3.quat_conjugate(calib), rel), calib)
        rot.append((i, i + 1, rigid3.quat_multiply(dq, _quat(rng, 0.01)), 1.6e3, 0))
    rot.append((2, 3, rigid3.quat_multiply(rot[2][2], _quat(rng, 0.02)), 500.0, 1))
    t["r_a"] = np.array([r[0] for r in rot], np.int32)
    t["r_b"] = np.array([r[1] for r in rot], np.int32)
    t["r_dq"] = np.stack([r[2] for r in rot]).astype(np.float32)
    t["r_weight"] = np.array([r[3] for r in rot], np.float32)
    t["r_traj"] = np.array([r[4] for r in rot], np.int32)
    t["r_mask"] = np.ones(len(rot), bool)
    # IMU acceleration over triples: the delta velocity that the truth's
    # second difference and gravity 9.8 imply, in the imu frame.
    acc = []
    dt = 0.5
    for i in range(n - 2):
        tf, tm, tl = (nodes[j][:3] for j in (i, i + 1, i + 2))
        target = (tl - tm) / dt - (tm - tf) / dt + 9.8 * dt * np.array([0.0, 0, 1])
        qm = rigid3.quat_multiply(nodes[i + 1][3:], calib)
        dv = rigid3.quat_rotate(rigid3.quat_conjugate(qm), target) + rng.normal(0, 0.01, 3)
        acc.append((i, i + 1, i + 2, dv, dt, dt, 110.0 / (2 * dt)))
    t["a_first"] = np.array([a[0] for a in acc], np.int32)
    t["a_mid"] = np.array([a[1] for a in acc], np.int32)
    t["a_last"] = np.array([a[2] for a in acc], np.int32)
    t["a_dv"] = np.stack([a[3] for a in acc]).astype(np.float32)
    t["a_dt1"] = np.array([a[4] for a in acc], np.float32)
    t["a_dt2"] = np.array([a[5] for a in acc], np.float32)
    t["a_weight"] = np.array([a[6] for a in acc], np.float32)
    t["a_traj"] = np.zeros(len(acc), np.int32)
    t["a_mask"] = np.ones(len(acc), bool)
    t["gravity"] = np.array([9.6, 9.8], np.float32)
    t["calib_q"] = np.stack([rigid3.quat_multiply(calib, _quat(rng, 0.02)), [1.0, 0, 0, 0]]).astype(np.float32)
    t["optimize_calibration"] = np.asarray(calibration)

    # Extras: two landmarks seen between nodes, one fixed frame.
    e = {}
    lms = [_pose(np.array([1.0, 2.0, 0.5]), _quat(rng, 0.3)),
           _pose(np.array([-2.0, 1.0, 0.2]), _quat(rng, 0.3))]
    obs = [(1, 2, 0.3, 0), (4, 5, 0.6, 0), (6, 7, 0.5, 1), (7, 8, 0.0, 1)]
    e["l_t"] = np.stack([noisy(p, 0.1, 0.05)[:3] for p in lms]).astype(np.float32)
    e["l_q"] = np.stack([noisy(p, 0.1, 0.05)[3:] for p in lms]).astype(np.float32)
    e["l_free"] = np.ones(2, bool)
    o_z = []
    for a, b, f, li in obs:
        interp = rigid3.interpolate(nodes[a], nodes[b], f)
        o_z.append(rigid3.relative(interp, lms[li]))
    e["o_node_a"] = np.array([o[0] for o in obs], np.int32)
    e["o_node_b"] = np.array([o[1] for o in obs], np.int32)
    e["o_factor"] = np.array([o[2] for o in obs], np.float32)
    e["o_landmark"] = np.array([o[3] for o in obs], np.int32)
    e["o_z_t"] = np.stack([z[:3] for z in o_z]).astype(np.float32)
    e["o_z_q"] = np.stack([z[3:] for z in o_z]).astype(np.float32)
    e["o_weight"] = np.tile(np.array([[1e3, 1e3]], np.float32), (len(obs), 1))
    e["o_mask"] = np.ones(len(obs), bool)
    yaw = 0.4
    origin = _pose(np.array([5.0, -2.0, 0.3]), np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)]))
    e["f_t"] = (origin[:3] + [0.2, -0.1, 0.05]).astype(np.float32)[None]
    e["f_q"] = np.array([[np.cos(0.45 / 2), 0, 0, np.sin(0.45 / 2)]], np.float32)
    e["f_free"] = np.ones(1, bool)
    g_nodes = [0, 2, 5, 7, 9]
    g_z = [rigid3.relative(origin, nodes[i]) for i in g_nodes]
    g_z[2] = rigid3.compose(g_z[2], _pose(np.array([1.5, 0.0, 0.0]), np.array([1.0, 0, 0, 0])))
    e["g_node"] = np.array(g_nodes, np.int32)
    e["g_traj"] = np.zeros(len(g_nodes), np.int32)
    e["g_z_t"] = np.stack([z[:3] for z in g_z]).astype(np.float32)
    e["g_z_q"] = np.stack([z[3:] for z in g_z]).astype(np.float32)
    e["g_weight"] = np.tile(np.array([[300.0, 1000.0]], np.float32), (len(g_nodes), 1))
    e["g_mask"] = np.ones(len(g_nodes), bool)
    e["g_tolerant"] = np.asarray(tolerant)
    e["g_loss_a"] = np.asarray(1.0, np.float32)
    e["g_loss_b"] = np.asarray(1.0, np.float32)
    return t, e


def _jax_tuple(cls, tables):
    import jax.numpy as jnp

    return cls(**{k: jnp.asarray(tables[k]) for k in cls._fields})


def _angle(qa, qb):
    d = rigid3.quat_multiply(rigid3.quat_conjugate(qa.astype(np.float64)), qb.astype(np.float64))
    return 2 * np.arctan2(np.linalg.norm(d[..., 1:], axis=-1), np.abs(d[..., 0]))


@pytest.mark.parametrize("fix_z", [False, True], ids=["every_family", "fix_z"])
def test_solve_3d_matches_jax(fix_z, one_torch_thread):  # noqa: F811
    """fix_z is a traced flag in the JAX solver, so both cases share one
    JAX compile (≈ 40 s on the CPU)."""
    t, e = se3_problem(5, fix_z=fix_z)
    kw = dict(huber_scale=1.0, max_iterations=50)
    jp = _jax_tuple(jspa.SpaProblem3D, t)
    je = _jax_tuple(jspa.SpaExtras3D, e)
    want = [np.asarray(a) for a in jspa.solve_3d(jp, extras=je, **kw)]
    tp = tspa.problem_from_numpy(t, CPU)
    te = tspa.extras_from_numpy(e, CPU)
    got = [a.numpy() for a in tspa.solve_3d(tp, extras=te, **kw)]
    assert len(got) == len(want)
    # Translations within 1e-4 m, rotations within 1e-4 rad; the gravity
    # constants (≈ 9.8, weakly observed) within 1e-4 relative.
    for i in range(len(got) - 1):
        if got[i].ndim == 2 and got[i].shape[1] == 4:
            assert np.max(_angle(got[i], want[i])) < 1e-4, i
        elif i == 4:
            np.testing.assert_allclose(got[i], want[i], rtol=1e-4)
        else:
            np.testing.assert_allclose(got[i], want[i], atol=1e-4, rtol=0, err_msg=str(i))
    np.testing.assert_allclose(got[-1], want[-1], rtol=1e-3)
    # The solve moved the poses: the test would pass vacuously otherwise.
    assert np.max(np.abs(got[2] - t["node_t"])) > 1e-2
    if fix_z:
        np.testing.assert_array_equal(got[2][:, 2], t["node_t"][:, 2])


def test_blocks_match_central_difference(one_torch_thread):  # noqa: F811
    """Every family's written-out Jacobian (with respect to the parameter
    table, through the right Jacobian of exp at nonzero rotation deltas,
    the Huber and TolerantLoss factors included) against a central
    difference of the residuals, in float64."""
    t, e = se3_problem(7)
    # Make the Huber and TolerantLoss factors active and non-trivial.
    p = tspa.problem_from_numpy(t, CPU)
    ex = tspa.extras_from_numpy(e, CPU)
    model = tspa._Model(p, ex, 0.5, torch.float64)
    rng = np.random.default_rng(3)
    x = model.x0() + torch.from_numpy(rng.normal(0, 0.05, tuple(model.mask.shape))) * model.mask
    res, blocks = model.linearize(x)
    names = ["constraints", "node_node", "imu_rotation", "imu_acceleration",
             "landmarks", "fixed_frame"]
    assert len(res) == len(names)
    num_params = x.numel()
    eps = 1e-6
    for k, name in enumerate(names):
        rows = res[k].numel()
        dense = torch.zeros((rows, num_params), dtype=torch.float64)
        for idx, m in blocks[k]:
            r, d = m.shape[0], m.shape[1]
            for j in range(r):
                i = int(idx[j])
                dense[j * d:(j + 1) * d, i * 6:(i + 1) * 6] += m[j]
        numeric = torch.zeros_like(dense)
        for c in range(num_params):
            step = torch.zeros(num_params, dtype=torch.float64)
            step[c] = eps
            step = step.reshape(x.shape)
            plus = model.residuals(x + step)[k].reshape(-1)
            minus = model.residuals(x - step)[k].reshape(-1)
            numeric[:, c] = (plus - minus) / (2 * eps)
        scale = max(1.0, float(numeric.abs().max()))
        err = float((dense - numeric).abs().max()) / scale
        assert err < 1e-6, (name, err)
        assert float(numeric.abs().max()) > 0, name
