"""Gauge-aware trajectory accuracy metrics against ground truth.

A pose graph makes a map internally CONSISTENT; yaw drift accumulated
before the first loop closure rotates the whole map relative to ground
truth (a gauge freedom — the first node is fixed arbitrarily). Raw ATE
therefore mostly measures the gauge. Standard trajectory benchmarks align
before measuring; the reference sidesteps the issue entirely with its
relation-based metric (docs/source/evaluation.rst,
ground_truth/compute_relations_metrics_main.cc). Both forms live here:
SE(2)-aligned ATE, and relation errors over ground-truth revisit pairs.
"""

from __future__ import annotations

import numpy as np


def align_se2(est_xy: np.ndarray, true_xy: np.ndarray):
    """Best-fit rotation+translation (Umeyama, no scale) mapping est onto
    truth. Returns (aligned_est_xy, yaw_radians)."""
    ce, ct = est_xy.mean(0), true_xy.mean(0)
    e, t = est_xy - ce, true_xy - ct
    u, _, vt = np.linalg.svd(e.T @ t)
    r = (u @ vt).T
    if np.linalg.det(r) < 0:
        r = (u @ np.diag([1.0, -1.0]) @ vt).T
    return (r @ e.T).T + ct, float(np.arctan2(r[1, 0], r[0, 0]))


def aligned_ate(est_xy: np.ndarray, true_xy: np.ndarray) -> np.ndarray:
    """Per-node translational errors after SE(2) alignment."""
    aligned, _ = align_se2(est_xy, true_xy)
    return np.linalg.norm(aligned - true_xy, axis=1)


def revisit_relation_errors(
    times: np.ndarray,
    est_xy: np.ndarray,
    true_xy: np.ndarray,
    min_dt: float = 15.0,
    max_d: float = 1.5,
) -> np.ndarray:
    """Relative-pose errors over revisit pairs — far apart in TIME, close
    in TRUE space: the reference's relations metric built from ground
    truth instead of the optimized graph. Gauge-invariant, and exactly
    the quantity loop closure must fix."""
    errs = []
    n = len(times)
    for i in range(n):
        for j in range(i + 1, n):
            if times[j] - times[i] < min_dt:
                continue
            if np.linalg.norm(true_xy[j] - true_xy[i]) > max_d:
                continue
            errs.append(
                np.linalg.norm(
                    (est_xy[j] - est_xy[i]) - (true_xy[j] - true_xy[i])
                )
            )
    return np.asarray(errs)
