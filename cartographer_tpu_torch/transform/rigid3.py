"""SE(3) transforms as arrays [tx, ty, tz, qw, qx, qy, qz].

Reference semantics: cartographer/transform/rigid_transform.h:117 (Rigid3<T>)
and transform/transform.h (GetYaw, Project2D, Embed3D, angle-axis helpers).
Quaternions are [w, x, y, z], kept normalized by `compose`.
"""

from __future__ import annotations

import numpy as np


def identity(xp=np, dtype=np.float64):
    out = xp.zeros((7,), dtype=dtype)
    if xp is np:
        out[3] = 1.0
        return out
    return out.at[3].set(1.0)


def make(t, q, xp=np):
    return xp.concatenate([xp.asarray(t), xp.asarray(q)], axis=-1)


def translation(t, xp=np):
    t = xp.asarray(t)
    q = xp.zeros(t.shape[:-1] + (4,), dtype=t.dtype)
    if xp is np:
        q[..., 0] = 1.0
    else:
        q = q.at[..., 0].set(1.0)
    return xp.concatenate([t, q], axis=-1)


def rotation(q, xp=np):
    q = xp.asarray(q)
    t = xp.zeros(q.shape[:-1] + (3,), dtype=q.dtype)
    return xp.concatenate([t, q], axis=-1)


def trans(pose):
    return pose[..., :3]


def quat(pose):
    return pose[..., 3:7]


# -- quaternion ops ----------------------------------------------------------


def quat_multiply(q1, q2, xp=np):
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return xp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_conjugate(q, xp=np):
    return xp.stack([q[..., 0], -q[..., 1], -q[..., 2], -q[..., 3]], axis=-1)


def quat_normalize(q, xp=np):
    return q / xp.linalg.norm(q, axis=-1, keepdims=True)


def quat_rotate(q, v, xp=np):
    """Rotate vectors v (..., 3) by quaternion q (..., 4)."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * xp.cross(qv, v)
    return v + qw * t + xp.cross(qv, t)


def quat_from_angle_axis(angle_axis, xp=np):
    """Angle-axis vector (direction * angle) -> quaternion.

    Uses the Taylor expansion near zero for stability (matches Eigen/ceres
    semantics used at transform/transform.h AngleAxisVectorToRotationQuaternion).
    """
    angle_axis = xp.asarray(angle_axis)
    theta2 = xp.sum(angle_axis * angle_axis, axis=-1, keepdims=True)
    theta = xp.sqrt(xp.maximum(theta2, 1e-32))
    half = 0.5 * theta
    small = theta2 < 1e-16
    k = xp.where(small, 0.5 - theta2 / 48.0, xp.sin(half) / theta)
    w = xp.where(small[..., 0], 1.0 - theta2[..., 0] / 8.0, xp.cos(half[..., 0]))
    xyz = angle_axis * k
    return xp.concatenate([w[..., None], xyz], axis=-1)


def quat_to_angle_axis(q, xp=np):
    """Quaternion -> angle-axis vector (matches RotationQuaternionToAngleAxisVector)."""
    q = xp.asarray(q)
    # Ensure w >= 0 so the angle is in [0, pi].
    sign = xp.where(q[..., 0:1] < 0, -1.0, 1.0)
    q = q * sign
    w = xp.clip(q[..., 0], -1.0, 1.0)
    sin_half = xp.linalg.norm(q[..., 1:4], axis=-1)
    angle = 2.0 * xp.arctan2(sin_half, w)
    scale = xp.where(sin_half < 1e-12, 2.0, angle / xp.maximum(sin_half, 1e-32))
    return q[..., 1:4] * scale[..., None]


def quat_from_two_vectors(a, b, xp=np):
    """Shortest-arc rotation taking a to b (Eigen FromTwoVectors semantics)."""
    a = a / xp.linalg.norm(a, axis=-1, keepdims=True)
    b = b / xp.linalg.norm(b, axis=-1, keepdims=True)
    c = xp.cross(a, b)
    d = xp.sum(a * b, axis=-1)
    w = 1.0 + d
    # Degenerate case (a == -b): rotate pi around any orthogonal axis.
    small = w < 1e-8
    ortho = xp.cross(a, xp.asarray([1.0, 0.0, 0.0]))
    ortho_norm = xp.linalg.norm(ortho, axis=-1, keepdims=True)
    ortho2 = xp.cross(a, xp.asarray([0.0, 1.0, 0.0]))
    ortho = xp.where(ortho_norm < 1e-8, ortho2, ortho)
    q = xp.concatenate([w[..., None], c], axis=-1)
    q_degenerate = xp.concatenate([xp.zeros_like(w[..., None]), ortho], axis=-1)
    q = xp.where(small[..., None], q_degenerate, q)
    return quat_normalize(q, xp=xp)


def get_yaw(pose_or_quat, xp=np):
    """Yaw of rotation (reference transform::GetYaw: atan2 on rotated unit-x)."""
    q = pose_or_quat if pose_or_quat.shape[-1] == 4 else quat(pose_or_quat)
    direction = quat_rotate(q, xp.broadcast_to(xp.asarray([1.0, 0.0, 0.0]), q.shape[:-1] + (3,)), xp=xp)
    return xp.arctan2(direction[..., 1], direction[..., 0])


def quat_angle(q, xp=np):
    """Rotation angle magnitude (GetAngle)."""
    w = xp.abs(q[..., 0])
    s = xp.linalg.norm(q[..., 1:4], axis=-1)
    return 2.0 * xp.arctan2(s, w)


# -- rigid ops ---------------------------------------------------------------


def compose(a, b, xp=np):
    t = trans(a) + quat_rotate(quat(a), trans(b), xp=xp)
    q = quat_normalize(quat_multiply(quat(a), quat(b), xp=xp), xp=xp)
    return xp.concatenate([t, q], axis=-1)


def inverse(pose, xp=np):
    qinv = quat_conjugate(quat(pose), xp=xp)
    t = -quat_rotate(qinv, trans(pose), xp=xp)
    return xp.concatenate([t, qinv], axis=-1)


def apply(pose, points, xp=np):
    """Apply pose (..., 7) to points (..., N, 3)."""
    q = quat(pose)[..., None, :]
    return quat_rotate(q, points, xp=xp) + trans(pose)[..., None, :]


def relative(a, b, xp=np):
    return compose(inverse(a, xp=xp), b, xp=xp)


# -- 2D <-> 3D (reference transform/transform.h Project2D / Embed3D) ---------


def project_2d(pose, xp=np):
    """SE(3) -> SE(2): [x, y, yaw]."""
    return xp.stack([pose[..., 0], pose[..., 1], get_yaw(pose, xp=xp)], axis=-1)


def embed_3d(pose2, xp=np):
    """SE(2) [x, y, theta] -> SE(3)."""
    pose2 = xp.asarray(pose2)
    half = 0.5 * pose2[..., 2]
    zeros = xp.zeros_like(half)
    q = xp.stack([xp.cos(half), zeros, zeros, xp.sin(half)], axis=-1)
    t = xp.stack([pose2[..., 0], pose2[..., 1], zeros], axis=-1)
    return xp.concatenate([t, q], axis=-1)


def slerp(q0, q1, t, xp=np):
    d = xp.sum(q0 * q1, axis=-1)
    sign = xp.where(d < 0, -1.0, 1.0)
    q1 = q1 * sign[..., None]
    d = xp.abs(d)
    d = xp.clip(d, -1.0, 1.0)
    theta = xp.arccos(d)
    sin_theta = xp.sin(theta)
    small = sin_theta < 1e-6
    w0 = xp.where(small, 1.0 - t, xp.sin((1.0 - t) * theta) / xp.where(small, 1.0, sin_theta))
    w1 = xp.where(small, t, xp.sin(t * theta) / xp.where(small, 1.0, sin_theta))
    return quat_normalize(w0[..., None] * q0 + w1[..., None] * q1, xp=xp)


def interpolate(pose_a, pose_b, t, xp=np):
    """Linear translation + slerp rotation between two SE(3) poses."""
    trans_out = (1.0 - t) * trans(pose_a) + t * trans(pose_b)
    q_out = slerp(quat(pose_a), quat(pose_b), t, xp=xp)
    return xp.concatenate([trans_out, q_out], axis=-1)
