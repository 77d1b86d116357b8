"""SE(2) transforms as arrays [x, y, theta].

Reference semantics: cartographer/transform/rigid_transform.h:35 (Rigid2<T>).
Array-first design: a pose is a (..., 3) array so every operation batches and
differentiates under jit/vmap. Works with both numpy and jax.numpy inputs
(pass `xp=jnp` inside jitted code; numpy is the host default).
"""

from __future__ import annotations

import numpy as np


def identity(xp=np, dtype=np.float64):
    return xp.zeros((3,), dtype=dtype)


def translation(t, xp=np):
    t = xp.asarray(t)
    return xp.concatenate([t, xp.zeros_like(t[..., :1])], axis=-1)


def rotation(angle, xp=np):
    angle = xp.asarray(angle)
    z = xp.zeros_like(angle)
    return xp.stack([z, z, angle], axis=-1)


def make(t, angle, xp=np):
    t = xp.asarray(t)
    angle = xp.asarray(angle)
    return xp.concatenate([t, angle[..., None]], axis=-1)


def trans(pose):
    return pose[..., :2]


def angle(pose):
    return pose[..., 2]


def normalize_angle(a, xp=np):
    """Wrap to (-pi, pi]."""
    return a - 2.0 * xp.pi * xp.ceil((a - xp.pi) / (2.0 * xp.pi))


def compose(a, b, xp=np):
    """a * b: first apply b, then a (reference operator*)."""
    ca, sa = xp.cos(a[..., 2]), xp.sin(a[..., 2])
    bx, by = b[..., 0], b[..., 1]
    x = a[..., 0] + ca * bx - sa * by
    y = a[..., 1] + sa * bx + ca * by
    th = normalize_angle(a[..., 2] + b[..., 2], xp=xp)
    return xp.stack([x, y, th], axis=-1)


def inverse(pose, xp=np):
    c, s = xp.cos(pose[..., 2]), xp.sin(pose[..., 2])
    x, y = pose[..., 0], pose[..., 1]
    ix = -(c * x + s * y)
    iy = -(-s * x + c * y)
    return xp.stack([ix, iy, normalize_angle(-pose[..., 2], xp=xp)], axis=-1)


def apply(pose, points, xp=np):
    """Apply pose (..., 3) to points (..., N, 2) -> (..., N, 2)."""
    c = xp.cos(pose[..., 2])[..., None]
    s = xp.sin(pose[..., 2])[..., None]
    px, py = points[..., 0], points[..., 1]
    x = c * px - s * py + pose[..., 0][..., None]
    y = s * px + c * py + pose[..., 1][..., None]
    return xp.stack([x, y], axis=-1)


def relative(a, b, xp=np):
    """a^{-1} * b."""
    return compose(inverse(a, xp=xp), b, xp=xp)
