"""Math helpers (reference: cartographer/common/math.h:30-90).

Port of cartographer_tpu/common/math.py.
"""

from __future__ import annotations

import math

import numpy as np


def clamp(value, min_value, max_value):
    return np.minimum(np.maximum(value, min_value), max_value)


def pow2(a):
    return a * a


def round_to_int(x):
    """Round half away from zero, like C++ std::lround."""
    return np.asarray(np.floor(np.asarray(x) + 0.5), dtype=np.int64)


def radians_to_degrees(rad: float) -> float:
    return math.degrees(rad)


def degrees_to_radians(deg: float) -> float:
    return math.radians(deg)


def normalize_angle_difference(difference):
    """Wrap angle to (-pi, pi]. Works on scalars and arrays (numpy)."""
    return difference - 2.0 * np.pi * np.ceil((difference - np.pi) / (2.0 * np.pi))


def atan2_approx(y, x):
    return np.arctan2(y, x)
