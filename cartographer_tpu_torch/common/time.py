"""Time representation.

The reference (cartographer/common/time.h:42-73) uses a microsecond-resolution
universal time scale. Host-side orchestration here uses float64 seconds, which
keeps sub-microsecond precision over multi-day spans and interoperates
directly with numpy vectorized per-point relative times (float32 on device).
"""

from __future__ import annotations

# Time is absolute seconds (float). Duration is seconds (float).
Time = float
Duration = float

TIME_MIN: Time = float("-inf")
TIME_MAX: Time = float("inf")


def from_seconds(seconds: float) -> Duration:
    return float(seconds)


def to_seconds(duration: Duration) -> float:
    return float(duration)
