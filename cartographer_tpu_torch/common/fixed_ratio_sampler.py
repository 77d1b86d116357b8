"""Deterministic fixed-ratio sampler (reference: common/fixed_ratio_sampler.h:29-46)."""

from __future__ import annotations


class FixedRatioSampler:
    """Pulses return True close to the given ratio of calls, deterministically."""

    def __init__(self, ratio: float):
        if not (0.0 <= ratio <= 1.0):
            raise ValueError(f"ratio must be in [0, 1], got {ratio}")
        if ratio == 0.0:
            # The reference LOGs a warning that all data is dropped.
            pass
        self._ratio = ratio
        self._num_pulses = 0
        self._num_samples = 0

    def pulse(self) -> bool:
        self._num_pulses += 1
        if self._num_samples < self._ratio * self._num_pulses:
            self._num_samples += 1
            return True
        return False

    def debug_string(self) -> str:
        if self._num_pulses == 0:
            return "0 (0.00%)"
        return f"{self._num_samples} ({100.0 * self._num_samples / self._num_pulses:.2f}%)"
