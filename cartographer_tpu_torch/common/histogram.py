"""Text histogram for log output (reference: common/histogram.h)."""

from __future__ import annotations

import math


class Histogram:
    def __init__(self):
        self._values: list[float] = []

    def add(self, value: float) -> None:
        self._values.append(value)

    def to_string(self, buckets: int) -> str:
        assert buckets > 0
        if not self._values:
            return "Count: 0"
        lo = min(self._values)
        hi = max(self._values)
        mean = sum(self._values) / len(self._values)
        out = [f"Count: {len(self._values)}  Min: {lo}  Max: {hi}  Mean: {mean}"]
        if lo == hi:
            return out[0]
        counts = [0] * buckets
        for v in self._values:
            i = min(int((v - lo) / (hi - lo) * buckets), buckets - 1)
            counts[i] += 1
        total = len(self._values)
        cum = 0
        for i, c in enumerate(counts):
            b_lo = lo + (hi - lo) * i / buckets
            b_hi = lo + (hi - lo) * (i + 1) / buckets
            cum += c
            bar = "#" * int(math.ceil(20 * c / total)) if c else ""
            out.append(
                f"[{b_lo:10.4g}, {b_hi:10.4g})\t{100.0 * c / total:5.1f}%\t"
                f"Count: {c} ({100.0 * cum / total:.1f}%)\t{bar}"
            )
        return "\n".join(out)
