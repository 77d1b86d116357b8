"""Metrics with null-object defaults (the instruments the ported slice
touches, copied from cartographer_tpu/metrics/__init__.py).

Reference: cartographer/metrics/{counter,gauge,family_factory}.h —
instrumentation is free unless a real family factory is registered.
"""

from __future__ import annotations

import threading
from typing import Dict


class Counter:
    def increment(self, by: float = 1.0) -> None:
        pass

    def value(self) -> float:
        return 0.0


class Gauge:
    def set(self, value: float) -> None:
        pass

    def value(self) -> float:
        return 0.0


class _RealCounter(Counter):
    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def increment(self, by: float = 1.0) -> None:
        with self._lock:
            self._value += by

    def value(self) -> float:
        return self._value


class _RealGauge(Gauge):
    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    def value(self) -> float:
        return self._value


class FamilyFactory:
    """Null by default; `enable_collection()` swaps in real metrics."""

    def __init__(self, real: bool = False):
        self._real = real
        self._registry: Dict[str, object] = {}

    def counter(self, name: str) -> Counter:
        return self._get(name, _RealCounter if self._real else Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, _RealGauge if self._real else Gauge)

    def _get(self, name, ctor):
        if name not in self._registry:
            self._registry[name] = ctor()
        return self._registry[name]

    def registry(self) -> Dict[str, object]:
        return dict(self._registry)


_factory = FamilyFactory(real=False)


def register_family_factory(factory: FamilyFactory) -> None:
    """Swap the global factory (RegisterAllMetrics analog) and re-register."""
    global _factory
    _factory = factory
    _register_all()


def enable_collection() -> FamilyFactory:
    factory = FamilyFactory(real=True)
    register_family_factory(factory)
    return factory


def _register_all() -> None:
    global local_slam_real_time_ratio, grid_oob_points
    local_slam_real_time_ratio = _factory.gauge(
        "mapping_2d_local_trajectory_builder_real_time_ratio"
    )
    # Range-data endpoints dropped because they fell outside a fixed grid
    # extent (the reference grows its grids; here the loss is observable).
    grid_oob_points = _factory.counter("mapping_grid_out_of_extent_points")


_register_all()
