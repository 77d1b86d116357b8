"""Metrics with null-object defaults.

Port of cartographer_tpu/metrics/__init__.py. Reference:
cartographer/metrics/{counter,gauge,histogram,family_factory}.h and
metrics/register.cc:31-41 — instrumentation is free unless a real family
factory is registered; metrics/prometheus.py renders a real factory's
registry for a scrape. metrics/trace.py adds spans of the program's work,
null outside a torch profiler session (`span`, `timed`, `spans`).
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence

from cartographer_tpu_torch.metrics.trace import (  # noqa: F401
    NULL_SPAN,
    reset_spans,
    span,
    spans,
    spans_dropped,
    timed,
)


class Counter:
    def increment(self, by: float = 1.0) -> None:
        pass

    def value(self) -> float:
        return 0.0


class Gauge:
    def set(self, value: float) -> None:
        pass

    def increment(self, by: float = 1.0) -> None:
        pass

    def decrement(self, by: float = 1.0) -> None:
        pass

    def value(self) -> float:
        return 0.0


class HistogramMetric:
    def observe(self, value: float) -> None:
        pass


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

    def increment(self, by: float = 1.0) -> None:
        with self._lock:
            self._value += by

    def decrement(self, by: float = 1.0) -> None:
        with self._lock:
            self._value -= by

    def value(self) -> float:
        return self._value


class _RealHistogram(HistogramMetric):
    def __init__(self, boundaries: Sequence[float]):
        self._boundaries = list(boundaries)
        self._counts = [0] * (len(self._boundaries) + 1)
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._counts[bisect.bisect_left(self._boundaries, value)] += 1
            self._sum += value

    def counts(self) -> List[int]:
        return list(self._counts)


def score_histogram_boundaries(lo: float, hi: float, n: int = 20) -> List[float]:
    return [lo + (hi - lo) * i / n for i in range(1, n + 1)]


class FamilyFactory:
    """Null by default; `enable_collection()` swaps in real metrics."""

    def __init__(self, real: bool = False):
        self._real = real
        self._registry: Dict[str, object] = {}
        self._meta: Dict[str, tuple] = {}

    def counter(self, name: str, description: str = "") -> Counter:
        return self._get(
            name, _RealCounter if self._real else Counter, "counter", description
        )

    def gauge(self, name: str, description: str = "") -> Gauge:
        return self._get(
            name, _RealGauge if self._real else Gauge, "gauge", description
        )

    def histogram(
        self, name: str, description: str = "", boundaries: Optional[Sequence[float]] = None
    ) -> HistogramMetric:
        return self._get(
            name,
            (lambda: _RealHistogram(boundaries or score_histogram_boundaries(0, 1)))
            if self._real
            else HistogramMetric,
            "histogram", description,
        )

    def _get(self, name, ctor, kind: str = "", description: str = ""):
        if name not in self._registry:
            self._registry[name] = ctor()
            self._meta[name] = (kind, description)
        return self._registry[name]

    def registry(self) -> Dict[str, object]:
        return dict(self._registry)

    def meta(self, name: str):
        """(kind, description) of a registered metric."""
        return self._meta.get(name, ("", ""))


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
    global local_slam_latency, local_slam_real_time_ratio, grid_oob_points
    global local_slam_subdivisions_per_unwarp
    global frontend_slow_path_scans, frontend_odometry_dropped
    global pose_graph_constraints_inter, pose_graph_constraints_intra
    global constraint_scores, constraints_found, constraints_searched
    global optimization_runs, beam_overflow_retries
    global sharded_constraint_batches, sharded_spa_solves
    global pose_graph_work_queue_size, pose_graph_work_queue_delay
    global spa_lm_iterations, spa_cg_steps
    local_slam_latency = _factory.gauge("mapping_2d_local_trajectory_builder_latency")
    local_slam_real_time_ratio = _factory.gauge(
        "mapping_2d_local_trajectory_builder_real_time_ratio"
    )
    # Range scans (subdivisions) the per-scan 2D builder unwarped in its
    # last extrapolator call: num_accumulated_range_data when it unwarps an
    # accumulation at once, 1 with the IMU-based extrapolator.
    local_slam_subdivisions_per_unwarp = _factory.gauge(
        "mapping_2d_local_trajectory_builder_subdivisions_per_unwarp"
    )
    # Local-SLAM configurations that asked for the chunked frontend and
    # fell back to the per-scan path: scans counted instead of silent.
    frontend_slow_path_scans = _factory.counter("mapping_frontend_slow_path_scans")
    # Odometry samples the chunked 3D frontend cannot fuse: dropped with a
    # warning and counted (the per-scan 3D builder fuses them).
    frontend_odometry_dropped = _factory.counter(
        "mapping_frontend_odometry_samples_dropped"
    )
    # Range-data endpoints dropped because they fell outside a fixed grid
    # extent (the reference grows its grids; here the loss is observable).
    grid_oob_points = _factory.counter("mapping_grid_out_of_extent_points")
    pose_graph_work_queue_size = _factory.gauge("mapping_pose_graph_work_queue_size")
    pose_graph_work_queue_delay = _factory.gauge("mapping_pose_graph_work_queue_delay")
    pose_graph_constraints_inter = _factory.gauge("mapping_constraints_inter_submap")
    pose_graph_constraints_intra = _factory.gauge("mapping_constraints_intra_submap")
    constraint_scores = _factory.histogram(
        "mapping_constraint_builder_scores",
        boundaries=score_histogram_boundaries(0.0, 1.0),
    )
    constraints_found = _factory.counter(
        "mapping_constraint_builder_constraints_found"
    )
    constraints_searched = _factory.counter(
        "mapping_constraint_builder_constraints_searched"
    )
    optimization_runs = _factory.counter("mapping_pose_graph_optimizations")
    # The last 2D SPA solve's Levenberg-Marquardt iterations and its CG
    # steps summed over them (ops/spa_solver.solve, kernel or plain path).
    spa_lm_iterations = _factory.gauge("mapping_pose_graph_spa_lm_iterations")
    spa_cg_steps = _factory.gauge("mapping_pose_graph_spa_cg_steps")
    # BnB searches whose per-level survivor set exceeded the beam cap (the
    # search is exact only while the cap does not bind; such searches are
    # re-run with a widened beam).
    beam_overflow_retries = _factory.counter(
        "mapping_constraint_builder_beam_overflow_retries"
    )
    # Production sharded-execution dispatches (loop-closure search batches /
    # SPA solves partitioned over a device mesh, parallel/sharded.py).
    sharded_constraint_batches = _factory.counter(
        "parallel_sharded_constraint_batches"
    )
    sharded_spa_solves = _factory.counter("parallel_sharded_spa_solves")


_register_all()
