"""The port's metrics, Prometheus exposition and common helpers against
the JAX package: the text exposition after the same updates, a scrape of
the exporter, and the port's copies of tests/test_common.py's
BlockingQueue and math cases; RateTimer on the same pulses."""

import threading
import urllib.request

import numpy as np
import pytest

from cartographer_tpu import metrics as jmetrics
from cartographer_tpu.common import math as jmath
from cartographer_tpu.common.rate_timer import RateTimer as JRateTimer
from cartographer_tpu.metrics import prometheus as jprometheus
from cartographer_tpu_torch import common as tcommon
from cartographer_tpu_torch import metrics as tmetrics
from cartographer_tpu_torch.common import math as tmath
from cartographer_tpu_torch.common.blocking_queue import BlockingQueue
from cartographer_tpu_torch.common.rate_timer import RateTimer
from cartographer_tpu_torch.metrics import prometheus as tprometheus


def updated_factory(mod, real=True):
    """One set of updates on a fresh factory of `mod`: counters, gauges
    with increments and decrements, histograms with default and given
    boundaries, descriptions on some."""
    factory = mod.FamilyFactory(real=real)
    factory.counter("mapping_constraints_found", "constraints found").increment(3)
    factory.counter("scrapes_total").increment()
    gauge = factory.gauge("mapping_pose_graph_work_queue_size", "work items")
    gauge.set(7.0)
    gauge.increment(2.5)
    gauge.decrement()
    scores = factory.histogram("mapping_scores", "scores", boundaries=[0.25, 0.5, 1.0])
    for v in (0.1, 0.3, 0.6, 0.9, 1.5):
        scores.observe(v)
    factory.histogram("mapping_default_boundaries").observe(0.42)
    factory.counter("name.with-odd chars").increment(0.5)
    return factory


@pytest.mark.parametrize("real", [True, False], ids=["collecting", "null"])
def test_text_exposition_equals_the_jax_package(real):
    text = tprometheus.text_exposition(updated_factory(tmetrics, real))
    assert text == jprometheus.text_exposition(updated_factory(jmetrics, real))
    if real:
        assert "mapping_pose_graph_work_queue_size 8.5" in text
        assert 'mapping_scores_bucket{le="+Inf"} 5' in text
        assert "# HELP mapping_constraints_found constraints found" in text
        assert "name_with_odd_chars 0.5" in text


def test_factory_meta_and_registered_handles():
    factory, jfactory = tmetrics.FamilyFactory(real=True), jmetrics.FamilyFactory(real=True)
    for f in (factory, jfactory):
        f.gauge("g", "a gauge")
        f.histogram("h")
    for name in ("g", "h", "missing"):
        assert factory.meta(name) == jfactory.meta(name)
    assert factory.meta("g") == ("gauge", "a gauge")
    assert factory.meta("missing") == ("", "")
    for name in ("pose_graph_work_queue_size", "pose_graph_work_queue_delay"):
        assert isinstance(getattr(tmetrics, name), tmetrics.Gauge)
    null = tmetrics.Gauge()
    null.increment()
    null.decrement(2.0)
    assert null.value() == 0.0


def test_enable_collection_registers_live_handles():
    """After enable_collection the module's handles collect, and the
    default exposition renders them under the JAX package's names."""
    previous = tmetrics._factory
    try:
        tmetrics.enable_collection()
        tmetrics.optimization_runs.increment()
        tmetrics.pose_graph_work_queue_size.set(4.0)
        text = tprometheus.text_exposition()
        assert "mapping_pose_graph_optimizations 1" in text
        assert "mapping_pose_graph_work_queue_size 4" in text
    finally:
        tmetrics.register_family_factory(previous)


def test_prometheus_exporter_scrape():
    factory = tmetrics.FamilyFactory(real=True)
    factory.counter("scrapes_total").increment(5)
    exporter = tprometheus.PrometheusExporter(0, factory)
    try:
        url = f"http://127.0.0.1:{exporter.port}"
        body = urllib.request.urlopen(url + "/metrics", timeout=10).read().decode()
        assert body == tprometheus.text_exposition(factory)
        assert "scrapes_total 5" in body
        with pytest.raises(urllib.error.HTTPError, match="404"):
            urllib.request.urlopen(url + "/other", timeout=10)
    finally:
        exporter.close()


# -- common -------------------------------------------------------------------------------


def test_common_reexports():
    for name in ("Time", "Duration", "from_seconds", "to_seconds", "clamp",
                 "normalize_angle_difference", "round_to_int", "FixedRatioSampler",
                 "Histogram", "Task", "ThreadPool", "BlockingQueue"):
        assert hasattr(tcommon, name), name


@pytest.mark.parametrize("x,want", [
    (0.0, 0.0), (np.pi, np.pi), (3 * np.pi, np.pi), (2 * np.pi, 0.0),
])
def test_normalize_angle(x, want):
    assert tmath.normalize_angle_difference(x) == pytest.approx(want, abs=1e-12)


def test_normalize_angle_of_minus_pi():
    assert abs(tmath.normalize_angle_difference(-np.pi)) == pytest.approx(np.pi)


@pytest.mark.parametrize("x,want", [(0.4, 0), (0.5, 1), (np.array([1.4, 1.6]), [1, 2])])
def test_round_to_int(x, want):
    np.testing.assert_array_equal(tmath.round_to_int(x), want)


def test_round_to_int_of_minus_half():
    assert tmath.round_to_int(-0.5) in (-1, 0)  # half away or to even


def test_math_equals_the_jax_package():
    x = np.random.default_rng(0).uniform(-20.0, 20.0, 1000)
    for name in ("normalize_angle_difference", "round_to_int", "pow2", "atan2_approx"):
        args = (x, x[::-1]) if name == "atan2_approx" else (x,)
        np.testing.assert_array_equal(getattr(tmath, name)(*args), getattr(jmath, name)(*args))
    np.testing.assert_array_equal(tmath.clamp(x, -3.0, 4.0), jmath.clamp(x, -3.0, 4.0))
    assert tmath.radians_to_degrees(1.25) == jmath.radians_to_degrees(1.25)
    assert tmath.degrees_to_radians(70.0) == jmath.degrees_to_radians(70.0)


def test_blocking_queue_fifo():
    q = BlockingQueue()
    q.push(1)
    q.push(2)
    assert q.peek() == 1 and q.size() == 2
    assert q.pop() == 1
    assert q.pop() == 2
    assert q.empty()


@pytest.mark.parametrize("pop", ["pop_with_timeout", "peek_with_timeout"])
def test_blocking_queue_timeout(pop):
    assert getattr(BlockingQueue(), pop)(0.01) is None


def test_blocking_queue_bounded():
    q = BlockingQueue(queue_size=1)
    q.push(1)
    assert not q.push_with_timeout(2, timeout=0.01)
    assert q.pop() == 1
    assert q.push_with_timeout(2, timeout=0.01)


def test_blocking_queue_many_producers_and_consumers():
    """Four producers and four consumers through a queue of 3 slots: every
    item arrives once (a lost wake-up would hang the joins)."""
    q = BlockingQueue(queue_size=3)
    got, lock = [], threading.Lock()

    def produce(k):
        for i in range(200):
            q.push((k, i))

    def consume():
        while True:
            item = q.pop()
            if item is None:
                return
            with lock:
                got.append(item)

    producers = [threading.Thread(target=produce, args=(k,), daemon=True) for k in range(4)]
    consumers = [threading.Thread(target=consume, daemon=True) for _ in range(4)]
    for t in producers + consumers:
        t.start()
    for t in producers:
        t.join(timeout=30)
    for _ in consumers:
        q.push(None)
    for t in consumers:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in producers + consumers)
    assert sorted(got) == [(k, i) for k in range(4) for i in range(200)]


def test_rate_timer_equals_the_jax_package():
    """The same pulses, sensor and wall times given, in both packages:
    the same rates, ratios and strings as the window slides."""
    ours, theirs = RateTimer(0.5), JRateTimer(0.5)
    assert ours.compute_rate() == theirs.compute_rate() == 0.0
    assert np.isnan(ours.compute_wall_time_rate_ratio())
    rng = np.random.default_rng(3)
    sensor, wall = 100.0, 0.0
    for _ in range(60):
        sensor += rng.uniform(0.04, 0.06)
        wall += rng.uniform(0.01, 0.05)
        ours.pulse(sensor, wall)
        theirs.pulse(sensor, wall)
        assert ours.compute_rate() == theirs.compute_rate()
        np.testing.assert_equal(ours.compute_wall_time_rate_ratio(),
                                theirs.compute_wall_time_rate_ratio())  # nan after one pulse
        assert ours.debug_string() == theirs.debug_string()
    assert 15.0 < ours.compute_rate() < 25.0
