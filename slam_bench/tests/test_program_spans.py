"""The readers of the program's own spans on a synthetic record: clipped
to the window and divided by the revolutions completed in it, the feeding
thread told apart, wall minus CPU time for the off-CPU reader, the idle
attribution by the innermost open span, the breakdown's idle gaps named
by the program's spans (the benchmark's own where none is open), and None
wherever the program recorded no spans or dropped some.

    python -m pytest slam_bench/tests/test_program_spans.py -q
"""

import pytest

from cartographer_tpu_torch import metrics
from slam_bench import program_spans, registry

FEEDER, POOL = 1, 2
MS = 1_000_000  # ns; span times are in ms after the clock's 1,000 s


def span(name, start_ms, end_ms, thread=FEEDER, cpu_ms=None, parent=None):
    cpu = (end_ms - start_ms) if cpu_ms is None else cpu_ms
    return (name, int((1_000_000 + start_ms) * MS), int((1_000_000 + end_ms) * MS), int(cpu * MS),
            thread, parent, None)


# The window is [1.0 s, 1.1 s) after the clock's 1,000 s: 100 ms, 4
# revolutions completed inside it (one before, one after).
RECORD = {"t0": 1001.0, "t1": 1001.1,
          "done": [1000.99, 1001.02, 1001.04, 1001.06, 1001.08, 1001.2],
          "device_events": [("k", "kernel", 1001.000, 1001.010),
                            ("k", "kernel", 1001.030, 1001.032),
                            ("k", "kernel", 1001.060, 1001.100)]}

SPANS = [
    span("facade.add_sensor_data", 990, 1040),
    span("local_slam.unwarp", 995, 1010, cpu_ms=5),  # 10 ms inside, 2/3 off CPU
    span("local_slam.filter", 1010, 1014, parent=1),
    span("local_slam.scan_match", 1014, 1030, cpu_ms=4, parent=1),
    span("local_slam.insert", 1030, 1034, parent=1),
    span("pose_graph.work_lock_wait", 1034, 1040, cpu_ms=0, parent=1),
    span("pose_graph.work_lock_wait", 1040, 1050, thread=POOL, cpu_ms=0),
    span("pose_graph.solve", 1050, 1090, thread=POOL),
    span("local_slam.unwarp", 1095, 1120),  # 5 ms inside
]


@pytest.fixture
def recorded(monkeypatch):
    state = {"spans": list(SPANS), "dropped": 0}
    monkeypatch.setattr(metrics, "spans", lambda: list(state["spans"]))
    monkeypatch.setattr(metrics, "spans_dropped", lambda: state["dropped"])
    return state


def read(name):
    return registry.reader(name)(RECORD)


def test_stages_are_clipped_to_the_window_per_revolution(recorded):
    assert read("unwarp_ms_per_scan.replay") == pytest.approx((10 + 5) / 4)
    assert read("filter_ms_per_scan.replay") == pytest.approx(4 / 4)
    assert read("scan_match_ms_per_scan.replay") == pytest.approx(16 / 4)
    assert read("insert_ms_per_scan.replay") == pytest.approx(4 / 4)


def test_the_lock_wait_is_the_feeding_threads_alone(recorded):
    assert read("work_lock_wait_ms_per_scan.replay") == pytest.approx(6 / 4)


def test_off_cpu_is_wall_minus_thread_cpu(recorded, capsys):
    # unwarp: 10 ms inside × (1 - 5/15); scan_match: 16 - 4; the rest on CPU.
    want = (10 * (1 - 5 / 15) + 12) / 4
    assert read("local_slam_off_cpu_ms_per_scan.replay") == pytest.approx(want)
    err = capsys.readouterr().err
    assert ("by stage (ms a revolution): local_slam.unwarp 1.666667, local_slam.filter "
            "0.000000, local_slam.scan_match 3.000000, local_slam.insert 0.000000") in err
    # The idle gaps 10-30 ms and 32-60 ms, cut at the spans' boundaries.
    assert "device idle 0.048000 s of 0.100000 s" in err
    want = {("local_slam.scan_match", "backend (no span open)"): 0.016,
            ("feeder (no span open)", "pose_graph.work_lock_wait"): 0.010,
            ("feeder (no span open)", "pose_graph.solve"): 0.010,
            ("pose_graph.work_lock_wait", "backend (no span open)"): 0.006,
            ("local_slam.filter", "backend (no span open)"): 0.004,
            ("local_slam.insert", "backend (no span open)"): 0.002}
    spans = program_spans.program_spans()
    got = program_spans.idle_by_span(RECORD, spans)
    got = {k: v for k, v in got.items() if v > 1e-9}  # slivers of the ns-to-s rounding
    assert got.keys() == want.keys()
    assert all(got[k] == pytest.approx(v) for k, v in want.items())
    assert "local_slam.scan_match | backend (no span open) 0.016000 s" in err


def test_innermost_span_is_the_latest_started_of_those_open():
    spans = [("outer", 0.0, 10.0), ("inner", 2.0, 4.0), ("late", 3.0, 8.0)]
    spans = [s + (0.0, 1, None, None) for s in spans]
    assert program_spans.innermost_at(spans, [1.0, 2.5, 3.5, 5.0, 9.0, 11.0]) == [
        "outer", "inner", "late", "late", "outer", None]


def test_nothing_reads_as_a_number_without_every_span(recorded, monkeypatch):
    names = [m["name"] for m in registry.benchmark()["per_layer"]
             if m["source"] == "program_span" and m["name"] in {
                 "unwarp_ms_per_scan.replay", "filter_ms_per_scan.replay",
                 "scan_match_ms_per_scan.replay", "insert_ms_per_scan.replay",
                 "work_lock_wait_ms_per_scan.replay", "local_slam_off_cpu_ms_per_scan.replay"}]
    assert len(names) == 6
    recorded["dropped"] = 1
    assert all(read(n) is None for n in names)
    recorded["dropped"], recorded["spans"] = 0, []
    assert all(read(n) is None for n in names)
    monkeypatch.delattr(metrics, "spans")  # a program without the recorder
    assert all(read(n) is None for n in names)


def test_off_cpu_sums_a_tick_sampled_thread_clock(recorded):
    # A thread clock in 10 ms ticks: of two 5 ms stages that ran on the
    # CPU throughout, one reads no CPU and the other a whole tick.
    recorded["spans"] = [span("facade.add_sensor_data", 1000, 1020),
                         span("local_slam.filter", 1002, 1007, cpu_ms=0, parent=0),
                         span("local_slam.filter", 1010, 1015, cpu_ms=10, parent=0)]
    assert read("local_slam_off_cpu_ms_per_scan.replay") == pytest.approx(0.0)


def test_idle_gaps_are_named_by_the_program_spans(recorded):
    from slam_bench.trace import breakdown

    # Idle gaps (ms): 1015-1025 under the feeder's scan match; 1042-1048
    # with the feeder in no program span and the pool in its lock wait;
    # 1090-1094 with no program span open, in the benchmark's own
    # `local_slam` span; 1140-1160 with nothing open at all.
    events = ((1000, 1015), (1025, 1042), (1048, 1090), (1094, 1140), (1160, 1200))
    record = {"t0": 1001.0, "t1": 1001.2,
              "device_events": [("k", "kernel", 1000 + a / 1e3, 1000 + b / 1e3) for a, b in events],
              "spans": [("facade", 1001.000, 1001.040), ("local_slam", 1001.091, 1001.0935)]}
    want = [("feeder (no span open)", 0.020), ("local_slam.scan_match", 0.010),
            ("pose_graph.work_lock_wait", 0.006), ("local_slam", 0.004)]
    got = breakdown(record)["idle_gaps"]
    assert [n for n, _ in got] == [n for n, _ in want]
    assert [s for _, s in got] == pytest.approx([s for _, s in want])
    # Without the program's spans, the benchmark's own name the gaps.
    recorded["dropped"] = 1
    assert [n for n, _ in breakdown(record)["idle_gaps"]] == [
        "feeder (no span open)", "facade", "feeder (no span open)", "local_slam"]
