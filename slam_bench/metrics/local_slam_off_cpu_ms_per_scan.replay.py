"""The time the frontend was inside local SLAM but not running, per
revolution: over the feeding thread's four `local_slam.*` spans, wall time
minus the thread's CPU time (waiting for the interpreter lock, a lock or
the device), inside the window, per revolution completed in it. The
thread clock of the card's host advances in 10 ms ticks, so the value is
an estimate from the window's thousands of spans (program_spans.off_cpu_s).

Also prints to standard error the same by stage, and the window's
device-idle seconds split by what the program had open: the feeding
thread's innermost span and the other threads' (the pose graph's pool)."""

import sys

from slam_bench import layers, program_spans


def read(record):
    spans = program_spans.program_spans()
    if spans is None or program_spans.feeding_thread(spans) is None:
        return None
    by_stage = program_spans.off_cpu_s(record, spans)
    value = layers.per_revolution_ms(record, sum(by_stage.values()))
    if value is None:
        return None
    parts = ", ".join(f"{n} {layers.per_revolution_ms(record, s):.6f}" for n, s in by_stage.items())
    print(f"local SLAM off CPU by stage (ms a revolution): {parts}", file=sys.stderr)
    if record.get("device_events"):
        by_span = program_spans.idle_by_span(record, spans)
        parts = "; ".join(f"{f} | {b} {s:.6f} s" for (f, b), s in by_span.most_common())
        print(f"device idle {sum(by_span.values()):.6f} s of {record['t1'] - record['t0']:.6f} s "
              f"by the program's innermost open span (feeder | backend): {parts}", file=sys.stderr)
    return value
