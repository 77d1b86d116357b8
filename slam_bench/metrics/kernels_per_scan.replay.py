"""CUDA kernels the device ran in the window (the profiler's kernel
events, from every thread: frontend and pose graph), per revolution
completed in it."""

from slam_bench import layers


def read(record):
    if not record.get("device_events"):
        return None
    t0, t1 = record["t0"], record["t1"]
    n = sum(1 for _, kind, a, _ in record["device_events"]
            if kind == "kernel" and t0 <= a < t1)
    revs = layers.completed_in_window(record)
    return None if revs == 0 else n / revs
